"""The launch layer under the port's CUDA kernel wrappers (``pair_flow``,
``pair_flow_train``, ``resblock``): what every launch needs and no kernel
decides.

One copy each of: loading a kernel library with its C signatures
(:func:`library`), the C call of a launch with its record (:func:`call`,
:data:`LAUNCHES`, :data:`LAST_LAUNCH`), a kernel's registers and spills
(:func:`kernel_attrs`), the tensor-core rule (:func:`uses_tensor_cores`),
the shared-memory limit (:data:`SMEM_MAX`), the wave-balancing tile rule
(:func:`balanced_t_tile`) and the tensor cores' weight packing
(:func:`pack_tc_weights`, :func:`pad_dim`, :func:`pad_halves`).  Each
wrapper keeps its operand layout, its width rule, its tile choice, its
plain version and its autograd Functions.  Nothing loads at import: a
library is built and loaded on its first use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SMEM_MAX = 232448               # bytes of shared memory one CTA may use

_I, _P = ctypes.c_int, ctypes.c_void_p
_LL, _F = ctypes.c_longlong, ctypes.c_float
# library (csrc/<name>.cu) -> C function -> (result type, argument types).
# A launch takes (dtype code, its ints, ptrs, dims, [scalar,] stream); an
# attributes function fills out[3] (pair_train_attrs: out[2]).
SIGNATURES = {
    "pair_flow": {
        "pair_reverse_threads": (_I, ()),
        # (dtype, variant, tc, R, R_in, t_tile)
        "pair_reverse_smem_bytes": (_I, (_I,) * 6),
        # (dtype, variant, tc, ptrs, dims, stream)
        "pair_reverse_launch": (_I, (_I,) * 3 + (_P,) * 3),
        # (dtype, variant, out)
        "pair_reverse_attrs": (_I, (_I, _I, _P)),
    },
    "pair_flow_wino": {
        "pair_wino_threads": (_I, ()),
        # (dtype, P, tc, R, R_in, t_tile)
        "pair_wino_smem_bytes": (_I, (_I,) * 6),
        # (dtype, P, hoisted, tc, ptrs, dims, stream)
        "pair_wino_launch": (_I, (_I,) * 4 + (_P,) * 3),
        # (dtype, P, hoisted, out)
        "pair_wino_attrs": (_I, (_I, _I, _I, _P)),
    },
    "pair_flow_train": {
        # (backward, tc, R, R_in, Cc, t_tile)
        "pair_train_ws_bytes": (_LL, (_I,) * 6),
        # (backward, tc, R, R_in, t_tile)
        "pair_train_smem_bytes": (_LL, (_I,) * 5),
        # (R, R_in, Cc)
        "pair_train_grad_floats": (_LL, (_I,) * 3),
        # (dtype, stats, tc, ptrs, dims, hinge margin, stream)
        "pair_train_fwd_launch": (_I, (_I,) * 3 + (_P, _P, _F, _P)),
        # (dtype, tc, ptrs, dims, hinge margin, stream)
        "pair_train_bwd_launch": (_I, (_I,) * 2 + (_P, _P, _F, _P)),
        # (kernel, dtype, out)
        "pair_train_attrs": (_I, (_I, _I, _P)),
    },
    "resblock": {
        "resblock_threads": (_I, ()),
        # (dtype, v2, R, Cc, t_tile, dilation)
        "resblock_smem_bytes": (_I, (_I,) * 6),
        # (dtype, v2, tc, ptrs, dims, stream)
        "resblock_launch": (_I, (_I,) * 3 + (_P,) * 3),
        # (dtype, v2, out)
        "resblock_attrs": (_I, (_I, _I, _P)),
    },
}

# kernel -> (library, the ints that pick its instance there): after the
# dtype code in the library's launch, shared-memory and attributes
# functions (variant; P, hoisted; v2), before it in pair_train_attrs
# (0 pair_fwd, 1 pair_train_fwd, 2 pair_train_bwd)
KERNELS = {
    "pair_flow": ("pair_flow", (0,)),
    "pair_flow_i8": ("pair_flow", (1,)),
    "pair_flow_i8rs": ("pair_flow", (2,)),
    "pair_flow_hoisted": ("pair_flow", (3,)),
    "pair_flow_hoisted_i8": ("pair_flow", (4,)),
    "pair_flow_wino": ("pair_flow_wino", (6, 0)),
    "pair_flow_wino4": ("pair_flow_wino", (12, 0)),
    "pair_flow_wino_hoisted": ("pair_flow_wino", (6, 1)),
    "pair_flow_wino4_hoisted": ("pair_flow_wino", (12, 1)),
    "pair_fwd": ("pair_flow_train", (0,)),
    "pair_train_fwd": ("pair_flow_train", (1,)),
    "pair_train_bwd": ("pair_flow_train", (2,)),
    "resblock": ("resblock", (0,)),
    "resblock_v2": ("resblock", (1,)),
}

# Launches of the CUDA kernels, by name; :func:`call` adds one per launch.
LAUNCHES = dict.fromkeys(KERNELS, 0)
# per kernel, what its last launch ran with: rows per tile ("t_tile") and
# CTAs ("ctas"); the training pairs also the bytes they allocated besides
# their inputs and outputs ("workspace_bytes", and "slab_bytes" for the
# backward's gradient slabs).  The int8 pairs' output depends on the tile
# (per-window activation scales), so a plain check runs at this tile.
LAST_LAUNCH: dict = {}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The kernel library ``csrc/<name>.cu``, built and loaded on first use,
    with every C signature of :data:`SIGNATURES` declared."""
    from . import _build

    lib = _build.load(name)
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(argtypes)
    return lib


def call(fn, name: str, ints, tensors, dims, device, record: dict,
         scalar=None) -> None:
    """Launch kernel ``name`` through its C entry point ``fn`` on the
    current stream of ``device``: ``fn(*ints, ptrs, dims, [scalar,]
    stream)``, where ptrs holds the data pointers of ``tensors`` (None is a
    null pointer) and dims the ints ``dims``.  Raises RuntimeError on a
    cudaError; otherwise counts the launch in :data:`LAUNCHES` and keeps
    ``record`` as :data:`LAST_LAUNCH` [name].  The kernel runs on the
    current stream, so the caching allocator may reuse the caller's
    temporaries only for work queued after it."""
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[0 if x is None else x.data_ptr() for x in tensors])
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ints, ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(dim_arr, ctypes.c_void_p),
                 *(() if scalar is None else (scalar,)), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    LAST_LAUNCH[name] = record


def kernel_attrs(name: str, dtype: torch.dtype) -> tuple[int, int]:
    """(registers, local bytes) per thread of kernel ``name``'s instance in
    ``dtype``, as cudaFuncGetAttributes reports them (local bytes are the
    register spills' stack)."""
    lib_name, pick = KERNELS[name]
    dcode = 0 if dtype == torch.float32 else 1
    # pair_train_attrs takes (kernel, dtype, out), the others (dtype, the
    # instance's ints, out)
    args = (*pick, dcode) if lib_name == "pair_flow_train" else (dcode, *pick)
    attrs = next(f for f in SIGNATURES[lib_name] if f.endswith("_attrs"))
    out = (ctypes.c_int * 3)()
    err = getattr(library(lib_name), attrs)(*args, out)
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return out[0], out[1]


def uses_tensor_cores(dtype: torch.dtype) -> bool:
    """Whether a kernel of this storage type runs its products on the
    tensor cores (mma.sync): every kernel in bf16 (the nine reverse pairs,
    the three training-side pairs and both ResBlocks); fp32 runs on CUDA
    cores (fp32 keeps its rel <= 1e-4 bar, which a bf16 product cannot
    meet)."""
    return dtype == torch.bfloat16


def balanced_t_tile(B: int, T: int, n_sm: int, fits, *,
                    shortest: bool = False) -> int:
    """Rows per tile of a tensor-core instance (one CTA per SM): the fewest
    waves of B * ceil(T / tile) tiles over ``n_sm`` SMs among the tiles of
    16-72 rows that ``fits(tile)`` accepts; with several waves the
    shortest tile that needs no more (a last wave of a few tiles leaves
    the card idle: lj22k block 0 at batch 8 takes 66 rows, 392 tiles in 3
    waves, where 64 rows would give 400 tiles and 4), in one wave the
    longest (on the card, at T = 400 and 300, 64-row tiles beat 25- and
    16-row ones, and 95-row ones lost to 64).  With ``shortest`` (the
    forward's rule: one CTA per tile, no persistent grid) the shortest in
    one wave too, since a CTA's time follows its window's rows and a
    part-filled wave leaves SMs idle: pair_fwd at lj22k block 3 (batch 8,
    T 400) takes 0.360 ms of kernel time on 25-row tiles (128 CTAs) and
    0.771 ms on 72-row ones (48 CTAs) (H100 80GB HBM3, 700 W;
    tools/train_pair_ab.py --fwd-tiles)."""
    fit = [tt for tt in range(16, 73) if fits(tt)]
    if not fit:
        raise ValueError("no tile of the tensor-core pair fits in "
                         f"{SMEM_MAX} bytes of shared memory")

    def waves(tt):
        return -(-B * -(-T // tt) // n_sm)
    least = min(waves(tt) for tt in fit)
    best = [tt for tt in fit if waves(tt) == least]
    return best[-1] if least == 1 and not shortest else best[0]


def pad_dim(x: torch.Tensor, dim: int, n: int, value: float = 0.0):
    """``x`` with ``dim`` extended to ``n`` by entries equal to ``value``."""
    if x.shape[dim] == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - x.shape[dim]
    return torch.cat([x, x.new_full(shape, value)], dim)


def pad_halves(x: torch.Tensor, r: int, value: float = 0.0):
    """Last axis [filter R | gate R] -> [filter r | gate r]."""
    f, g = x.split(x.shape[-1] // 2, -1)
    return torch.cat([pad_dim(f, -1, r, value), pad_dim(g, -1, r, value)],
                     -1)


def pack_tc_weights(w: torch.Tensor) -> torch.Tensor:
    """[..., K, N] weight -> the tensor cores' fragment order [..., K/ks,
    N/8, 32, e]: ks = 16, e = 4 for bf16 (mma m16n8k16); ks = 32, e = 8
    for int8 (m16n8k32), K zero-padded to a multiple of ks.  Entry [s, t,
    l, i] is the i-th B element that lane l holds for k-step s and n-tile
    t (PTX ISA): n = 8t + l//4 and, in bf16, k = 16s + 2(l%4) + i%2 +
    8(i//2); in int8, k = 32s + 4(l%4) + i%4 + 16(i//4).  So a lane reads
    its fragment as one 8-byte load and a warp 256 contiguous bytes."""
    *lead, k, n = w.shape
    r = 4 if w.dtype == torch.int8 else 2          # consecutive k per half
    ks = 8 * r
    kp = -(-k // ks) * ks
    if n % 8:
        raise ValueError(f"N={n} must be a multiple of 8")
    if kp != k:
        w = torch.cat([w, w.new_zeros(*lead, kp - k, n)], -2)
    nl = len(lead)
    # k = ks*s + (ks/2)*h + r*q + i_r ; n = 8*t + g ; lane = 4*g + q,
    # element i = r*h + i_r
    w = w.reshape(*lead, kp // ks, 2, 4, r, n // 8, 8)
    w = w.permute(*range(nl), nl, nl + 4, nl + 5, nl + 2, nl + 1, nl + 3)
    return w.reshape(*lead, kp // ks, n // 8, 32, 2 * r).contiguous()
