"""Fused gated ResBlock: the plain versions, the autograd Functions and the
wrappers around the CUDA kernels ``csrc/resblock.cu``.

Twin of ``flowavenet_tpu/ops/pallas_resblock.py``: ``_resblock_kernel``
(:func:`fused_gated_resblock`, kernel ``resblock``) takes the conditioning
pre-activations ``cond_fg`` [B, T, 2R] (c's 1x1, the g term and both
biases); ``_resblock_kernel_v2`` (:func:`fused_gated_resblock_v2`, kernel
``resblock_v2``) takes the raw half conditioning c [B, T, Cc <=
``V2_MAX_CC``] with its weights and computes c @ w_cond in the kernel.
Both give

    fg    = cond + sum_k hpad[t + k*d] @ w_conv[k]        (fp32)
    gated = tanh(fg[:R]) * sigmoid(fg[R:])                rounded to h.dtype
    h_new = ((h + gated @ w_res + b_res) * sqrt(1/2))     rounded to h.dtype
    skip  = gated @ w_skip + b_skip                        rounded to h.dtype

with hpad = h zero-padded by d on each side, or 2d on the left when causal.
Weights are used in h.dtype, biases in fp32.  :func:`resblock_ref` and
:func:`resblock_v2_ref` compute exactly that at the same cast points.  The
Functions run the plain version for CPU tensors and launch the kernel for
CUDA tensors (or raise); their backward is the JAX package's ``_fgr_bwd`` /
``_fgr2_bwd`` line by line, plain PyTorch (the JAX package has no backward
kernel for these: its backward is XLA math).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

SQRT_HALF = math.sqrt(0.5)
# Dilations up to HALO // 2 (the Pallas kernel's window pad; the CUDA
# kernel's window is the tile plus 2d rows).
HALO = 32
# v2 takes Cc up to this width (lj22k blocks 0-5); wider conditioning or a
# global condition takes v1 (models/modules.py:_res_layer).
V2_MAX_CC = 2560
# Output rows per CTA of the CUDA kernels (before _plan_tiles).
KERNEL_T_TILE = 64

# Launches of the CUDA kernels, by name; each wrapper adds one per launch.
LAUNCHES = {"resblock": 0, "resblock_v2": 0}


def _plan_tiles(T: int, t_tile: int) -> tuple[int, int]:
    """(t_tile, T_pad): the tile rounded to 16 rows when T is short, time
    padded to a whole number of tiles (the JAX ``_plan_tiles``)."""
    if T <= 2 * t_tile:
        t_tile = -(-T // 16) * 16
    n_t = -(-T // t_tile)
    return t_tile, n_t * t_tile


def _check_dilation(dilation: int) -> None:
    if not 0 < 2 * dilation <= HALO:
        raise ValueError(f"dilation {dilation} exceeds HALO//2={HALO // 2}")


def _taps(h: torch.Tensor, w_conv: torch.Tensor, dilation: int,
          causal: bool) -> torch.Tensor:
    """fp32 sum over k of hpad[t + k*d] @ w_conv[k] of the h.dtype values
    (the JAX ``_dilated_conv_taps``)."""
    d, T = dilation, h.shape[1]
    lead = 2 * d if causal else d
    hp = F.pad(h.float(), (0, 0, lead, 2 * d - lead))
    w = w_conv.to(h.dtype).float()
    acc = None
    for k in range(3):
        o = torch.matmul(hp[:, k * d:k * d + T], w[k])
        acc = o if acc is None else acc + o
    return acc


def _epilogue(h, acc, w_res, b_res, w_skip, b_skip):
    """Gate (rounded to h.dtype), res and skip 1x1s with fp32 biases, and
    h_new = (h + res) * sqrt(1/2), both outputs rounded to h.dtype."""
    dt, r = h.dtype, w_res.shape[0]
    gated = (torch.tanh(acc[..., :r]) * torch.sigmoid(acc[..., r:])
             ).to(dt).float()
    res = torch.matmul(gated, w_res.to(dt).float()) + b_res.float()
    h_new = ((h.float() + res) * SQRT_HALF).to(dt)
    skip = (torch.matmul(gated, w_skip.to(dt).float())
            + b_skip.float()).to(dt)
    return h_new, skip


def resblock_ref(h, cond_fg, w_conv, w_res, b_res, w_skip, b_skip, *,
                 dilation: int, causal: bool):
    """Plain version of ``_resblock_kernel``: (h_new, skip).  cond_fg is
    rounded to h.dtype first, as the kernel reads it.  On the card, run it
    with TF32 off."""
    _check_dilation(dilation)
    acc = cond_fg.to(h.dtype).float() + _taps(h, w_conv, dilation, causal)
    return _epilogue(h, acc, w_res, b_res, w_skip, b_skip)


def resblock_v2_ref(h, c, w_conv, w_cond, b_all, w_res, b_res, w_skip,
                    b_skip, *, dilation: int, causal: bool):
    """Plain version of ``_resblock_kernel_v2``: the conditioning c @
    w_cond (h.dtype operands, fp32 sums) plus b_all in fp32."""
    _check_dilation(dilation)
    dt = h.dtype
    acc = (torch.matmul(c.to(dt).float(), w_cond.to(dt).float())
           + b_all.float() + _taps(h, w_conv, dilation, causal))
    return _epilogue(h, acc, w_res, b_res, w_skip, b_skip)


# ---------------------------------------------------------------------------
# Backward: the JAX package's _fgr_bwd / _fgr2_bwd
# ---------------------------------------------------------------------------

def _fgr_bwd(dilation, causal, residuals, grads):
    """Gradients of (h, cond_fg, w_conv, w_res, b_res, w_skip, b_skip) from
    a recompute of the forward (pallas_resblock.py:133-181)."""
    h, cond_fg, w_conv, w_res, w_skip = residuals
    dh_new, dskip = grads
    r = w_res.shape[0]
    f32 = torch.float32
    fg = _taps(h, w_conv, dilation, causal) + cond_fg.float()
    tf_ = torch.tanh(fg[..., :r])
    sg = torch.sigmoid(fg[..., r:])
    gated = tf_ * sg

    dres = dh_new.float() * SQRT_HALF
    dh = dres.to(h.dtype)
    dsk = dskip.float()
    dgated = (torch.matmul(dres, w_res.float().t())
              + torch.matmul(dsk, w_skip.float().t()))
    dw_res = torch.einsum("btr,btd->rd", gated, dres).to(w_res.dtype)
    db_res = dres.sum(dim=(0, 1))
    dw_skip = torch.einsum("btr,bts->rs", gated, dsk).to(w_skip.dtype)
    db_skip = dsk.sum(dim=(0, 1))

    df = dgated * sg * (1.0 - tf_ * tf_)
    dg = dgated * gated * (1.0 - sg)
    dfg = torch.cat([df, dg], dim=-1)
    dcond = dfg.to(cond_fg.dtype)

    # through the 3-tap conv: scatter back with the taps' transposes
    d, (B, T, R) = dilation, h.shape
    lead = 2 * d if causal else d
    dhp = torch.zeros(B, T + 2 * d, R, dtype=f32, device=h.device)
    hp = F.pad(h, (0, 0, lead, 2 * d - lead)).float()
    dw_conv = []
    for k in range(3):
        dhp[:, k * d:k * d + T] += torch.matmul(dfg, w_conv[k].float().t())
        dw_conv.append(torch.einsum("btc,btd->cd", hp[:, k * d:k * d + T],
                                    dfg))
    dh = dh + dhp[:, lead:lead + T].to(h.dtype)
    dw_conv = torch.stack(dw_conv).to(w_conv.dtype)
    return dh, dcond, dw_conv, dw_res, db_res, dw_skip, db_skip


def _fgr2_bwd(dilation, causal, residuals, grads):
    """v2: the conditioning pre-activations recomputed in fp32, then
    :func:`_fgr_bwd` and the 1x1's gradients (pallas_resblock.py:417-433)."""
    h, c, w_conv, w_cond, b_all, w_res, w_skip = residuals
    cond_fg = (torch.matmul(c.float(), w_cond.to(c.dtype).float())
               + b_all.float())
    dh, dcond, dw_conv, dw_res, db_res, dw_skip, db_skip = _fgr_bwd(
        dilation, causal, (h, cond_fg, w_conv, w_res, w_skip), grads)
    dcf = dcond.float()
    dc = torch.matmul(dcf, w_cond.float().t()).to(c.dtype)
    dw_cond = torch.einsum("btc,btd->cd", c.float(), dcf).to(w_cond.dtype)
    db_all = dcf.sum(dim=(0, 1))
    return dh, dc, dw_conv, dw_cond, db_all, dw_res, db_res, dw_skip, db_skip


def _like(grads, inputs):
    """Each gradient in its input's dtype."""
    return tuple(g.to(x.dtype) for g, x in zip(grads, inputs))


class _ResBlock(torch.autograd.Function):
    """``fused_gated_resblock``: kernel ``resblock`` forward (plain version
    on CPU tensors), :func:`_fgr_bwd` backward."""

    @staticmethod
    def forward(ctx, h, cond_fg, w_conv, w_res, b_res, w_skip, b_skip,
                dilation, causal):
        ctx.args = (dilation, causal)
        ctx.save_for_backward(h, cond_fg, w_conv, w_res, b_res, w_skip,
                              b_skip)
        if h.device.type == "cpu":
            return resblock_ref(h, cond_fg, w_conv, w_res, b_res, w_skip,
                                b_skip, dilation=dilation, causal=causal)
        return _launch(h, cond_fg, w_conv, None, None, w_res, b_res, w_skip,
                       b_skip, dilation=dilation, causal=causal)

    @staticmethod
    def backward(ctx, dh_new, dskip):
        h, cond_fg, w_conv, w_res, b_res, w_skip, b_skip = ctx.saved_tensors
        grads = _fgr_bwd(*ctx.args, (h, cond_fg, w_conv, w_res, w_skip),
                         (dh_new, dskip))
        return _like(grads, ctx.saved_tensors) + (None, None)


class _ResBlockV2(torch.autograd.Function):
    """``fused_gated_resblock_v2``: kernel ``resblock_v2`` forward (plain
    version on CPU tensors), :func:`_fgr2_bwd` backward."""

    @staticmethod
    def forward(ctx, h, c, w_conv, w_cond, b_all, w_res, b_res, w_skip,
                b_skip, dilation, causal):
        ctx.args = (dilation, causal)
        ctx.save_for_backward(h, c, w_conv, w_cond, b_all, w_res, b_res,
                              w_skip, b_skip)
        if h.device.type == "cpu":
            return resblock_v2_ref(h, c, w_conv, w_cond, b_all, w_res, b_res,
                                   w_skip, b_skip, dilation=dilation,
                                   causal=causal)
        return _launch(h, c, w_conv, w_cond, b_all, w_res, b_res, w_skip,
                       b_skip, dilation=dilation, causal=causal)

    @staticmethod
    def backward(ctx, dh_new, dskip):
        (h, c, w_conv, w_cond, b_all, w_res, b_res, w_skip,
         b_skip) = ctx.saved_tensors
        grads = _fgr2_bwd(*ctx.args,
                          (h, c, w_conv, w_cond, b_all, w_res, w_skip),
                          (dh_new, dskip))
        return _like(grads, ctx.saved_tensors) + (None, None)


def fused_gated_resblock(h, cond_fg, w_conv, w_res, b_res, w_skip, b_skip,
                         *, dilation: int, causal: bool):
    """One gated ResBlock from precomputed conditioning (port of
    ``_resblock_kernel``; JAX's signature without its TPU tile and
    interpret switches): h [B, T, R], cond_fg [B, T, 2R] (conditioning plus
    both conv biases), w_conv [3, R, 2R], w_res [R, R], w_skip [R, S] and
    biases.  Returns (h_new, skip); differentiable."""
    return _ResBlock.apply(h, cond_fg, w_conv, w_res, b_res, w_skip, b_skip,
                           dilation, causal)


def fused_gated_resblock_v2(h, c, w_conv, w_cond, b_all, w_res, b_res,
                            w_skip, b_skip, *, dilation: int, causal: bool):
    """v2 (port of ``_resblock_kernel_v2``): the raw half conditioning c
    [B, T, Cc], its weights w_cond [Cc, 2R] and b_all [2R] (conditioning
    plus conv biases) in place of cond_fg."""
    return _ResBlockV2.apply(h, c, w_conv, w_cond, b_all, w_res, b_res,
                             w_skip, b_skip, dilation, causal)


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library ``resblock`` with its C signatures."""
    from . import _build

    lib = _build.load("resblock")
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.resblock_threads.argtypes = []
    lib.resblock_threads.restype = c_int
    lib.resblock_smem_bytes.argtypes = [c_int] * 6
    lib.resblock_smem_bytes.restype = c_int
    lib.resblock_launch.argtypes = [c_int, c_int, c_ptr, c_ptr, c_ptr]
    lib.resblock_launch.restype = c_int
    return lib


def _launch(h, cond, w_conv, w_cond, b_all, w_res, b_res, w_skip, b_skip,
            *, dilation: int, causal: bool):
    """Check the inputs and launch ``resblock`` (``w_cond`` None: ``cond``
    is cond_fg) or ``resblock_v2`` (``cond`` is c) on the current stream.
    Weights are cast to h.dtype and biases to fp32 first, as the JAX
    wrappers do; every input is made contiguous."""
    v2 = w_cond is not None
    name = "resblock_v2" if v2 else "resblock"
    dt = h.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes fp32 or bf16, got {dt}")
    if h.dim() != 3:
        raise ValueError(f"h must be [B, T, R], got {tuple(h.shape)}")
    B, T, R = h.shape
    _check_dilation(dilation)
    lib = _library()
    threads = lib.resblock_threads()
    if threads % R:
        raise ValueError(f"{name} takes R dividing {threads}, got {R}")
    Cc = cond.shape[-1]
    want = {"cond": (B, T, Cc if v2 else 2 * R), "w_conv": (3, R, 2 * R),
            "w_res": (R, R), "b_res": (R,), "w_skip": (R, R), "b_skip": (R,)}
    if v2:
        want.update(w_cond=(Cc, 2 * R), b_all=(2 * R,))
    given = {"cond": cond, "w_conv": w_conv, "w_cond": w_cond,
             "b_all": b_all, "w_res": w_res, "b_res": b_res,
             "w_skip": w_skip, "b_skip": b_skip}
    for key, shape in want.items():
        x = given[key]
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(x.shape)}, "
                             f"expected {shape} (the kernel takes S == R)")
        if not x.is_cuda or x.device != h.device:
            raise ValueError(f"{name}: {key} must be on {h.device}")
    if not h.is_cuda:
        raise ValueError(f"{name}: h must be a CUDA tensor")
    h = h.contiguous()
    ops = [given[k].to(dt if k in ("cond", "w_conv", "w_cond", "w_res",
                                   "w_skip") else torch.float32
                       ).contiguous() if given[k] is not None else None
           for k in ("cond", "w_conv", "w_cond", "b_all", "w_res", "b_res",
                     "w_skip", "b_skip")]
    tt = _plan_tiles(T, KERNEL_T_TILE)[0]
    dcode = 0 if dt == torch.float32 else 1
    smem = lib.resblock_smem_bytes(dcode, int(v2), R, Cc, tt, dilation)
    if not 0 < smem <= 232448:
        raise ValueError(f"{name}: t_tile={tt} needs {smem} bytes of shared "
                         "memory per CTA (at most 232448)")
    h_new, skip = torch.empty_like(h), torch.empty_like(h)
    ptrs = [h, *ops, h_new, skip]
    ptr_arr = (ctypes.c_void_p * len(ptrs))(
        *[0 if x is None else x.data_ptr() for x in ptrs])
    lead = 2 * dilation if causal else dilation
    dims = (ctypes.c_int * 7)(B, T, R, Cc if v2 else 0, tt, dilation, lead)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.resblock_launch(dcode, int(v2),
                                  ctypes.cast(ptr_arr, ctypes.c_void_p),
                                  ctypes.cast(dims, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return h_new, skip


def resblock_bound_ms(B: int, T: int, R: int = 256, S: int = 256,
                      cc: int = 0, dtype=torch.bfloat16) -> tuple[float, str]:
    """Least time an H100 SXM could take for one ResBlock: the larger of the
    bytes over 3.35 TB/s (h, cond_fg or v2's c, and the weights read once;
    h_new and skip written once) and the JAX package's operation count
    (``pl.CostEstimate``, pallas_resblock.py:247-252, :375-380; ``cc`` > 0
    is v2 and adds its 1x1) over the dense peak of the storage type (989
    TFLOP/s bf16, 67 TFLOP/s fp32).  Returns (ms, "bytes" or
    "operations")."""
    es = 2 if dtype == torch.bfloat16 else 4
    ops = 2 * B * T * (R * (3 * 2 * R + R + S) + cc * 2 * R)
    act = B * T * (R + (cc if cc else 2 * R) + R + S) * es
    wts = (3 * R * 2 * R + R * R + R * S + cc * 2 * R) * es
    bias = 4 * (R + S + (2 * R if cc else 0))
    ops_s = ops / (989e12 if es == 2 else 67e12)
    mem_s = (act + wts + bias) / 3.35e12
    return (max(ops_s, mem_s) * 1e3,
            "operations" if ops_s >= mem_s else "bytes")
