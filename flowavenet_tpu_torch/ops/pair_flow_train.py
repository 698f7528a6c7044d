"""Forward and training flow pairs: the plain PyTorch version, the wrappers
around the CUDA kernels ``csrc/pair_flow_train.cu`` and the
``autograd.Function`` of the training route.

Twin of ``flowavenet_tpu/ops/pallas_flow_train.py`` (``_pair_kernel_fws``
through ``fused_pair_train_fwd``, ``_pair_kernel_bwd`` through
``fused_pair_train_bwd``) and of ``_pair_kernel_fw`` in
``flowavenet_tpu/ops/pallas_flow.py``.  One forward pair applies

    u0 = (u + b)*s ; v0 = (v + b)*s                    ActNorm (even)
    v2 = (v0 - t(u0; even)) * exp(-log_s(u0; even))   coupling (even)
    v3 = (v2 + b)*s ; u2 = (u0 + b)*s                  ActNorm (odd)
    u3 = (u2 - t(v3; odd)) * exp(-log_s(v3; odd))     coupling (odd)

and returns (u3, v3, raw) with raw = sum of -log_s over both couplings,
plus on the training pair max|log_s|, sum log_s^2 and
sum relu(|log_s| - HINGE_MARGIN)^2.  The VJP boundary sits at the folded
operands (``pair_flow.pair_forward_operands``), as in the JAX package, so
autograd differentiates weight norm, exp(3*scale) and the ActNorm folding
outside the kernel; the cotangent of max|log_s| is dropped.

A CPU tensor runs :func:`pair_train_fwd_ref` (and autograd through it for
the backward); a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.flags import HINGE_MARGIN as _HINGE_MARGIN
from .pair_flow import _OP_NAMES, LAUNCHES, _coupling_net, _mask, pair_cost

# Dead-zone margin of the hinge statistic (a live attribute: tests set it).
HINGE_MARGIN = _HINGE_MARGIN
FWD_HALO = 10       # rows per side of the plain version's window


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def pair_train_fwd_ref(u, v, c_a, c_b, operands, *, stats: bool = True):
    """Plain version of the forward pair over the whole sequence, with the
    kernels' cast points (h0, h1, gate outputs, relu'd skip sum and final
    1x1 output rounded to u.dtype; the zero conv, the affine updates and
    the statistics in fp32).  Differentiable: autograd through it is the
    plain version of the backward.  On the card, run it with TF32 off.

    Returns (u3, v3, raw) or, with ``stats``, (u3, v3, raw, max|log_s|,
    sum log_s^2, hinge sum)."""
    B, T, r_in = u.shape
    dt = u.dtype
    # fp64 inputs run the whole pair in fp64 (a reference for the fp32
    # kernel's summation error); every other type computes in fp32
    wt = torch.float64 if dt == torch.float64 else torch.float32
    h = FWD_HALO
    L = T + 2 * h

    def rnd(x):
        return x.to(dt).to(wt)

    def pad(x):
        return F.pad(x.to(wt), (0, 0, h, h))

    uw, vw, caw, cbw = pad(u), pad(v), pad(c_a), pad(c_b)
    p0 = torch.full((B,), -h, dtype=torch.long, device=u.device)

    def flow_w(fi):
        return {name: operands[i][fi].to(wt)
                for i, name in enumerate(_OP_NAMES)}

    an_s, an_b = operands[13].to(wt), operands[14].to(wt)
    u0 = _mask(rnd((uw + an_b[0, 0]) * an_s[0, 0]), p0, T)
    v0 = (vw + an_b[0, 1]) * an_s[0, 1]
    net = _coupling_net(u0, caw, x_off=5, c_off=5, out_len=L - 10,
                        p0=p0 + 5, T=T, w=flow_w(0), rnd=rnd, int8=False)
    ls1, t1 = net[..., :r_in], net[..., r_in:]
    v3 = ((v0[:, 5:L - 5] - t1) * torch.exp(-ls1) + an_b[1, 0]) * an_s[1, 0]
    u2 = (u0[:, 5:L - 5] + an_b[1, 1]) * an_s[1, 1]
    v3m = _mask(rnd(v3), p0 + 5, T)
    net2 = _coupling_net(v3m, cbw, x_off=5, c_off=10, out_len=L - 20,
                         p0=p0 + 10, T=T, w=flow_w(1), rnd=rnd, int8=False)
    ls2, t2 = net2[..., :r_in], net2[..., r_in:]
    u3 = (u2[:, 5:5 + T] - t2) * torch.exp(-ls2)
    ls1 = ls1[:, 5:5 + T]
    raw = -(ls1.sum() + ls2.sum())
    outs = (u3.to(dt), v3[:, 5:5 + T].to(dt), raw)
    if not stats:
        return outs
    mx = torch.maximum(ls1.detach().abs().max(), ls2.detach().abs().max())
    sq = (ls1 * ls1).sum() + (ls2 * ls2).sum()
    e1 = torch.relu(ls1.abs() - HINGE_MARGIN)
    e2 = torch.relu(ls2.abs() - HINGE_MARGIN)
    hq = (e1 * e1).sum() + (e2 * e2).sum()
    return outs + (mx, sq, hq)


def pair_train_bwd_ref(u, v, c_a, c_b, gu, gv, gr, gq, gh, operands):
    """Plain version of the backward: autograd through
    :func:`pair_train_fwd_ref` (recomputed, as the kernel recomputes the
    pair).  Returns (d_operands, du, dv, dc_a, dc_b)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (u, v, c_a, c_b,
                                                         *operands)]
        u3, v3, raw, _mx, sq, hq = pair_train_fwd_ref(*leaves[:4],
                                                      leaves[4:])
        grads = torch.autograd.grad(
            (u3, v3, raw, sq, hq), leaves,
            (gu, gv, gr.reshape(()), gq.reshape(()), gh.reshape(())),
            allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    return tuple(grads[4:]), grads[0], grads[1], grads[2], grads[3]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, with every C signature declared."""
    from . import _build

    lib = _build.load("pair_flow_train")
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.pair_train_ws_floats.argtypes = [c_int] * 5
    lib.pair_train_ws_floats.restype = c_ll
    lib.pair_train_grad_floats.argtypes = [c_int] * 3
    lib.pair_train_grad_floats.restype = c_ll
    lib.pair_train_fwd_launch.argtypes = [c_int, c_int, c_ptr, c_ptr,
                                          ctypes.c_float, c_ptr]
    lib.pair_train_fwd_launch.restype = c_int
    lib.pair_train_bwd_launch.argtypes = [c_int, c_ptr, c_ptr,
                                          ctypes.c_float, c_ptr]
    lib.pair_train_bwd_launch.restype = c_int
    return lib


def train_t_tile(B: int, T: int, n_sm: int) -> int:
    """Rows per tile: the largest power of two in [32, 256] that still
    gives at least one tile per SM, so the persistent grid fills the
    card."""
    tt = 256
    while tt > 32 and B * -(-T // tt) < n_sm:
        tt //= 2
    return tt


def _geometry(u):
    """(t_tile, CTAs, tiles) for a launch over u [B, T, R_in]."""
    B, T, _ = u.shape
    n_sm = torch.cuda.get_device_properties(u.device).multi_processor_count
    tt = train_t_tile(B, T, n_sm)
    n_tiles = B * -(-T // tt)
    return tt, min(n_tiles, n_sm), n_tiles


def _check(u, v, c_a, c_b, operands, extra=()):
    B, T, r_in = u.shape
    dt = u.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pair kernels take fp32 or bf16, got {dt}")
    if len(operands) != 15:
        raise ValueError(f"expected 15 operands, got {len(operands)}")
    R = operands[5].shape[-1]
    Cc = c_a.shape[-1]
    for name, x in (("u", u), ("v", v), ("c_a", c_a), ("c_b", c_b),
                    *extra):
        if not (x.is_cuda and x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
        if x.dtype != dt:
            raise TypeError(f"{name} is {x.dtype}, expected {dt}")
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, not {u.device}")
    if (v.shape != u.shape or c_a.shape != (B, T, Cc)
            or c_b.shape != c_a.shape):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)}, c {tuple(c_a.shape)}, "
                         f"{tuple(c_b.shape)}")
    R2 = 2 * R
    want = [(2, 3, r_in, R), (2, R), (2, 2, 3, R, R2), (2, 2, Cc, R2),
            (2, 2, R2), (2, R, R), (2, R), (2, 2, R, R), (2, 2, R),
            (2, R, R), (2, R), (2, R, 2 * r_in), (2, 2 * r_in),
            (2, 2, r_in), (2, 2, r_in)]
    ops = []
    for i, (o, shp) in enumerate(zip(operands, want)):
        if tuple(o.shape) != shp:
            raise ValueError(f"operand {i} has shape {tuple(o.shape)}, "
                             f"expected {shp}")
        if o.device != u.device:
            raise ValueError(f"operand {i} is on {o.device}, not {u.device}")
        w_dt = dt if i in (0, 2, 3, 5, 7, 9, 11) else torch.float32
        if o.dtype != w_dt:
            raise TypeError(f"operand {i} is {o.dtype}, expected {w_dt}")
        ops.append(o.contiguous())
    return ops, R, Cc


def _run(fn, name: str, *args):
    with torch.cuda.device(args[-1]):
        stream = torch.cuda.current_stream(args[-1]).cuda_stream
        err = fn(*args[:-1], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def launch_forward(u, v, c_a, c_b, operands, *, stats: bool):
    """Launch ``pair_train_fwd`` (``stats``) or ``pair_fwd``.  Returns
    (u3, v3, raw) or (u3, v3, raw, max, sumsq, hinge) as 0-d fp32 tensors
    on the device (no host sync)."""
    lib = _library()
    ops, R, Cc = _check(u, v, c_a, c_b, operands)
    B, T, r_in = u.shape
    dt = u.dtype
    tt, G, n_tiles = _geometry(u)
    ws = torch.empty(G * lib.pair_train_ws_floats(0, R, r_in, Cc, tt),
                     dtype=torch.float32, device=u.device)
    st = torch.empty(n_tiles, 4, dtype=torch.float32, device=u.device)
    u_out, v_out = torch.empty_like(u), torch.empty_like(v)
    ptrs = [u, v, c_a, c_b, u_out, v_out, st, ws, *ops]
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*[x.data_ptr() for x in ptrs])
    dims = (ctypes.c_int * 7)(B, T, r_in, R, Cc, tt, G)
    _run(lib.pair_train_fwd_launch, "pair_train_fwd" if stats else "pair_fwd",
         0 if dt == torch.float32 else 1, int(stats),
         ctypes.cast(ptr_arr, ctypes.c_void_p),
         ctypes.cast(dims, ctypes.c_void_p), float(HINGE_MARGIN), u.device)
    LAUNCHES["pair_train_fwd" if stats else "pair_fwd"] += 1
    raw = st[:, 0].sum()
    if not stats:
        return u_out, v_out, raw
    return u_out, v_out, raw, st[:, 1].max(), st[:, 2].sum(), st[:, 3].sum()


def launch_backward(u, v, c_a, c_b, gu, gv, gr, gq, gh, operands):
    """Launch ``pair_train_bwd`` (the main kernel plus the launch that sums
    its per-CTA gradient slabs).  Returns (d_operands, du, dv, dc_a, dc_b);
    d_operands in fp32, shaped as the operands."""
    lib = _library()
    gu, gv = gu.to(u.dtype).contiguous(), gv.to(u.dtype).contiguous()
    ops, R, Cc = _check(u, v, c_a, c_b, operands,
                        extra=(("gu", gu), ("gv", gv)))
    B, T, r_in = u.shape
    dt = u.dtype
    tt, G, _ = _geometry(u)
    ws = torch.empty(G * lib.pair_train_ws_floats(1, R, r_in, Cc, tt),
                     dtype=torch.float32, device=u.device)
    n_grad = lib.pair_train_grad_floats(R, r_in, Cc)
    slab = torch.empty(G * n_grad, dtype=torch.float32, device=u.device)
    d_flat = torch.empty(n_grad, dtype=torch.float32, device=u.device)
    gsc = torch.stack([torch.as_tensor(g, device=u.device).reshape(())
                       .float() for g in (gr, gq, gh)])
    du, dv = torch.empty_like(u), torch.empty_like(v)
    dca, dcb = torch.empty_like(c_a), torch.empty_like(c_b)
    ptrs = [u, v, c_a, c_b, gu, gv, du, dv, dca, dcb, gsc, ws, slab, d_flat,
            *ops]
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*[x.data_ptr() for x in ptrs])
    dims = (ctypes.c_int * 7)(B, T, r_in, R, Cc, tt, G)
    _run(lib.pair_train_bwd_launch, "pair_train_bwd",
         0 if dt == torch.float32 else 1,
         ctypes.cast(ptr_arr, ctypes.c_void_p),
         ctypes.cast(dims, ctypes.c_void_p), float(HINGE_MARGIN), u.device)
    LAUNCHES["pair_train_bwd"] += 1
    d_ops, off = [], 0
    for o in ops:
        n = o.numel()
        d_ops.append(d_flat[off:off + n].view(o.shape))
        off += n
    return tuple(d_ops), du, dv, dca, dcb


def fused_pair_train_fwd(u, v, c_a, c_b, operands):
    """Primal of the training pair (port of ``_pair_kernel_fws``): (u3, v3,
    raw, max|log_s|, sum log_s^2, hinge sum), the statistics fp32 over the
    valid rows.  CPU: the plain version; CUDA: the kernel."""
    if u.device.type == "cpu":
        with torch.no_grad():
            return pair_train_fwd_ref(u, v, c_a, c_b, operands)
    return launch_forward(u, v, c_a, c_b, operands, stats=True)


def fused_pair_train_bwd(u, v, c_a, c_b, gu, gv, gr, gq, gh, operands):
    """Backward of the training pair (port of ``_pair_kernel_bwd``):
    (d_operands, du, dv, dc_a, dc_b).  CPU: autograd through the plain
    version; CUDA: the kernel."""
    if u.device.type == "cpu":
        return pair_train_bwd_ref(u, v, c_a, c_b, gu, gv, torch.as_tensor(gr),
                                  torch.as_tensor(gq), torch.as_tensor(gh),
                                  operands)
    return launch_backward(u, v, c_a, c_b, gu, gv, gr, gq, gh, operands)


class PairTrain(torch.autograd.Function):
    """The training route's pair: forward ``fused_pair_train_fwd``,
    backward ``fused_pair_train_bwd`` from input-only residuals (the
    recompute is the remat policy).  Call as
    ``PairTrain.apply(u, v, c_a, c_b, *operands)``."""

    @staticmethod
    def forward(ctx, u, v, c_a, c_b, *operands):
        ctx.save_for_backward(u, v, c_a, c_b, *operands)
        out = fused_pair_train_fwd(u, v, c_a, c_b, operands)
        ctx.mark_non_differentiable(out[3])
        return out

    @staticmethod
    def backward(ctx, gu, gv, gr, _gmx, gq, gh):
        u, v, c_a, c_b, *ops = ctx.saved_tensors
        d_ops, du, dv, dca, dcb = fused_pair_train_bwd(
            u, v, c_a, c_b, gu, gv, gr, gq, gh, ops)
        return (du, dv, dca, dcb, *d_ops)


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------

def train_pair_cost(B: int, T: int, r_in: int, cc: int, r: int = 256,
                    backward: bool = False) -> dict:
    """Work of one training pair over [B, T] rows.  Forward: the operations
    of ``pair_flow.pair_cost`` (two coupling nets); bytes: u, v, c read
    once, u', v' written once, one pair's bf16 weights.  Backward: the
    forward recompute plus the input-gradient products plus the
    weight-gradient products, each the size of the forward's, so 3x the
    forward operations (JAX's own estimate, pallas_flow_train.py:734-736);
    bytes: u, v, c, du', dv' read, du, dv, dc written, the weights read
    and their fp32 gradients written."""
    c = pair_cost(B, T, r_in, cc, r)
    ops = c["fg_cond_ops"] + c["other_ops"]
    if not backward:
        return {"ops": ops, "bytes": c["bytes"]}
    es = 2
    w_el = 2 * (2 * 3 * r * 2 * r + 2 * cc * 2 * r + 3 * r_in * r
                + 3 * r * r + r * 2 * r_in)
    byts = (2 * B * T * cc * es * 2 + 8 * B * T * r_in * es
            + w_el * (es + 4))
    return {"ops": 3 * ops, "bytes": byts}


def train_pair_bound_ms(B: int, T: int, r_in: int, cc: int, r: int = 256,
                        backward: bool = False) -> tuple[float, str]:
    """Least time an H100 SXM could take for one bf16 training pair
    (forward or backward): the larger of bytes over 3.35 TB/s and
    operations over 989 TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    c = train_pair_cost(B, T, r_in, cc, r, backward)
    ops_s, mem_s = c["ops"] / 989e12, c["bytes"] / 3.35e12
    return (max(ops_s, mem_s) * 1e3,
            "operations" if ops_s >= mem_s else "bytes")
