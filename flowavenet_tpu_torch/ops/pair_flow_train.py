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
the backward); a CUDA tensor launches the kernels or raises.  In bf16,
``pair_fwd``, ``pair_train_fwd`` and ``pair_train_bwd`` run on the tensor
cores (``launch.uses_tensor_cores``); every fp32 instance on CUDA cores.
:func:`fused_pair_forward` is the forward pair without the statistics
(kernel ``pair_fwd``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..utils.flags import HINGE_MARGIN as _HINGE_MARGIN
from .launch import (SMEM_MAX, balanced_t_tile, call, library,
                     pack_tc_weights, uses_tensor_cores)
from .pair_flow import (_OP_NAMES, _coupling_net, _mask,
                        check_kernel_geometry, kernel_widths,
                        pad_pair_widths, pair_cost)

# Dead-zone margin of the hinge statistic (a live attribute: tests set it).
HINGE_MARGIN = _HINGE_MARGIN
FWD_HALO = 10       # rows per side of the plain version's window


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

class _RoundGrad(torch.autograd.Function):
    """Identity whose gradient is rounded to ``dtype`` and back: the cast
    points of the JAX backward (``_net_bwd`` rounds dnet, dfg and dh1 *
    sqrt(.5) to the storage type before their dots).  An identity in fp32
    and fp64."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def pair_train_fwd_ref(u, v, c_a, c_b, operands, *, stats: bool = True):
    """Plain version of the forward pair over the whole sequence, with the
    kernels' cast points (h0, h1, gate outputs, relu'd skip sum and final
    1x1 output rounded to u.dtype; the zero conv, the affine updates and
    the statistics in fp32).  Differentiable: autograd through it is the
    plain version of the backward, whose every product operand is in
    u.dtype as in the JAX backward (autograd rounds the cotangent of each
    rounded activation; :class:`_RoundGrad` rounds dnet, each layer's dfg
    before its bias and the cotangent of h1's residual sum).  On the card,
    run it with TF32 off.

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

    def rg(x):
        return _RoundGrad.apply(x, dt)

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
                        p0=p0 + 5, T=T, w=flow_w(0), rnd=rnd, int8=False,
                        rg=rg)
    ls1, t1 = net[..., :r_in], net[..., r_in:]
    v3 = ((v0[:, 5:L - 5] - t1) * torch.exp(-ls1) + an_b[1, 0]) * an_s[1, 0]
    u2 = (u0[:, 5:L - 5] + an_b[1, 1]) * an_s[1, 1]
    v3m = _mask(rnd(v3), p0 + 5, T)
    net2 = _coupling_net(v3m, cbw, x_off=5, c_off=10, out_len=L - 20,
                         p0=p0 + 10, T=T, w=flow_w(1), rnd=rnd, int8=False,
                         rg=rg)
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

# the three kernels of csrc/pair_flow_train.cu
TRAIN_KERNELS = ("pair_fwd", "pair_train_fwd", "pair_train_bwd")


def train_t_tile(B: int, T: int, n_sm: int) -> int:
    """Rows per tile of the CUDA-core instances: the largest power of two
    in [32, 256] that still gives at least one tile per SM, so the
    persistent grid fills the card."""
    tt = 256
    while tt > 32 and B * -(-T // tt) < n_sm:
        tt //= 2
    return tt


@functools.lru_cache(maxsize=None)
def train_tc_t_tile(B: int, T: int, r: int, r_in: int, backward: bool,
                    n_sm: int) -> int:
    """``launch.balanced_t_tile`` over the tiles whose window (the tile
    plus 10 rows per side forward, 20 backward) fits in one CTA's shared
    memory; the forward takes the shortest tile of the fewest waves."""
    lib = library("pair_flow_train")
    return balanced_t_tile(
        B, T, n_sm, lambda tt: 0 < lib.pair_train_smem_bytes(
            int(backward), 1, r, r_in, tt) <= SMEM_MAX,
        shortest=not backward)


def _geometry(u, tc: bool, r: int, backward: bool):
    """(t_tile, CTAs, tiles) for a launch over u [B, T, R_in]: the
    tensor-core forward runs one CTA per tile, every other instance a
    persistent grid of at most one CTA per SM."""
    B, T, r_in = u.shape
    n_sm = torch.cuda.get_device_properties(u.device).multi_processor_count
    tt = (train_tc_t_tile(B, T, r, r_in, backward, n_sm) if tc
          else train_t_tile(B, T, n_sm))
    n_tiles = B * -(-T // tt)
    if tc and not backward:
        return tt, n_tiles, n_tiles
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


# folded operands the tensor-core instances take packed in fragment order
# (slots of pair_forward_operands: kfg, cond_w, res_w, skip_w, fin_w)
_TC_SLOTS = (2, 3, 5, 7, 9)


def _pad_tc(c_a, c_b, ops, R: int, Cc: int):
    """(c_a, c_b, ops, R, Cc) at the widths the tensor-core instances take
    (``pair_flow.kernel_widths``): zero c columns and zero channels through
    every weight (``pair_flow.pad_pair_widths``), so the real channels'
    outputs are unchanged and the padded ones carry zero gradients; the
    lj22k widths are never padded."""
    Rk, Cck = kernel_widths(R, Cc, True)
    if (Rk, Cck) == (R, Cc):
        return c_a, c_b, ops, R, Cc
    c_a, c_b, ops = pad_pair_widths(c_a, c_b, ops, Rk, Cck)
    return c_a, c_b, [o.contiguous() for o in ops], Rk, Cck


# operands whose last axis is [filter R | gate R] (launch.pad_halves)
_HALVES = ("kfg", "cond_w", "cond_b")


def _unpad_grad(g, shape, name: str):
    """The gradient ``g`` of an operand padded by :func:`_pad_tc`, cut back
    to the operand's ``shape``."""
    if name in _HALVES and g.shape[-1] != shape[-1]:
        n, half = shape[-1] // 2, g.shape[-1] // 2
        g = torch.cat([g[..., :n], g[..., half:half + n]], -1)
    return g[tuple(slice(0, n) for n in shape)].contiguous()


def _tc_operands(ops, transposed: bool = True):
    """The 15 operands with kfg, cond_w, res_w, skip_w and fin_w packed
    for the shared forward body (pack_tc_weights), and (``transposed``,
    else an empty list) the transposed weights the backward's
    input-gradient products take (pack_tc_weights of W^T: [.., N, K]
    packed as K = N rows)."""
    fwd = [pack_tc_weights(o) if i in _TC_SLOTS else o
           for i, o in enumerate(ops)]
    bwd = ([pack_tc_weights(ops[i].transpose(-1, -2)) for i in _TC_SLOTS]
           if transposed else [])
    return fwd, bwd


def launch_forward(u, v, c_a, c_b, operands, *, stats: bool):
    """Launch ``pair_train_fwd`` (``stats``) or ``pair_fwd``.  Returns
    (u3, v3, raw) or (u3, v3, raw, max, sumsq, hinge) as 0-d fp32 tensors
    on the device (no host sync)."""
    lib = library("pair_flow_train")
    ops, R, Cc = _check(u, v, c_a, c_b, operands)
    B, T, r_in = u.shape
    dt = u.dtype
    name = "pair_train_fwd" if stats else "pair_fwd"
    tc = uses_tensor_cores(dt)
    if tc:
        c_a, c_b, ops, R, Cc = _pad_tc(c_a, c_b, ops, R, Cc)
        check_kernel_geometry(R, Cc, True)
        ops, _ = _tc_operands(ops, transposed=False)
    tt, G, n_tiles = _geometry(u, tc, R, False)
    ws = torch.empty(lib.pair_train_ws_bytes(0, int(tc), R, r_in, Cc, tt)
                     // 4 * G, dtype=torch.float32, device=u.device)
    st = torch.empty(n_tiles, 4, dtype=torch.float32, device=u.device)
    u_out, v_out = torch.empty_like(u), torch.empty_like(v)
    call(lib.pair_train_fwd_launch, name,
         (0 if dt == torch.float32 else 1, int(stats), int(tc)),
         [u, v, c_a, c_b, u_out, v_out, st, ws, *ops],
         (B, T, r_in, R, Cc, tt, G), u.device,
         {"t_tile": tt, "ctas": G, "workspace_bytes": 4 * ws.numel()},
         float(HINGE_MARGIN))
    raw = st[:, 0].sum()
    if not stats:
        return u_out, v_out, raw
    return u_out, v_out, raw, st[:, 1].max(), st[:, 2].sum(), st[:, 3].sum()


def launch_backward(u, v, c_a, c_b, gu, gv, gr, gq, gh, operands):
    """Launch ``pair_train_bwd`` (the main kernel plus the launch that sums
    its per-CTA gradient slabs).  Returns (d_operands, du, dv, dc_a, dc_b);
    d_operands in fp32, shaped as the operands."""
    lib = library("pair_flow_train")
    gu, gv = gu.to(u.dtype).contiguous(), gv.to(u.dtype).contiguous()
    ops, R, Cc = _check(u, v, c_a, c_b, operands,
                        extra=(("gu", gu), ("gv", gv)))
    B, T, r_in = u.shape
    dt = u.dtype
    tc = uses_tensor_cores(dt)
    shapes = [o.shape for o in ops]
    cc0, extra = Cc, []
    if tc:
        c_a, c_b, ops, R, Cc = _pad_tc(c_a, c_b, ops, R, Cc)
        check_kernel_geometry(R, Cc, True)
    padded = [o.shape for o in ops]
    if tc:
        ops, extra = _tc_operands(ops)
    tt, G, _ = _geometry(u, tc, R, True)
    ws = torch.empty(lib.pair_train_ws_bytes(1, int(tc), R, r_in, Cc, tt)
                     // 4 * G, dtype=torch.float32, device=u.device)
    n_grad = lib.pair_train_grad_floats(R, r_in, Cc)
    slab = torch.empty(G * n_grad, dtype=torch.float32, device=u.device)
    d_flat = torch.empty(n_grad, dtype=torch.float32, device=u.device)
    gsc = torch.stack([torch.as_tensor(g, device=u.device).reshape(())
                       .float() for g in (gr, gq, gh)])
    du, dv = torch.empty_like(u), torch.empty_like(v)
    dca, dcb = torch.empty_like(c_a), torch.empty_like(c_b)
    call(lib.pair_train_bwd_launch, "pair_train_bwd",
         (0 if dt == torch.float32 else 1, int(tc)),
         [u, v, c_a, c_b, gu, gv, du, dv, dca, dcb, gsc, ws, slab, d_flat,
          *ops, *extra],
         (B, T, r_in, R, Cc, tt, G), u.device,
         {"t_tile": tt, "ctas": G, "workspace_bytes": 4 * ws.numel(),
          "slab_bytes": 4 * slab.numel()}, float(HINGE_MARGIN))
    d_ops, off = [], 0
    for name, shp, pshp in zip(_OP_NAMES + ("an_s", "an_b"), shapes,
                               padded):
        n = pshp.numel()
        d = d_flat[off:off + n].view(pshp)
        d_ops.append(d if pshp == shp else _unpad_grad(d, shp, name))
        off += n
    if Cc != cc0:
        dca, dcb = (d[..., :cc0].contiguous() for d in (dca, dcb))
    return tuple(d_ops), du, dv, dca, dcb


def fused_pair_forward(u, v, c_a, c_b, operands):
    """Apply one FORWARD flow pair (twin of the JAX ``fused_pair_forward``,
    the port of ``_pair_kernel_fw``).  u, v: [B, T, R_in]; c_*: [B, T, Cc];
    ``operands`` from ``pair_flow.pair_forward_operands``.  Returns (u', v',
    raw) where raw is the fp32 sum of -log_s over both couplings.

    A CPU tensor runs the plain version (:func:`pair_train_fwd_ref` without
    the extra statistics); a CUDA tensor launches ``pair_fwd`` (or raises).
    No gradient: the model's autograd.Function recomputes the plain pair
    for that."""
    if u.device.type == "cpu":
        return pair_train_fwd_ref(u, v, c_a, c_b, operands, stats=False)
    return launch_forward(u, v, c_a, c_b, operands, stats=False)


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
