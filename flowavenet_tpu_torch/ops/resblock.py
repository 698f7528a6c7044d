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

In bf16 the kernels run on the tensor cores, with w_conv, w_cond, w_res
and w_skip packed in fragment order per launch (:func:`pack_resblock_weights`)
on the hoisted pairs' wave-balanced tile; fp32 runs on CUDA cores.  Widths
an instance does not take are zero-padded in the wrapper
(:func:`resblock_widths`, :func:`pad_resblock_widths`) and the outputs cut
back, so every R the JAX kernels take runs.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .launch import (SMEM_MAX, balanced_t_tile, call, library,
                     pack_tc_weights, pad_dim, pad_halves, uses_tensor_cores)

SQRT_HALF = math.sqrt(0.5)
# Dilations up to HALO // 2 (the Pallas kernel's window pad; the CUDA
# kernel's window is the tile plus 2d rows).
HALO = 32
# v2 takes Cc up to this width (lj22k blocks 0-5); wider conditioning or a
# global condition takes v1 (models/modules.py:_res_layer).
V2_MAX_CC = 2560
# Output rows per CTA of the CUDA-core (fp32) kernels (before _plan_tiles);
# the tensor-core ones take the wave-balanced tile of _tc_tile.
KERNEL_T_TILE = 64


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

def resblock_widths(r: int, cc: int, dtype: torch.dtype,
                    threads: int = 512) -> tuple[int, int]:
    """The (R, Cc) a ResBlock of widths (r, cc) runs at on the kernel (cc:
    v2's conditioning width, 0 for v1): on the tensor cores (bf16) R up to
    a multiple of 32 and Cc up to a multiple of 16; on CUDA cores (fp32) R
    up to a divisor of ``threads`` that is a multiple of 4, Cc unchanged.
    Equal to (r, cc) on the lj22k geometry (R = 256, Cc = 80 * 2^b)."""
    if uses_tensor_cores(dtype):
        return -(-r // 32) * 32, -(-cc // 16) * 16
    fits = [w for w in range(4, threads + 1, 4)
            if threads % w == 0 and w >= r]
    if not fits:
        raise ValueError(f"the fp32 ResBlock kernels take R up to {threads}, "
                         f"got {r}")
    return fits[0], cc


def pad_resblock_widths(h, ops: dict, r: int, cc: int):
    """h and the operands of one launch (``ops``: cond, w_conv, w_cond,
    b_all, w_res, b_res, w_skip, b_skip; w_cond and b_all None for v1)
    padded to R = ``r`` channels and (v2) Cc = ``cc`` conditioning columns
    (:func:`resblock_widths`): zero h channels, c columns and cond-weight
    rows, and zero channels through every weight and bias (the filter and
    gate halves each), so a padded channel's fg is 0, its gate tanh(0) *
    sigmoid(0) = 0, and the real channels' sums are unchanged; a padded
    channel's h_new and skip are 0.  Returns (h, ops)."""
    v2 = ops["w_cond"] is not None
    pad = {"cond": (lambda x: pad_dim(x, -1, cc)) if v2
           else (lambda x: pad_halves(x, r)),
           "w_conv": lambda x: pad_halves(pad_dim(x, -2, r), r),
           "w_cond": lambda x: pad_halves(pad_dim(x, -2, cc), r),
           "b_all": lambda x: pad_halves(x, r),
           "w_res": lambda x: pad_dim(pad_dim(x, -2, r), -1, r),
           "w_skip": lambda x: pad_dim(pad_dim(x, -2, r), -1, r),
           "b_res": lambda x: pad_dim(x, -1, r),
           "b_skip": lambda x: pad_dim(x, -1, r)}
    return (pad_dim(h, -1, r).contiguous(),
            {k: None if x is None else pad[k](x).contiguous()
             for k, x in ops.items()})


# the operands the tensor-core instances take packed by pack_tc_weights
_TC_WEIGHTS = ("w_conv", "w_cond", "w_res", "w_skip")


def pack_resblock_weights(ops: dict) -> dict:
    """``ops`` with w_conv [3, R, 2R] (tap k's fragments k * R/16 * 2R/8 *
    32 on, as direct_layer_tc_bf reads layer 0), w_cond [Cc, 2R], w_res and
    w_skip [R, R] in the tensor cores' fragment order
    (``launch.pack_tc_weights``)."""
    return {k: pack_tc_weights(x) if k in _TC_WEIGHTS and x is not None
            else x for k, x in ops.items()}


@functools.lru_cache(maxsize=None)
def _tc_tile(B: int, T: int, r: int, dilation: int, n_sm: int) -> int:
    """Rows per CTA of the tensor-core ResBlocks (one CTA per (batch row,
    tile)): the hoisted pairs' rule, ``launch.balanced_t_tile(shortest=
    True)``, over the tiles whose h window and gate rows fit in shared
    memory (the launcher's ``resblock_smem_bytes``): the fewest waves of B
    * ceil(T / tile) CTAs over ``n_sm`` SMs, then the shortest tile.
    lj22k blocks 6-7 at 4 x 360 frames (T 720 and 360) take 22 and 16
    rows: 132 and 92 CTAs, where the CUDA-core kernel's 64 rows gave 48
    and 24."""
    lib = library("resblock")
    return balanced_t_tile(
        B, T, n_sm, lambda tt: 0 < lib.resblock_smem_bytes(
            1, 0, r, 0, tt, dilation) <= SMEM_MAX, shortest=True)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, copied if its data does not start on 16 bytes (the tensor-core
    instances read h in 16-byte and c in 4-byte words)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


# the launcher's operand slots after h, in order
_SLOTS = ("cond", "w_conv", "w_cond", "b_all", "w_res", "b_res", "w_skip",
          "b_skip")


def _launch(h, cond, w_conv, w_cond, b_all, w_res, b_res, w_skip, b_skip,
            *, dilation: int, causal: bool):
    """Check the inputs and launch ``resblock`` (``w_cond`` None: ``cond``
    is cond_fg) or ``resblock_v2`` (``cond`` is c) on the current stream:
    bf16 on the tensor cores, fp32 on CUDA cores.  Weights are cast to
    h.dtype and biases to fp32 first, as the JAX wrappers do; widths the
    instance does not take are zero-padded (:func:`resblock_widths`) and
    the outputs cut back to R."""
    v2 = w_cond is not None
    name = "resblock_v2" if v2 else "resblock"
    dt = h.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes fp32 or bf16, got {dt}")
    if h.dim() != 3:
        raise ValueError(f"h must be [B, T, R], got {tuple(h.shape)}")
    B, T, R = h.shape
    _check_dilation(dilation)
    lib = library("resblock")
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
    tc = uses_tensor_cores(dt)
    h = h.contiguous()
    ops = {k: None if x is None else x.to(
        dt if k in ("cond", "w_conv", "w_cond", "w_res", "w_skip")
        else torch.float32).contiguous() for k, x in given.items()}
    # widths the instance does not take run zero-padded (exact); the
    # launcher refuses them unpadded
    Rk, Cck = resblock_widths(R, Cc if v2 else 0, dt, lib.resblock_threads())
    if (Rk, Cck) != (R, Cc if v2 else 0):
        h, ops = pad_resblock_widths(h, ops, Rk, Cck)
    if tc:
        ops = pack_resblock_weights(ops)
        if not v2:          # cond_fg holds the biases
            ops["b_all"] = torch.zeros(2 * Rk, device=h.device)
        n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
        tt = _tc_tile(B, T, Rk, dilation, n_sm)
    else:
        tt = _plan_tiles(T, KERNEL_T_TILE)[0]
    h, ops["cond"] = _aligned(h), _aligned(ops["cond"])
    dcode = 0 if dt == torch.float32 else 1
    smem = lib.resblock_smem_bytes(dcode, int(v2), Rk, Cck, tt, dilation)
    if not 0 < smem <= SMEM_MAX:
        raise ValueError(f"{name}: t_tile={tt} needs {smem} bytes of shared "
                         f"memory per CTA (at most {SMEM_MAX})")
    h_new, skip = torch.empty_like(h), torch.empty_like(h)
    lead = 2 * dilation if causal else dilation
    call(lib.resblock_launch, name, (dcode, int(v2), int(tc)),
         [h, *[ops[k] for k in _SLOTS], h_new, skip],
         (B, T, Rk, Cck, tt, dilation, lead), h.device,
         {"t_tile": tt, "ctas": B * -(-T // tt)})
    if Rk != R:
        h_new, skip = h_new[..., :R].contiguous(), skip[..., :R].contiguous()
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
