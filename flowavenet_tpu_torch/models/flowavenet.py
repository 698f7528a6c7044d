"""FloWaveNet in PyTorch (twin of ``flowavenet_tpu/models/flowavenet.py``):
``init_flowavenet``, one-shot synthesis (``reverse``) and the likelihood
side (``forward``, ``ddi``, ``loss_fn``).

Parameters are the JAX package's tree (nested dicts and lists), with
torch tensors as leaves and the flow axis of each block stacked first.

Scope: affine couplings, non-causal convs, n_layer == 2, even n_flow, no
global conditioning, logs_clamp == 0 — the lj22k path.  Anything else
raises ``NotImplementedError`` naming the JAX code path it would need.

Synthesis routes, per block, as the JAX package's ``_pair_kernel_mode``
picks them (``ops/pair_flow.py`` holds the pairs):
* ``cfg.use_pallas=False``: the plain pair-scan on every block.
* ``int8`` (``FWN_INT8`` on, the default; cc_half <= 1280 unless
  ``FWN_MAX_CC``): the fused pair with int8 fg convs and conditioning
  (``FWN_INT8_RS=1``: also int8 res/skip);
* ``wino`` / ``wino4`` (``FWN_WINO``, on; cc_half <= ``FWN_WINO_MAX_CC``,
  320, where int8 does not route): the Winograd F(2,3) / F(4,3) pair;
* ``direct`` (cc_half <= 640 unless ``FWN_MAX_CC``): the fused pair in the
  compute dtype;
* ``hoisted`` (``FWN_HOISTED=1``, wider blocks): one matmul per c half for
  all pairs' conditioning, then the hoisted-conditioning pair (int8 fg
  convs with ``FWN_INT8``);
* otherwise the plain pair-scan, with int8 conditioning 1x1s on the int8
  route.

Forward (likelihood) routes, per block, in this order:
* ``FWN_TRAIN_KERNEL=1`` and cc_half <= ``FWN_TRAIN_MAX_CC`` (80): the
  training pair (``ops/pair_flow_train.py``, kernels ``pair_train_fwd`` and
  ``pair_train_bwd``) with exact log_s statistics;
* ``FWN_FWD_KERNEL=1`` and cc_half <= ``FWN_FWD_MAX_CC`` (640): the forward
  pair (``pair_fwd``), whose backward recomputes the plain pair; its
  blocks report zero log_s statistics;
* otherwise the plain pair-scan, under ``torch.utils.checkpoint`` when
  ``cfg.remat``/``cfg.remat_blocks`` ask for it.
Both kernel routes need ``cfg.use_pallas``; on CPU tensors they run the
kernels' plain versions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops import pair_flow as pf
from ..ops import pair_flow_train as pft
from ..ops.conv import quantize_act
from ..ops.squeeze import (change_order, squeeze, squeeze_level_cond_perm,
                           squeeze_to_level, unsqueeze)
from ..utils import flags as _flags
from ..utils.device import constant
from ..utils.tree import leaves, rebuild, tree_map
from .modules import apply_wavenet, init_wavenet
from .upsample import apply_upsample, init_upsample

LOG_2PI = math.log(2.0 * math.pi)

# Live routing switches (tests flip them at runtime, as in the JAX
# package).
PAIR_KERNEL_INT8 = _flags.INT8
PAIR_KERNEL_WINO = _flags.WINO
PAIR_KERNEL_WINO4 = _flags.WINO4
PAIR_KERNEL_WINO_MAX_CC = _flags.WINO_MAX_CC
PAIR_KERNEL_MAX_CC = _flags.MAX_CC or None
PAIR_KERNEL_HOISTED = _flags.HOISTED
INT8_RS = _flags.INT8_RS
TRAIN_KERNEL = _flags.TRAIN_KERNEL
TRAIN_KERNEL_MAX_CC = _flags.TRAIN_MAX_CC
PAIR_KERNEL_FWD = _flags.FWD_KERNEL
PAIR_KERNEL_FWD_MAX_CC = _flags.FWD_MAX_CC
# Dead-zone margin of the log_s hinge (TrainConfig.logs_hinge).
LOGS_HINGE_MARGIN = _flags.HINGE_MARGIN


def _pair_max_cc() -> int:
    """Conditioning-width bound of the fused pair routes: FWN_MAX_CC when
    set, else 1280 int8 and 640 otherwise (the JAX package's
    ``_pair_max_cc``)."""
    if PAIR_KERNEL_MAX_CC is not None:
        return PAIR_KERNEL_MAX_CC
    return 1280 if PAIR_KERNEL_INT8 else 640


def init_actnorm(channels: int, device=None) -> dict:
    return {"b": torch.zeros(1, 1, channels, device=device),
            "logs": torch.zeros(1, 1, channels, device=device)}


def init_block(gen: torch.Generator, in_channels: int, cin_channels: int,
               cfg: ModelConfig) -> dict:
    """Stacked params for one block (channel counts after its squeeze)."""
    sq, sq_c = 2 * in_channels, 2 * cin_channels
    out_ch = sq if cfg.affine else sq // 2
    flows = [{"actnorm": init_actnorm(sq, gen.device),
              "coupling": init_wavenet(
                  gen, in_channels=sq // 2, out_channels=out_ch,
                  num_layers=cfg.n_layer, residual_channels=cfg.filter_size,
                  cin_channels=sq_c // 2)}
             for _ in range(cfg.n_flow)]
    return {"flows": tree_map(lambda *xs: torch.stack(xs), *flows)}


def init_flowavenet(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Fresh fp32 params on ``gen.device``.  The same tree as the JAX
    package's init (the numbers differ: torch and JAX draw differently)."""
    if cfg.gin_channels > 0:
        raise NotImplementedError(
            "global conditioning is not ported yet "
            "(flowavenet_tpu/models/flowavenet.py:init_flowavenet, "
            "speaker_emb)")
    params: dict = {"upsample": init_upsample(gen, cfg.upsample_scales)}
    blocks = []
    in_ch, cin_ch = 1, cfg.num_mels
    for _ in range(cfg.n_block):
        blocks.append(init_block(gen, in_ch, cin_ch, cfg))
        in_ch, cin_ch = in_ch * 2, cin_ch * 2
    params["blocks"] = blocks
    return params


def actnorm_forward(p: dict, x: torch.Tensor):
    """x -> (x + b) * exp(3*logs); logdet = mean(3*logs)."""
    logs3 = p["logs"].float() * 3.0
    out = (x + p["b"].to(x.dtype)) * torch.exp(logs3).to(x.dtype)
    return out, logs3.mean()


def actnorm_ddi(x: torch.Tensor) -> dict:
    """Data-dependent init from one batch: b = -mean(x),
    logs = log(1/(std+1e-7))/3, statistics over (batch, time)."""
    xf = x.float()
    mean = xf.mean(dim=(0, 1), keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=(0, 1), keepdim=True)
    logs = torch.log(1.0 / (torch.sqrt(var) + 1e-7)) / 3.0
    return {"b": -mean, "logs": logs}


def _log_s_stats(log_s: torch.Tensor):
    """(max |log_s|, sum log_s^2, sum relu(|log_s| - margin)^2) in fp32."""
    ls = log_s.float()
    excess = torch.relu(ls.abs() - LOGS_HINGE_MARGIN)
    return ls.abs().max(), (ls * ls).sum(), (excess * excess).sum()


def coupling_forward(p: dict, x: torch.Tensor, c: torch.Tensor,
                     stats: bool = False):
    """Affine coupling, forward: the second half of x becomes
    (x_b - t) * exp(-log_s) with (log_s, t) = net(x_a, c_a)."""
    in_a, in_b = torch.chunk(x, 2, dim=2)
    c_a = torch.chunk(c, 2, dim=2)[0]
    log_s, t = torch.chunk(apply_wavenet(p, in_a, c_a), 2, dim=2)
    out_b = (in_b - t) * torch.exp(-log_s)
    logdet = (-log_s.float()).mean() / 2.0
    out = torch.cat([in_a, out_b], dim=2)
    if stats:
        return out, logdet, _log_s_stats(log_s)
    return out, logdet


def _an_half(fp_an: dict, half: int, x: torch.Tensor) -> torch.Tensor:
    """Apply one channel-half of an ActNorm (forward)."""
    C2 = x.shape[-1]
    sl = slice(0, C2) if half == 0 else slice(C2, 2 * C2)
    b = fp_an["b"][..., sl].to(x.dtype)
    logs3 = fp_an["logs"][..., sl].float() * 3.0
    return (x + b) * torch.exp(logs3).to(x.dtype)


def _couple_halves_fwd(fp: dict, u, v, c_half):
    """Forward affine coupling of v given net(u): (v', logdet, stats)."""
    log_s, t = torch.chunk(apply_wavenet(fp, u, c_half), 2, dim=2)
    out = (v - t) * torch.exp(-log_s)
    return out, (-log_s.float()).mean() / 2.0, _log_s_stats(log_s)


def _an_logdet(fp_an: dict) -> torch.Tensor:
    return (fp_an["logs"].float() * 3.0).mean()


def _pair_step_fwd(pair: dict, u, v, c_a, c_b):
    """Two forward flow steps with the halves as explicit state: each
    change_order is a relabelling of (u, v).  Returns (u, v, logdet,
    (max, sumsq, hinge))."""
    even, odd = _index(pair, 0), _index(pair, 1)
    u = _an_half(even["actnorm"], 0, u)
    v = _an_half(even["actnorm"], 1, v)
    v, ld0, st0 = _couple_halves_fwd(even["coupling"], u, v, c_a)
    v = _an_half(odd["actnorm"], 0, v)
    u = _an_half(odd["actnorm"], 1, u)
    u, ld1, st1 = _couple_halves_fwd(odd["coupling"], v, u, c_b)
    ld = _an_logdet(even["actnorm"]) + _an_logdet(odd["actnorm"]) + ld0 + ld1
    st = (torch.maximum(st0[0], st1[0]), st0[1] + st1[1], st0[2] + st1[2])
    return u, v, ld, st


def _pair_fwd_ref(pair: dict, u, v, c_a, c_b):
    """Plain mirror of the fused forward pair (the JAX ``_pair_fwd_ref``):
    (u', v', raw -log_s sum), computed with the model's own modules."""
    even, odd = _index(pair, 0), _index(pair, 1)
    u1 = _an_half(even["actnorm"], 0, u)
    v1 = _an_half(even["actnorm"], 1, v)
    log_s, t = torch.chunk(apply_wavenet(even["coupling"], u1, c_a), 2, 2)
    v2 = (v1 - t) * torch.exp(-log_s)
    v3 = _an_half(odd["actnorm"], 0, v2)
    u2 = _an_half(odd["actnorm"], 1, u1)
    log_s2, t2 = torch.chunk(apply_wavenet(odd["coupling"], v3, c_b), 2, 2)
    u3 = (u2 - t2) * torch.exp(-log_s2)
    return u3, v3, -(log_s.float().sum() + log_s2.float().sum())


class _PairFwdFused(torch.autograd.Function):
    """The forward-kernel route's pair: forward through
    ``pf.fused_pair_forward`` (kernel ``pair_fwd``), backward by autograd
    through a recompute of :func:`_pair_fwd_ref` from input-only
    residuals (the JAX ``_pair_fwd_fused_b``)."""

    @staticmethod
    def forward(ctx, template, u, v, c_a, c_b, *pair_leaves):
        ctx.template = template
        ctx.save_for_backward(u, v, c_a, c_b, *pair_leaves)
        pair = rebuild(template, pair_leaves)
        ops = pf.pair_forward_operands(pair, u.dtype)
        return pf.fused_pair_forward(u, v, c_a, c_b, ops)

    @staticmethod
    def backward(ctx, gu, gv, gr):
        u, v, c_a, c_b, *pair_leaves = ctx.saved_tensors
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in (u, v, c_a, c_b,
                                                         *pair_leaves)]
            outs = _pair_fwd_ref(rebuild(ctx.template, xs[4:]), *xs[:4])
            grads = torch.autograd.grad(outs, xs, (gu, gv, gr),
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, xs)]
        return (None, *grads)


def _pair_fwd_fused(pair: dict, u, v, c_a, c_b):
    """(u', v', raw) of one forward pair on the forward-kernel route."""
    return _PairFwdFused.apply(pair, u, v, c_a, c_b, *leaves(pair))


def _an_half_rev(fp_an: dict, half: int, x: torch.Tensor) -> torch.Tensor:
    C2 = x.shape[-1]
    sl = slice(0, C2) if half == 0 else slice(C2, 2 * C2)
    b = fp_an["b"][..., sl].to(x.dtype)
    logs3 = fp_an["logs"][..., sl].float() * 3.0
    return x * torch.exp(-logs3).to(x.dtype) - b


def _couple_halves(fp: dict, u: torch.Tensor, v: torch.Tensor, c_half
                   ) -> torch.Tensor:
    """Reverse affine coupling: v' = v * exp(log_s(u)) + t(u)."""
    net_out = apply_wavenet(fp, u, c_half)
    log_s, t = torch.chunk(net_out, 2, dim=2)
    return v * torch.exp(log_s) + t


def _pair_params(p: dict) -> dict:
    """Restack the flow axis [n_flow, ...] into pairs [n_flow//2, 2, ...]."""
    return tree_map(lambda l: l.reshape((l.shape[0] // 2, 2) + l.shape[1:]),
                    p["flows"])


def _index(tree, i: int):
    return tree_map(lambda l: l[i], tree)


def _pair_step_rev(pair: dict, u, v, c_a, c_b):
    """Inverse of one forward pair step (flows in reverse order)."""
    even, odd = _index(pair, 0), _index(pair, 1)
    u = _couple_halves(odd["coupling"], v, u, c_b)
    v = _an_half_rev(odd["actnorm"], 0, v)
    u = _an_half_rev(odd["actnorm"], 1, u)
    v = _couple_halves(even["coupling"], u, v, c_a)
    u = _an_half_rev(even["actnorm"], 0, u)
    v = _an_half_rev(even["actnorm"], 1, v)
    return u, v


def _permute_cond_rows(flows: dict, perm) -> dict:
    """Permute the conditioning convs' input rows (the weight-norm sum is
    over those rows, so the fold is unchanged); pairs with the free reshape
    view of the mel halves (ops/squeeze.py squeeze_level_cond_perm)."""
    coup = flows["coupling"]
    layers = []
    for layer in coup["layers"]:
        layer = dict(layer)
        for kk in ("filter_c", "gate_c"):
            v = layer[kk]["v"]
            idx = constant(perm, v.device)
            layer[kk] = {**layer[kk], "v": v.index_select(v.dim() - 2, idx)}
        layers.append(layer)
    return {**flows, "coupling": {**coup, "layers": layers}}


def _check_scope(cfg: ModelConfig) -> None:
    if cfg.gin_channels > 0:
        raise NotImplementedError(
            "reverse with global conditioning is not ported yet "
            "(flowavenet_tpu/models/flowavenet.py:1119-1125, g_emb)")
    if not cfg.affine:
        raise NotImplementedError(
            "additive couplings are not ported yet "
            "(flowavenet_tpu/models/flowavenet.py:_couple_halves, "
            "affine=False)")
    if cfg.causal:
        raise NotImplementedError(
            "causal couplings are not ported yet "
            "(flowavenet_tpu/ops/conv.py:dilated_conv1d, causal=True)")
    if cfg.n_flow % 2:
        raise NotImplementedError(
            "odd n_flow needs the generic flow scan, not ported yet "
            "(flowavenet_tpu/models/flowavenet.py:837-847)")
    if cfg.n_layer != 2:
        raise NotImplementedError(
            f"n_layer={cfg.n_layer}: the port covers n_layer == 2 "
            "(flowavenet_tpu/models/flowavenet.py:_pair_kernel_eligible)")
    if cfg.logs_clamp != 0.0:
        raise NotImplementedError(
            "logs_clamp is not ported yet "
            "(flowavenet_tpu/models/flowavenet.py:_bound_log_s)")
    if cfg.num_mels % 2:
        raise NotImplementedError(
            "an odd num_mels needs the per-level conditioning squeeze, not "
            "ported yet (flowavenet_tpu/models/flowavenet.py:1119-1125)")


def _pair_kernel_mode(cfg: ModelConfig, cc_half: int) -> Optional[str]:
    """'int8' | 'wino' | 'wino4' | 'direct' | 'hoisted' | None (the plain
    pair-scan), by conditioning width and the live switches, exactly as the
    JAX package's ``_pair_kernel_mode`` (models/flowavenet.py:534-547)."""
    eligible = (cfg.use_pallas and cfg.gin_channels <= 0 and cfg.affine
                and not cfg.causal and cfg.n_layer == 2
                and cfg.logs_clamp == 0.0)
    if not eligible:
        return None
    if PAIR_KERNEL_INT8 and cc_half <= _pair_max_cc():
        return "int8"
    if PAIR_KERNEL_WINO and cc_half <= PAIR_KERNEL_WINO_MAX_CC:
        return "wino4" if PAIR_KERNEL_WINO4 else "wino"
    if cc_half <= _pair_max_cc():
        return "direct"
    if PAIR_KERNEL_HOISTED:
        return "hoisted"
    return None


def block_reverse(p: dict, cfg: ModelConfig, x: torch.Tensor, c_halves,
                  *, cond_perm=None, c_scales=None) -> torch.Tensor:
    """Inverse of one block on the squeezed x; returns x unsqueezed.

    ``c_halves=(c_a, c_b)``: the block's conditioning halves.  They are
    free reshape views of the mel halves when ``cond_perm`` is given (the
    cond weight rows are permuted to match).  On the int8 fused-pair route
    they are int8 with per-row scales ``c_scales=(s_a, s_b)`` ([B, 1, 1]
    each); on the int8 scan route they are ``(q, scale)`` pairs; the
    Winograd and hoisted routes take them in the compute dtype."""
    if cond_perm is not None:
        p = {**p, "flows": _permute_cond_rows(p["flows"], cond_perm)}
    u, v = torch.chunk(x, 2, dim=2)
    u, v = u.contiguous(), v.contiguous()
    c_a, c_b = c_halves
    cc_half = (c_a[0] if isinstance(c_a, tuple) else c_a).shape[-1]
    mode = _pair_kernel_mode(cfg, cc_half)
    pp = _pair_params(p)
    n_pair = cfg.n_flow // 2
    dt = x.dtype
    if mode == "hoisted":
        # one matmul per c half for every pair's conditioning (K = Cc up to
        # 10240), summed in fp32 and rounded once to the compute dtype as
        # the JAX package does (models/flowavenet.py:740-761); then one
        # launch per pair
        make = (pf.pair_reverse_operands_hoisted_int8 if PAIR_KERNEL_INT8
                else pf.pair_reverse_operands_hoisted)
        ops, we, wo = [], [], []
        for i in range(n_pair):
            o, (w_e, w_o) = make(_index(pp, i), dtype=dt)
            ops.append(o)
            we.append(w_e)
            wo.append(w_o)
        pw = we[0].shape[-1]                  # n_layer * 2R per pair
        ce = pf.hoist_cond(c_a, torch.cat(we, -1))
        co = pf.hoist_cond(c_b, torch.cat(wo, -1))
        for i in reversed(range(n_pair)):
            sl = slice(i * pw, (i + 1) * pw)
            u, v = pf.fused_pair_reverse(
                u, v, ce[..., sl].contiguous(), co[..., sl].contiguous(),
                ops[i], int8=PAIR_KERNEL_INT8, hoisted=True)
    elif mode in ("wino", "wino4"):
        make = (pf.pair_reverse_operands_wino4 if mode == "wino4"
                else pf.pair_reverse_operands_wino)
        for i in reversed(range(n_pair)):
            u, v = pf.fused_pair_reverse_wino(u, v, c_a, c_b,
                                              make(_index(pp, i), dtype=dt))
    elif mode is not None:
        int8 = mode == "int8"
        crs = None
        if int8:
            crs = torch.cat([s.float().reshape(-1, 1) for s in c_scales], 1)
        for i in reversed(range(n_pair)):
            pair = _index(pp, i)
            ops = (pf.pair_reverse_operands_int8(pair, dtype=dt, rs=INT8_RS)
                   if int8 else pf.pair_reverse_operands(pair, dtype=dt))
            u, v = pf.fused_pair_reverse(u, v, c_a, c_b, ops, int8=int8,
                                         c_row_scales=crs)
    else:
        for i in reversed(range(n_pair)):
            u, v = _pair_step_rev(_index(pp, i), u, v, c_a, c_b)
    return unsqueeze(torch.cat([u, v], dim=2))


def _check_shapes(cfg: ModelConfig, z: torch.Tensor, c: torch.Tensor
                  ) -> None:
    sq, hop = cfg.squeeze_factor, cfg.hop_size
    if z.dim() != 3 or z.shape[-1] != 1:
        raise ValueError(f"audio must be [B, T, 1], got {tuple(z.shape)}")
    if c.dim() != 3 or c.shape[-1] != cfg.num_mels:
        raise ValueError(
            f"mel must be [B, T_mel, {cfg.num_mels}], got {tuple(c.shape)}")
    if z.shape[1] % sq != 0:
        raise ValueError(
            f"T={z.shape[1]} must be divisible by 2**n_block={sq} "
            f"(each of the {cfg.n_block} blocks halves time)")
    if c.shape[1] * hop != z.shape[1]:
        raise ValueError(
            f"audio/mel misaligned: T={z.shape[1]} != T_mel*hop="
            f"{c.shape[1]}*{hop}={c.shape[1] * hop}")


@torch.no_grad()
def reverse(params: dict, cfg: ModelConfig, z: torch.Tensor,
            c: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """One-shot synthesis: z [B, T, 1] noise -> audio [B, T, 1].

    The mel is upsampled once and split into its two halves; each block
    takes its conditioning as a free reshape view of those halves, with
    the cond weight rows permuted to match.  On the int8 routes the halves
    are quantized once, with one scale per batch row, and shared by every
    int8 block; the Winograd and hoisted blocks take the unquantized
    halves, as in the JAX package (models/flowavenet.py:1072-1108)."""
    _check_scope(cfg)
    _check_shapes(cfg, z, c)
    z = z.to(compute_dtype)
    c = apply_upsample(params["upsample"], c.to(compute_dtype),
                       cfg.upsample_scales)
    x = squeeze_to_level(z, cfg.n_block)
    c_lo, c_hi = (h.contiguous() for h in torch.chunk(c, 2, dim=2))
    q8 = None
    if PAIR_KERNEL_INT8 and cfg.use_pallas:
        q8 = (quantize_act(c_lo, per_row=True),
              quantize_act(c_hi, per_row=True))
    Bc, Tc, C0 = c_lo.shape
    for bi in reversed(range(cfg.n_block)):
        k = bi + 1
        cc_half = (cfg.num_mels << k) // 2
        mode = _pair_kernel_mode(cfg, cc_half)

        def lvl(h):
            return h.reshape(Bc, Tc >> k, C0 << k)

        c_scales = None
        if q8 is not None and mode == "int8":
            c_halves = (lvl(q8[0][0]), lvl(q8[1][0]))
            c_scales = (q8[0][1], q8[1][1])
        elif q8 is not None and mode is None:
            c_halves = ((lvl(q8[0][0]), q8[0][1]), (lvl(q8[1][0]), q8[1][1]))
        else:
            c_halves = (lvl(c_lo), lvl(c_hi))
        x = block_reverse(params["blocks"][bi], cfg, x, c_halves,
                          cond_perm=squeeze_level_cond_perm(k, C0),
                          c_scales=c_scales)
    return x


# ---------------------------------------------------------------------------
# Likelihood side: forward, DDI, loss
# ---------------------------------------------------------------------------

def block_forward(p: dict, cfg: ModelConfig, x, c, *,
                  return_stats: bool = False, remat: Optional[bool] = None):
    """Forward through one block.  Returns (x, c, logdet); with
    ``return_stats`` a fourth element (max|log_s|, sum log_s^2,
    sum relu(|log_s|-margin)^2), fp32 scalars over every coupling of the
    block.  ``remat`` overrides cfg.remat for this block."""
    do_remat = cfg.remat if remat is None else remat
    x, c = squeeze(x), squeeze(c)
    u, v = (h.contiguous() for h in torch.chunk(x, 2, dim=2))
    c_a, c_b = (h.contiguous() for h in torch.chunk(c, 2, dim=2))
    zero = torch.zeros((), device=x.device)
    pp = _pair_params(p)
    n_pair = cfg.n_flow // 2
    cc = c_a.shape[-1]

    def out(u, v, ld, st):
        x = torch.cat([u, v], dim=2)
        return (x, c, ld, st) if return_stats else (x, c, ld)

    def an_logdets(pair):
        return (_an_logdet(_index(pair, 0)["actnorm"])
                + _an_logdet(_index(pair, 1)["actnorm"]))

    B, T_lvl, r_in = u.shape
    if TRAIN_KERNEL and cfg.use_pallas and cc <= TRAIN_KERNEL_MAX_CC:
        # the training pair: exact log_s statistics out of the kernel, and
        # its backward recomputes from input-only residuals (no checkpoint)
        ld, raw, mx, sq, hq = zero, zero, zero, zero, zero
        for i in range(n_pair):
            pair = _index(pp, i)
            ops = pf.pair_forward_operands(pair, u.dtype)
            u, v, s, m_, q_, h_ = pft.PairTrain.apply(u, v, c_a, c_b, *ops)
            raw, mx = raw + s, torch.maximum(mx, m_)
            sq, hq = sq + q_, hq + h_
            ld = ld + an_logdets(pair)
        ld = ld + raw / (B * T_lvl * r_in) / 2.0
        return out(u, v, ld, (mx, sq, hq))
    if PAIR_KERNEL_FWD and cfg.use_pallas and cc <= PAIR_KERNEL_FWD_MAX_CC:
        # the forward pair: log_s never materializes whole, so the block's
        # statistics read 0 (loss_fn refuses the guards on this route)
        ld, raw = zero, zero
        for i in range(n_pair):
            pair = _index(pp, i)
            u, v, s = _pair_fwd_fused(pair, u, v, c_a, c_b)
            raw = raw + s
            ld = ld + an_logdets(pair)
        ld = ld + raw / (B * T_lvl * r_in) / 2.0
        return out(u, v, ld, (zero, zero, zero))
    ld, mx, sq, hq = zero, zero, zero, zero
    for i in range(n_pair):
        pair = _index(pp, i)

        def step(u, v, pair=pair):
            return _pair_step_fwd(pair, u, v, c_a, c_b)

        if do_remat and torch.is_grad_enabled():
            u, v, ld_i, st = checkpoint(step, u, v, use_reentrant=False)
        else:
            u, v, ld_i, st = step(u, v)
        ld = ld + ld_i
        mx, sq, hq = torch.maximum(mx, st[0]), sq + st[1], hq + st[2]
    return out(u, v, ld, (mx, sq, hq))


def block_ddi(p: dict, cfg: ModelConfig, x, c):
    """DDI through one block: each flow's ActNorm is set from the
    statistics of its own input.  Returns (x, c, new block params)."""
    x, c = squeeze(x), squeeze(c)
    ans = []
    for i in range(cfg.n_flow):
        fp = _index(p["flows"], i)
        an = actnorm_ddi(x)
        x, _ = actnorm_forward(an, x)
        x, _ = coupling_forward(fp["coupling"], x, c)
        x, c = change_order(x), change_order(c)
        ans.append(an)
    new_an = tree_map(lambda *xs: torch.stack(xs), *ans)
    return x, c, {"flows": {**p["flows"], "actnorm": new_an}}


def forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
            c: torch.Tensor, compute_dtype=torch.float32,
            return_stats: bool = False):
    """NLL forward pass.  x: [B, T, 1] audio; c: [B, T/hop, num_mels] mel.
    Returns fp32 (log_p, logdet) in nats/dim; with ``return_stats`` also a
    dict of per-block logdets, max|log_s|, mean log_s^2 and the hinge sum
    normalized like the logdet."""
    _check_scope(cfg)
    _check_shapes(cfg, x, c)
    x = x.to(compute_dtype)
    c = apply_upsample(params["upsample"], c.to(compute_dtype),
                       cfg.upsample_scales)
    zero = torch.zeros((), device=x.device)
    logdet, max_ls, sumsq_ls, hinge_ls = zero, zero, zero, zero
    nel = x.numel()
    block_lds = []
    n_ls = 0
    out = x
    rb = cfg.remat_blocks
    for bi, bp in enumerate(params["blocks"]):
        bl_remat = cfg.remat and (rb < 0 or bi < rb)
        out, c, ld, st = block_forward(bp, cfg, out, c, return_stats=True,
                                       remat=bl_remat)
        max_ls = torch.maximum(max_ls, st[0])
        sumsq_ls, hinge_ls = sumsq_ls + st[1], hinge_ls + st[2]
        n_ls += cfg.n_flow * out.shape[0] * out.shape[1] * out.shape[2] // 2
        block_lds.append(ld)
        logdet = logdet + ld
    z32 = out.float()
    log_p = (0.5 * (-LOG_2PI - z32 * z32)).mean()
    if not return_stats:
        return log_p, logdet
    stats = {f"logdet_block{i}": ld for i, ld in enumerate(block_lds)}
    stats["max_log_s"] = max_ls
    stats["logs_mean_sq"] = sumsq_ls / max(n_ls, 1)
    stats["logs_hinge"] = hinge_ls / max(nel, 1)
    return log_p, logdet, stats


@torch.no_grad()
def ddi(params: dict, cfg: ModelConfig, x: torch.Tensor, c: torch.Tensor,
        compute_dtype=torch.float32) -> dict:
    """Data-dependent ActNorm initialization over one batch; returns the
    params with every ActNorm replaced."""
    _check_scope(cfg)
    _check_shapes(cfg, x, c)
    out = x.to(compute_dtype)
    c = apply_upsample(params["upsample"], c.to(compute_dtype),
                       cfg.upsample_scales)
    new_blocks = []
    for bp in params["blocks"]:
        out, c, new_bp = block_ddi(bp, cfg, out, c)
        new_blocks.append(new_bp)
    return {**params, "blocks": new_blocks}


def loss_fn(params: dict, cfg: ModelConfig, x, c,
            compute_dtype=torch.float32, logs_l2: float = 0.0,
            logs_hinge: float = 0.0):
    """NLL = -(log_p + logdet) in nats/dim, plus the optional log_s guards
    (``logs_l2`` * mean log_s^2, ``logs_hinge`` * the hinge).  Returns
    (total, aux); aux["loss"] is the pure NLL."""
    log_p, logdet, stats = forward(params, cfg, x, c, compute_dtype,
                                   return_stats=True)
    loss = -(log_p + logdet)
    aux = {"loss": loss, "log_p": log_p, "logdet": logdet,
           "bits_per_dim": loss / math.log(2.0), **stats}
    total = loss
    if logs_l2 > 0.0 or logs_hinge > 0.0:
        if PAIR_KERNEL_FWD and cfg.use_pallas:
            raise ValueError(
                "FWN_FWD_KERNEL=1 is incompatible with the log_s "
                "divergence guards (logs_hinge/logs_l2): the fused pair "
                "kernel's log_s stats read 0, disabling the penalty "
                "silently.  Unset FWN_FWD_KERNEL for guarded training, "
                "or set logs_hinge=0 and logs_l2=0 to train unguarded.")
        penalty = torch.zeros((), device=loss.device)
        if logs_l2 > 0.0:
            penalty = penalty + logs_l2 * stats["logs_mean_sq"]
        if logs_hinge > 0.0:
            penalty = penalty + logs_hinge * stats["logs_hinge"]
        aux["logs_penalty"] = penalty
        total = loss + penalty
    return total, aux
