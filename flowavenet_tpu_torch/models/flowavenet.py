"""FloWaveNet in PyTorch (twin of ``flowavenet_tpu/models/flowavenet.py``):
``init_flowavenet``, one-shot synthesis (``reverse``) and the likelihood
side (``forward``, ``ddi``, ``loss_fn``).

Parameters are the JAX package's tree (nested dicts and lists), with
torch tensors as leaves and the flow axis of each block stacked first.

The whole model family of the JAX package: affine or additive couplings,
causal or non-causal convs, any n_layer, even n_flow (the pair-scan, with
the change_order swaps as relabellings of the halves) or odd n_flow (the
generic flow scan), the ``logs_clamp`` soft bound, odd ``num_mels`` (the
per-level conditioning squeeze) and global (speaker) conditioning through
``speaker_emb`` (``parity_drop_global_cond`` reproduces the reference's
dropped g).

Synthesis routes, per block, as the JAX package's ``_pair_kernel_mode``
picks them (``ops/pair_flow.py`` holds the pairs).  Every kernel route
needs ``_pair_kernel_eligible``: ``cfg.use_pallas``, affine, non-causal,
n_layer == 2, no logs_clamp and no global conditioning; otherwise, or with
``cfg.use_pallas=False``, the plain pair-scan (or the generic scan) runs:
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

Forward (likelihood) routes, per block of an eligible config, in this
order:
* ``FWN_TRAIN_KERNEL=1`` and cc_half <= ``FWN_TRAIN_MAX_CC`` (80): the
  training pair (``ops/pair_flow_train.py``, kernels ``pair_train_fwd`` and
  ``pair_train_bwd``) with exact log_s statistics;
* ``FWN_FWD_KERNEL=1`` and cc_half <= ``FWN_FWD_MAX_CC`` (640): the forward
  pair (``pair_fwd``), whose backward recomputes the plain pair; its
  blocks report zero log_s statistics;
* otherwise the plain pair-scan (generic scan for odd n_flow), under
  ``torch.utils.checkpoint`` when ``cfg.remat``/``cfg.remat_blocks`` ask
  for it.
On CPU tensors the kernel routes run the kernels' plain versions.

``use_pallas`` of the coupling functions (``coupling_forward``,
``coupling_reverse``, ``_couple_halves``, the pair and flow steps) sends
the coupling nets through the fused ResBlock kernels (``ops/resblock.py``);
as in the JAX package, the model's own routes never set it.
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
from ..utils.profiling import span, spanned
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
               cfg: ModelConfig, gin_channels: int = 0) -> dict:
    """Stacked params for one block (channel counts after its squeeze)."""
    sq, sq_c = 2 * in_channels, 2 * cin_channels
    out_ch = sq if cfg.affine else sq // 2
    flows = [{"actnorm": init_actnorm(sq, gen.device),
              "coupling": init_wavenet(
                  gen, in_channels=sq // 2, out_channels=out_ch,
                  num_layers=cfg.n_layer, residual_channels=cfg.filter_size,
                  cin_channels=sq_c // 2, gin_channels=gin_channels)}
             for _ in range(cfg.n_flow)]
    return {"flows": tree_map(lambda *xs: torch.stack(xs), *flows)}


def init_flowavenet(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Fresh fp32 params on ``gen.device``.  The same tree as the JAX
    package's init (the numbers differ: torch and JAX draw differently)."""
    params: dict = {"upsample": init_upsample(gen, cfg.upsample_scales)}
    if cfg.gin_channels > 0:
        limit = math.sqrt(6.0 / (cfg.n_speakers + cfg.gin_channels))
        params["speaker_emb"] = (
            torch.rand(cfg.n_speakers, cfg.gin_channels, generator=gen,
                       device=gen.device) * (2.0 * limit) - limit)
    blocks = []
    in_ch, cin_ch = 1, cfg.num_mels
    # each block's squeeze doubles g's channels; a half feeds each net
    gin = cfg.gin_channels if cfg.gin_channels > 0 else 0
    for _ in range(cfg.n_block):
        blocks.append(init_block(gen, in_ch, cin_ch, cfg, gin))
        in_ch, cin_ch, gin = in_ch * 2, cin_ch * 2, gin * 2
    params["blocks"] = blocks
    return params


def actnorm_forward(p: dict, x: torch.Tensor):
    """x -> (x + b) * exp(3*logs); logdet = mean(3*logs)."""
    logs3 = p["logs"].float() * 3.0
    out = (x + p["b"].to(x.dtype)) * torch.exp(logs3).to(x.dtype)
    return out, logs3.mean()


def actnorm_reverse(p: dict, x: torch.Tensor) -> torch.Tensor:
    logs3 = p["logs"].float() * 3.0
    return x * torch.exp(-logs3).to(x.dtype) - p["b"].to(x.dtype)


def actnorm_ddi(x: torch.Tensor) -> dict:
    """Data-dependent init from one batch: b = -mean(x),
    logs = log(1/(std+1e-7))/3, statistics over (batch, time)."""
    xf = x.float()
    mean = xf.mean(dim=(0, 1), keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=(0, 1), keepdim=True)
    logs = torch.log(1.0 / (torch.sqrt(var) + 1e-7)) / 3.0
    return {"b": -mean, "logs": logs}


def _bound_log_s(log_s: torch.Tensor, clamp: float) -> torch.Tensor:
    """Soft bound log_s to (-clamp, clamp) as clamp * tanh(log_s / clamp)
    (``ModelConfig.logs_clamp``; 0.0 = identity).  Forward and reverse
    apply the same bounded value, so the flow stays invertible."""
    if clamp <= 0.0:
        return log_s
    c = torch.tensor(clamp, dtype=log_s.dtype, device=log_s.device)
    return c * torch.tanh(log_s / c)


def _log_s_stats(log_s: torch.Tensor):
    """(max |log_s|, sum log_s^2, sum relu(|log_s| - margin)^2) in fp32."""
    ls = log_s.float()
    excess = torch.relu(ls.abs() - LOGS_HINGE_MARGIN)
    return ls.abs().max(), (ls * ls).sum(), (excess * excess).sum()


def _halves(x: Optional[torch.Tensor]):
    return torch.chunk(x, 2, dim=2) if x is not None else (None, None)


def coupling_forward(p: dict, x: torch.Tensor, c: torch.Tensor,
                     g: Optional[torch.Tensor] = None, *, affine: bool,
                     causal: bool, use_pallas: bool = False,
                     logs_clamp: float = 0.0, stats: bool = False):
    """Coupling, forward: the second half of x becomes (x_b - t) *
    exp(-log_s) with (log_s, t) = net(x_a, c_a, g_a) (affine), or x_b +
    net(...) (additive, logdet 0)."""
    in_a, in_b = torch.chunk(x, 2, dim=2)
    c_a, g_a = _halves(c)[0], _halves(g)[0]
    net_out = apply_wavenet(p, in_a, c_a, g_a, causal=causal,
                            use_pallas=use_pallas)
    zero = torch.zeros((), device=x.device)
    if affine:
        log_s, t = torch.chunk(net_out, 2, dim=2)
        log_s = _bound_log_s(log_s, logs_clamp)
        out_b = (in_b - t) * torch.exp(-log_s)
        logdet = (-log_s.float()).mean() / 2.0
    else:
        log_s, out_b, logdet = None, in_b + net_out, zero
    out = torch.cat([in_a, out_b], dim=2)
    if stats:
        return out, logdet, (_log_s_stats(log_s) if log_s is not None
                             else (zero, zero, zero))
    return out, logdet


def coupling_reverse(p: dict, x: torch.Tensor, c: torch.Tensor,
                     g: Optional[torch.Tensor] = None, *, affine: bool,
                     causal: bool, use_pallas: bool = False,
                     logs_clamp: float = 0.0) -> torch.Tensor:
    out_a, out_b = torch.chunk(x, 2, dim=2)
    c_a, g_a = _halves(c)[0], _halves(g)[0]
    net_out = apply_wavenet(p, out_a, c_a, g_a, causal=causal,
                            use_pallas=use_pallas, per_row=True)
    if affine:
        log_s, t = torch.chunk(net_out, 2, dim=2)
        in_b = out_b * torch.exp(_bound_log_s(log_s, logs_clamp)) + t
    else:
        in_b = out_b - net_out
    return torch.cat([out_a, in_b], dim=2)


def _an_half(fp_an: dict, half: int, x: torch.Tensor) -> torch.Tensor:
    """Apply one channel-half of an ActNorm (forward)."""
    C2 = x.shape[-1]
    sl = slice(0, C2) if half == 0 else slice(C2, 2 * C2)
    b = fp_an["b"][..., sl].to(x.dtype)
    logs3 = fp_an["logs"][..., sl].float() * 3.0
    return (x + b) * torch.exp(logs3).to(x.dtype)


def _an_half_rev(fp_an: dict, half: int, x: torch.Tensor) -> torch.Tensor:
    C2 = x.shape[-1]
    sl = slice(0, C2) if half == 0 else slice(C2, 2 * C2)
    b = fp_an["b"][..., sl].to(x.dtype)
    logs3 = fp_an["logs"][..., sl].float() * 3.0
    return x * torch.exp(-logs3).to(x.dtype) - b


def _couple_halves(fp: dict, u, v, c_half, g_half, cfg: ModelConfig,
                   reverse: bool, use_pallas: bool = False,
                   stats: bool = False):
    """Transform v given net(u).  Returns (v', logdet), plus the log_s
    statistics when ``stats``.  In reverse (synthesis) the net's
    batch-sensitive products run one row at a time (``per_row``)."""
    net_out = apply_wavenet(fp, u, c_half, g_half, causal=cfg.causal,
                            use_pallas=use_pallas, per_row=reverse)
    zero = torch.zeros((), device=v.device)
    if cfg.affine:
        log_s, t = torch.chunk(net_out, 2, dim=2)
        log_s = _bound_log_s(log_s, cfg.logs_clamp)
        if reverse:
            out, ld = v * torch.exp(log_s) + t, zero
        else:
            out = (v - t) * torch.exp(-log_s)
            ld = (-log_s.float()).mean() / 2.0
        if stats:
            return out, ld, _log_s_stats(log_s)
        return out, ld
    out = (v - net_out) if reverse else (v + net_out)
    if stats:
        return out, zero, (zero, zero, zero)
    return out, zero


def _an_logdet(fp_an: dict) -> torch.Tensor:
    return (fp_an["logs"].float() * 3.0).mean()


def _pair_step_fwd(cfg: ModelConfig, pair: dict, u, v, c_a, c_b,
                   g_a=None, g_b=None):
    """Two forward flow steps with the halves as explicit state: each
    change_order is a relabelling of (u, v).  Returns (u, v, logdet,
    (max, sumsq, hinge))."""
    even, odd = _index(pair, 0), _index(pair, 1)
    u = _an_half(even["actnorm"], 0, u)
    v = _an_half(even["actnorm"], 1, v)
    v, ld0, st0 = _couple_halves(even["coupling"], u, v, c_a, g_a, cfg,
                                 reverse=False, stats=True)
    v = _an_half(odd["actnorm"], 0, v)
    u = _an_half(odd["actnorm"], 1, u)
    u, ld1, st1 = _couple_halves(odd["coupling"], v, u, c_b, g_b, cfg,
                                 reverse=False, stats=True)
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
    ``pft.fused_pair_forward`` (kernel ``pair_fwd``), backward by autograd
    through a recompute of :func:`_pair_fwd_ref` from input-only
    residuals (the JAX ``_pair_fwd_fused_b``)."""

    @staticmethod
    def forward(ctx, template, u, v, c_a, c_b, *pair_leaves):
        ctx.template = template
        ctx.save_for_backward(u, v, c_a, c_b, *pair_leaves)
        pair = rebuild(template, pair_leaves)
        ops = pf.pair_forward_operands(pair, u.dtype)
        return pft.fused_pair_forward(u, v, c_a, c_b, ops)

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


def _pair_params(p: dict) -> dict:
    """Restack the flow axis [n_flow, ...] into pairs [n_flow//2, 2, ...]."""
    return tree_map(lambda l: l.reshape((l.shape[0] // 2, 2) + l.shape[1:]),
                    p["flows"])


def _index(tree, i: int):
    return tree_map(lambda l: l[i], tree)


def _pair_step_rev(cfg: ModelConfig, pair: dict, u, v, c_a, c_b, g_a=None,
                   g_b=None, use_pallas: bool = False):
    """Inverse of one forward pair step (flows in reverse order)."""
    even, odd = _index(pair, 0), _index(pair, 1)
    u, _ = _couple_halves(odd["coupling"], v, u, c_b, g_b, cfg, reverse=True,
                          use_pallas=use_pallas)
    v = _an_half_rev(odd["actnorm"], 0, v)
    u = _an_half_rev(odd["actnorm"], 1, u)
    v, _ = _couple_halves(even["coupling"], u, v, c_a, g_a, cfg,
                          reverse=True, use_pallas=use_pallas)
    u = _an_half_rev(even["actnorm"], 0, u)
    v = _an_half_rev(even["actnorm"], 1, v)
    return u, v


def _change_order_g(g):
    return change_order(g) if g is not None else None


def _flow_step_fwd(cfg: ModelConfig, fp: dict, x, c, g):
    """One generic forward flow step (odd n_flow): ActNorm, coupling,
    change_order of x, c and g.  Returns (x, c, g, logdet, stats)."""
    x, ld_a = actnorm_forward(fp["actnorm"], x)
    x, ld_c, st = coupling_forward(fp["coupling"], x, c, g,
                                   affine=cfg.affine, causal=cfg.causal,
                                   logs_clamp=cfg.logs_clamp, stats=True)
    return (change_order(x), change_order(c), _change_order_g(g),
            ld_a + ld_c, st)


def _flow_step_rev(cfg: ModelConfig, fp: dict, x, c, g,
                   use_pallas: bool = False):
    """One generic reverse flow step, the JAX package's step as its
    reversed scan runs it: change_order of g, x and c, then the coupling
    and ActNorm inverses."""
    g = _change_order_g(g)
    x, c = change_order(x), change_order(c)
    x = coupling_reverse(fp["coupling"], x, c, g, affine=cfg.affine,
                         causal=cfg.causal, use_pallas=use_pallas,
                         logs_clamp=cfg.logs_clamp)
    return actnorm_reverse(fp["actnorm"], x), c, g


def _flow_step_ddi(cfg: ModelConfig, fp: dict, x, c, g):
    """One DDI flow step: the ActNorm is set from its own input.  Returns
    (x, c, g, new ActNorm)."""
    an = actnorm_ddi(x)
    x, _ = actnorm_forward(an, x)
    x, _ = coupling_forward(fp["coupling"], x, c, g, affine=cfg.affine,
                            causal=cfg.causal, logs_clamp=cfg.logs_clamp)
    return change_order(x), change_order(c), _change_order_g(g), an


@spanned("fwn.fold.cond_perm")
def _permute_cond_rows(flows: dict, perm) -> dict:
    """Permute the conditioning convs' input rows (the weight-norm sum is
    over those rows, so the fold is unchanged); pairs with the free reshape
    view of the mel halves (ops/squeeze.py squeeze_level_cond_perm)."""
    _whole_cond(flows, len(perm), "synthesis")
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


def _whole_cond(flows: dict, cc_half: int, route: str) -> None:
    """The kernel routes and the reverse's row permutation take whole
    conditioning kernels: a tensor-parallel shard (``parallel/tp.py``)
    raises here rather than reach them."""
    for layer in flows["coupling"]["layers"]:
        if layer["filter_c"]["v"].shape[-2] != cc_half:
            raise ValueError(
                f"the {route} route takes no tensor-parallel shard (a "
                f"conditioning kernel of {layer['filter_c']['v'].shape[-2]} "
                f"input channels beside {cc_half})")


def _pair_kernel_eligible(cfg: ModelConfig, has_g: bool) -> bool:
    """Base eligibility of the fused pair kernels (the JAX package's
    ``_pair_kernel_eligible`` without its CPU-backend clause: on CPU
    tensors the port runs the kernels' plain versions): affine, non-causal,
    n_layer == 2, no logs_clamp (the kernels bake the unbounded
    exp(log_s)) and no global conditioning."""
    return (cfg.use_pallas and not has_g and cfg.affine and not cfg.causal
            and cfg.n_layer == 2 and cfg.logs_clamp == 0.0)


def _pair_kernel_mode(cfg: ModelConfig, cc_half: int,
                      has_g: bool = False) -> Optional[str]:
    """'int8' | 'wino' | 'wino4' | 'direct' | 'hoisted' | None (the plain
    pair-scan), by conditioning width and the live switches, exactly as the
    JAX package's ``_pair_kernel_mode`` (models/flowavenet.py:534-547)."""
    if not _pair_kernel_eligible(cfg, has_g):
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


def _forward_route(cfg: ModelConfig, cc_half: int,
                   has_g: bool) -> Optional[str]:
    """'train' | 'fwd' | None (the plain pair-scan): the forward-kernel
    route of an even-n_flow block, as the JAX package's block_forward
    picks it (models/flowavenet.py:592-593, :621-622)."""
    if not _pair_kernel_eligible(cfg, has_g):
        return None
    if TRAIN_KERNEL and cc_half <= TRAIN_KERNEL_MAX_CC:
        return "train"
    if PAIR_KERNEL_FWD and cc_half <= PAIR_KERNEL_FWD_MAX_CC:
        return "fwd"
    return None


def _int8_mel(cfg: ModelConfig, has_g: bool) -> bool:
    """Whether ``reverse`` quantizes the mel halves once for the int8
    routes (the JAX package's condition, models/flowavenet.py:1060-1061)."""
    return (PAIR_KERNEL_INT8 and not has_g and cfg.n_flow % 2 == 0
            and _pair_kernel_eligible(cfg, False))


def block_reverse(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  c_halves=None, *, g_halves=None, c=None, g=None,
                  cond_perm=None, c_scales=None) -> torch.Tensor:
    """Inverse of one block on the squeezed x; returns x unsqueezed.

    The block's conditioning comes either as ``c_halves=(c_a, c_b)`` (and
    ``g_halves``) or whole as ``c`` (and ``g``), at the block's level.  The
    halves are free reshape views of the mel halves when ``cond_perm`` is
    given (the cond weight rows are permuted to match).  On the int8
    fused-pair route they are int8 with per-row scales ``c_scales=(s_a,
    s_b)`` ([B, 1, 1] each); on the int8 scan route they are ``(q, scale)``
    pairs (whole halves are quantized here); the Winograd and hoisted
    routes take them in the compute dtype.  Odd n_flow runs the generic
    flow scan on the whole c and g."""
    if cond_perm is not None:
        p = {**p, "flows": _permute_cond_rows(p["flows"], cond_perm)}
    if c_halves is None:
        c_halves = tuple(h.contiguous() for h in _halves(c))
        g_halves = _halves(g) if g is not None else None
    has_g = g_halves is not None
    if cfg.n_flow % 2:
        c = torch.cat(c_halves, dim=2)
        g = torch.cat(g_halves, dim=2) if has_g else None
        for i in reversed(range(cfg.n_flow)):
            x, c, g = _flow_step_rev(cfg, _index(p["flows"], i), x, c, g)
        return unsqueeze(x)
    u, v = torch.chunk(x, 2, dim=2)
    u, v = u.contiguous(), v.contiguous()
    c_a, c_b = c_halves
    g_a, g_b = g_halves if has_g else (None, None)
    cc_half = (c_a[0] if isinstance(c_a, tuple) else c_a).shape[-1]
    mode = _pair_kernel_mode(cfg, cc_half, has_g)
    if mode is not None:
        _whole_cond(p["flows"], cc_half, mode)
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
            if c_scales is None:
                # whole halves (the per-level route): per-row int8 codes
                # here, where the JAX kernel quantizes each tile's c itself
                (c_a, s_a), (c_b, s_b) = (quantize_act(c_a, per_row=True),
                                          quantize_act(c_b, per_row=True))
                c_scales = (s_a, s_b)
            crs = torch.cat([s.float().reshape(-1, 1) for s in c_scales], 1)
        for i in reversed(range(n_pair)):
            pair = _index(pp, i)
            ops = (pf.pair_reverse_operands_int8(pair, dtype=dt, rs=INT8_RS)
                   if int8 else pf.pair_reverse_operands(pair, dtype=dt))
            u, v = pf.fused_pair_reverse(u, v, c_a, c_b, ops, int8=int8,
                                         c_row_scales=crs)
    else:
        if (PAIR_KERNEL_INT8 and _pair_kernel_eligible(cfg, has_g)
                and not isinstance(c_a, tuple)):
            # the deep-block int8 scan: its conditioning 1x1s take int8
            # codes, quantized once per block with per-row scales
            c_a = quantize_act(c_a, per_row=True)
            c_b = quantize_act(c_b, per_row=True)
        for i in reversed(range(n_pair)):
            u, v = _pair_step_rev(cfg, _index(pp, i), u, v, c_a, c_b, g_a,
                                  g_b)
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


@spanned("fwn.model.upsample")
def _prepare_cond(params: dict, cfg: ModelConfig, c: torch.Tensor, g,
                  compute_dtype):
    """Mel upsampling and the speaker-embedding lookup: (c [B, T, mels],
    g_emb [B, T, gin] or None).  ``g`` holds speaker ids [B]; with
    ``parity_drop_global_cond`` the embedding never reaches the nets, as
    in the reference."""
    c = apply_upsample(params["upsample"], c.to(compute_dtype),
                       cfg.upsample_scales)
    if cfg.gin_channels <= 0:
        return c, None
    if g is None:
        raise ValueError("gin_channels > 0 requires speaker ids g")
    if cfg.parity_drop_global_cond:
        return c, None
    emb = params["speaker_emb"]
    ids = torch.as_tensor(g, device=emb.device).long().reshape(-1)
    emb = emb[ids].to(compute_dtype)                     # [B, gin]
    return c, emb[:, None, :].expand(emb.shape[0], c.shape[1], emb.shape[1])


@spanned("fwn.model.reverse")
@torch.no_grad()
def reverse(params: dict, cfg: ModelConfig, z: torch.Tensor,
            c: torch.Tensor, g=None, compute_dtype=torch.float32
            ) -> torch.Tensor:
    """One-shot synthesis: z [B, T, 1] noise -> audio [B, T, 1]; g: [B]
    speaker ids (global conditioning).

    With an even num_mels (and gin) the mel is upsampled once and split
    into its two halves; each block takes its conditioning as a free
    reshape view of those halves, with the cond weight rows permuted to
    match (with global conditioning: ``squeeze_to_level`` of the halves
    and of g, as in the JAX package).  On the int8 routes the halves are
    quantized once, with one scale per batch row, and shared by every int8
    block; the Winograd and hoisted blocks take the unquantized halves
    (models/flowavenet.py:1072-1108).  Otherwise each block takes
    ``squeeze_to_level`` of the whole c and g (:1119-1125)."""
    _check_shapes(cfg, z, c)
    z = z.to(compute_dtype)
    c, g_emb = _prepare_cond(params, cfg, c, g, compute_dtype)
    gin = g_emb.shape[-1] if g_emb is not None else 0
    x = squeeze_to_level(z, cfg.n_block)
    if cfg.num_mels % 2 or gin % 2:
        for bi in reversed(range(cfg.n_block)):
            k = bi + 1
            g_k = squeeze_to_level(g_emb, k) if g_emb is not None else None
            with span("fwn.model.block", block=bi):
                x = block_reverse(params["blocks"][bi], cfg, x,
                                  c=squeeze_to_level(c, k), g=g_k)
        return x
    c_lo, c_hi = (h.contiguous() for h in torch.chunk(c, 2, dim=2))
    q8 = None
    if _int8_mel(cfg, g_emb is not None):
        q8 = (quantize_act(c_lo, per_row=True),
              quantize_act(c_hi, per_row=True))
    Bc, Tc, C0 = c_lo.shape
    for bi in reversed(range(cfg.n_block)):
        k = bi + 1
        if g_emb is not None:
            with span("fwn.model.block", block=bi):
                x = block_reverse(
                    params["blocks"][bi], cfg, x,
                    (squeeze_to_level(c_lo, k), squeeze_to_level(c_hi, k)),
                    g_halves=tuple(squeeze_to_level(h, k)
                                   for h in torch.chunk(g_emb, 2, dim=2)))
            continue
        cc_half = (cfg.num_mels << k) // 2
        mode = (_pair_kernel_mode(cfg, cc_half) if cfg.n_flow % 2 == 0
                else None)

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
        with span("fwn.model.block", block=bi):
            x = block_reverse(params["blocks"][bi], cfg, x, c_halves,
                              cond_perm=squeeze_level_cond_perm(k, C0),
                              c_scales=c_scales)
    return x


# ---------------------------------------------------------------------------
# Likelihood side: forward, DDI, loss
# ---------------------------------------------------------------------------

def block_forward(p: dict, cfg: ModelConfig, x, c, g=None, *,
                  return_stats: bool = False, remat: Optional[bool] = None):
    """Forward through one block.  Returns (x, c, g, logdet); with
    ``return_stats`` a fifth element (max|log_s|, sum log_s^2,
    sum relu(|log_s|-margin)^2), fp32 scalars over every coupling of the
    block.  ``remat`` overrides cfg.remat for this block."""
    do_remat = (cfg.remat if remat is None else remat) and \
        torch.is_grad_enabled()
    x, c = squeeze(x), squeeze(c)
    g = squeeze(g) if g is not None else None
    has_g = g is not None
    zero = torch.zeros((), device=x.device)

    def out(x, c, g, ld, st):
        return (x, c, g, ld, st) if return_stats else (x, c, g, ld)

    if cfg.n_flow % 2:
        ld, mx, sq, hq = zero, zero, zero, zero
        for i in range(cfg.n_flow):
            def step(x, c, g, fp=_index(p["flows"], i)):
                return _flow_step_fwd(cfg, fp, x, c, g)

            if do_remat:
                x, c, g, ld_i, st = checkpoint(step, x, c, g,
                                               use_reentrant=False)
            else:
                x, c, g, ld_i, st = step(x, c, g)
            ld = ld + ld_i
            mx, sq, hq = torch.maximum(mx, st[0]), sq + st[1], hq + st[2]
        return out(x, c, g, ld, (mx, sq, hq))

    u, v = (h.contiguous() for h in torch.chunk(x, 2, dim=2))
    c_a, c_b = (h.contiguous() for h in torch.chunk(c, 2, dim=2))
    g_a, g_b = _halves(g)
    pp = _pair_params(p)
    n_pair = cfg.n_flow // 2
    route = _forward_route(cfg, c_a.shape[-1], has_g)

    def cat_out(u, v, ld, st):
        return out(torch.cat([u, v], dim=2), c, g, ld, st)

    def an_logdets(pair):
        return (_an_logdet(_index(pair, 0)["actnorm"])
                + _an_logdet(_index(pair, 1)["actnorm"]))

    B, T_lvl, r_in = u.shape
    if route is not None:
        _whole_cond(p["flows"], c_a.shape[-1], route)
    if route == "train":
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
        return cat_out(u, v, ld, (mx, sq, hq))
    if route == "fwd":
        # the forward pair: log_s never materializes whole, so the block's
        # statistics read 0 (loss_fn refuses the guards on this route)
        ld, raw = zero, zero
        for i in range(n_pair):
            pair = _index(pp, i)
            u, v, s = _pair_fwd_fused(pair, u, v, c_a, c_b)
            raw = raw + s
            ld = ld + an_logdets(pair)
        ld = ld + raw / (B * T_lvl * r_in) / 2.0
        return cat_out(u, v, ld, (zero, zero, zero))
    ld, mx, sq, hq = zero, zero, zero, zero
    for i in range(n_pair):
        def step(u, v, pair=_index(pp, i)):
            return _pair_step_fwd(cfg, pair, u, v, c_a, c_b, g_a, g_b)

        if do_remat:
            u, v, ld_i, st = checkpoint(step, u, v, use_reentrant=False)
        else:
            u, v, ld_i, st = step(u, v)
        ld = ld + ld_i
        mx, sq, hq = torch.maximum(mx, st[0]), sq + st[1], hq + st[2]
    return cat_out(u, v, ld, (mx, sq, hq))


def block_ddi(p: dict, cfg: ModelConfig, x, c, g=None):
    """DDI through one block: each flow's ActNorm is set from the
    statistics of its own input.  Returns (x, c, g, new block params)."""
    x, c = squeeze(x), squeeze(c)
    g = squeeze(g) if g is not None else None
    ans = []
    for i in range(cfg.n_flow):
        x, c, g, an = _flow_step_ddi(cfg, _index(p["flows"], i), x, c, g)
        ans.append(an)
    new_an = tree_map(lambda *xs: torch.stack(xs), *ans)
    return x, c, g, {"flows": {**p["flows"], "actnorm": new_an}}


def forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
            c: torch.Tensor, g=None, compute_dtype=torch.float32,
            return_stats: bool = False):
    """NLL forward pass.  x: [B, T, 1] audio; c: [B, T/hop, num_mels] mel;
    g: [B] speaker ids.  Returns fp32 (log_p, logdet) in nats/dim; with
    ``return_stats`` also a dict of per-block logdets, max|log_s|, mean
    log_s^2 and the hinge sum normalized like the logdet."""
    _check_shapes(cfg, x, c)
    x = x.to(compute_dtype)
    c, g_emb = _prepare_cond(params, cfg, c, g, compute_dtype)
    zero = torch.zeros((), device=x.device)
    logdet, max_ls, sumsq_ls, hinge_ls = zero, zero, zero, zero
    nel = x.numel()
    block_lds = []
    n_ls = 0
    out = x
    rb = cfg.remat_blocks
    for bi, bp in enumerate(params["blocks"]):
        bl_remat = cfg.remat and (rb < 0 or bi < rb)
        out, c, g_emb, ld, st = block_forward(bp, cfg, out, c, g_emb,
                                              return_stats=True,
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
        g=None, compute_dtype=torch.float32) -> dict:
    """Data-dependent ActNorm initialization over one batch; returns the
    params with every ActNorm replaced."""
    _check_shapes(cfg, x, c)
    out = x.to(compute_dtype)
    c, g_emb = _prepare_cond(params, cfg, c, g, compute_dtype)
    new_blocks = []
    for bp in params["blocks"]:
        out, c, g_emb, new_bp = block_ddi(bp, cfg, out, c, g_emb)
        new_blocks.append(new_bp)
    return {**params, "blocks": new_blocks}


def loss_fn(params: dict, cfg: ModelConfig, x, c, g=None,
            compute_dtype=torch.float32, logs_l2: float = 0.0,
            logs_hinge: float = 0.0):
    """NLL = -(log_p + logdet) in nats/dim, plus the optional log_s guards
    (``logs_l2`` * mean log_s^2, ``logs_hinge`` * the hinge).  Returns
    (total, aux); aux["loss"] is the pure NLL."""
    log_p, logdet, stats = forward(params, cfg, x, c, g, compute_dtype,
                                   return_stats=True)
    loss = -(log_p + logdet)
    aux = {"loss": loss, "log_p": log_p, "logdet": logdet,
           "bits_per_dim": loss / math.log(2.0), **stats}
    total = loss
    if logs_l2 > 0.0 or logs_hinge > 0.0:
        if PAIR_KERNEL_FWD and _pair_kernel_eligible(cfg, g is not None):
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
