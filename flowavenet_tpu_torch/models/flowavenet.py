"""FloWaveNet one-shot synthesis in PyTorch (twin of
``flowavenet_tpu/models/flowavenet.py``: ``init_flowavenet`` and
``reverse``).

Parameters are the JAX package's tree (nested dicts and lists), with
torch tensors as leaves and the flow axis of each block stacked first.

Scope of ``reverse``: affine couplings, non-causal convs, n_layer == 2,
even n_flow, no global conditioning, logs_clamp == 0 — the lj22k
synthesis path.  Anything else raises ``NotImplementedError`` naming the
JAX code path it would need.

Routes (as in the JAX package):
* ``cfg.use_pallas=False``: the plain pair-scan on every block.
* default (``FWN_INT8`` on): blocks with cc_half <= 1280 run the fused pair
  (``ops/pair_flow.py``) with int8 fg convs and conditioning; deeper blocks
  run the plain pair-scan with int8 conditioning 1x1s.
* ``FWN_INT8=0``: blocks with cc_half <= 640 run the fused pair in the
  compute dtype; deeper blocks run the plain pair-scan.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..ops import pair_flow as pf
from ..ops.conv import quantize_act
from ..ops.squeeze import squeeze_level_cond_perm, squeeze_to_level, unsqueeze
from ..utils.flags import INT8 as _INT8_FLAG
from ..utils.tree import tree_map
from .modules import apply_wavenet, init_wavenet
from .upsample import apply_upsample, init_upsample

# Live routing switch (tests flip it at runtime, like the JAX package's
# PAIR_KERNEL_INT8).
PAIR_KERNEL_INT8 = _INT8_FLAG


def _pair_max_cc() -> int:
    """Conditioning-width bound of the fused pair route: 1280 int8, 640
    otherwise (the JAX package's defaults)."""
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
            idx = torch.as_tensor(perm, device=v.device)
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
    """'int8' | 'direct' | None (the plain pair-scan), by conditioning
    width and the live int8 switch."""
    if not cfg.use_pallas or cc_half > _pair_max_cc():
        return None
    return "int8" if PAIR_KERNEL_INT8 else "direct"


def block_reverse(p: dict, cfg: ModelConfig, x: torch.Tensor, c_halves,
                  *, cond_perm=None, c_scales=None) -> torch.Tensor:
    """Inverse of one block on the squeezed x; returns x unsqueezed.

    ``c_halves=(c_a, c_b)``: the block's conditioning halves.  They are
    free reshape views of the mel halves when ``cond_perm`` is given (the
    cond weight rows are permuted to match).  On the int8 fused-pair route
    they are int8 with per-row scales ``c_scales=(s_a, s_b)`` ([B, 1, 1]
    each); on the int8 scan route they are ``(q, scale)`` pairs."""
    if cond_perm is not None:
        p = {**p, "flows": _permute_cond_rows(p["flows"], cond_perm)}
    u, v = torch.chunk(x, 2, dim=2)
    u, v = u.contiguous(), v.contiguous()
    c_a, c_b = c_halves
    cc_half = (c_a[0] if isinstance(c_a, tuple) else c_a).shape[-1]
    mode = _pair_kernel_mode(cfg, cc_half)
    pp = _pair_params(p)
    n_pair = cfg.n_flow // 2
    if mode is not None:
        int8 = mode == "int8"
        crs = None
        if int8:
            crs = torch.cat([s.float().reshape(-1, 1) for s in c_scales], 1)
        make_ops = (pf.pair_reverse_operands_int8 if int8
                    else pf.pair_reverse_operands)
        for i in reversed(range(n_pair)):
            ops = make_ops(_index(pp, i), dtype=x.dtype)
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
    block."""
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
        elif q8 is not None:
            c_halves = ((lvl(q8[0][0]), q8[0][1]), (lvl(q8[1][0]), q8[1][1]))
        else:
            c_halves = (lvl(c_lo), lvl(c_hi))
        x = block_reverse(params["blocks"][bi], cfg, x, c_halves,
                          cond_perm=squeeze_level_cond_perm(k, C0),
                          c_scales=c_scales)
    return x
