"""WaveNet coupling network (twin of ``flowavenet_tpu/models/modules.py``).

Filter and gate convs are fused into one conv with 2R output channels, as
are the conditioning 1x1s.  Parameter tree of one net (a leading flow axis
is added by the block):

    front:      wn conv  [3, in, R]
    layers[i]:  filter, gate:     wn conv [3, R, R]
                filter_c, gate_c: wn 1x1  [1, Cc, R]
                filter_g, gate_g: wn 1x1  [1, Cg, R] (gin_channels > 0)
                res, skip:        wn 1x1  [1, R, R]
    final:      wn 1x1  [1, R, R]
    zero:       zero-init 1x1 [1, R, out] + per-channel scale

``use_pallas`` sends each gated layer that keeps its residual through the
fused ResBlock (``ops/resblock.py``; CUDA kernels ``resblock_v2`` without
global conditioning and Cc <= ``V2_MAX_CC``, else ``resblock``), as the
JAX package routes its Pallas ResBlocks.  The model itself never sets it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.conv import (conv1x1, conv1x1_int8, dilated_conv1d,
                        init_wn_conv1d, init_zero_conv1d, wn_conv1d,
                        wn_kernel, zero_conv1d)
from ..parallel.tp import copy_to_model, reduce_from_model, shard_of

SQRT_HALF = math.sqrt(0.5)


def init_wavenet(gen: torch.Generator, in_channels: int, out_channels: int,
                 num_layers: int, residual_channels: int, cin_channels: int,
                 gin_channels: int = 0, kernel_size: int = 3) -> dict:
    r = residual_channels
    params: dict = {
        "front": init_wn_conv1d(gen, in_channels, r, kernel_size),
        "layers": [],
        "final": init_wn_conv1d(gen, r, r, 1),
        "zero": init_zero_conv1d(r, out_channels, gen.device),
    }
    for _ in range(num_layers):
        layer = {
            "filter": init_wn_conv1d(gen, r, r, kernel_size),
            "gate": init_wn_conv1d(gen, r, r, kernel_size),
            "filter_c": init_wn_conv1d(gen, cin_channels, r, 1),
            "gate_c": init_wn_conv1d(gen, cin_channels, r, 1),
            "res": init_wn_conv1d(gen, r, r, 1),
            "skip": init_wn_conv1d(gen, r, r, 1),
        }
        if gin_channels > 0:
            layer["filter_g"] = init_wn_conv1d(gen, gin_channels, r, 1)
            layer["gate_g"] = init_wn_conv1d(gen, gin_channels, r, 1)
        params["layers"].append(layer)
    return params


def _fused_fg_kernel(pf: dict, pg: dict, group=None):
    k = torch.cat([wn_kernel(pf, group), wn_kernel(pg, group)], dim=-1)
    b = torch.cat([pf["b"], pg["b"]], dim=-1)
    return k, b


def _cond_conv(x: torch.Tensor, pf: dict, pg: dict,
               bias: Optional[torch.Tensor], per_row: bool) -> torch.Tensor:
    """The fused filter|gate conditioning 1x1 of x plus its biases (and
    ``bias``, when given).  When the kernels hold this rank's Cin shard (tensor
    parallelism, ``parallel/tp.py``), the rank multiplies its slice of x
    and the partial products are summed over the model group."""
    tp = shard_of(x.shape[-1], pf["v"].shape[-2])
    group, index = tp if tp is not None else (None, 0)
    k, b = _fused_fg_kernel(pf, pg, group)
    if bias is not None:
        b = b + bias.to(b.dtype)
    if group is None:
        return conv1x1(x, k, b, per_row)
    n = k.shape[-2]
    x = copy_to_model(x, group)[..., index * n: (index + 1) * n]
    return (reduce_from_model(conv1x1(x, k, None, per_row), group)
            + b.to(x.dtype))


def _cond_fg(c, g: Optional[torch.Tensor], layer: dict,
             conv_bias: torch.Tensor, out_dtype=None,
             per_row: bool = False) -> torch.Tensor:
    """Conditioning pre-activations plus ``conv_bias``, one [B, T, 2R]
    tensor, with the global-conditioning term when ``g`` is given.  ``c``
    may be a pre-quantized ``(q_int8, fp32_scale)`` pair: the 1x1 then runs
    on int8 operands (the deep-block int8 route, which has no g; exact
    int32 sums, so no row follows its companions).  ``per_row``: the
    compute-dtype products (K = Cc up to 10240) one row at a time."""
    if isinstance(c, tuple):
        if g is not None:
            raise ValueError("the int8 conditioning route takes no global "
                             "conditioning")
        c_q, c_scale = c
        if shard_of(c_q.shape[-1], layer["filter_c"]["v"].shape[-2]):
            raise ValueError("the int8 conditioning route takes no "
                             "tensor-parallel shard")
        kc, bc = _fused_fg_kernel(layer["filter_c"], layer["gate_c"])
        return conv1x1_int8(c_q, c_scale, kc,
                            bc + conv_bias.to(bc.dtype), out_dtype)
    fg = _cond_conv(c, layer["filter_c"], layer["gate_c"], conv_bias,
                    per_row)
    if g is not None and "filter_g" in layer:
        fg = fg + _cond_conv(g, layer["filter_g"], layer["gate_g"], None,
                             per_row)
    return fg


def _res_layer(h: torch.Tensor, c, g: Optional[torch.Tensor], layer: dict,
               dilation: int, causal: bool = False, use_pallas: bool = False,
               need_residual: bool = True, per_row: bool = False):
    """One gated residual unit: returns (residual_out or None, skip)."""
    r = layer["res"]["b"].shape[0]
    k, b = _fused_fg_kernel(layer["filter"], layer["gate"])
    if use_pallas and need_residual:
        if isinstance(c, tuple):
            raise ValueError("pre-quantized conditioning takes the plain "
                             "route (use_pallas=False)")
        if c.shape[-1] != layer["filter_c"]["v"].shape[-2]:
            raise ValueError("the fused ResBlock route takes no "
                             "tensor-parallel shard")
        from ..ops import resblock as rb
        res_w, skip_w = wn_kernel(layer["res"])[0], wn_kernel(layer["skip"])[0]
        if g is None and c.shape[-1] <= rb.V2_MAX_CC:
            # v2: the conditioning 1x1 runs inside the kernel
            kc, bc = _fused_fg_kernel(layer["filter_c"], layer["gate_c"])
            return rb.fused_gated_resblock_v2(
                h, c, k, kc[0], bc + b, res_w, layer["res"]["b"], skip_w,
                layer["skip"]["b"], dilation=dilation, causal=causal)
        return rb.fused_gated_resblock(
            h, _cond_fg(c, g, layer, b, per_row=per_row), k, res_w,
            layer["res"]["b"], skip_w, layer["skip"]["b"],
            dilation=dilation, causal=causal)
    fg = dilated_conv1d(h, k, b, dilation=dilation, causal=causal)
    fg = fg + _cond_fg(c, g, layer, torch.zeros_like(b), out_dtype=h.dtype,
                       per_row=per_row)
    out = torch.tanh(fg[..., :r]) * torch.sigmoid(fg[..., r:])
    skip = conv1x1(out, wn_kernel(layer["skip"]), layer["skip"]["b"])
    if not need_residual:
        return None, skip
    res = conv1x1(out, wn_kernel(layer["res"]), layer["res"]["b"])
    # the constant is rounded to h's dtype first, as in the JAX package
    return (h + res) * torch.tensor(SQRT_HALF, dtype=h.dtype), skip


def apply_wavenet(params: dict, x: torch.Tensor, c,
                  g: Optional[torch.Tensor] = None, *, causal: bool = False,
                  kernel_size: int = 3, use_pallas: bool = False,
                  per_row: bool = False) -> torch.Tensor:
    """Coupling net: x [B, T, in] half-tensor, c [B, T, Cc] half-condition
    (or its int8 ``(q, scale)`` pair), g [B, T, Cg] half global condition
    or None.  Returns [B, T, out] (log_s || t for affine couplings).
    ``per_row`` (synthesis) runs the front conv and the compute-dtype
    conditioning products one row at a time, so that a row's output never
    depends on its batch companions: at their shapes (the front conv's
    short K, the conditioning's long K) cuBLAS gave a row other bits
    beside companions.  Training batches them: per row they cost a step
    about a fifth more (PERF.md §6)."""
    h = torch.relu(wn_conv1d(x, params["front"], dilation=1, causal=causal,
                             per_row=per_row))
    skip_sum = None
    n_layers = len(params["layers"])
    for n, layer in enumerate(params["layers"]):
        h, s = _res_layer(h, c, g, layer, dilation=kernel_size ** n,
                          causal=causal, use_pallas=use_pallas,
                          need_residual=n + 1 < n_layers, per_row=per_row)
        skip_sum = s if skip_sum is None else skip_sum + s
    out = torch.relu(skip_sum)
    out = torch.relu(conv1x1(out, wn_kernel(params["final"]),
                             params["final"]["b"]))
    return zero_conv1d(out, params["zero"])
