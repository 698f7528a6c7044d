"""WaveNet coupling network (twin of ``flowavenet_tpu/models/modules.py``).

Filter and gate convs are fused into one conv with 2R output channels, as
are the conditioning 1x1s.  Parameter tree of one net (a leading flow axis
is added by the block):

    front:      wn conv  [3, in, R]
    layers[i]:  filter, gate:     wn conv [3, R, R]
                filter_c, gate_c: wn 1x1  [1, Cc, R]
                res, skip:        wn 1x1  [1, R, R]
    final:      wn 1x1  [1, R, R]
    zero:       zero-init 1x1 [1, R, out] + per-channel scale
"""

from __future__ import annotations

import math

import torch

from ..ops.conv import (conv1x1, conv1x1_int8, dilated_conv1d,
                        init_wn_conv1d, init_zero_conv1d, wn_conv1d,
                        wn_kernel, zero_conv1d)

SQRT_HALF = math.sqrt(0.5)


def init_wavenet(gen: torch.Generator, in_channels: int, out_channels: int,
                 num_layers: int, residual_channels: int, cin_channels: int,
                 kernel_size: int = 3) -> dict:
    r = residual_channels
    params: dict = {
        "front": init_wn_conv1d(gen, in_channels, r, kernel_size),
        "layers": [],
        "final": init_wn_conv1d(gen, r, r, 1),
        "zero": init_zero_conv1d(r, out_channels, gen.device),
    }
    for _ in range(num_layers):
        params["layers"].append({
            "filter": init_wn_conv1d(gen, r, r, kernel_size),
            "gate": init_wn_conv1d(gen, r, r, kernel_size),
            "filter_c": init_wn_conv1d(gen, cin_channels, r, 1),
            "gate_c": init_wn_conv1d(gen, cin_channels, r, 1),
            "res": init_wn_conv1d(gen, r, r, 1),
            "skip": init_wn_conv1d(gen, r, r, 1),
        })
    return params


def _fused_fg_kernel(pf: dict, pg: dict):
    k = torch.cat([wn_kernel(pf), wn_kernel(pg)], dim=-1)
    b = torch.cat([pf["b"], pg["b"]], dim=-1)
    return k, b


def _cond_fg(c, layer: dict, conv_bias: torch.Tensor, out_dtype
             ) -> torch.Tensor:
    """Conditioning pre-activations plus ``conv_bias``, one [B, T, 2R]
    tensor.  ``c`` may be a pre-quantized ``(q_int8, fp32_scale)`` pair:
    the 1x1 then runs on int8 operands (the deep-block int8 route)."""
    kc, bc = _fused_fg_kernel(layer["filter_c"], layer["gate_c"])
    if isinstance(c, tuple):
        c_q, c_scale = c
        return conv1x1_int8(c_q, c_scale, kc,
                            bc + conv_bias.to(bc.dtype), out_dtype)
    return conv1x1(c, kc, bc + conv_bias.to(bc.dtype))


def _res_layer(h: torch.Tensor, c, layer: dict, dilation: int,
               need_residual: bool = True):
    """One gated residual unit: returns (residual_out or None, skip)."""
    r = layer["res"]["b"].shape[0]
    k, b = _fused_fg_kernel(layer["filter"], layer["gate"])
    fg = dilated_conv1d(h, k, b, dilation=dilation)
    fg = fg + _cond_fg(c, layer, torch.zeros_like(b), out_dtype=h.dtype)
    out = torch.tanh(fg[..., :r]) * torch.sigmoid(fg[..., r:])
    skip = conv1x1(out, wn_kernel(layer["skip"]), layer["skip"]["b"])
    if not need_residual:
        return None, skip
    res = conv1x1(out, wn_kernel(layer["res"]), layer["res"]["b"])
    # the constant is rounded to h's dtype first, as in the JAX package
    return (h + res) * torch.tensor(SQRT_HALF, dtype=h.dtype), skip


def apply_wavenet(params: dict, x: torch.Tensor, c,
                  kernel_size: int = 3) -> torch.Tensor:
    """Coupling net: x [B, T, in] half-tensor, c [B, T, Cc] half-condition
    (or its int8 ``(q, scale)`` pair).  Returns [B, T, out] (log_s || t)."""
    h = torch.relu(wn_conv1d(x, params["front"], dilation=1))
    skip_sum = None
    n_layers = len(params["layers"])
    for n, layer in enumerate(params["layers"]):
        h, s = _res_layer(h, c, layer, dilation=kernel_size ** n,
                          need_residual=n + 1 < n_layers)
        skip_sum = s if skip_sum is None else skip_sum + s
    out = torch.relu(skip_sum)
    out = torch.relu(conv1x1(out, wn_kernel(params["final"]),
                             params["final"]["b"]))
    return zero_conv1d(out, params["zero"])
