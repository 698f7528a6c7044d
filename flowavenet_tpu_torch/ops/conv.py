"""Convolution primitives for the flow model (twin of
``flowavenet_tpu/ops/conv.py``).

Channels-last at every public function: activations ``[B, T, C]``, 1-D
kernels ``[K, Cin, Cout]`` (the TF/JAX layout, so checkpoints carry over
unchanged).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_WN_EPS = 1e-12  # tf.nn.l2_normalize epsilon


def _tf_fans(shape) -> tuple[int, int]:
    """TF keras ``_compute_fans`` semantics."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive


def he_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """TF he_uniform in fp32, drawn on the generator's device."""
    fan_in, _ = _tf_fans(shape)
    limit = math.sqrt(6.0 / fan_in)
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                   device=gen.device)
    return u * (2.0 * limit) - limit


def init_wn_conv1d(gen: torch.Generator, in_ch: int, out_ch: int,
                   kernel_size: int) -> dict:
    """Weight-normalized conv params: raw kernel ``v`` [K, Cin, Cout], gain
    ``g`` (init 1) and he_uniform bias ``b``."""
    return {"v": he_uniform(gen, (kernel_size, in_ch, out_ch)),
            "g": torch.ones(out_ch, device=gen.device),
            "b": he_uniform(gen, (out_ch,))}


def wn_kernel(p: dict) -> torch.Tensor:
    """Effective weight-normalized kernel, computed in fp32: l2 over axes
    [0, 1] with eps 1e-12, times g."""
    v = p["v"].float()
    sq = torch.sum(v * v, dim=(0, 1), keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=_WN_EPS)) * p["g"].float()


def dilated_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], dilation: int = 1,
                   causal: bool = False) -> torch.Tensor:
    """Non-causal dilated conv with symmetric zero padding d*(k-1)//2,
    accumulated in fp32 and cast back to x.dtype (on the GPU an fp32 conv
    follows ``torch.backends.cudnn.allow_tf32``)."""
    if causal:
        raise NotImplementedError(
            "causal convs are not ported yet "
            "(flowavenet_tpu/ops/conv.py:dilated_conv1d, causal=True)")
    k = kernel.shape[0]
    pad = dilation * (k - 1) // 2
    w = kernel.to(x.dtype).permute(2, 1, 0)             # [Cout, Cin, K]
    out = F.conv1d(x.transpose(1, 2), w, padding=pad, dilation=dilation)
    out = out.transpose(1, 2)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def wn_conv1d(x: torch.Tensor, p: dict, dilation: int = 1,
              causal: bool = False) -> torch.Tensor:
    return dilated_conv1d(x, wn_kernel(p), p["b"], dilation, causal)


def conv1x1(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """1x1 conv as a matmul. kernel ``[1, Cin, Cout]`` or ``[Cin, Cout]``."""
    w = kernel[0] if kernel.dim() == 3 else kernel
    out = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def quantize_act(x: torch.Tensor, per_row: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-abs int8 activation quantization: (q, fp32 scale).
    ``per_row=True`` ([B, T, C] input) gives one scale per batch row
    ([B, 1, 1]), so a row's codes never depend on its batch companions."""
    xf = x.float()
    amax = (torch.amax(xf.abs(), dim=(1, 2), keepdim=True) if per_row
            else torch.amax(xf.abs()))
    scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def conv1x1_int8(x_q: torch.Tensor, x_scale: torch.Tensor,
                 kernel: torch.Tensor, bias: Optional[torch.Tensor],
                 out_dtype) -> torch.Tensor:
    """1x1 conv with int8 operands and int32 accumulation.

    ``x_q``/``x_scale`` come from :func:`quantize_act`; ``kernel`` is
    quantized here with per-out-channel max-abs scales.  The product is
    ``torch._int_mm`` (cuBLASLt on the GPU), which takes M > 16 and K, N
    multiples of 8; other shapes raise."""
    w = (kernel[0] if kernel.dim() == 3 else kernel).float()
    w_scale = torch.clamp(torch.amax(w.abs(), dim=0), min=1e-30) * (
        1.0 / 127.0)
    w_q = torch.clamp(torch.round(w / w_scale[None, :]), -127.0, 127.0
                      ).to(torch.int8)
    B, T, K = x_q.shape
    N = w_q.shape[1]
    if B * T <= 16 or K % 8 or N % 8:
        raise ValueError(
            f"conv1x1_int8 takes M > 16 and K, N multiples of 8; got "
            f"M={B * T}, K={K}, N={N}")
    # column-major B operand: [N, K] contiguous, passed transposed
    acc = torch._int_mm(x_q.reshape(B * T, K), w_q.t().contiguous().t())
    acc = acc.reshape(B, T, N)
    out = (acc.float() * x_scale.float() * w_scale[None, None, :]
           ).to(out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


def init_zero_conv1d(in_ch: int, out_ch: int, device=None) -> dict:
    return {"w": torch.zeros(1, in_ch, out_ch, device=device),
            "b": torch.zeros(out_ch, device=device),
            "scale": torch.zeros(out_ch, device=device)}


def zero_conv1d(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Zero-init 1x1 conv scaled by exp(3*scale) (scale cast to x.dtype
    first, as the JAX package does)."""
    out = conv1x1(x, p["w"], p["b"])
    return out * torch.exp(p["scale"].to(x.dtype) * 3.0)
