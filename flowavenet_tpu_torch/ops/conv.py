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

from ..utils.profiling import count, span

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


def wn_kernel(p: dict, group=None) -> torch.Tensor:
    """Effective weight-normalized kernel, computed in fp32: l2 over axes
    [0, 1] with eps 1e-12, times g.  ``group``: ``v`` is this rank's Cin
    shard of a tensor-parallel kernel (``parallel/tp.py``); the sum of
    squares runs over every shard of the model group, and the replicated
    scale and gain enter the shard's product through ``copy_to_model``."""
    with span("fwn.fold.wn"):
        v = p["v"].float()
        sq = torch.sum(v * v, dim=(0, 1), keepdim=True)
        if group is None:
            return (v * torch.rsqrt(torch.clamp(sq, min=_WN_EPS))
                    * p["g"].float())
        from ..parallel.tp import copy_to_model, reduce_from_model
        r = torch.rsqrt(torch.clamp(reduce_from_model(sq, group),
                                    min=_WN_EPS))
        return (v * copy_to_model(r, group)
                * copy_to_model(p["g"].float(), group))


def dilated_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], dilation: int = 1,
                   causal: bool = False, per_row: bool = False
                   ) -> torch.Tensor:
    """Dilated conv of x [B, T, Cin] with kernel [K, Cin, Cout] as one GEMM
    over its taps, [B*T, K*Cin] x [K*Cin, Cout], in x.dtype (on the GPU an
    fp32 product follows ``torch.backends.cuda.matmul.allow_tf32``).
    Non-causal: symmetric zero padding d*(k-1)//2 (odd kernels).  Causal:
    a left pad of d*(k-1), the reference's pad-both-sides-then-crop in one
    step.  Not cuDNN: cuDNN picks a conv's algorithm by the batch size, so
    a synthesized row's bits would follow its batch companions.  cuBLAS
    kept a GEMM row's bits at the widths of the coupling nets' layer convs
    at every batch size measured, but not at a front conv's short K
    (PERF.md §6): ``per_row`` runs one GEMM per row of x, whose bits then
    never depend on the other rows."""
    k = kernel.shape[0]
    left = dilation * (k - 1) if causal else dilation * (k - 1) // 2
    xp = F.pad(x, (0, 0, left, dilation * (k - 1) - left))
    T = x.shape[1]
    taps = torch.cat([xp[:, j * dilation: j * dilation + T]
                      for j in range(k)], dim=-1)     # [B, T, K*Cin]
    return conv1x1(taps, kernel.reshape(-1, kernel.shape[-1]), bias,
                   per_row)


def wn_conv1d(x: torch.Tensor, p: dict, dilation: int = 1,
              causal: bool = False, per_row: bool = False) -> torch.Tensor:
    return dilated_conv1d(x, wn_kernel(p), p["b"], dilation, causal,
                          per_row)


def conv1x1(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor], per_row: bool = False
            ) -> torch.Tensor:
    """1x1 conv as a matmul. kernel ``[1, Cin, Cout]`` or ``[Cin, Cout]``.
    ``per_row``: one matmul per row of x [B, T, Cin], so that a row's bits
    never depend on its batch companions: at some shapes (a long K, a
    short one) cuBLAS picks the kernel, and with it the order of the sums,
    by the number of rows (measured: PERF.md §6)."""
    w = (kernel[0] if kernel.dim() == 3 else kernel).to(x.dtype)
    if per_row and x.shape[0] > 1:
        B = x.shape[0]
        with span("fwn.conv.per_row", rows=B):
            out = torch.cat([torch.matmul(x[b:b + 1], w) for b in range(B)])
        count("fwn.conv.matmuls", B)
    else:
        out = torch.matmul(x, w)
        count("fwn.conv.matmuls")
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
    multiples of 8: other shapes run padded with zero rows (M up to 17)
    and zero columns (K and N up to multiples of 8), which leave the exact
    int32 sums of the real rows and columns unchanged."""
    w = (kernel[0] if kernel.dim() == 3 else kernel).float()
    w_scale = torch.clamp(torch.amax(w.abs(), dim=0), min=1e-30) * (
        1.0 / 127.0)
    w_q = torch.clamp(torch.round(w / w_scale[None, :]), -127.0, 127.0
                      ).to(torch.int8)
    B, T, K = x_q.shape
    N = w_q.shape[1]
    M = B * T
    x2 = x_q.reshape(M, K)
    pk, pn = -K % 8, -N % 8
    if M <= 16 or pk:
        x2 = F.pad(x2, (0, pk, 0, max(0, 17 - M)))
    if pk or pn:
        w_q = F.pad(w_q, (0, pn, 0, pk))
    # column-major B operand: [N, K] contiguous, passed transposed
    acc = torch._int_mm(x2, w_q.t().contiguous().t())
    count("fwn.conv.matmuls")
    acc = acc[:M, :N].reshape(B, T, N)
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
