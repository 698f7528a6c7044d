"""Mel-conditioning upsampler (twin of ``flowavenet_tpu/models/upsample.py``).

For each scale ``s``: one weight-normalized ``Conv2DTranspose(filters=1,
kernel=(2s, 3), strides=(s, 1), SAME)`` over the mel as an image, then
leaky_relu(0.4).  Each scale runs as one dense phase matmul
``[B*H, D*(W+2)] x [D*(W+2), s*W]`` (the JAX package's ``dense`` form).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import he_uniform
from ..utils.device import constant

_WN_EPS = 1e-12


def init_upsample(gen: torch.Generator, scales) -> list[dict]:
    return [{"v": he_uniform(gen, (2 * s, 3, 1, 1)),  # (H, W, out, in)
             "g": torch.ones(1, device=gen.device),
             "b": torch.zeros(1, device=gen.device)} for s in scales]


def _wn_kernel_t(p: dict) -> torch.Tensor:
    v = p["v"].float()
    sq = torch.sum(v * v, dim=(0, 2), keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=_WN_EPS)) * p["g"].float()


def _subpixel_plan(kh: int, s: int):
    """Static index plan for one transposed-conv scale (TF SAME, stride s):
    per output phase p, the kernel row h that reads frame offset d."""
    pad_top = (kh - s) // 2
    taps = []
    for p in range(s):
        h0 = (p + pad_top) % s
        for h in range(h0, kh, s):
            taps.append((p, h, (p + pad_top - h) // s))
    offsets = sorted({d for _, _, d in taps})
    idx = np.full((s, len(offsets)), -1, np.int64)
    for p, h, d in taps:
        idx[p, offsets.index(d)] = h
    return offsets, idx


def _dense_upsample(x: torch.Tensor, kern: torch.Tensor, s: int
                    ) -> torch.Tensor:
    """x: [B, H, W]; kern: [kh, 3] in x.dtype.  Output [B, H*s, W]."""
    kh = kern.shape[0]
    offsets, idx = _subpixel_plan(kh, s)
    D = len(offsets)
    B, H, W = x.shape
    kpad = torch.cat([kern, kern.new_zeros(1, 3)], dim=0)
    wsub = kpad[constant(idx, kern.device)]                # [s, D, 3]
    # A[d, j, p, w] = wsub[p, d, u] where frame column j = w + 2 - u
    A = sum(torch.einsum(
        "pd,jw->djpw", wsub[:, :, u],
        constant(np.eye(W + 2, W, k=u - 2), wsub.device, wsub.dtype))
        for u in range(3))
    A2 = A.reshape(D * (W + 2), s * W).to(x.dtype)
    d_lo, d_hi = -min(offsets), max(offsets)
    xp = F.pad(x, (1, 1, d_lo, d_hi))                      # [B, H+D-1, W+2]
    frames = torch.cat([xp[:, d + d_lo:d + d_lo + H] for d in offsets],
                       dim=-1)                             # [B, H, D*(W+2)]
    return torch.matmul(frames, A2).reshape(B, H * s, W)


def apply_upsample(params: list[dict], c: torch.Tensor, scales
                   ) -> torch.Tensor:
    """c: [B, T_mel, n_mels] -> [B, T_mel * prod(scales), n_mels]."""
    dtype = c.dtype
    h = c
    for p, s in zip(params, scales):
        k2 = _wn_kernel_t(p)[:, :, 0, 0].to(dtype)         # [2s, 3]
        h = _dense_upsample(h, k2, s)
        h = h + p["b"].to(dtype)
        h = F.leaky_relu(h, 0.4)
    return h
