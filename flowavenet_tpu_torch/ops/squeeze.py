"""Squeeze / unsqueeze: trade time resolution for channels.

Bit-exact layout twin of ``flowavenet_tpu/ops/squeeze.py``: output channel
``2*c + p`` takes input ``(t = 2*t2 + p, c)``.  Tensors are ``[B, T, C]``.
"""

from __future__ import annotations

import numpy as np
import torch


def squeeze(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, T//2, 2C] with the reference's 2c+p channel layout."""
    b, t, c = x.shape
    return x.reshape(b, t // 2, 2, c).transpose(2, 3).reshape(b, t // 2,
                                                               2 * c)


def unsqueeze(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`squeeze`."""
    b, t, c2 = x.shape
    return x.reshape(b, t, c2 // 2, 2).transpose(2, 3).reshape(b, t * 2,
                                                               c2 // 2)


def squeeze_to_level(x: torch.Tensor, k: int) -> torch.Tensor:
    """``squeeze`` applied k times, as one permute: level-k channel
    ``2**k * c + bitrev_k(delta)`` takes input ``(t = 2**k * t_k + delta,
    c)``."""
    if k == 0:
        return x
    b, t, c = x.shape
    p = 1 << k
    v = x.reshape((b, t // p) + (2,) * k + (c,))
    perm = (0, 1, k + 2) + tuple(range(k + 1, 1, -1))
    return v.permute(perm).reshape(b, t // p, c * p)


def squeeze_level_cond_perm(k: int, c: int) -> np.ndarray:
    """Weight-row permutation that makes the free row-major reshape
    ``[B, T, C] -> [B, T/2**k, 2**k * C]`` equivalent to
    :func:`squeeze_to_level` for anything consumed by a 1x1 conv:

        squeeze_to_level(x, k) @ W  ==  x.reshape(B, T>>k, C<<k) @ W[perm]
    """
    if k == 0:
        return np.arange(c)
    n = 1 << k
    jmap = np.empty(n * c, np.int64)
    for delta in range(n):
        rb = int(format(delta, f"0{k}b")[::-1], 2)
        for ch in range(c):
            jmap[n * ch + rb] = delta * c + ch
    return np.argsort(jmap)


def change_order(x: torch.Tensor) -> torch.Tensor:
    """Swap channel halves between flows. Involution."""
    a, b = torch.chunk(x, 2, dim=2)
    return torch.cat([b, a], dim=2)
