"""On-device noise that reproduces ``jax.random``'s stream (threefry2x32 with
``jax_threefry_partitionable`` on, the JAX package's setting), so the port's
device-noise paths draw the same z as the JAX package's for a given seed:

* per row, ``normal(PRNGKey(seed), (T,)) * temp``
  (``flowavenet_tpu/synthesis/synthesize.py:_jitted_reverse_devnoise``);
* per absolute mel frame f, ``normal(fold_in(PRNGKey(seed), f), (hop,)) *
  temp`` (``_jitted_reverse_posnoise``), which makes the noise of a frame
  independent of the window that computes it.

Elementwise integer work in plain torch ops, on whatever device the caller
names; uint32 words are held in int64 tensors.  Nothing here copies from
pageable host memory to the card (such a copy waits for the stream), so
drawing noise never waits for the work queued before it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import upload

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# uniform's open lower bound nextafter(-1, 0) and sqrt(2), both as float32
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_SCALE = float(np.float32(1.0) - np.float32(_LO))     # maxval - minval
# XLA's single-precision erf_inv (Giles), highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), elementwise over
    broadcastable int64 tensors holding uint32 words; returns (y0, y1)."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for uint32 seeds: the key words (0,
    seed), as int64 tensors of the seed's shape."""
    s = upload(seed, torch.int64, device) & _M32
    return torch.zeros_like(s), s


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: threefry of the count (0, data)."""
    k0, k1 = key
    d = upload(data, torch.int64, k0.device) & _M32
    return threefry2x32(k0, k1, torch.zeros_like(d), d)


def random_bits(key, n: int):
    """32-bit random words of ``jax.random.bits(key, (.., n))``, one key per
    leading element: key words [...] -> bits [..., n]."""
    k0, k1 = key
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(i),
                          i)
    return y0 ^ y1


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: Giles' polynomial in w = -log1p(-x^2)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.full_like(x, _ERFINV_LT5[i]).where(lt, _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.inf, out)


def normal(key, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (.., n), float32)``: bits -> uniform in
    (nextafter(-1, 0), 1) -> sqrt(2) * erf_inv."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * _SCALE + _LO, _LO)
    return _SQRT2 * _erfinv(u)


def row_noise(seeds, temps, n: int, device=None) -> torch.Tensor:
    """z [rows, n, 1] of the serving path: row i is
    ``normal(PRNGKey(seeds[i]), (n,)) * temps[i]``."""
    key = prng_key(seeds, device)
    t = upload(temps, torch.float32, key[0].device)
    return (normal(key, n) * t[:, None])[..., None]


def frame_noise(seed: int, w0s, temps, frames: int, hop: int,
                device=None) -> torch.Tensor:
    """z [rows, frames*hop, 1] of positional noise: the hop samples of
    absolute frame w0s[i] + j are ``normal(fold_in(PRNGKey(seed), w0s[i] +
    j), (hop,)) * temps[i]``."""
    k = prng_key(seed, device)
    w0 = upload(w0s, torch.int64, k[0].device)
    f = w0[:, None] + torch.arange(frames, device=w0.device)
    key = fold_in((k[0].expand_as(f), k[1].expand_as(f)), f)
    t = upload(temps, torch.float32, w0.device)
    z = normal(key, hop) * t[:, None, None]
    return z.reshape(len(w0), frames * hop, 1)
