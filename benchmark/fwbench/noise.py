"""The synthesis noise worked out again on the host: per row,
``jax.random.normal(PRNGKey(seed), (n,), float32) * temp`` under JAX's
partitionable Threefry-2x32, the stream the measured package draws on the
device for ``noise="device"``.

numpy uint32 arithmetic: the key of a seed is (0, seed mod 2**32); element
i takes the cipher of the counter (0, i) and the XOR of its two output
words; 23 of those bits make a float in [1, 2), mapped to the open interval
(-1, 1) and through sqrt(2) erfinv, with XLA's float32 polynomial for
erfinv (Giles).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_LOW = np.nextafter(np.float32(-1.0), np.float32(0.0))
# Giles' single-precision erfinv, in w = -log(1 - x^2): w < 5 and w >= 5
_P_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
            -4.39150654e-06, 0.00021858087, -0.00125372503,
            -0.00417768164, 0.246640727, 1.50140941)
_P_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
            -0.00367342844, 0.00573950773, -0.0076224613,
            0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, over uint32 arrays."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _erfinv32(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, np.float32(_P_SMALL[0]), np.float32(_P_LARGE[0]))
    for a, b in zip(_P_SMALL[1:], _P_LARGE[1:]):
        p = np.where(small, np.float32(a), np.float32(b)) + p * w
    return np.where(np.abs(x) == 1.0, x * np.inf, p * x).astype(np.float32)


def normal(seed: int, n: int) -> np.ndarray:
    """float32 [n]: ``jax.random.normal(PRNGKey(seed), (n,))``."""
    with np.errstate(over="ignore"):
        i = np.arange(n, dtype=np.uint32)
        y0, y1 = threefry(0, int(seed) % 2 ** 32, np.zeros_like(i), i)
    bits = y0 ^ y1
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    f = f - np.float32(1.0)
    u = np.maximum(f * (np.float32(1.0) - _LOW) + _LOW, _LOW)
    return (np.float32(np.sqrt(2.0)) * _erfinv32(u.astype(np.float32))
            ).astype(np.float32)
