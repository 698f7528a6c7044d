"""The general traffic generator: every cell's inputs come from here, from
its traffic file's parameters and the run's seed.

Sizes and arrivals do not depend on the seed, only their order does: a
length distribution becomes the fixed set of its quantiles at (i + 0.5) / n
and an arrival process the fixed set of its gaps' quantiles, and the seed
shuffles them.  So every seed offers the same work and two runs differ in
content (mels, noise seeds, speakers, the order of sizes), not in amount.
"""

from __future__ import annotations

import io
import math

import numpy as np
from scipy.special import ndtri

MEL_POOL_FRAMES = 1 << 17


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of the run."""
    return np.random.Generator(np.random.Philox(key=[int(seed) % 2 ** 64,
                                                     *stream][:2]))


def length_quantiles(spec: dict, n: int) -> np.ndarray:
    """Seconds: the n quantiles at (i + 0.5) / n of a normal of mean
    ``mean_s`` and sd ``sd_s`` truncated to [``min_s``, ``max_s``] (mass
    outside the range sits on its ends, as clipped draws would)."""
    if spec.get("dist", "normal") != "normal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    q = (np.arange(n) + 0.5) / n
    x = spec["mean_s"] + spec["sd_s"] * ndtri(q)
    return np.clip(x, spec["min_s"], spec["max_s"])


def frames_of(seconds: np.ndarray, sample_rate: int, hop: int) -> np.ndarray:
    return np.maximum(1, np.rint(seconds * sample_rate / hop)).astype(int)


def shuffled(values: np.ndarray, gen: np.random.Generator) -> np.ndarray:
    return values[gen.permutation(len(values))]


def arrivals(rate: float, seconds: float, gen: np.random.Generator
             ) -> np.ndarray:
    """Due times in [0, seconds) of round(rate * seconds) Poisson arrivals:
    the exponential gaps' quantiles, shuffled, scaled to span the window."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = shuffled(-np.log1p(-q), gen)
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return t * (seconds / gaps.sum())


def mel_pool(seed: int, num_mels: int) -> np.ndarray:
    """Mel frames in the frontend's normalized range [0, 1): a pool that
    each utterance reads a stretch of (the content does not change the
    work, so it is drawn once)."""
    return rng(seed, 1).random((MEL_POOL_FRAMES, num_mels), dtype=np.float32)


def mel_at(pool: np.ndarray, offset: int, frames: int) -> np.ndarray:
    start = int(offset) % (len(pool) - frames)
    return pool[start: start + frames]


def npy_bytes(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(a, np.float32), allow_pickle=False)
    return buf.getvalue()


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def padded_frames(frames: int, bucket: int, hop: int, squeeze: int) -> int:
    """A batch's padded length: its longest row rounded up to ``bucket``
    frames, then to audio divisible by the squeeze factor."""
    pad = ceil_div(frames, bucket) * bucket if bucket > 1 else frames
    while (pad * hop) % squeeze:
        pad += 1
    return pad


def usable_frames(frames: int, hop: int, squeeze: int) -> int:
    """The longest prefix whose audio the squeeze factor divides."""
    while frames > 0 and (frames * hop) % squeeze:
        frames -= 1
    return frames


def percentile(values, q: float) -> float:
    """The q-th percentile (nearest rank) of values, where +inf stands for
    a request that never completed."""
    v = sorted(values)
    if not v:
        return math.nan
    k = max(0, math.ceil(q / 100.0 * len(v)) - 1)
    return float(v[k])
