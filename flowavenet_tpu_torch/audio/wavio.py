"""WAV output with the stdlib ``wave`` module (copy of ``write_wav`` from
``flowavenet_tpu/audio/wavio.py``)."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM WAV (x32768, clipped)."""
    data = np.asarray(data, dtype=np.float32).reshape(-1)
    pcm = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
