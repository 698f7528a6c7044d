"""WAV I/O with the stdlib ``wave`` module and numpy (a jax-free copy of
``flowavenet_tpu/audio/wavio.py``), and scipy's polyphase resampler."""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Load a PCM WAV as mono float32 in [-1, 1] plus its sample rate."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] as 16-bit PCM WAV (x32768, clipped)."""
    data = np.asarray(data, dtype=np.float32).reshape(-1)
    pcm = np.clip(np.rint(data * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling with scipy (librosa.load resamples on a
    mismatch)."""
    if orig_sr == target_sr:
        return y
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(path: str, target_sr: int) -> np.ndarray:
    """librosa.load equivalent: mono float32 at ``target_sr``."""
    y, sr = read_wav(path)
    return resample(y, sr, target_sr)
