"""Mel-spectrogram frontend, the conditioning contract (twin of
``flowavenet_tpu/audio/mel.py``; a jax-free copy of its numpy pipeline).

The reference's librosa pipeline without librosa:

* STFT: n_fft window, hop, periodic Hann, center=True with reflect padding
  (librosa.stft defaults), power spectrogram |.|^2.
* Mel filterbank: Slaney-scale triangles with Slaney area normalization
  (librosa.filters.mel defaults: htk=False, norm='slaney').
* dB + clip normalization to [0,1] — synthesis inputs must match this
  exact normalization.
* Audio pad/trim so len(audio) == n_frames * hop.

Two implementations with the same semantics:
* numpy (host, offline preprocessing; bit-identical to the JAX package's),
* ``mel_spectrogram_torch`` on tensors of any device (within 2e-4 of the
  numpy one: fp32 FFT differences).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AudioConfig

# ---------------------------------------------------------------------------
# Slaney mel scale (librosa.core.convert + librosa.filters.mel, htk=False)
# ---------------------------------------------------------------------------

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    mel = np.where(log_region,
                   _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ)
                   / _LOGSTEP,
                   mel)
    return mel


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * _F_SP
    log_region = m >= _MIN_LOG_MEL
    return np.where(log_region,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] Slaney-normalized triangular filters."""
    fftfreqs = np.linspace(0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def hann_window(n: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann, librosa/scipy default."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# numpy pipeline (offline preprocessing)
# ---------------------------------------------------------------------------

def stft_power(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Power spectrogram [n_frames, 1 + n_fft//2]; center=True reflect pad."""
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * hann_window(n_fft)[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2).astype(np.float32)


def mel_spectrogram(y: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Raw (un-normalized) mel power spectrogram [n_frames, num_mels]."""
    S = stft_power(y.astype(np.float32), cfg.n_fft, cfg.hop_size)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels,
                        cfg.fmin, cfg.fmax)
    return S @ fb.T


def normalize_mel(m: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """dB + clip normalization to [0,1] (preprocessing.py:68-69)."""
    m = 20.0 * np.log10(np.maximum(1e-4, m)) - cfg.ref_level_db
    return np.clip((m - cfg.min_level_db) / (-cfg.min_level_db), 0.0, 1.0
                   ).astype(np.float32)


def process_wav(wav: np.ndarray, cfg: AudioConfig
                ) -> tuple[np.ndarray, np.ndarray]:
    """Full utterance processing (preprocessing.py:50-86): peak-normalize,
    mel, normalize, pad/trim audio to exactly n_frames*hop samples.

    Returns (audio [T], mel [T//hop, num_mels]).
    """
    peak = np.abs(wav).max()
    if peak > 0:
        wav = wav / peak * cfg.rescaling_max
    mel = normalize_mel(mel_spectrogram(wav, cfg), cfg)

    pad = (len(wav) // cfg.hop_size + 1) * cfg.hop_size - len(wav)
    out = np.pad(wav, (pad // 2, pad // 2 + pad % 2), mode="constant")
    n = mel.shape[0]
    assert len(out) >= n * cfg.hop_size
    out = out[: n * cfg.hop_size]
    return out.astype(np.float32), mel


# ---------------------------------------------------------------------------
# torch pipeline (on-device feature extraction)
# ---------------------------------------------------------------------------

def mel_spectrogram_torch(y: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Normalized mel of a batch [B, T] -> [B, 1 + T // hop, num_mels] on
    ``y``'s device, in fp32: the numpy pipeline's ``normalize_mel(
    mel_spectrogram(y))`` row by row (the JAX package's
    ``mel_spectrogram_jax``)."""
    n_fft, hop = cfg.n_fft, cfg.hop_size
    pad = n_fft // 2
    y = F.pad(y.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + (y.shape[1] - n_fft) // hop
    win = torch.from_numpy(hann_window(n_fft)).to(y.device)
    frames = y.unfold(1, n_fft, hop)[:, :n_frames] * win
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, n_fft, cfg.num_mels,
                                         cfg.fmin, cfg.fmax)).to(y.device)
    m = torch.einsum("bfk,mk->bfm", power, fb)
    m = 20.0 * torch.log10(torch.clamp(m, min=1e-4)) - cfg.ref_level_db
    return torch.clamp((m - cfg.min_level_db) / (-cfg.min_level_db), 0.0, 1.0)
