"""The training corpus: seeded speech-like utterances, their mels through a
copy of the frontend's numpy recipe (STFT power, Slaney mel filterbank, dB
and clip to [0, 1]), written in the measured package's record format, and
the crops its loader takes at a step, worked out again for the reference.

Record format (``name.fwrec`` + ``name.fwidx.npy``): the magic
``FWRECv1\\0``, then per record four little-endian int64 (audio length, mel
frames, mel bins, speaker id), the float32 audio and the float32 mel; the
index holds each record's byte offset as uint64.
"""

from __future__ import annotations

import numpy as np

MAGIC = b"FWRECv1\0"


# ---------------------------------------------------------------------------
# Frontend (librosa's defaults without librosa)
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    f_sp, min_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_hz,
                    min_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp, min_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_hz / f_sp,
                    min_hz * np.exp(logstep * (m - min_hz / f_sp)), m * f_sp)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def process_wav(wav: np.ndarray, audio: dict):
    """(audio [frames * hop], normalized mel [frames, mels]) of a waveform,
    peak-normalized to ``rescaling_max``."""
    n_fft, hop = audio["n_fft"], audio["hop_size"]
    wav = wav / np.abs(wav).max() * audio["rescaling_max"]
    y = np.pad(wav.astype(np.float32), (n_fft // 2, n_fft // 2),
               mode="reflect")
    n = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
           ).astype(np.float32)
    spec = np.fft.rfft(y[idx] * win, n=n_fft, axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    fb = mel_filterbank(audio["sample_rate"], n_fft, audio["num_mels"],
                        audio["fmin"], audio["fmax"])
    m = 20.0 * np.log10(np.maximum(1e-4, power @ fb.T)) - audio["ref_level_db"]
    mel = np.clip((m - audio["min_level_db"]) / -audio["min_level_db"],
                  0.0, 1.0).astype(np.float32)
    pad = (len(wav) // hop + 1) * hop - len(wav)
    out = np.pad(wav, (pad // 2, pad // 2 + pad % 2))[: n * hop]
    return out.astype(np.float32), mel


def speech_wav(gen: np.random.Generator, seconds: float, sr: int
               ) -> np.ndarray:
    """A speech-like utterance: phrases of harmonics on a gliding f0 under
    a syllable envelope, with breath noise, separated by pauses and led and
    trailed by silence, as read speech is (room noise 40 dB down)."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = gen.uniform(90, 220) * (1 + 0.25 * np.sin(
        2 * np.pi * gen.uniform(0.3, 1.2) * t + gen.uniform(0, 6.3)))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum((0.6 ** k) * np.sin((k + 1) * phase) for k in range(10))
    env = np.clip(np.sin(2 * np.pi * gen.uniform(2.5, 4.5) * t
                         + gen.uniform(0, 6.3)) + 0.4, 0, None)
    speech = np.zeros(n, bool)
    lead, trail = gen.uniform(0.05, 0.3, 2)
    a, end = int(lead * sr), n - int(trail * sr)
    while a < end:
        b = min(end, a + int(gen.uniform(0.8, 2.5) * sr))
        speech[a:b] = True
        a = b + int(gen.uniform(0.15, 0.5) * sr)
    wav = np.where(speech, 0.3 * voiced * env + 0.02 * gen.standard_normal(n),
                   0.003 * gen.standard_normal(n))
    return wav.astype(np.float32)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

def write_records(path: str, utterances) -> None:
    """Write (audio, mel, speaker) triples as ``path`` and its index."""
    offsets, pos = [], len(MAGIC)
    with open(path, "wb") as f:
        f.write(MAGIC)
        for audio, mel, sid in utterances:
            audio = np.ascontiguousarray(audio, np.float32)
            mel = np.ascontiguousarray(mel, np.float32)
            offsets.append(pos)
            f.write(np.array([audio.size, mel.shape[0], mel.shape[1], sid],
                             "<i8").tobytes())
            f.write(audio.tobytes())
            f.write(mel.tobytes())
            pos += 32 + audio.nbytes + mel.nbytes
    base = path[: -len(".fwrec")] if path.endswith(".fwrec") else path
    np.save(base + ".fwidx.npy", np.asarray(offsets, np.uint64))


def crop_batch(utts: list, step: int, seed: int, batch: int, crop: int,
               hop: int) -> dict:
    """The batch the loader takes at ``step``: rows drawn by a Philox keyed
    (seed, step), each a random mel-aligned crop (short clips padded)."""
    gen = np.random.Generator(np.random.Philox(key=[seed, step]))
    frames = crop // hop
    idx = gen.integers(0, len(utts), size=batch)
    audio = np.zeros((batch, frames * hop), np.float32)
    mel = np.zeros((batch, frames, utts[0][1].shape[1]), np.float32)
    spk = np.zeros((batch,), np.int64)
    for b, i in enumerate(idx):
        a, m, s = utts[int(i)]
        avail = m.shape[0] - frames
        if avail > 0:
            start = int(gen.integers(0, avail))
            audio[b] = a[start * hop: (start + frames) * hop]
            mel[b] = m[start: start + frames]
        else:
            f = min(m.shape[0], frames)
            mel[b, :f] = m[:f]
            t = min(len(a), f * hop)
            audio[b, :t] = a[:t]
        spk[b] = s
    return {"audio": audio, "mel": mel, "speaker": spk}
