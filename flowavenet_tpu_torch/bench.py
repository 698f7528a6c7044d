"""Benchmark: one-shot synthesis throughput of the port on one card (twin
of the top-level ``bench.py``).

    python -m flowavenet_tpu_torch.bench

Prints ONE JSON line on stdout:
  {"metric": "synthesis_khz_per_sec_per_chip", "value": N, "unit": "kHz/s",
   "vs_baseline": M}

value        = kHz of audio synthesized per wall-second on the card
vs_baseline  = x real-time (value / sample rate in kHz)

and ``#`` lines on stderr: the card (name and power limit), the model and
batch, the first call (which includes the kernel builds), the best call,
its real-time factor, the output energy and the peak device memory.

Measurement: params come from a seeded ``torch.Generator`` and are cast to
bf16; the noise and the synthetic mels are drawn on the device, and only
two scalars (the output's energy and its count of finite values) are read
back, which is the fence of each timed call.  The result is the best of
``BENCH_ITERS`` calls after one untimed call.

Env knobs: BENCH_BATCH (128, from the batch sweep recorded in PERF.md) |
BENCH_SECONDS (7; trimmed to a 30-frame multiple) | BENCH_ITERS (5) |
BENCH_CONFIG (lj22k) | BENCH_MELS (synthetic | speech | /path/to/mels_dir)
| BENCH_DEVICE (cuda; ``--device cpu`` or BENCH_DEVICE=cpu runs on the
CPU) | the FWN_* route switches (``utils/flags.py``: FWN_INT8=0,
FWN_HOISTED=1, ...).

BENCH_MELS modes: "synthetic" (default) conditions on uniform-random mels
drawn on the device; "speech" runs speech-like waveforms (harmonics,
formant-shaped noise, silence gaps) through the port's mel frontend
(``audio/mel.py:process_wav``) on the host and uploads them once; a
directory loads preprocessed .npy mels.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

DEFAULT_BATCH = 128


def _speech_mels(cfg, batch: int, frames: int) -> np.ndarray:
    """Speech-like conditioning through the mel frontend: a harmonic
    series with a gliding f0, formant-shaped noise and silence gaps."""
    from .audio.mel import process_wav

    sr = cfg.audio.sample_rate
    hop = cfg.audio.hop_size
    n = frames * hop + cfg.audio.n_fft
    rng = np.random.RandomState(1234)
    mels = []
    for b in range(batch):
        t = np.arange(n) / sr
        f0 = 120.0 + 60.0 * np.sin(2 * np.pi * (0.7 + 0.1 * (b % 7)) * t)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        voiced = sum((0.5 ** k) * np.sin((k + 1) * phase) for k in range(8))
        envelope = np.clip(np.sin(2 * np.pi * 1.7 * t + b) + 0.7, 0, None)
        noise = rng.randn(n) * 0.05
        wav = (0.3 * voiced * envelope + noise).astype(np.float32)
        _, mel = process_wav(wav, cfg.audio)
        mels.append(mel[:frames])
    return np.stack(mels).astype(np.float32)


def _load_mels_dir(path: str, cfg, batch: int, frames: int) -> np.ndarray:
    """Preprocessed .npy mels, cycled/cropped/padded to [batch, frames]."""
    names = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    if not names:
        raise FileNotFoundError(f"no .npy mels in {path}")
    out = np.zeros((batch, frames, cfg.model.num_mels), np.float32)
    for b in range(batch):
        m = np.load(os.path.join(path, names[b % len(names)]))
        f = min(frames, m.shape[0])
        out[b, :f] = m[:f]
    return out


def bench_frames(cfg, seconds: float) -> int:
    """Mel frames of a ``seconds`` clip: a multiple of 30 frames where
    that keeps T a multiple of the squeeze factor, then aligned to it."""
    hop, sq = cfg.audio.hop_size, cfg.model.squeeze_factor
    frames = int(seconds * cfg.audio.sample_rate) // hop
    if frames >= 30 and (30 * hop) % sq == 0:
        frames -= frames % 30
    while (frames * hop) % sq != 0 and frames > 1:
        frames -= 1
    return frames


def _card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        smi = f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return smi


def main(argv=None) -> dict:
    from .config import get_config
    from .models.flowavenet import init_flowavenet, reverse
    from .synthesis.synthesize import resolve_device
    from .utils.tree import tree_map

    parser = argparse.ArgumentParser(
        description="One-shot synthesis throughput of the PyTorch port")
    parser.add_argument("--device",
                        default=os.environ.get("BENCH_DEVICE", "cuda"),
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(os.environ.get("BENCH_CONFIG", "lj22k"))
    batch = int(os.environ.get("BENCH_BATCH", str(DEFAULT_BATCH)))
    seconds = float(os.environ.get("BENCH_SECONDS", "7"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))

    sr = cfg.audio.sample_rate
    frames = bench_frames(cfg, seconds)
    T = frames * cfg.audio.hop_size
    print(f"# device: {_card(dev)} | model: {cfg.model.n_block}x"
          f"{cfg.model.n_flow} flows | batch {batch} x {T / sr:.2f}s",
          file=sys.stderr, flush=True)

    t0 = time.time()
    gen = torch.Generator(dev).manual_seed(0)
    params = tree_map(lambda l: l.to(torch.bfloat16),
                      init_flowavenet(gen, cfg.model))
    print(f"# init {time.time() - t0:.1f}s", file=sys.stderr, flush=True)

    mels_mode = os.environ.get("BENCH_MELS", "synthetic")
    c_dev = None
    if mels_mode != "synthetic":
        c_host = (_speech_mels(cfg, batch, frames) if mels_mode == "speech"
                  else _load_mels_dir(mels_mode, cfg, batch, frames))
        t0 = time.time()
        c_dev = torch.from_numpy(c_host).to(dev)
        float(c_dev[0, 0, 0])
        print(f"# uploaded {mels_mode!r} mels ({c_host.nbytes / 1e6:.1f} MB)"
              f" in {time.time() - t0:.1f}s", file=sys.stderr, flush=True)

    def synth(seed: int):
        g = torch.Generator(dev).manual_seed(seed)
        z = torch.randn(batch, T, 1, generator=g, device=dev) * cfg.train.temp
        c = c_dev
        if c is None:
            c = torch.rand(batch, frames, cfg.model.num_mels, generator=g,
                           device=dev)
        wav = reverse(params, cfg.model, z, c, compute_dtype=torch.bfloat16)
        w32 = wav.float()
        # fp64 holds the finite count exactly
        return torch.stack([torch.sum(w32 * w32).double(),
                            torch.isfinite(w32).sum().double()])

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # first call (kernel builds, allocator); the scalar readback fences it
    t0 = time.time()
    energy, finite = synth(0).cpu().tolist()
    first_s = time.time() - t0
    if int(finite) != batch * T:
        raise RuntimeError(f"non-finite synthesis output ({int(finite)} of "
                           f"{batch * T} finite)")

    times = []
    for i in range(iters):
        t0 = time.time()
        float(synth(i + 1)[0])
        times.append(time.time() - t0)
    best = min(times)

    samples_per_sec = batch * T / best
    khz = samples_per_sec / 1000.0
    rtf = samples_per_sec / sr
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else float("nan"))
    print(f"# first call {first_s:.1f}s | best {best * 1e3:.1f} ms for "
          f"{batch}x{T / sr:.2f}s | {rtf:.1f}x real-time | energy "
          f"{energy:.1f} | peak device memory {peak:.2f} GB | calls ms "
          f"{[round(t * 1e3, 1) for t in times]}", file=sys.stderr,
          flush=True)
    result = {"metric": "synthesis_khz_per_sec_per_chip",
              "value": round(khz, 2), "unit": "kHz/s",
              "vs_baseline": round(rtf, 2)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
