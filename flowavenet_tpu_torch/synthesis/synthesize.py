"""Batch synthesis on the card: mel .npy dir -> .wav dir (twin of
``flowavenet_tpu/synthesis/synthesize.py``).

Mels are padded to the longest item (rounded up to ``bucket_frames``),
batched through one ``reverse`` and cropped back.  Each item's noise comes
from its own seed on the host (``np.random.RandomState(seed).randn``), so
the noise, and an item's audio, never depend on its batch companions.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
without CUDA they raise.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..checkpoint.bridge import latest_checkpoint, load_params_npz, to_torch
from ..config import Config, get_config
from ..models.flowavenet import reverse


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device to run on; a CUDA device without CUDA raises (nothing
    falls back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def resolve_compute_dtype(cfg: Config, compute_dtype=None) -> torch.dtype:
    """An explicit request wins, else cfg.train.compute_dtype decides."""
    if compute_dtype is not None:
        if isinstance(compute_dtype, str):
            return {"bfloat16": torch.bfloat16,
                    "float32": torch.float32}[compute_dtype]
        return compute_dtype
    return (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
            else torch.float32)


def load_params(saved_dir: str, cfg: Config, compute_dtype=None,
                device: str | torch.device = "cuda"):
    """Params and step of the newest ``ckpt-<step>.npz`` in ``saved_dir``
    (as written by ``flowavenet_tpu.checkpoint.save_checkpoint``), on
    ``device``; cast once to bf16 when synthesis computes in bf16."""
    dev = resolve_device(device)
    ckpt = latest_checkpoint(saved_dir)
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint found in {saved_dir}")
    print(f"Loading checkpoint {ckpt}")
    tree, step = load_params_npz(ckpt)
    dt = resolve_compute_dtype(cfg, compute_dtype)
    return to_torch(tree, dev, torch.bfloat16 if dt == torch.bfloat16
                    else torch.float32), step


def _usable_frames(frames: int, cfg: Config) -> int:
    """Largest frame count whose audio length divides 2**n_block."""
    sq, hop = cfg.model.squeeze_factor, cfg.audio.hop_size
    while frames > 0 and (frames * hop) % sq != 0:
        frames -= 1
    return frames


def padded_frames(frames: int, cfg: Config, bucket_frames: int = 60) -> int:
    """Padded frame count: rounded up to ``bucket_frames``, then to
    squeeze-factor alignment."""
    pad = frames
    if bucket_frames > 1:
        pad = -(-pad // bucket_frames) * bucket_frames
    hop = cfg.audio.hop_size
    while (pad * hop) % cfg.model.squeeze_factor != 0:
        pad += 1
    return pad


def dispatch_mels(params, cfg: Config, mels: list[np.ndarray],
                  seed: int | list[int] = 0, compute_dtype=None,
                  temp: float | None = None, bucket_frames: int = 60,
                  noise: str = "host", pcm16: bool = False,
                  data_sharding=None, device: str | torch.device = "cuda"):
    """Queue one batched reverse on ``device``; returns ``(wav, frames)``
    with ``wav`` still on the device (the caller crops it with
    :func:`materialize_wavs`)."""
    if noise != "host":
        raise NotImplementedError(
            "device noise is not ported yet (flowavenet_tpu/synthesis/"
            "synthesize.py:_jitted_reverse_devnoise)")
    if pcm16:
        raise NotImplementedError(
            "pcm16 output is not ported yet (flowavenet_tpu/synthesis/"
            "synthesize.py:_jitted_reverse_devnoise, pcm16)")
    if data_sharding is not None:
        raise NotImplementedError(
            "sharded synthesis is not ported yet (flowavenet_tpu/synthesis/"
            "synthesize.py:dispatch_mels, data_sharding)")
    dev = resolve_device(device)
    dt = resolve_compute_dtype(cfg, compute_dtype)
    n = len(mels)
    seeds = [seed + i for i in range(n)] if isinstance(seed, int) else seed
    if len(seeds) != n:
        raise ValueError(f"need {n} seeds, got {len(seeds)}")
    temp = cfg.train.temp if temp is None else float(temp)

    hop = cfg.audio.hop_size
    frames = [_usable_frames(m.shape[0], cfg) for m in mels]
    pad_frames = padded_frames(max(frames), cfg, bucket_frames)
    batch = np.zeros((n, pad_frames, cfg.audio.num_mels), np.float32)
    for i, m in enumerate(mels):
        batch[i, : frames[i]] = m[: frames[i]]
    z = np.zeros((n, pad_frames * hop, 1), np.float32)
    for i, s in enumerate(seeds):
        z[i, :, 0] = np.random.RandomState(s % (2 ** 32)).randn(
            pad_frames * hop) * temp
    # cast on the host first: rounding to bf16 is the same on either side
    # and halves the upload
    z_t = torch.from_numpy(z).to(dt).to(dev)
    c_t = torch.from_numpy(batch).to(dt).to(dev)
    wav = reverse(params, cfg.model, z_t, c_t, compute_dtype=dt)
    return wav, frames


def materialize_wavs(wav: torch.Tensor, frames, cfg: Config
                     ) -> list[np.ndarray]:
    """Bring a :func:`dispatch_mels` result to the host (float32) and crop
    each row to its true length."""
    hop = cfg.audio.hop_size
    w = wav.float().cpu().numpy()
    return [w[i, : frames[i] * hop, 0] for i in range(len(frames))]


def synthesize_mels(params, cfg: Config, mels: list[np.ndarray],
                    seed: int | list[int] = 0, compute_dtype=None,
                    temp: float | None = None, bucket_frames: int = 60,
                    noise: str = "host", pcm16: bool = False,
                    device: str | torch.device = "cuda"
                    ) -> list[np.ndarray]:
    """Synthesize a list of [T_mel, num_mels] mels into float32 wavs.
    ``seed`` may be a per-item list; a scalar seed expands to ``seed + i``
    per item."""
    wav, frames = dispatch_mels(
        params, cfg, mels, seed=seed, compute_dtype=compute_dtype, temp=temp,
        bucket_frames=bucket_frames, noise=noise, pcm16=pcm16, device=device)
    return materialize_wavs(wav, frames, cfg)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="FloWaveNet synthesis on the GPU (PyTorch port)")
    parser.add_argument("--saved_dir", default="logs/pretrained/")
    parser.add_argument("--mels_dir", default="mels/")
    parser.add_argument("--output_dir", default="output/")
    parser.add_argument("--config", default="lj22k")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="mels synthesized per reverse pass")
    parser.add_argument("--temp", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--bucket_frames", type=int, default=60)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--stream", action="store_true",
                        help="not ported yet")
    parser.add_argument("--time_parallel", type=int, default=0,
                        help="not ported yet")
    args = parser.parse_args(argv)
    if args.stream:
        raise NotImplementedError(
            "--stream is not ported yet (flowavenet_tpu/synthesis/"
            "streaming.py:synthesize_streaming)")
    if args.time_parallel:
        raise NotImplementedError(
            "--time_parallel is not ported yet (flowavenet_tpu/synthesis/"
            "streaming.py:synthesize_time_parallel)")

    cfg = get_config(args.config)
    params, _ = load_params(args.saved_dir, cfg, device=args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    from ..audio.wavio import write_wav

    names = sorted(f for f in os.listdir(args.mels_dir)
                   if f.endswith(".npy"))
    if not names:
        raise FileNotFoundError(f"no .npy mels in {args.mels_dir}")
    total_samples, total_time = 0, 0.0
    for i in range(0, len(names), args.batch_size):
        chunk = names[i: i + args.batch_size]
        mels = [np.load(os.path.join(args.mels_dir, n)) for n in chunk]
        t0 = time.time()
        wavs = synthesize_mels(params, cfg, mels, seed=args.seed + i,
                               temp=args.temp,
                               bucket_frames=args.bucket_frames,
                               device=args.device)
        dt = time.time() - t0
        for n, w in zip(chunk, wavs):
            write_wav(os.path.join(args.output_dir, n[:-4] + ".wav"), w,
                      cfg.audio.sample_rate)
            total_samples += len(w)
        total_time += dt
        print(f"[{i + len(chunk)}/{len(names)}] {dt:.3f}s")
    rtf = total_samples / cfg.audio.sample_rate / max(total_time, 1e-9)
    print(f"Synthesized {total_samples / cfg.audio.sample_rate:.1f}s of "
          f"audio in {total_time:.2f}s — {rtf:.1f}x real-time "
          f"(first batch includes the kernel build)")


if __name__ == "__main__":
    main()
