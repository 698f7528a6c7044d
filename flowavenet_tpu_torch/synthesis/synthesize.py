"""Batch synthesis on the card: mel .npy dir -> .wav dir (twin of
``flowavenet_tpu/synthesis/synthesize.py``).

Mels are padded to the longest item (rounded up to ``bucket_frames``),
batched through one ``reverse`` and cropped back.  Each item's noise comes
from its own seed, on the host (``np.random.RandomState(seed).randn``) or
on the device (the JAX package's threefry stream, ``noise="device"``), so
the noise, and an item's audio, never depend on its batch companions.
``--stream`` and ``--time_parallel`` run ``synthesis/streaming.py``.

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
from ..utils.device import upload
from ..utils.profiling import counters, span, spanned
from .noise import row_noise


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


@spanned("fwn.synth.pcm16")
def pcm16_quantize(wav: torch.Tensor) -> torch.Tensor:
    """float audio -> int16 PCM on its device: clip(round(x * 32768),
    -32768, 32767) with round-half-even (the WAV layer's quantization)."""
    return torch.clamp(torch.round(wav.float() * 32768.0), -32768, 32767
                       ).to(torch.int16)


def split_rows(params, rows: int, data_sharding=None,
               device: str | torch.device = "cuda"):
    """``([(device, params)], rows per device)`` of a synthesis call of
    ``rows`` rows: ``device`` alone, or every device of a data mesh with
    its replica of the params, each taking whole rows (else it raises)."""
    if data_sharding is None:
        return [(resolve_device(device), params)], rows
    shards = list(zip(data_sharding.devices, data_sharding.replicas(params)))
    if rows % len(shards):
        raise ValueError(f"{rows} rows do not split over {len(shards)} "
                         f"devices; pass batch_multiple={len(shards)}")
    return shards, rows // len(shards)


def _cuda_frees(shards) -> int:
    """``cudaFree`` calls the caching allocator has made so far on the
    cards of ``shards`` (0 off the card)."""
    return sum(torch.cuda.memory_stats(d).get("num_device_free", 0)
               for d in {d for d, _ in shards if d.type == "cuda"})


def dispatch_mels(params, cfg: Config, mels: list[np.ndarray],
                  seed: int | list[int] = 0, speaker_ids=None,
                  compute_dtype=None,
                  temp: float | list[float] | None = None,
                  bucket_frames: int = 60, pad_batch: bool = False,
                  noise: str = "host", pcm16: bool = False,
                  data_sharding=None, batch_multiple: int = 1,
                  device: str | torch.device = "cuda"):
    """Queue one batched reverse on ``device`` without waiting for the card;
    returns ``(wav, frames)`` with ``wav`` still on the device (the caller
    crops it with :func:`materialize_wavs`, which is where the host waits).

    ``seed`` / ``temp`` may be per-item lists (``None`` items take
    cfg.train.temp); a scalar seed expands to ``seed + i``.  ``pad_batch``
    pads the row count to the next power of two with zero rows.
    ``noise='device'`` draws each row's z on the device as the JAX package
    does (``normal(PRNGKey(seed)) * temp``, synthesis/noise.py) instead of
    uploading host RandomState noise; ``pcm16`` (device noise only)
    quantizes to int16 on the device.  ``speaker_ids`` (one per mel) select
    each row's speaker on a global-conditioning model; padding rows take
    speaker 0.  A gin model without them raises, as in the JAX package.

    ``data_sharding`` (a ``parallel/mesh.py:DataMesh``) splits the rows
    over its devices, each running its rows on its replica of the params
    (``device`` is then unused), and ``wav`` is the list of the devices'
    rows; ``batch_multiple`` rounds the (possibly pow2-padded) row count
    up to a multiple, so that every device gets whole rows."""
    with span("fwn.synth.dispatch") as attrs:
        matmuls0 = counters().get("fwn.conv.matmuls", 0)
        if noise not in ("host", "device"):
            raise ValueError(
                f"noise must be 'host' or 'device', got {noise!r}")
        if pcm16 and noise != "device":
            raise ValueError("pcm16=True requires noise='device'")
        n = len(mels)
        n_rows = 1 << (n - 1).bit_length() if pad_batch else n
        if batch_multiple > 1:
            n_rows = -(-n_rows // batch_multiple) * batch_multiple
        shards, per = split_rows(params, n_rows, data_sharding, device)
        frees0 = _cuda_frees(shards)
        dt = resolve_compute_dtype(cfg, compute_dtype)
        seeds = [seed + i for i in range(n)] if isinstance(seed, int) else seed
        if temp is None or isinstance(temp, (int, float)):
            temps = [cfg.train.temp if temp is None else float(temp)] * n
        else:
            temps = [cfg.train.temp if t is None else float(t) for t in temp]
        if len(seeds) != n or len(temps) != n:
            raise ValueError(f"need {n} seeds/temps, got {len(seeds)}/"
                             f"{len(temps)}")

        hop = cfg.audio.hop_size
        frames = [_usable_frames(m.shape[0], cfg) for m in mels]
        pad_frames = padded_frames(max(frames), cfg, bucket_frames)
        attrs.update(rows=n_rows, pad_frames=pad_frames,
                     requested_samples=sum(frames) * hop)
        with span("fwn.synth.pack"):
            batch = np.zeros((n_rows, pad_frames, cfg.audio.num_mels),
                             np.float32)
            for i, m in enumerate(mels):
                batch[i, : frames[i]] = m[: frames[i]]
            if noise == "device":
                s_arr = np.zeros((n_rows,), np.int64)
                t_arr = np.zeros((n_rows,), np.float32)
                s_arr[:n] = [s % (2 ** 32) for s in seeds]
                t_arr[:n] = temps
            else:
                z = np.zeros((n_rows, pad_frames * hop, 1), np.float32)
                for i, (s, t) in enumerate(zip(seeds, temps)):
                    z[i, :, 0] = np.random.RandomState(s % (2 ** 32)).randn(
                        pad_frames * hop) * t
            ids = None
            if cfg.model.gin_channels > 0 and speaker_ids is not None:
                ids = np.zeros((n_rows,), np.int64)
                ids[:n] = np.asarray(speaker_ids, np.int64)

        def run(dev, p, rows: slice) -> torch.Tensor:
            with span("fwn.synth.upload"):
                # cast on the host first: rounding to bf16 is the same on
                # either side and halves the upload
                c_t = upload(torch.from_numpy(batch[rows]), dt, dev)
                z_t = (upload(torch.from_numpy(z[rows]), dt, dev)
                       if noise == "host" else None)
                g = (torch.from_numpy(ids[rows]).to(dev) if ids is not None
                     else None)
            if noise == "device":
                with span("fwn.synth.noise"):
                    z_t = row_noise(s_arr[rows], t_arr[rows],
                                    pad_frames * hop, dev)
            wav = reverse(p, cfg.model, z_t, c_t, g, compute_dtype=dt)
            return pcm16_quantize(wav) if pcm16 else wav

        wavs = [run(dev, p, slice(i * per, (i + 1) * per))
                for i, (dev, p) in enumerate(shards)]
        attrs["matmuls"] = counters().get("fwn.conv.matmuls", 0) - matmuls0
        attrs["cuda_frees"] = _cuda_frees(shards) - frees0
        return (wavs[0] if data_sharding is None else wavs), frames


def materialize_wavs(wav, frames, cfg: Config) -> list[np.ndarray]:
    """Bring a :func:`dispatch_mels` result to the host and crop each row to
    its true length: float32 rows, or int16 when it was dispatched with
    ``pcm16``.  Padding rows are dropped on the device first (over a data
    mesh, the devices that hold only padding rows are not read)."""
    hop = cfg.audio.hop_size

    def host(t):
        return (t if t.dtype == torch.int16 else t.float()).cpu().numpy()

    if isinstance(wav, list):
        keep = -(-len(frames) // wav[0].shape[0])
        w = np.concatenate([host(p) for p in wav[:keep]])
    else:
        w = host(wav[: len(frames)])
    return [w[i, : frames[i] * hop, 0] for i in range(len(frames))]


def synthesize_mels(params, cfg: Config, mels: list[np.ndarray],
                    seed: int | list[int] = 0, speaker_ids=None,
                    compute_dtype=None,
                    temp: float | list[float] | None = None,
                    bucket_frames: int = 60, pad_batch: bool = False,
                    noise: str = "host", pcm16: bool = False,
                    device: str | torch.device = "cuda"
                    ) -> list[np.ndarray]:
    """Synthesize a list of [T_mel, num_mels] mels into float32 wavs (int16
    with ``pcm16``); the options are :func:`dispatch_mels`'."""
    wav, frames = dispatch_mels(
        params, cfg, mels, seed=seed, speaker_ids=speaker_ids,
        compute_dtype=compute_dtype, temp=temp, bucket_frames=bucket_frames,
        pad_batch=pad_batch, noise=noise, pcm16=pcm16, device=device)
    return materialize_wavs(wav, frames, cfg)


def local_data_mesh(n: int, device: str | torch.device = "cuda"):
    """The data mesh of ``n`` local devices of ``device``'s type (-1: every
    card; one CPU replica on the CPU), as ``--time_parallel`` and the
    server's ``--data_parallel`` build it."""
    from ..parallel.mesh import make_data_mesh
    dev = resolve_device(device)
    if dev.type != "cuda":
        return make_data_mesh([dev] * max(1, n))
    count = torch.cuda.device_count()
    n = count if n < 0 else n
    if n > count:
        raise ValueError(f"{n} devices asked for, {count} cards present")
    return make_data_mesh([torch.device("cuda", i) for i in range(n)])


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
                        help="chunked streaming synthesis (streaming.py): "
                             "one window shape for any length, bounded "
                             "memory")
    parser.add_argument("--chunk_frames", type=int, default=None,
                        help="--stream / --time_parallel window advance, "
                             "in mel frames")
    parser.add_argument("--time_parallel", type=int, default=0,
                        help="batch each utterance's halo windows through "
                             "one reverse and split them over N devices "
                             "(-1: every local card; on the CPU, N CPU "
                             "replicas); exact vs --stream")
    args = parser.parse_args(argv)
    if args.stream and args.time_parallel:
        parser.error("--stream and --time_parallel are exclusive")
    mesh = None
    if args.time_parallel:
        mesh = local_data_mesh(args.time_parallel, args.device)

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
        if args.stream or args.time_parallel:
            from .streaming import (synthesize_streaming,
                                    synthesize_time_parallel)
            run = (synthesize_streaming if args.stream
                   else synthesize_time_parallel)
            kw = (dict(data_sharding=mesh, batch_multiple=mesh.size)
                  if mesh is not None and mesh.size > 1 else {})
            wavs = [run(params, cfg, m.astype(np.float32),
                        seed=args.seed + i + j, temp=args.temp,
                        chunk_frames=args.chunk_frames, device=args.device,
                        **kw)
                    for j, m in enumerate(mels)]
        else:
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
