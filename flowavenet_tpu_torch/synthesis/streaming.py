"""Chunked / streaming and time-parallel synthesis on the card (twin of
``flowavenet_tpu/synthesis/streaming.py``).

The reverse pass is a finite-receptive-field convolutional map, so audio
sample t depends on (z, mel) only within a window whose one-sided extent
:func:`reverse_halo` computes from the config.  Sliding a fixed-size window
over the utterance, synthesizing each window and keeping its center
reproduces the full-utterance reverse: one window shape serves any length,
memory stays bounded by the window, and time to first audio is one
window's synthesis.

Windows start at absolute positions that are multiples of the squeeze
factor (:func:`plan_chunks` rounds the halo), so a window's squeeze
grouping matches the full-length one.  On the plain route the streamed
audio then equals the one-shot audio up to float summation order.  Two
routes compute something that depends on the window:

* the int8 route's activation scales are max-abs over each kernel window
  (and the mel's per-row scale over the mel window);
* the Winograd route (``FWN_INT8=0``, blocks 0-2) groups level-k samples
  by absolute position within the window's own level-k frame: window k
  starts at frame 64*(2k-1) of the default lj22k plan, i.e. at level-1
  sample 8192*(2k-1), which is in general not a multiple of 6, so the
  groups differ from the one-shot pass (as in the JAX kernel).

Both are differences of rounding, not seams (PERF.md section 2 holds them
to rel < 0.08, corr > 0.998).  Entry points run on ``device="cuda"``
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import Config, ModelConfig
from ..models.flowavenet import reverse
from ..utils.device import upload
from .noise import frame_noise
from .synthesize import (_usable_frames, pcm16_quantize,
                         resolve_compute_dtype, resolve_device, split_rows)


def reverse_halo(m: ModelConfig) -> int:
    """One-sided receptive-field extent of reverse() in AUDIO samples: per
    flow a front conv (extent 1) plus n_layer dilated convs (3^i), times
    n_flow, summed over blocks at 2^(b+1) samples per squeezed step (causal
    convs reach twice as far, all to the left)."""
    rf_flow = 1 + (3 ** m.n_layer - 1) // 2
    if m.causal:
        rf_flow *= 2
    return m.n_flow * rf_flow * (2 ** (m.n_block + 1) - 2)


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Static geometry of a streaming run: every window has one shape."""
    chunk_frames: int      # mel frames of NEW audio per chunk
    halo_frames: int       # one-sided context frames (aligned)
    window_frames: int     # chunk_frames + 2 * halo_frames
    n_chunks: int
    total_frames: int      # usable frames of the utterance


def plan_chunks(cfg: Config, mel_frames: int,
                chunk_frames: Optional[int] = None,
                halo_frames: Optional[int] = None) -> ChunkPlan:
    """An aligned (chunk, halo) geometry for an utterance: both rounded so
    that frames * hop is a multiple of the squeeze factor, which aligns
    every window start k*chunk - halo."""
    if chunk_frames is not None and chunk_frames <= 0:
        raise ValueError(f"chunk_frames must be positive, got {chunk_frames}")
    if halo_frames is not None and halo_frames < 0:
        raise ValueError(f"halo_frames must be >= 0, got {halo_frames}")
    hop = cfg.audio.hop_size
    sq = cfg.model.squeeze_factor
    align = sq // math.gcd(sq, hop)  # frames per aligned boundary

    total = _usable_frames(mel_frames, cfg)
    if halo_frames is None:
        # the upsampler reads at most 4 more mel frames
        halo_frames = -(-reverse_halo(cfg.model) // hop) + 4
    halo_frames = -(-halo_frames // align) * align
    if chunk_frames is None:
        chunk_frames = max(2 * halo_frames, 4 * align)
    chunk_frames = -(-chunk_frames // align) * align
    window = chunk_frames + 2 * halo_frames
    if window >= total:
        # the utterance fits one window: a single full-length "chunk"
        return ChunkPlan(total, 0, total, 1, total)
    n_chunks = -(-total // chunk_frames)
    return ChunkPlan(chunk_frames, halo_frames, window, n_chunks, total)


def _window_starts(plan: ChunkPlan) -> Iterator[tuple[int, int, int]]:
    """(start, stop, w0) per chunk: the first new frame, the end of the new
    frames and the window's first frame (clamped into the utterance); one
    geometry for the serial and the batched paths."""
    for k in range(plan.n_chunks):
        start = k * plan.chunk_frames
        stop = min(start + plan.chunk_frames, plan.total_frames)
        w0 = min(max(start - plan.halo_frames, 0),
                 plan.total_frames - plan.window_frames)
        yield start, stop, w0


def _speaker_rows(cfg: Config, speaker_id: Optional[int], rows: int,
                  dev: torch.device) -> Optional[torch.Tensor]:
    """Speaker ids [rows] of a global-conditioning model, or None (no
    model g, or no id: then reverse raises, as in the JAX package)."""
    if cfg.model.gin_channels <= 0 or speaker_id is None:
        return None
    return torch.full((rows,), int(speaker_id), dtype=torch.long,
                      device=dev)


def _check_mel(cfg: Config, mel: np.ndarray) -> None:
    if mel.ndim != 2 or mel.shape[1] != cfg.audio.num_mels:
        raise ValueError(
            f"mel must be [T, {cfg.audio.num_mels}], got {mel.shape}")


def stream_reverse(params, cfg: Config, mel: np.ndarray, seed: int = 0,
                   temp: Optional[float] = None,
                   chunk_frames: Optional[int] = None,
                   halo_frames: Optional[int] = None, compute_dtype=None,
                   speaker_id: Optional[int] = None,
                   device: str | torch.device = "cuda"
                   ) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(start_sample, float32 audio chunk)`` for one [T_mel,
    num_mels] mel, left to right.

    The noise is the full-length host RandomState stream of the offline
    path, drawn incrementally as windows advance, so the chunks
    concatenate to ``synthesize_mels(..., bucket_frames=1)`` of an aligned
    length.  Each window's halo is trimmed on the device; one window stays
    in flight (window k+1 is queued before window k is read back), except
    the first, which is read back at once for time to first audio.
    ``speaker_id`` selects the speaker of a global-conditioning model (the
    same id in every window: g is constant in time)."""
    _check_mel(cfg, mel)
    dev = resolve_device(device)
    dt = resolve_compute_dtype(cfg, compute_dtype)
    hop = cfg.audio.hop_size
    t0 = cfg.train.temp if temp is None else float(temp)
    plan = plan_chunks(cfg, mel.shape[0], chunk_frames, halo_frames)
    rs = np.random.RandomState(seed % (2 ** 32))
    z_full = np.empty(plan.total_frames * hop, np.float32)
    z_end = 0
    mel = np.ascontiguousarray(mel[: plan.total_frames], np.float32)
    keep = plan.chunk_frames * hop
    wf_hop = plan.window_frames * hop
    g = _speaker_rows(cfg, speaker_id, 1, dev)

    def materialize(dev_wav, start, stop, off):
        wav = dev_wav.float().cpu().numpy()
        return start * hop, wav[off: off + (stop - start) * hop]

    pending = None
    first = True
    for start, stop, w0 in _window_starts(plan):
        w_end = (w0 + plan.window_frames) * hop
        if w_end > z_end:
            z_full[z_end:w_end] = rs.randn(w_end - z_end) * t0
            z_end = w_end
        z = torch.from_numpy(z_full[w0 * hop: w_end])[None, :, None]
        c = torch.from_numpy(mel[w0: w0 + plan.window_frames])[None]
        k0 = min((start - w0) * hop, wf_hop - keep)
        with torch.no_grad():
            wav = reverse(params, cfg.model, upload(z, dt, dev),
                          upload(c, dt, dev), g, compute_dtype=dt
                          )[0, k0: k0 + keep, 0]
        off = (start - w0) * hop - k0
        if first:
            yield materialize(wav, start, stop, off)
            first = False
            continue
        if pending is not None:
            yield materialize(*pending)
        pending = (wav, start, stop, off)
    if pending is not None:
        yield materialize(*pending)


def synthesize_streaming(params, cfg: Config, mel: np.ndarray,
                         **kw) -> np.ndarray:
    """Run :func:`stream_reverse` to completion and return the utterance
    (float32)."""
    return np.concatenate([a for _, a in
                           stream_reverse(params, cfg, mel, **kw)])


def synthesize_time_parallel(params, cfg: Config, mel: np.ndarray,
                             seed: int = 0, temp: Optional[float] = None,
                             chunk_frames: Optional[int] = None,
                             halo_frames: Optional[int] = None,
                             compute_dtype=None,
                             speaker_id: Optional[int] = None,
                             rows_per_pass: Optional[int] = None,
                             data_sharding=None, batch_multiple: int = 1,
                             noise: str = "host", pcm16: bool = False,
                             device: str | torch.device = "cuda"
                             ) -> np.ndarray:
    """One long utterance synthesized as a batch: the halo windows that
    :func:`stream_reverse` walks one by one run ``rows_per_pass`` (default
    min(16, chunks), rounded up to ``batch_multiple``) at a time through
    one reverse, one pass in flight, with each row's halo trimmed on the
    device.  With host noise the output equals
    :func:`synthesize_streaming`'s for the same (seed, temp, plan).
    ``noise='device'`` draws positional noise on the device (the JAX
    package's ``normal(fold_in(PRNGKey(seed), frame))`` per mel frame,
    synthesis/noise.py), a function of (seed, absolute frame) alone;
    ``pcm16`` (device noise only) returns int16 quantized on the device.
    ``speaker_id`` as in :func:`stream_reverse`.  ``data_sharding`` (a
    ``parallel/mesh.py:DataMesh``) splits each pass's rows over its
    devices, each on its replica of the params (``device`` is then
    unused)."""
    _check_mel(cfg, mel)
    if noise not in ("host", "device"):
        raise ValueError(f"noise must be 'host' or 'device', got {noise!r}")
    if pcm16 and noise != "device":
        raise ValueError("pcm16=True requires noise='device'")
    dt = resolve_compute_dtype(cfg, compute_dtype)
    hop = cfg.audio.hop_size
    t0 = cfg.train.temp if temp is None else float(temp)
    plan = plan_chunks(cfg, mel.shape[0], chunk_frames, halo_frames)
    mel = np.ascontiguousarray(mel[: plan.total_frames], np.float32)
    if rows_per_pass is None:
        rows_per_pass = min(16, plan.n_chunks)
    if rows_per_pass <= 0:
        raise ValueError(f"rows_per_pass must be positive, got "
                         f"{rows_per_pass}")
    rows = -(-rows_per_pass // batch_multiple) * batch_multiple
    shards, per = split_rows(params, rows, data_sharding, device)
    n_total = plan.total_frames * hop
    z_full = None
    if noise == "host":
        z_full = np.random.RandomState(seed % (2 ** 32)).randn(
            n_total).astype(np.float32) * t0
    wf = plan.window_frames
    keep = plan.chunk_frames * hop
    out = np.empty(n_total, np.int16 if pcm16 else np.float32)
    windows = list(_window_starts(plan))
    temps = np.full((rows,), t0, np.float32)
    gs = [_speaker_rows(cfg, speaker_id, per, d) for d, _ in shards]

    def materialize(parts, geom, offs):
        wav = np.concatenate([(w if pcm16 else w.float()).cpu().numpy()
                              for w in parts])
        for i, (start, stop, _) in enumerate(geom):
            out[start * hop: stop * hop] = (
                wav[i, offs[i]: offs[i] + (stop - start) * hop])

    pending = None
    for p0 in range(0, len(windows), rows):
        geom = windows[p0: p0 + rows]
        cb = np.zeros((rows, wf, cfg.audio.num_mels), np.float32)
        for i, (_, _, w0) in enumerate(geom):
            cb[i] = mel[w0: w0 + wf]
        if noise == "device":
            w0s = np.zeros((rows,), np.int64)
            w0s[: len(geom)] = [w for _, _, w in geom]
        else:
            zb = np.zeros((rows, wf * hop, 1), np.float32)
            for i, (_, _, w0) in enumerate(geom):
                zb[i, :, 0] = z_full[w0 * hop: (w0 + wf) * hop]
        # per-row trim start, clamped so the last (over-long) window's
        # slice stays inside the window
        k0s = [min((s - w) * hop, wf * hop - keep) for s, _, w in geom]
        offs = [(s - w) * hop - k0 for (s, _, w), k0 in zip(geom, k0s)]
        parts = []
        for j, (dev, p) in enumerate(shards):
            sl = slice(j * per, (j + 1) * per)
            if not k0s[sl]:              # padding rows only
                break
            c_t = upload(torch.from_numpy(cb[sl]), dt, dev)
            if noise == "device":
                z_t = frame_noise(seed % (2 ** 32), torch.from_numpy(w0s[sl]),
                                  torch.from_numpy(temps[sl]), wf, hop,
                                  device=dev)
            else:
                z_t = upload(torch.from_numpy(zb[sl]), dt, dev)
            with torch.no_grad():
                wav = reverse(p, cfg.model, z_t, c_t, gs[j],
                              compute_dtype=dt)
                wav = torch.stack([wav[i, k0: k0 + keep, 0]
                                   for i, k0 in enumerate(k0s[sl])])
                parts.append(pcm16_quantize(wav) if pcm16 else wav)
        if pending is not None:  # overlap host assembly with device work
            materialize(*pending)
        pending = (parts, geom, offs)
    materialize(*pending)
    return out
