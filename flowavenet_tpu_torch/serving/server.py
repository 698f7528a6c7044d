"""Inference server on the card: HTTP mel-in / wav-out with dynamic
micro-batching (twin of ``flowavenet_tpu/serving/server.py``).

* stdlib ThreadingHTTPServer front end;
* one worker thread owns the card: requests queue up, the worker drains up
  to ``max_batch`` of them (waiting ``batch_window_ms`` for stragglers),
  groups them by bucketed padded length and queues one batched reverse per
  group (``max_dispatch_rows`` rows at most, pow2-padded) without waiting
  for the card; a completion thread reads the results back and wakes the
  waiters, so host work of batch k overlaps device work of batch k+1;
* deterministic per-request seeds and temperatures: each request's noise is
  drawn from its own X-Seed at its bucketed length, so its audio depends on
  (mel, seed, temp, batch shape) only: bit-identical across companions in
  the same pow2 batch bucket.

API:
  POST /synthesize     body = float32 .npy of one [T_mel, num_mels] mel;
                       headers X-Seed (int), X-Temp (float), X-Speaker-Id
                       (int; a global-conditioning model without one
                       synthesizes speaker 0).
                       Response: 16-bit PCM WAV.  Mels longer than
                       max_frames go through the streaming path server-side
                       with the same complete-WAV response.
  POST /synthesize_stream
                       same body/headers plus X-Chunk-Frames; any length;
                       a progressively written WAV (exact Content-Length)
                       whose first bytes follow one window's synthesis
                       (synthesis/streaming.py).
  GET  /healthz        liveness + model/config info (JSON)
  GET  /stats          serving counters (JSON): requests, batches,
                       streams, dispatches, audio_seconds, busy_seconds
                       (the worker's host time per micro-batch, less
                       backpressure), backpressure_seconds and
                       queue_wait_seconds (each drained request's wait
                       from submit until the worker took it)

``python -m flowavenet_tpu_torch.serving.server --device cuda --saved_dir
<dir> --config lj22k`` serves a checkpoint on the card; ``--device cpu``
on the CPU; ``--data_parallel N`` splits each micro-batch over N cards
(-1: every card).
"""

from __future__ import annotations

import io
import json
import queue
import struct
import threading
import time
import wave
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..synthesis.streaming import plan_chunks, stream_reverse
from ..synthesis.synthesize import (_usable_frames, dispatch_mels,
                                    materialize_wavs, padded_frames,
                                    resolve_device)
from ..utils.profiling import span


@dataclass
class _Request:
    mel: np.ndarray
    seed: int
    speaker_id: Optional[int]
    temp: Optional[float]
    done: threading.Event = field(default_factory=threading.Event)
    submitted: float = field(default_factory=time.perf_counter)
    wav: Optional[np.ndarray] = None
    error: Optional[str] = None


class SynthesisService:
    """Device worker with dynamic micro-batching on ``device`` (the card
    unless the caller asks for the CPU; without CUDA it raises).

    ``noise='device'`` (default) draws each request's z on the device with
    the JAX package's threefry stream; 'host' reproduces offline-CLI audio.
    ``pcm16`` (on by default with device noise) quantizes to 16-bit PCM on
    the device, halving the readback.  ``mesh`` (a ``parallel/mesh.py:
    DataMesh``) serves data-parallel: the params are replicated on its
    devices once, each micro-batch's rows are rounded up to a multiple of
    its size and split over them, and streams run on its first device (in
    place of ``device``)."""

    def __init__(self, params, cfg: Config, *, max_batch: int = 16,
                 batch_window_ms: float = 10.0, bucket_frames: int = 60,
                 noise: str = "device", pcm16: Optional[bool] = None,
                 max_frames: int = 4000, mesh=None,
                 max_dispatch_rows: int = 32,
                 device: str | torch.device = "cuda"):
        self.params = params
        self._batch_multiple = 1
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.devices[0]
            mesh.replicas(params)            # made once, kept by the mesh
            self._batch_multiple = mesh.size
        self.cfg = cfg
        self.mesh = mesh
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1000.0
        self.bucket_frames = bucket_frames
        self.noise = noise
        if pcm16 is None:
            pcm16 = noise == "device"
        elif pcm16 and noise != "device":
            raise ValueError("pcm16=True requires noise='device'")
        self.pcm16 = pcm16
        self.max_frames = max_frames
        # larger groups dispatch as consecutive sub-batches (still pow2
        # padded), so the host prep of one overlaps the card's work on the
        # previous
        self.max_dispatch_rows = max(1, max_dispatch_rows)
        self._submit_lock = threading.Lock()
        self._q: "queue.Queue[_Request]" = queue.Queue()
        # bounded hand-off = backpressure: one full drain's sub-groups plus
        # one may be queued on the card but not yet read back
        per_drain = -(-max_batch // self.max_dispatch_rows)
        self._done_q: "queue.Queue" = queue.Queue(maxsize=per_drain + 1)
        self._stop = threading.Event()
        self._inflight: list = []
        self.stats = {"data_parallel": self._batch_multiple,
                      "requests": 0, "batches": 0, "streams": 0,
                      "dispatches": 0, "max_dispatch_rows_seen": 0,
                      "audio_seconds": 0.0, "busy_seconds": 0.0,
                      "backpressure_seconds": 0.0,
                      "queue_wait_seconds": 0.0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._completer = threading.Thread(target=self._complete,
                                           daemon=True)
        self._completer.start()

    def submit(self, mel: np.ndarray, seed: int = 0,
               speaker_id: Optional[int] = None,
               temp: Optional[float] = None,
               timeout: float = 300.0) -> np.ndarray:
        if mel.ndim != 2 or mel.shape[1] != self.cfg.audio.num_mels:
            raise ValueError(
                f"mel must be [T, {self.cfg.audio.num_mels}], got {mel.shape}")
        if mel.shape[0] > self.max_frames:
            raise ValueError(
                f"mel too long: {mel.shape[0]} > max_frames="
                f"{self.max_frames}; use streaming synthesis "
                "(POST /synthesize_stream) for long-form audio")
        req = _Request(np.asarray(mel, np.float32), seed, speaker_id, temp)
        with self._submit_lock:  # pairs with close(): no put after stop
            if self._stop.is_set():
                raise RuntimeError("service closed")
            self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("synthesis timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.wav

    def stream(self, mel: np.ndarray, seed: int = 0,
               speaker_id: Optional[int] = None,
               temp: Optional[float] = None,
               chunk_frames: Optional[int] = None):
        """Streaming synthesis of one mel of any length: returns
        ``(n_samples, chunks)``, the exact sample count (from the chunk
        plan, for Content-Length) and a generator of little-endian int16
        PCM byte blocks.  Runs on the caller's thread, so its windows
        interleave with the worker's micro-batches on the card."""
        if mel.ndim != 2 or mel.shape[1] != self.cfg.audio.num_mels:
            raise ValueError(
                f"mel must be [T, {self.cfg.audio.num_mels}], got {mel.shape}")
        if self._stop.is_set():
            raise RuntimeError("service closed")
        if self.cfg.model.gin_channels > 0 and speaker_id is None:
            speaker_id = 0           # as submit: gin models default to 0
        plan = plan_chunks(self.cfg, mel.shape[0], chunk_frames)
        n_samples = plan.total_frames * self.cfg.audio.hop_size

        # on a mesh, the first device's replica
        params = (self.params if self.mesh is None
                  else self.mesh.replicas(self.params)[0])

        def chunks():
            self.stats["streams"] += 1
            t0 = time.time()
            for _, audio in stream_reverse(
                    params, self.cfg, mel, seed=seed, temp=temp,
                    chunk_frames=chunk_frames, speaker_id=speaker_id,
                    device=self.device):
                if self._stop.is_set():
                    raise RuntimeError("service closed")
                yield _pcm16(audio).tobytes()
            self.stats["audio_seconds"] += (
                n_samples / self.cfg.audio.sample_rate)
            self.stats["busy_seconds"] += time.time() - t0

        return n_samples, chunks()

    def _bucket_key(self, mel: np.ndarray) -> int:
        """Padded frame count this mel synthesizes at (the group key): the
        same function dispatch_mels pads with."""
        return padded_frames(_usable_frames(mel.shape[0], self.cfg),
                             self.cfg, self.bucket_frames)

    def _drain(self) -> list[_Request]:
        """Next micro-batch; [] when woken by close() with nothing queued."""
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        else:
            return []
        batch = [first]
        deadline = time.time() + self.batch_window
        while len(batch) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._drain()
            except Exception:
                continue
            if not batch:
                continue
            self._inflight = batch  # close() fails these if we outlive it
            taken = time.perf_counter()
            self.stats["queue_wait_seconds"] += sum(
                taken - r.submitted for r in batch)
            t0 = time.time()
            bp0 = self.stats["backpressure_seconds"]
            # one group per bucketed length: within a group the padded
            # length is the key itself, so a request's audio does not
            # depend on its companions
            groups: dict[int, list[_Request]] = {}
            for r in batch:
                groups.setdefault(self._bucket_key(r.mel), []).append(r)
            split = self.max_dispatch_rows
            for whole in groups.values():
                for i in range(0, len(whole), split):
                    self._dispatch_group(whole[i: i + split])
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            blocked = self.stats["backpressure_seconds"] - bp0
            self.stats["busy_seconds"] += time.time() - t0 - blocked
            self._inflight = []

    def _dispatch_group(self, group: list) -> None:
        with span("fwn.serve.dispatch", requests=len(group)):
            self.stats["dispatches"] += 1
            self.stats["max_dispatch_rows_seen"] = max(
                self.stats["max_dispatch_rows_seen"], len(group))
            try:
                # a gin model's request without X-Speaker-Id is speaker 0
                sids = ([r.speaker_id if r.speaker_id is not None else 0
                         for r in group] if self.cfg.model.gin_channels > 0
                        else None)
                wav, frames = dispatch_mels(
                    self.params, self.cfg, [r.mel for r in group],
                    seed=[r.seed for r in group], speaker_ids=sids,
                    temp=[r.temp for r in group],
                    bucket_frames=self.bucket_frames,
                    # group sizes follow the load: pow2 rows keep the set of
                    # batch shapes (and each row's arithmetic) small
                    pad_batch=True, noise=self.noise, pcm16=self.pcm16,
                    data_sharding=self.mesh,
                    batch_multiple=self._batch_multiple, device=self.device)
                # hand the queued result to the completion thread; blocks only
                # when the bounded hand-off is full (readback-bound waiting,
                # kept out of busy_seconds)
                tq = time.time()
                self._done_q.put((group, wav, frames))
                self.stats["backpressure_seconds"] += time.time() - tq
            except Exception as e:  # surface errors to every waiter
                for r in group:
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()

    def _complete(self) -> None:
        while True:
            item = self._done_q.get()
            if item is None:
                return
            group, wav, frames = item
            try:
                wavs = materialize_wavs(wav, frames, self.cfg)
                for r, w in zip(group, wavs):
                    r.wav = w
                self.stats["audio_seconds"] += sum(
                    len(w) / self.cfg.audio.sample_rate for w in wavs)
            except Exception as e:
                for r in group:
                    r.error = f"{type(e).__name__}: {e}"
            for r in group:
                r.done.set()

    def _fail_pending(self) -> None:
        """Error out every request still in the submit queue."""
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            r.error = "service closed"
            r.done.set()

    def close(self) -> None:
        """Orderly shutdown, idempotent: no new submits; the in-flight batch
        finishes and wakes its waiters (the worker is joined before the
        completer's sentinel, so whatever it queued is still read back);
        queued-but-undispatched requests fail at once.  If the worker
        outlives its join (a wedged card), its requests fail now and the
        completer is left to consume a late result."""
        with self._submit_lock:
            self._stop.set()
        self._worker.join(timeout=600)
        if self._worker.is_alive():
            for r in self._inflight:
                if not r.done.is_set():
                    r.error = "service closed during dispatch"
                    r.done.set()
        else:
            self._done_q.put(None)
            self._completer.join(timeout=60)
        self._fail_pending()


def _pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> little-endian int16, the quantization of the
    device pcm16 path (int16 input passes through)."""
    if audio.dtype == np.int16:
        return audio.astype("<i2", copy=False)
    return np.clip(np.rint(audio * 32768.0), -32768, 32767).astype("<i2")


def _wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(_pcm16(audio).tobytes())
    return buf.getvalue()


def _wav_header(n_samples: int, sample_rate: int) -> bytes:
    """The 44-byte mono 16-bit RIFF header of a known-length stream, the
    bytes the wave module writes, available before the audio exists."""
    data = n_samples * 2
    return (b"RIFF" + struct.pack("<I", 36 + data) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                          sample_rate * 2, 2, 16)
            + b"data" + struct.pack("<I", data))


def make_handler(service: SynthesisService):
    cfg = service.cfg

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_request(self):
            length = int(self.headers.get("Content-Length", "0"))
            mel = np.load(io.BytesIO(self.rfile.read(length)),
                          allow_pickle=False)
            sid = self.headers.get("X-Speaker-Id")
            temp = self.headers.get("X-Temp")
            return mel, dict(
                seed=int(self.headers.get("X-Seed", "0")),
                speaker_id=int(sid) if sid is not None else None,
                temp=float(temp) if temp is not None else None)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model": f"{cfg.model.n_block}x{cfg.model.n_flow}",
                    "sample_rate": cfg.audio.sample_rate,
                    "num_mels": cfg.audio.num_mels,
                    "data_parallel": service._batch_multiple,
                    "device": str(service.device),
                })
            elif self.path == "/stats":
                self._json(200, service.stats)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/synthesize", "/synthesize_stream"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                mel, kw = self._read_request()
                if self.path == "/synthesize_stream":
                    chunk = self.headers.get("X-Chunk-Frames")
                    self._stream_response(
                        mel, chunk_frames=int(chunk) if chunk else None,
                        **kw)
                    return
                if mel.ndim == 2 and mel.shape[0] > service.max_frames:
                    # long-form on the one-shot endpoint: the server's own
                    # streaming path, same complete-WAV response
                    self._stream_response(mel, chunk_frames=None, **kw)
                    return
                wav = service.submit(mel, **kw)
            except (ValueError, KeyError) as e:
                self._json(400, {"error": str(e)})
                return
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            body = _wav_bytes(wav, cfg.audio.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream_response(self, mel, *, seed, speaker_id, temp,
                             chunk_frames):
            """Plan and validate first (errors still get their statuses),
            then write a progressive WAV with exact Content-Length; a
            failure after the headers can only cut the body short."""
            n_samples, chunks = service.stream(
                mel, seed=seed, speaker_id=speaker_id, temp=temp,
                chunk_frames=chunk_frames)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(44 + 2 * n_samples))
            self.end_headers()
            self.wfile.write(_wav_header(n_samples, cfg.audio.sample_rate))
            try:
                for block in chunks:
                    self.wfile.write(block)
                    self.wfile.flush()
            except Exception:
                self.close_connection = True

    return Handler


def serve(params, cfg: Config, host: str = "127.0.0.1", port: int = 8800,
          **service_kw) -> ThreadingHTTPServer:
    """Start the server (returns it; call .serve_forever() or shutdown()).
    ``service_kw`` go to :class:`SynthesisService` (``device`` defaults to
    the card)."""
    service = SynthesisService(params, cfg, **service_kw)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    httpd.service = service  # type: ignore[attr-defined]
    return httpd


def main(argv=None):
    import argparse

    from ..config import get_config
    from ..synthesis.synthesize import load_params, local_data_mesh

    p = argparse.ArgumentParser(
        description="FloWaveNet serving on the GPU (PyTorch port)")
    p.add_argument("--saved_dir", default="logs/pretrained/")
    p.add_argument("--config", default="lj22k")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--batch_window_ms", type=float, default=10.0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split each micro-batch over this many devices "
                        "(0 = one device; -1 = every local card)")
    args = p.parse_args(argv)
    mesh = (local_data_mesh(args.data_parallel, args.device)
            if args.data_parallel else None)
    cfg = get_config(args.config)
    params, step = load_params(args.saved_dir, cfg, device=args.device)
    httpd = serve(params, cfg, args.host, args.port,
                  max_batch=args.max_batch,
                  batch_window_ms=args.batch_window_ms, mesh=mesh,
                  device=args.device)
    print(f"serving step-{step} model on http://{args.host}:{args.port} "
          f"({args.device})")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
