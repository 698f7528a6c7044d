"""Host input pipeline: records -> random aligned crops -> prefetched batches.

A copy of ``flowavenet_tpu/data/dataset.py`` (which imports no JAX) kept
in the port, which may not import the JAX package; the two must give
bit-identical batches for the same (seed, step).

Replaces the reference's tf.data pipeline (reference dataset.py:8-100)
with a deterministic, resumable host loader:

* random aligned crop of ``max_time_steps // hop`` mel frames and the
  matching ``hop``-aligned audio window (dataset.py:73-76);
* the reference crashes on clips shorter than the crop
  (``tf.random.uniform(maxval=mel_frames - max_frames)`` with negative
  maxval, papered over by catch-and-continue in train.py:241-243) — we pad
  short clips instead, as the reference's dead ``_adjust_time_resolution``
  helper intended (tfrecord.py:41-49);
* sampling is counter-based: batch ``step`` is drawn from
  ``np.random.Philox(key=(seed, step))`` so a resumed run continues the
  exact data stream (SURVEY §5.3 deterministic-resume requirement);
* a background thread keeps a small prefetch queue so host IO overlaps
  device step time (replaces dataset.prefetch, dataset.py:28).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from .records import FwRecordReader


class CropDataset:
    def __init__(self, record_path: str, *, hop_size: int,
                 max_time_steps: int, batch_size: int, seed: int = 42,
                 with_speaker: bool = False):
        self.reader = FwRecordReader(record_path)
        if len(self.reader) == 0:
            raise ValueError(f"{record_path} contains no records")
        self.hop = hop_size
        self.mel_crop = max_time_steps // hop_size
        self.time_crop = self.mel_crop * hop_size
        self.batch_size = batch_size
        self.seed = seed
        self.with_speaker = with_speaker
        self._mel_bins = self.reader.meta(0).mel_bins

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (resume-safe)."""
        rng = np.random.Generator(np.random.Philox(key=[self.seed, step]))
        n = len(self.reader)
        idx = rng.integers(0, n, size=self.batch_size)
        audio = np.zeros((self.batch_size, self.time_crop, 1), np.float32)
        mel = np.zeros((self.batch_size, self.mel_crop, self._mel_bins),
                       np.float32)
        sid = np.zeros((self.batch_size,), np.int32)
        for b, i in enumerate(idx):
            meta = self.reader.meta(int(i))
            avail = meta.mel_frames - self.mel_crop
            if avail > 0:
                start = int(rng.integers(0, avail))
                a, m, s = self.reader.read_crop(int(i), start, self.mel_crop,
                                                self.hop, copy=False)
                audio[b, :, 0], mel[b] = a, m
            else:
                # short clip: take it all, zero-pad the tail (bug fix vs
                # reference crash, train.py:241-243)
                a, m, s = self.reader.read(int(i), copy=False)
                f = min(meta.mel_frames, self.mel_crop)
                mel[b, :f] = m[:f]
                t = min(meta.audio_len, f * self.hop)
                audio[b, :t, 0] = a[:t]
            sid[b] = s
        out = {"audio": audio, "mel": mel}
        if self.with_speaker:
            out["speaker"] = sid
        return out

    def iterate(self, start_step: int = 0,
                prefetch: int = 2) -> Iterator[dict]:
        """Infinite prefetched batch stream starting at ``start_step``."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                batch = self.batch_at(step)
                while not stop.is_set():
                    try:
                        q.put((step, batch), timeout=0.5)
                        break
                    except queue.Full:
                        continue
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                _, batch = q.get()
                yield batch
        finally:
            stop.set()

    def eval_batches(self, max_batches: Optional[int] = None
                     ) -> Iterator[dict]:
        """Sequential deterministic crops over the whole (test) file —
        replaces the reference's shuffled eval iterator (dataset.py:40-44)."""
        count = 0
        for i in range(len(self.reader)):
            if max_batches is not None and count >= max_batches:
                return
            meta = self.reader.meta(i)
            audio = np.zeros((1, self.time_crop, 1), np.float32)
            mel = np.zeros((1, self.mel_crop, self._mel_bins), np.float32)
            f = min(meta.mel_frames, self.mel_crop)
            a, m, s = self.reader.read(i, copy=False)
            mel[0, :f] = m[:f]
            audio[0, : f * self.hop, 0] = a[: f * self.hop]
            out = {"audio": audio, "mel": mel}
            if self.with_speaker:
                out["speaker"] = np.asarray([s], np.int32)
            yield out
            count += 1
