"""ctypes binding of the native C++ FwRecords loader (twin of
``flowavenet_tpu/data/native_loader.py``).

``csrc/fwrec_loader.cc`` is a byte-identical copy of the repo's
``native/fwrec_loader.cc``, so both packages' loaders give one data stream
for a (seed, step).  It is built on first use with the host compiler and
``native/Makefile``'s flags into ``build/flowavenet_tpu_torch/``
(``ops/_build.py:build_host``); without a compiler it raises, naming the
missing tool.  Sampling is counter-based on (seed, step) like
``CropDataset``, but with splitmix64, not numpy's Philox: the native and
Python loaders are each deterministic, not bit-identical to one another.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "fwrec_loader.cc"

_lib: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """The loaded loader library, built if needed."""
    global _lib
    if _lib is not None:
        return _lib
    from ..ops._build import build_host
    lib = ctypes.CDLL(str(build_host(SOURCE)))
    lib.fwrec_open.restype = ctypes.c_void_p
    lib.fwrec_open.argtypes = [ctypes.c_char_p]
    lib.fwrec_count.restype = ctypes.c_int64
    lib.fwrec_count.argtypes = [ctypes.c_void_p]
    lib.fwrec_mel_bins.restype = ctypes.c_int64
    lib.fwrec_mel_bins.argtypes = [ctypes.c_void_p]
    lib.fwrec_record_meta.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.fwrec_batch.restype = ctypes.c_int64
    lib.fwrec_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p, f32p, i32p]
    lib.fwrec_prefetch_start.restype = ctypes.c_int
    lib.fwrec_prefetch_start.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fwrec_prefetch_next.restype = ctypes.c_int64
    lib.fwrec_prefetch_next.argtypes = [ctypes.c_void_p, f32p, f32p, i32p]
    lib.fwrec_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class NativeCropDataset:
    """C++-backed equivalent of ``data.dataset.CropDataset``: ``batch_at``
    and the prefetched ``iterate`` give the same batch for a step."""

    def __init__(self, record_path: str, *, hop_size: int,
                 max_time_steps: int, batch_size: int, seed: int = 42,
                 with_speaker: bool = False):
        self._lib = load_library()
        self._h = self._lib.fwrec_open(record_path.encode())
        if not self._h:
            raise ValueError(f"cannot open FwRecords file {record_path}")
        self.hop = hop_size
        self.mel_crop = max_time_steps // hop_size
        self.time_crop = self.mel_crop * hop_size
        self.batch_size = batch_size
        self.seed = seed
        self.with_speaker = with_speaker
        self.n_records = int(self._lib.fwrec_count(self._h))
        self.mel_bins = int(self._lib.fwrec_mel_bins(self._h))

    def __len__(self) -> int:
        return self.n_records

    def record_meta(self, i: int) -> tuple[int, int, int, int]:
        """(audio_len, mel_frames, mel_bins, speaker_id) of record i."""
        out = np.zeros(4, np.int64)
        self._lib.fwrec_record_meta(self._h, i, out)
        return tuple(int(x) for x in out)

    def _alloc(self):
        return (np.empty((self.batch_size, self.time_crop, 1), np.float32),
                np.empty((self.batch_size, self.mel_crop, self.mel_bins),
                         np.float32),
                np.empty((self.batch_size,), np.int32))

    def _out(self, audio, mel, sid) -> dict:
        out = {"audio": audio, "mel": mel}
        if self.with_speaker:
            out["speaker"] = sid
        return out

    @staticmethod
    def _check_rc(rc: int, hop: int) -> None:
        if rc < 0:
            raise ValueError(
                f"record {~rc}: audio shorter than mel_frames * hop ({hop}); "
                f"audio/mel misaligned FwRecords file")

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (resume-safe)."""
        audio, mel, sid = self._alloc()
        rc = self._lib.fwrec_batch(self._h, self.seed, step, self.batch_size,
                                   self.mel_crop, self.hop,
                                   audio.reshape(-1), mel.reshape(-1), sid)
        self._check_rc(rc, self.hop)
        return self._out(audio, mel, sid)

    def iterate(self, start_step: int = 0, prefetch: int = 3
                ) -> Iterator[dict]:
        """Batches from ``start_step`` on, assembled ahead by the loader's
        own thread (stopped by :meth:`close` or the next ``iterate``)."""
        rc = self._lib.fwrec_prefetch_start(self._h, self.seed, start_step,
                                            self.batch_size, self.mel_crop,
                                            self.hop, prefetch)
        self._check_rc(rc, self.hop)
        while True:
            audio, mel, sid = self._alloc()
            step = self._lib.fwrec_prefetch_next(
                self._h, audio.reshape(-1), mel.reshape(-1), sid)
            if step < 0:
                return
            yield self._out(audio, mel, sid)

    def close(self) -> None:
        if self._h:
            self._lib.fwrec_close(self._h)
            self._h = None
