"""FwRecords: packed binary record format for (audio, mel, speaker) triples.

A copy of ``flowavenet_tpu/data/records.py`` (which imports no JAX) kept
in the port, which may not import the JAX package; the two must give
bit-identical files and reads.

TPU-native replacement for the reference's TFRecord serialization
(reference tfrecord.py:10-88).  Unlike proto-based TFRecords, the
layout is flat fixed-header + raw float32 payloads with a separate offset
index, so readers can

* ``mmap`` the data file and serve **zero-copy slices**, and
* read only the crop window needed for training (the reference always
  deserializes whole utterances just to crop them, dataset.py:62-76),

which is also what the native C++ loader binds against.

Layout of ``name.fwrec``::

    magic   8 bytes  b"FWRECv1\\0"
    records: for each record
        header  4 * int64 little-endian:
                audio_len, mel_frames, mel_bins, speaker_id
        audio   float32[audio_len]
        mel     float32[mel_frames * mel_bins]

``name.fwidx`` is an ``uint64[n_records]`` numpy file of record offsets.
"""

from __future__ import annotations

import mmap
import os
from dataclasses import dataclass

import numpy as np

MAGIC = b"FWRECv1\0"
_HDR = np.dtype("<i8")
_HDR_BYTES = 4 * 8


class FwRecordWriter:
    def __init__(self, path: str):
        self._path = path
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offsets: list[int] = []
        self._pos = len(MAGIC)

    def write(self, audio: np.ndarray, mel: np.ndarray,
              speaker_id: int = 0) -> None:
        audio = np.ascontiguousarray(audio, dtype=np.float32).reshape(-1)
        mel = np.ascontiguousarray(mel, dtype=np.float32)
        assert mel.ndim == 2, f"mel must be [frames, bins], got {mel.shape}"
        hdr = np.array([audio.shape[0], mel.shape[0], mel.shape[1],
                        speaker_id], dtype=_HDR)
        self._offsets.append(self._pos)
        self._f.write(hdr.tobytes())
        self._f.write(audio.tobytes())
        self._f.write(mel.tobytes())
        self._pos += _HDR_BYTES + audio.nbytes + mel.nbytes

    def close(self) -> None:
        self._f.close()
        np.save(self._index_path(self._path),
                np.asarray(self._offsets, dtype=np.uint64))

    @staticmethod
    def _index_path(path: str) -> str:
        base, _ = os.path.splitext(path)
        return base + ".fwidx.npy"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class RecordMeta:
    audio_len: int
    mel_frames: int
    mel_bins: int
    speaker_id: int


class FwRecordReader:
    """mmap-backed random-access reader with zero-copy crop reads."""

    def __init__(self, path: str):
        self._path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[: len(MAGIC)] != MAGIC:
            raise ValueError(f"{path}: bad magic, not an FwRecords file")
        self.offsets = np.load(FwRecordWriter._index_path(path))

    def __len__(self) -> int:
        return len(self.offsets)

    def meta(self, i: int) -> RecordMeta:
        off = int(self.offsets[i])
        hdr = np.frombuffer(self._mm, dtype=_HDR, count=4, offset=off)
        return RecordMeta(int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[3]))

    def read(self, i: int, copy: bool = True
             ) -> tuple[np.ndarray, np.ndarray, int]:
        """Full record (audio [T], mel [F, M], sid).  ``copy=False`` returns
        zero-copy mmap views (caller must not outlive the reader)."""
        m = self.meta(i)
        off = int(self.offsets[i]) + _HDR_BYTES
        audio = np.frombuffer(self._mm, dtype=np.float32, count=m.audio_len,
                              offset=off)
        off += m.audio_len * 4
        mel = np.frombuffer(self._mm, dtype=np.float32,
                            count=m.mel_frames * m.mel_bins,
                            offset=off).reshape(m.mel_frames, m.mel_bins)
        if copy:
            audio, mel = audio.copy(), mel.copy()
        return audio, mel, m.speaker_id

    def read_crop(self, i: int, mel_start: int, mel_frames: int,
                  hop: int, copy: bool = True
                  ) -> tuple[np.ndarray, np.ndarray, int]:
        """Aligned crop without touching the rest of the record
        (audio window = mel window * hop, dataset.py:73-76)."""
        m = self.meta(i)
        if mel_start + mel_frames > m.mel_frames:
            raise IndexError(
                f"crop [{mel_start}, {mel_start + mel_frames}) exceeds "
                f"{m.mel_frames} mel frames of record {i}")
        if (mel_start + mel_frames) * hop > m.audio_len:
            # A record written without the audio_len == mel_frames*hop
            # alignment contract (e.g. a custom pipeline bypassing
            # process_wav) would otherwise silently read the NEXT record's
            # header bytes as audio.
            raise ValueError(
                f"record {i}: audio_len={m.audio_len} shorter than crop end "
                f"{(mel_start + mel_frames) * hop} (= {mel_start + mel_frames}"
                f" mel frames * hop {hop}); audio/mel misaligned record")
        base = int(self.offsets[i]) + _HDR_BYTES
        a_off = base + mel_start * hop * 4
        audio = np.frombuffer(self._mm, dtype=np.float32,
                              count=mel_frames * hop, offset=a_off)
        m_off = (base + m.audio_len * 4
                 + mel_start * m.mel_bins * 4)
        mel = np.frombuffer(self._mm, dtype=np.float32,
                            count=mel_frames * m.mel_bins,
                            offset=m_off).reshape(mel_frames, m.mel_bins)
        if copy:
            audio, mel = audio.copy(), mel.copy()
        return audio, mel, m.speaker_id

    def close(self) -> None:
        self._mm.close()
        self._file.close()


def train_test_split_indices(n: int, test_size: int,
                             random_state: int) -> tuple[np.ndarray, np.ndarray]:
    """Reproduces sklearn.model_selection.train_test_split semantics used by
    the reference (tfrecord.py:80-85: test_size=10, random_state=123) so the
    train/test partition is identical corpus-for-corpus."""
    rng = np.random.RandomState(random_state)
    perm = rng.permutation(n)
    test = perm[:test_size]
    train = perm[test_size:]
    return train, test
