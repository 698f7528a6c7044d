"""Metrics: a JSONL scalar stream and wav dumps (twin of
``flowavenet_tpu/training/metrics.py``; the same file layout, so the
JAX package's run tools read either)."""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsWriter:
    def __init__(self, logdir: str, name: str = "metrics"):
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, f"{name}.jsonl")
        self._f = open(self._path, "a", buffering=1)
        self._logdir = logdir

    def scalars(self, step: int, values: dict) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")

    def wav(self, step: int, name: str, audio: np.ndarray,
            sample_rate: int) -> None:
        from ..audio.wavio import write_wav
        wav_dir = os.path.join(self._logdir, "wavs")
        os.makedirs(wav_dir, exist_ok=True)
        write_wav(os.path.join(wav_dir, f"{name}-{step}.wav"),
                  np.asarray(audio).reshape(-1), sample_rate)

    def close(self) -> None:
        self._f.close()


def format_step(step: int, dt: float, metrics: dict) -> str:
    """The console line of the reference trainer."""
    return (f"Step {step:7d} [{dt:.3f} sec/step, "
            f"loss={float(metrics['loss']):.5f}, "
            f"log_p={float(metrics['log_p']):.5f}, "
            f"logdet={float(metrics['logdet']):.5f}, "
            f"bits/dim={float(metrics['bits_per_dim']):.5f}]")
