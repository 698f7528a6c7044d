"""Optional TensorBoard event writer (twin of
``flowavenet_tpu/training/tb_writer.py``) on
``torch.utils.tensorboard.SummaryWriter``.

The trainer's primary metrics stream is JSONL (``metrics.py``); this
mirrors scalars and audio into TensorBoard event files when the
``tensorboard`` package is importable.  It is not a dependency: without it
construction fails softly and the trainer goes on with JSONL only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class TensorBoardWriter:
    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                f"tensorboard writer needs the tensorboard package: {e}")
        self._writer = SummaryWriter(logdir)

    def scalars(self, step: int, values: dict) -> None:
        for k, v in values.items():
            self._writer.add_scalar(k, float(v), step)
        self._writer.flush()

    def wav(self, step: int, name: str, audio: np.ndarray,
            sample_rate: int) -> None:
        data = torch.from_numpy(np.asarray(audio, np.float32).reshape(1, -1))
        self._writer.add_audio(name, data, step, sample_rate=sample_rate)
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def maybe_tb_writer(logdir: str) -> Optional[TensorBoardWriter]:
    try:
        return TensorBoardWriter(logdir)
    except ImportError:
        return None
