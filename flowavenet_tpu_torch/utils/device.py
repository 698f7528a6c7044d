"""Host data on the device without waiting for the card.

A copy from pageable host memory to the card waits for the work already
queued on the stream, so a constant built with ``torch.as_tensor(array,
device=...)`` inside the reverse pass would make every dispatch wait for
the one before it.  The synthesis path reads such constants (index arrays,
shift matrices) from a per-device cache (:func:`constant`) and uploads its
per-call inputs through pinned memory (:func:`upload`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=512)
def _cached(raw: bytes, shape: tuple, np_dtype: str, device: str,
            dtype) -> torch.Tensor:
    arr = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    return torch.as_tensor(arr.copy(), dtype=dtype, device=device)


def constant(arr, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(arr, dtype, device)`` for a host array, cached by
    content and device (callers must not write to the result)."""
    arr = np.ascontiguousarray(arr)
    return _cached(arr.tobytes(), arr.shape, arr.dtype.str,
                   str(torch.device(device)), dtype)


def upload(x, dtype, device) -> torch.Tensor:
    """A Python number, sequence, array or tensor as a ``dtype`` tensor on
    ``device`` without a pageable copy: numbers are filled on the device,
    host data goes through pinned memory with ``non_blocking``."""
    device = torch.device(device) if device is not None else None
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.device.type != "cpu" or device is None:
        return t.to(device=device, dtype=dtype)
    t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
