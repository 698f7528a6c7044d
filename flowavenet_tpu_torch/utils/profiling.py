"""Profiling hooks (twin of ``flowavenet_tpu/utils/profiling.py``):

* ``trace(logdir)``: a ``torch.profiler`` window over CPU and, when a card
  is present, CUDA activity; it waits for the card before it stops and
  writes a Chrome trace (``*.pt.trace.json``, chrome://tracing or
  Perfetto) under ``logdir``;
* ``StepTimer``: wall-clock stats that leave out the first step(s);
* ``device_memory_stats``: memory in use on each card;
* ``BlockStages``: synthesis split by stage (the upsampler and each
  ``block_reverse``), with each stage's time and row 0 of its output.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; yields the ``torch.profiler.profile`` object (its
    ``key_averages()`` and ``events()`` are readable after the block)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.pt.trace.json"))


@dataclass
class StepTimer:
    skip_first: int = 1          # leave out the first step(s): builds, warm-up
    times: list = field(default_factory=list)
    _t0: float = 0.0
    _count: int = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip_first:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def best(self) -> float:
        return min(self.times) if self.times else 0.0


def device_memory_stats() -> list[dict]:
    """Bytes in use and their peak on each card (``torch.cuda.
    memory_stats``: the caching allocator's allocated bytes); without a
    card, the CPU with -1 (unknown), as the JAX package reports a device
    without memory statistics."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "bytes_in_use": -1,
                 "peak_bytes_in_use": -1}]
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": s.get("allocated_bytes.all.current", -1),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", -1),
        })
    return out


class BlockStages:
    """Inside the ``with`` block, ``models/flowavenet.py``'s upsampler and
    each ``block_reverse`` run wrapped, in call order: ``upsampler``, then
    ``block n_block - 1`` down to ``block 0``.  ``stage`` names the stage
    running (``-`` outside them); ``ms()`` sums each stage's time (CUDA
    events for tensors on the card, the host clock on the CPU); with
    ``rows=True``, ``rows`` holds (stage, row 0 of its output in fp32)."""

    def __init__(self, rows: bool = False):
        self.keep = rows
        self.stage = "-"
        self.rows, self.times = [], []

    def __enter__(self):
        from ..models import flowavenet as fwn
        self._fwn = fwn
        self._saved = (fwn.block_reverse, fwn.apply_upsample)
        block, up = self._saved
        done = []                    # blocks run since the upsampler

        def timed(fn, label):
            def run(*a, **k):
                self.stage = label(a)
                cuda = next(t for t in a if torch.is_tensor(t)).is_cuda
                if cuda:
                    t0, t1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    t0.record()
                else:
                    t0 = time.perf_counter()
                out = fn(*a, **k)
                if cuda:
                    t1.record()
                else:
                    t1 = time.perf_counter()
                self.times.append((self.stage, t0, t1))
                if self.keep:
                    self.rows.append((self.stage, out[:1].float().clone()))
                self.stage = "-"
                return out
            return run

        def block_label(a):
            done.append(1)
            return f"block {a[1].n_block - len(done)}"

        def up_label(a):
            done.clear()
            return "upsampler"
        fwn.block_reverse = timed(block, block_label)
        fwn.apply_upsample = timed(up, up_label)
        return self

    def __exit__(self, *exc):
        self._fwn.block_reverse, self._fwn.apply_upsample = self._saved

    def ms(self) -> dict:
        out = {}
        for name, t0, t1 in self.times:
            if isinstance(t0, float):
                d = (t1 - t0) * 1e3
            else:
                t1.synchronize()
                d = t0.elapsed_time(t1)
            out[name] = out.get(name, 0.0) + d
        return out
