"""Profiling hooks (twin of ``flowavenet_tpu/utils/profiling.py``):

* ``trace(logdir)``: a ``torch.profiler`` window over CPU and, when a card
  is present, CUDA activity; it waits for the card before it stops and
  writes a Chrome trace (``*.pt.trace.json``, chrome://tracing or
  Perfetto) under ``logdir``;
* ``span`` / ``count``: the program's own host spans and counters (below);
* ``StepTimer``: wall-clock stats that leave out the first step(s);
* ``device_memory_stats``: memory in use on each card;
* ``BlockStages``: synthesis split by stage (the upsampler and each
  ``block_reverse``), with each stage's time and row 0 of its output.

Program spans and counters.  ``span(name, **attrs)`` records one
:class:`Span` in an in-memory ring of the last ``SPAN_RING`` spans: its
name, start and end on ``time.perf_counter_ns()``, its own sequence number
and its parent's (the span open on the same thread when it started; 0 at
the top), the thread and the attrs (the ``with`` block receives the attrs
dict and may add to it).  ``count(name, n)`` adds to a cumulative integer
counter.  ``spans()`` and ``counters()`` return snapshots; ``ANCHOR`` is
one ``(time.time_ns(), time.perf_counter_ns())`` pair taken at import, so
a span's start on the wall clock is ``ANCHOR[0] + start_ns - ANCHOR[1]``.
Recording is always on (``enabled``, for tests and cost measurements,
turns it off).  While a ``torch.profiler`` window is open, and only then,
each span also opens ``torch.profiler.record_function(name)``, so it sits
on the profiler's timeline (the clock of the device events) and in the
Chrome trace that ``trace`` writes.

Every name starts with ``fwn.``:

* ``fwn.synth.dispatch``: all of ``synthesis/synthesize.py:dispatch_mels``;
  attrs ``rows``, ``pad_frames``, ``requested_samples`` and, at exit,
  ``matmuls`` (the change in ``fwn.conv.matmuls`` over the call) and
  ``cuda_frees`` (the change in the caching allocator's
  ``num_device_free`` on the call's cards, each ``cudaFree`` a wait for
  the whole card; 0 off the card);
* its children ``fwn.synth.pack`` (the padded mel batch, the seed, temp and
  id arrays, and host noise on that route), ``fwn.synth.upload`` (the mel
  batch, host noise and speaker ids to the device), ``fwn.synth.noise``
  (device noise), ``fwn.model.reverse`` and ``fwn.synth.pcm16``;
* inside ``fwn.model.reverse`` (``models/flowavenet.py``):
  ``fwn.model.upsample`` (``_prepare_cond``, also in training) and one
  ``fwn.model.block`` per ``block_reverse`` (attr ``block``);
* weight folding, wherever it runs: ``fwn.fold.wn`` (``ops/conv.py:
  wn_kernel``), ``fwn.fold.pair`` (the ``ops/pair_flow.py:
  pair_reverse_operands*`` builders, attr ``kind``; they nest), ``fwn.
  fold.pack`` (``_launch``'s packing of the operands) and
  ``fwn.fold.cond_perm`` (``models/flowavenet.py:_permute_cond_rows``);
* ``fwn.conv.per_row``: one per per-row loop of ``ops/conv.py:conv1x1``
  (attr ``rows``);
* ``fwn.serve.dispatch``: the server's ``_dispatch_group`` (attr
  ``requests``);
* counter ``fwn.conv.matmuls``: the products ``conv1x1`` and
  ``conv1x1_int8`` issue (a per-row loop counts one per row).

The benchmark's per-layer readers (``benchmark/fwbench/program.py``) select
a run's spans by their start on the wall clock.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_RING = 65536
ANCHOR = (time.time_ns(), time.perf_counter_ns())
enabled = True
_ring: collections.deque = collections.deque(maxlen=SPAN_RING)
_counters: dict = {}
_counter_lock = threading.Lock()
_seq = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    seq: int
    parent: int
    thread: int
    attrs: dict


class _Open:
    """One open span (see the module docstring)."""

    __slots__ = ("name", "attrs", "seq", "parent", "t0", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.seq = name, attrs, 0

    def __enter__(self) -> dict:
        if not enabled:
            return self.attrs
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else 0
        self.seq = next(_seq)
        stack.append(self.seq)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self.attrs

    def __exit__(self, *exc) -> bool:
        if not self.seq:
            return False
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        _ring.append(Span(self.name, self.t0, t1, self.seq, self.parent,
                          threading.get_ident(), self.attrs))
        return False


def span(name: str, **attrs) -> _Open:
    """``with span("fwn....", key=value) as attrs:`` records the block."""
    return _Open(name, attrs)


def spanned(name: str, **attrs):
    """Decorator: each call of the function runs inside ``span(name,
    **attrs)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _Open(name, dict(attrs)):
                return fn(*args, **kwargs)
        return run
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the cumulative counter ``name``."""
    if enabled:
        with _counter_lock:
            _counters[name] = _counters.get(name, 0) + n


def spans() -> list:
    """The ring's spans, oldest first (by end)."""
    return list(_ring)


def counters() -> dict:
    return dict(_counters)


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
