"""The readers of the program's own spans and counters
(``fwbench/program.py`` and the five ``metrics/synth.*`` files that use it)
on traced tiny offline runs on the CPU."""

import math
import time

import pytest
import torch

from fwbench import cells, program
from fwbench.trace import Tracer

READERS = ("synth.fold_host_ms", "synth.per_row_host_ms",
           "synth.inputs_host_ms", "synth.matmuls_per_call",
           "synth.cuda_frees_per_call")


def _traced_run(root, name: str, seed: int):
    """One traced run of a cell, as ``run.py`` drives it, kept for the
    readers."""
    cell = cells.find_cell(name, root, root / "benchmark")
    cells.set_routes(cell.config)
    run = cells.Run(cell, seed, 1.0, True, time.time(), torch.device("cpu"))
    run.tracer = Tracer(True)
    cell.driver().execute(run)
    return run


@pytest.fixture(scope="module", params=["tiny.offline", "tiny_gin.offline"])
def traced(request, tiny_root):
    return _traced_run(tiny_root, request.param, 4000000011)


def test_every_reader_reads_a_number(traced, tiny_root):
    for name in READERS:
        v = cells.metric_reader(name, tiny_root / "benchmark").read(traced)
        assert v is not None and math.isfinite(v), name
    names = {m["name"] for m in traced.cell.per_layer}
    assert set(READERS) <= names


def test_window_holds_the_window_dispatches_only(traced):
    """Neither the warm-up batch before the window nor the traced batches
    after it are selected."""
    calls = program.dispatches(traced)
    assert len(calls) == len(traced.spans["dispatch"])
    assert traced.counters["trace.batches"] >= 1
    rows = traced.cell.traffic["batch"]
    assert all(s.attrs["rows"] == rows for s in calls)


def test_split_adds_up_to_the_dispatch(traced):
    """The self times of every span under the window's dispatch spans add
    up to their durations, and those match the benchmark's own span around
    the call."""
    spans = program.window_spans(traced)
    calls = program.dispatches(traced)
    by_seq = {s.seq: s for s in spans}

    def root(s):
        while s.name != program.DISPATCH:
            s = by_seq[s.parent]
        return s

    covered = {}
    for s in spans:
        if s.parent in by_seq:
            covered[s.parent] = covered.get(s.parent, 0) + (s.end_ns
                                                            - s.start_ns)
    selfs = sum(s.end_ns - s.start_ns - covered.get(s.seq, 0)
                for s in spans if root(s) in calls)
    total = sum(s.end_ns - s.start_ns for s in calls)
    assert selfs == total
    outside = sum(traced.spans["dispatch"]) * 1e9
    assert total <= outside < 1.5 * total


def test_no_program_no_reading(tiny_root, monkeypatch):
    """A program without the span ring (an older commit) reads None."""
    from flowavenet_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    run = cells.Run(cells.find_cell("tiny.offline", tiny_root,
                                    tiny_root / "benchmark"),
                    1, 1.0, True, time.time(), torch.device("cpu"))
    run.window_s = 1.0
    for name in READERS:
        assert cells.metric_reader(name, tiny_root / "benchmark"
                                   ).read(run) is None
