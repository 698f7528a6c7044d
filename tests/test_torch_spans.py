"""PyTorch port, the program's own spans and counters
(``utils/profiling.py:span`` / ``count``) and where synthesis records them,
on the CPU: nesting per thread, the ring's bound, no profiler annotation
while no profiler runs, the spans in a ``profiling.trace`` Chrome trace,
one tiny ``dispatch_mels`` call's spans and product count, and the same
audio with recording off and on."""

import dataclasses
import glob
import json
import threading

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.config import tiny, tiny_gin
from flowavenet_tpu_torch.models import flowavenet as fwn
from flowavenet_tpu_torch.synthesis.synthesize import dispatch_mels
from flowavenet_tpu_torch.utils import profiling

CHILDREN = ["fwn.synth.pack", "fwn.synth.upload", "fwn.synth.noise",
            "fwn.model.reverse", "fwn.synth.pcm16"]


def _since(seq: int) -> list:
    return [s for s in profiling.spans() if s.seq > seq]


def _last_seq() -> int:
    s = profiling.spans()
    return max((x.seq for x in s), default=0)


def test_spans_nest_per_thread():
    """Two threads open interleaved spans: each inner span's parent is the
    outer span of its own thread, and attrs added in the block are kept."""
    seq0 = _last_seq()
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span("fwn.test.outer", tag=tag) as attrs:
            barrier.wait()
            with profiling.span("fwn.test.inner", tag=tag):
                barrier.wait()
            attrs["done"] = True

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    spans = _since(seq0)
    outer = {s.attrs["tag"]: s for s in spans if s.name == "fwn.test.outer"}
    inner = {s.attrs["tag"]: s for s in spans if s.name == "fwn.test.inner"}
    assert set(outer) == set(inner) == {"a", "b"}
    for tag in "ab":
        assert inner[tag].parent == outer[tag].seq
        assert inner[tag].thread == outer[tag].thread
        assert outer[tag].parent == 0 and outer[tag].attrs["done"]
        assert (outer[tag].start_ns <= inner[tag].start_ns
                <= inner[tag].end_ns <= outer[tag].end_ns)
    assert outer["a"].thread != outer["b"].thread


def test_ring_is_bounded_and_keeps_the_newest():
    for i in range(profiling.SPAN_RING + 5):
        with profiling.span("fwn.test.fill", i=i):
            pass
    spans = profiling.spans()
    assert len(spans) == profiling.SPAN_RING
    assert spans[-1].attrs["i"] == profiling.SPAN_RING + 4
    assert spans[0].attrs["i"] == 5


def test_counters_and_disabled_recording(monkeypatch):
    before = profiling.counters().get("fwn.test.n", 0)
    profiling.count("fwn.test.n", 3)
    profiling.count("fwn.test.n")
    assert profiling.counters()["fwn.test.n"] == before + 4
    seq0 = _last_seq()
    monkeypatch.setattr(profiling, "enabled", False)
    with profiling.span("fwn.test.off") as attrs:
        attrs["x"] = 1
    profiling.count("fwn.test.n")
    assert _since(seq0) == []
    assert profiling.counters()["fwn.test.n"] == before + 4


def test_anchor_places_spans_on_the_wall_clock(monkeypatch):
    """Spans run on the anchor's second clock, ``perf_counter_ns``: with
    an anchor taken just before, the span's start placed on the wall clock
    lies between two wall-clock readings around it.  (The import-time
    anchor places spans only as well as the two clocks keep pace.)"""
    import time
    assert all(isinstance(t, int) for t in profiling.ANCHOR)
    monkeypatch.setattr(profiling, "ANCHOR",
                        (time.time_ns(), time.perf_counter_ns()))
    t0 = time.time_ns()
    with profiling.span("fwn.test.wall"):
        pass
    t1 = time.time_ns()
    s = profiling.spans()[-1]
    wall0, perf0 = profiling.ANCHOR
    start = wall0 + s.start_ns - perf0
    assert t0 - 1_000_000 <= start <= t1 + 1_000_000


def _model(cfg, seed: int = 0):
    return fwn.init_flowavenet(torch.Generator().manual_seed(seed), cfg.model)


def _mels(n: int = 2):
    r = np.random.RandomState(5)
    return [r.rand(f, 80).astype(np.float32) for f in (10, 7, 9)[:n]]


def _call(cfg, params, **kw):
    ids = [1, 2] if cfg.model.gin_channels else None
    return dispatch_mels(params, cfg, _mels(), seed=[3, 4], speaker_ids=ids,
                         noise="device", pcm16=True, device="cpu", **kw)


def _plain(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 use_pallas=False))


def _derived_matmuls(m, rows: int) -> int:
    """Products ``conv1x1`` / ``conv1x1_int8`` issue in one reverse of
    ``rows`` rows: none on a fused-pair block; on a plain block, per
    coupling net, the front conv per row, per layer the taps GEMM, the
    conditioning (one int8 product, or per row, twice with g) and skip,
    res on every layer but the last, final and zero."""
    has_g = m.gin_channels > 0
    one_row = rows if rows > 1 else 1
    n = 0
    for k in range(1, m.n_block + 1):
        cc_half = (m.num_mels << k) // 2
        if fwn._pair_kernel_mode(m, cc_half, has_g) is not None:
            continue
        int8 = fwn.PAIR_KERNEL_INT8 and fwn._pair_kernel_eligible(m, has_g)
        cond = 1 if int8 else one_row * (2 if has_g else 1)
        net = one_row + m.n_layer * (2 + cond) + (m.n_layer - 1) + 2
        n += m.n_flow * net
    return n


@pytest.mark.parametrize("name", ["tiny", "tiny_plain", "tiny_gin"])
def test_dispatch_spans_children_and_products(name):
    cfg = {"tiny": tiny(), "tiny_plain": _plain(tiny()),
           "tiny_gin": tiny_gin()}[name]
    params = _model(cfg)
    seq0 = _last_seq()
    _call(cfg, params)
    spans = _since(seq0)
    calls = [s for s in spans if s.name == "fwn.synth.dispatch"]
    assert len(calls) == 1
    d = calls[0]
    kids = sorted((s for s in spans if s.parent == d.seq),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == CHILDREN
    assert d.attrs["rows"] == 2 and d.attrs["cuda_frees"] == 0
    assert d.attrs["requested_samples"] == (10 + 7) * cfg.audio.hop_size
    assert d.attrs["pad_frames"] == 60
    want = _derived_matmuls(cfg.model, 2)
    assert d.attrs["matmuls"] == want
    if name != "tiny":
        assert want > 0
    per_row = [s for s in spans if s.name == "fwn.conv.per_row"]
    assert all(s.attrs["rows"] == 2 for s in per_row)
    rev = next(s for s in kids if s.name == "fwn.model.reverse")
    blocks = [s for s in spans if s.name == "fwn.model.block"]
    assert [s.attrs["block"] for s in sorted(blocks, key=lambda s:
                                             s.start_ns)] == [1, 0]
    assert all(s.parent == rev.seq for s in blocks)
    assert all(d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns
               for s in spans if s.name.startswith("fwn."))


@pytest.mark.parametrize("name", ["tiny", "tiny_gin"])
def test_recording_leaves_the_audio_bit_identical(name, monkeypatch):
    cfg = {"tiny": tiny(), "tiny_gin": tiny_gin()}[name]
    params = _model(cfg, 1)
    on, _ = _call(cfg, params)
    seq0 = _last_seq()
    monkeypatch.setattr(profiling, "enabled", False)
    off, _ = _call(cfg, params)
    assert _since(seq0) == []
    assert on.dtype == torch.int16 and torch.equal(on, off)


def test_no_profiler_annotation_without_a_profiler(monkeypatch, tmp_path):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    cfg = tiny_gin()
    params = _model(cfg)
    _call(cfg, params)
    assert calls == []
    with profiling.trace(str(tmp_path)):
        with profiling.span("fwn.test.traced"):
            pass
    assert calls == ["fwn.test.traced"]


def test_spans_in_the_chrome_trace_nest_as_in_the_ring(tmp_path):
    """Under ``profiling.trace`` every span of a tiny call is a
    ``record_function`` range of the same name in the written trace, and
    each child's range lies inside its parent's."""
    cfg = tiny_gin()
    params = _model(cfg)
    _call(cfg, params)                      # warm: nothing lazy traced
    seq0 = _last_seq()
    with profiling.trace(str(tmp_path)):
        _call(cfg, params)
    ring = sorted(_since(seq0), key=lambda s: s.start_ns)
    assert ring
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    traced = sorted((e for e in evs if e.get("ph") == "X"
                     and e["name"].startswith("fwn.")
                     and e.get("cat") != "gpu_user_annotation"),
                    key=lambda e: e["ts"])
    assert sorted(e["name"] for e in traced) == sorted(s.name for s in ring)
    # the k-th span of a name is the k-th range of that name
    of = {}
    for s in ring:
        of.setdefault(s.name, []).append(s)
    match = {}
    for name, group in of.items():
        ranges = [e for e in traced if e["name"] == name]
        for s, e in zip(group, ranges):
            match[s.seq] = e
    for s in ring:
        if s.parent in match:
            c, p = match[s.seq], match[s.parent]
            assert p["ts"] <= c["ts"]
            assert c["ts"] + c["dur"] <= p["ts"] + p["dur"]
