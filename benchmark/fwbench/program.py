"""The measured program's own spans and counters in a run's window.

The program records host spans in a ring (``flowavenet_tpu_torch/utils/
profiling.py``: name, start and end on ``time.perf_counter_ns()``, its
sequence number and its parent's, attrs) with an anchor that places them on
the wall clock.  A span belongs to the window when its start lies in
``[t_start + setup_s, t_start + setup_s + window_s]``, so the warm-up
before the window and a traced stretch after it are left out.  A program
without the ring (an older commit) gives None, and so do the readers.
"""

from __future__ import annotations

DISPATCH = "fwn.synth.dispatch"


def window_spans(run):
    """The program's spans that started in the window, or None when the
    program records none."""
    try:
        from flowavenet_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or not run.window_s:
        return None
    wall0, perf0 = profiling.ANCHOR
    lo = (run.t_start + run.setup_s) * 1e9 + perf0 - wall0
    hi = lo + run.window_s * 1e9
    return [s for s in profiling.spans() if lo <= s.start_ns <= hi]


def dispatches(run):
    """The window's ``fwn.synth.dispatch`` spans (None without any)."""
    spans = window_spans(run)
    if spans is None:
        return None
    return [s for s in spans if s.name == DISPATCH] or None


def host_ms_per_call(run, match, outermost: bool = False):
    """Host milliseconds per dispatch call in the window's spans whose name
    ``match`` accepts; with ``outermost``, a span inside another accepted
    span is not added again."""
    spans, calls = window_spans(run), dispatches(run)
    if not calls:
        return None
    by_seq = {s.seq: s for s in spans}

    def inside_match(s) -> bool:
        p = by_seq.get(s.parent)
        while p is not None:
            if match(p.name):
                return True
            p = by_seq.get(p.parent)
        return False

    ns = sum(s.end_ns - s.start_ns for s in spans if match(s.name)
             and not (outermost and inside_match(s)))
    return ns / 1e6 / len(calls)


def dispatch_attr_mean(run, key: str):
    """Mean of the attr ``key`` over the window's dispatch spans."""
    calls = dispatches(run)
    vals = [s.attrs[key] for s in calls or () if key in s.attrs]
    return sum(vals) / len(vals) if vals else None
