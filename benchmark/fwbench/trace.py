"""A ``torch.profiler`` window over part of a run, reduced to what the
metrics read: the device's busy time (the union of device intervals), the
traced span, device time by kernel name, and the longest idle gaps named by
what the host was doing in them.  The reduction is
``chip_smoke.py:trace_split``'s union method, kept here so that the
yardstick does not move with the program.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

# the benchmark's own host spans (record_function labels) start with this
SPAN_PREFIX = "bench."


@dataclass
class Trace:
    window_s: float = 0.0                  # traced span, first to last event
    busy_s: float = 0.0                    # union of device intervals
    device_ops: int = 0
    by_name: dict = field(default_factory=dict)   # kernel -> [seconds, calls]
    gaps: list = field(default_factory=list)      # [(seconds, host label)]

    def kernel_seconds(self, match) -> tuple[float, int]:
        """Device seconds and calls of the kernels whose name ``match``
        accepts."""
        s, n = 0.0, 0
        for name, (t, c) in self.by_name.items():
            if match(name):
                s, n = s + t, n + c
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": [[label, s] for s, label in self.gaps[:top]]}


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns) of every traced event.  A host
    span's projection onto the device timeline (a user annotation) is no
    device work and is left out."""
    from torch.autograd import DeviceType
    try:
        evs = prof.profiler.kineto_results.events()
        out = [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
                e.start_ns() + e.duration_ns(),
                bool(getattr(e, "is_user_annotation", lambda: False)()))
               for e in evs]
    except AttributeError:
        out = [(e.name, e.device_type == DeviceType.CUDA,
                int(e.time_range.start * 1000),
                int(e.time_range.end * 1000), False) for e in prof.events()]
    return [(n, d, s, e) for n, d, s, e, ann in out
            if not (d and (ann or n.startswith(SPAN_PREFIX)))]


def _host_label(host: list, t: int) -> str:
    """The benchmark span and the innermost other host op open at t."""
    span, op, op_start = "", "", -1
    for name, s, e in host:
        if s <= t < e:
            if name.startswith(SPAN_PREFIX):
                span = name
            elif s > op_start:
                op, op_start = name, s
    return " / ".join(x for x in (span, op) if x) or "(no traced host op)"


def reduce(prof, top_gaps: int = 10) -> Trace:
    evs = _raw_events(prof)
    dev = sorted((s, e, n) for n, d, s, e in evs if d and e > s)
    host = [(n, s, e) for n, d, s, e in evs if not d]
    out = Trace()
    if not evs:
        return out
    t0 = min(s for _, _, s, _ in evs)
    t1 = max(e for _, _, _, e in evs)
    out.window_s = (t1 - t0) / 1e9
    if not dev:
        return out
    holes = []
    cur_s, cur_e = dev[0][0], dev[0][1]
    if cur_s > t0:
        holes.append((cur_s - t0, t0, cur_s))
    busy = 0
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            holes.append((s - cur_e, cur_e, s))
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    busy += cur_e - cur_s
    if t1 > cur_e:
        holes.append((t1 - cur_e, cur_e, t1))
    out.busy_s = busy / 1e9
    out.device_ops = len(dev)
    for s, e, n in dev:
        v = out.by_name.setdefault(n, [0.0, 0])
        v[0] += (e - s) / 1e9
        v[1] += 1
    holes.sort(reverse=True)
    out.gaps = [(d / 1e9, _host_label(host, (a + b) // 2))
                for d, a, b in holes[:top_gaps]]
    return out


class Tracer:
    """The profiler over one stretch of a traced run: :meth:`stop` waits for
    the card and closes it; the events are reduced when :attr:`result` is
    first read, after the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.state = "idle"              # idle -> running -> stopped
        self._result: Trace | None = None

    def start(self) -> None:
        if not self.enabled or self.state != "idle":
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.state = "running"

    @property
    def running(self) -> bool:
        return self.state == "running"

    def stop(self) -> None:
        if not self.running:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.state = "stopped"

    @property
    def result(self) -> Trace | None:
        if self.state == "stopped" and self._result is None:
            self._result = reduce(self.prof)
            self.prof = None
        return self._result


@contextlib.contextmanager
def span(name: str):
    """A benchmark host span, visible in the trace when one is open."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def idle_pct(run):
    """Share of the traced stretch in which no operation ran on the device,
    in percent; None without a trace that holds device work."""
    tr = run.tracer.result if run.tracer is not None else None
    if tr is None or not tr.window_s or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def span_mean_ms(run, name: str):
    """Mean milliseconds of the benchmark span ``name`` in the window."""
    s = run.spans.get(name)
    return 1e3 * sum(s) / len(s) if s else None
