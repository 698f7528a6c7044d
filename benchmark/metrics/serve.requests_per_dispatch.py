"""Requests per reverse dispatch of the HTTP service over the window: the
growth of ``SynthesisService.stats`` "requests" over that of
"dispatches"."""


def read(run):
    d = run.counters.get("service.dispatches", 0)
    return run.counters["service.requests"] / d if d else None
