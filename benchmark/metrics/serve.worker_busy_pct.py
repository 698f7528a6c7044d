"""Share of the window the service's worker thread spent draining,
grouping and dispatching: the growth of ``SynthesisService.stats``
"busy_seconds" over the window, in percent."""


def read(run):
    if "service.busy_seconds" not in run.counters or not run.window_s:
        return None
    return 100.0 * run.counters["service.busy_seconds"] / run.window_s
