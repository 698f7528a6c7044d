"""Mean host milliseconds from a ``train_step`` call to its return in the
window (the benchmark's span).  The step never synchronizes, so this is
the host's time to enqueue one step."""

from fwbench.trace import span_mean_ms


def read(run):
    return span_mean_ms(run, "train_step")
