"""Share of the traced stretch of the window in which no operation ran on
the device (the union of the profiler's device intervals), in percent."""

from fwbench.trace import idle_pct


def read(run):
    return idle_pct(run)
