"""Mean host milliseconds to take the next prefetched batch from the
loader and hand it to the device (the benchmark's span), per step of the
window."""

from fwbench.trace import span_mean_ms


def read(run):
    return span_mean_ms(run, "data_wait")
