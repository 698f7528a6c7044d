"""Host milliseconds per ``dispatch_mels`` call in the plain blocks'
one-row products: the program's ``fwn.conv.per_row`` spans (one per
per-row loop of ``ops/conv.py:conv1x1``) in the window."""

from fwbench.program import host_ms_per_call


def read(run):
    return host_ms_per_call(run, lambda n: n == "fwn.conv.per_row")
