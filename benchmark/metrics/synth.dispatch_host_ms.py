"""Mean host milliseconds of a ``dispatch_mels`` call in the window (the
benchmark's span around it).  The call returns before the card runs the
batch, so this is host work: operand folding and packing, uploads and
launches."""

from fwbench.trace import span_mean_ms


def read(run):
    return span_mean_ms(run, "dispatch")
