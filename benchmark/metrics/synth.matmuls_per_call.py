"""Products the model issues per ``dispatch_mels`` call: the mean
``matmuls`` attr of the window's ``fwn.synth.dispatch`` spans (the change
in the program's ``fwn.conv.matmuls`` counter over each call; a per-row
loop counts one product per row)."""

from fwbench.program import dispatch_attr_mean


def read(run):
    return dispatch_attr_mean(run, "matmuls")
