"""``cudaFree`` calls per ``dispatch_mels`` call: the mean ``cuda_frees``
attr of the window's ``fwn.synth.dispatch`` spans (the change in the
caching allocator's ``num_device_free`` over each call; each free waits
for the whole card)."""

from fwbench.program import dispatch_attr_mean


def read(run):
    return dispatch_attr_mean(run, "cuda_frees")
