"""Host milliseconds per ``dispatch_mels`` call preparing its inputs: the
program's ``fwn.synth.pack`` (padded batch and seed arrays), ``.upload``
(mel batch and speaker ids to the device) and ``.noise`` (device noise)
spans in the window."""

from fwbench.program import host_ms_per_call

INPUTS = ("fwn.synth.pack", "fwn.synth.upload", "fwn.synth.noise")


def read(run):
    return host_ms_per_call(run, lambda n: n in INPUTS)
