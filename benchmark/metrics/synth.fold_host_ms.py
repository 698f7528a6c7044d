"""Host milliseconds per ``dispatch_mels`` call spent folding weights into
kernel operands: the program's outermost ``fwn.fold.*`` spans in the window
(``wn_kernel``, the ``pair_reverse_operands*`` builders, ``_launch``'s
packing, ``_permute_cond_rows``), a fold inside a fold counted once."""

from fwbench.program import host_ms_per_call


def read(run):
    return host_ms_per_call(run, lambda n: n.startswith("fwn.fold."),
                            outermost=True)
