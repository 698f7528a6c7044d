"""Share of its roofline that ``pair_flow_i8`` (the int8 reverse pair,
kernel ``pair_reverse_kernel<bf16, I8, COND_I8, no RS, direct>``) reaches
in the traced batches: the least time of its launches' work
(``fwbench/flops.py:pair_i8_bound_s``, per launch from the block's shapes)
over the profiler's device time of those launches, in percent.  The blocks
it runs on are those whose filter|gate convs the configuration states in
int8; where the trace holds another number of launches than those blocks
make, the route has changed and nothing is read."""

import re

from fwbench import flops

KERNEL = re.compile(r"pair_reverse_kernel<[^,]+,\s*true,\s*1,\s*false,\s*0\b")


def read(run):
    tr = run.tracer.result if run.tracer is not None else None
    if tr is None:
        return None
    secs, calls = tr.kernel_seconds(lambda n: bool(KERNEL.search(n)))
    model = run.cell.model
    blocks = run.cell.config["precision"]["int8"].get("fg", [])
    batches = run.counters.get("trace.batches", 0)
    B, pad = run.notes.get("batch_rows"), run.notes.get("batch_pad_frames")
    per_batch = len(blocks) * model["n_flow"] // 2
    if not secs or not batches or calls != batches * per_batch:
        return None
    T = pad * run.cell.config["audio"]["hop_size"]
    bound = 0.0
    for bi in blocks:
        k = bi + 1
        bound += model["n_flow"] // 2 * flops.pair_i8_bound_s(
            B, T >> k, 2 ** bi, model["num_mels"] * 2 ** k // 2,
            model["filter_size"])
    return 100.0 * batches * bound / secs
