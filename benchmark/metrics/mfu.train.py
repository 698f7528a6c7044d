"""Model FLOP utilization of training: three times the forward FLOPs of
the samples trained on in the window (forward and backward, not the
recompute of rematerialization) over the window's seconds and the card's
bf16 dense peak, in percent."""

from fwbench import flops


def read(run):
    samples = run.counters.get("train.samples")
    if not samples or not run.window_s:
        return None
    rows = run.counters["train.steps"] * run.cell.traffic["batch"]
    f = 3.0 * flops.model_flops(run.cell.config, samples, rows)
    return 100.0 * f / run.window_s / flops.PEAK_BF16
