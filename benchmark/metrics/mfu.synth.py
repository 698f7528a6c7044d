"""Model FLOP utilization of synthesis: the model's FLOPs for the audio
requested and delivered in the window (``fwbench/flops.py``, from the
configuration's shapes; padding not counted) over the window's seconds and
the card's bf16 dense peak, in percent."""

from fwbench import flops


def read(run):
    samples = run.counters.get("synth.requested_samples")
    if not samples or not run.window_s:
        return None
    f = flops.model_flops(run.cell.config, samples,
                          run.counters["synth.rows"])
    return 100.0 * f / run.window_s / flops.PEAK_BF16
