"""FloWaveNet (arXiv 1811.02155, the ryhorv/tf-flowavenet model): its
parameter layout and its FLOP count.

The tree is the one ``init_flowavenet`` builds (nested dicts and lists,
the flow axis of each block stacked first), laid out here from the
configuration's sizes alone.

Unlike a fresh init, the zero convolutions and the ActNorms are drawn
non-zero (a trained model's are): with zero convs every coupling would be
the identity and synthesis a reshuffle of the noise.  The ActNorm scales
are centred so that 48 flows shrink the noise about tenfold, as a trained
vocoder's do, which keeps the audio inside 16-bit range.
"""

from __future__ import annotations

import math

ZERO_W_SD = 0.01
ZERO_B_SD = 0.01
ACTNORM_B_SD = 0.01
ACTNORM_LOGS = (0.016, 0.01)


def _he(fan_in: int) -> tuple:
    return ("uniform", math.sqrt(6.0 / fan_in))


def _wn_conv(nf: int, k: int, cin: int, cout: int) -> dict:
    """Weight-normalized conv leaves, stacked over ``nf`` flows."""
    return {"v": ((nf, k, cin, cout), _he(k * cin)),
            "g": ((nf, cout), ("const", 1.0)),
            "b": ((nf, cout), _he(cout))}


def layout(model: dict) -> dict:
    """The parameter tree of ``model`` (the config file's ``model``
    section) as {leaf: (shape, distribution)}."""
    nf, R, nl = model["n_flow"], model["filter_size"], model["n_layer"]
    gin = max(model["gin_channels"], 0)
    tree: dict = {"upsample": [
        {"v": ((2 * s, 3, 1, 1), _he(2 * s * 3)),
         "g": ((1,), ("const", 1.0)), "b": ((1,), ("const", 0.0))}
        for s in model["upsample_scales"]]}
    if gin:
        n_sp = model["n_speakers"]
        tree["speaker_emb"] = ((n_sp, gin),
                               ("uniform", math.sqrt(6.0 / (n_sp + gin))))
    blocks = []
    in_ch, cin_ch, g_ch = 1, model["num_mels"], gin
    out_ch = 2 * in_ch
    for _ in range(model["n_block"]):
        sq = 2 * in_ch
        out_ch = sq if model["affine"] else sq // 2
        layers = []
        for _ in range(nl):
            layer = {"filter": _wn_conv(nf, 3, R, R),
                     "gate": _wn_conv(nf, 3, R, R),
                     "filter_c": _wn_conv(nf, 1, cin_ch, R),
                     "gate_c": _wn_conv(nf, 1, cin_ch, R),
                     "res": _wn_conv(nf, 1, R, R),
                     "skip": _wn_conv(nf, 1, R, R)}
            if g_ch:
                layer["filter_g"] = _wn_conv(nf, 1, g_ch, R)
                layer["gate_g"] = _wn_conv(nf, 1, g_ch, R)
            layers.append(layer)
        coupling = {
            "front": _wn_conv(nf, 3, in_ch, R),
            "layers": layers,
            "final": _wn_conv(nf, 1, R, R),
            "zero": {"w": ((nf, 1, R, out_ch), ("normal", (0.0, ZERO_W_SD))),
                     "b": ((nf, out_ch), ("normal", (0.0, ZERO_B_SD))),
                     "scale": ((nf, out_ch), ("const", 0.0))}}
        actnorm = {"b": ((nf, 1, 1, sq), ("normal", (0.0, ACTNORM_B_SD))),
                   "logs": ((nf, 1, 1, sq), ("normal", ACTNORM_LOGS))}
        blocks.append({"flows": {"actnorm": actnorm, "coupling": coupling}})
        in_ch, cin_ch, g_ch = 2 * in_ch, 2 * cin_ch, 2 * g_ch
    tree["blocks"] = blocks
    return tree


def _net_flops(model: dict, k: int) -> tuple[float, float]:
    """(FLOPs of one coupling net at block level k per row of that level,
    FLOPs of its speaker term per utterance)."""
    R, nl = model["filter_size"], model["n_layer"]
    r_in = 2 ** (k - 1)                        # half of the level's channels
    out = 2 * r_in if model["affine"] else r_in
    cc = model["num_mels"] * 2 ** k // 2
    per_row = 2 * 3 * r_in * R                 # front conv, 3 taps
    per_row += nl * (2 * 3 * R * 2 * R         # filter|gate conv, 3 taps
                     + 2 * cc * 2 * R          # conditioning 1x1
                     + 2 * R * R)              # skip 1x1
    per_row += (nl - 1) * 2 * R * R            # res 1x1 (not the last layer)
    per_row += 2 * R * R + 2 * R * out         # final and zero 1x1s
    g = 0.0
    if model["gin_channels"] > 0:
        cg = model["gin_channels"] * 2 ** k // 2
        g = nl * 2 * cg * 2 * R
    return float(per_row), g


def model_flops(model: dict, samples: float, rows: float) -> float:
    """FLOPs of one pass (reverse, or the forward of the likelihood) over
    ``samples`` audio samples in ``rows`` utterances."""
    total = 0.0
    for k in range(1, model["n_block"] + 1):
        per_row, g = _net_flops(model, k)
        total += model["n_flow"] * (per_row * samples / 2 ** k + g * rows)
    # upsampler: a (2s x 3)-tap transposed conv per scale, s/2s of the taps
    # per output, at each scale's output rate
    rate = 1.0
    for s in reversed(model["upsample_scales"]):
        total += 2 * 2 * 3 * model["num_mels"] * samples / rate
        rate *= s
    return total
