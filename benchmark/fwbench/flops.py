"""Yardsticks: the model's FLOPs from the configuration's shapes, the work
and least time of one reverse pair launch (a frozen copy of the program's
``ops/pair_flow.py:pair_cost`` counts), and the card's published peaks.

Counts are FLOPs, two per multiply-add, of what the model asks for: the
coupling nets' convolutions and 1x1s over the audio's own length (not the
padding, not a recompute), the upsampler, and the speaker term once per
row (the speaker embedding is constant over time).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16 = 989e12          # FLOP/s
PEAK_INT8 = 1979e12         # OP/s
HBM_BYTES_S = 3.35e12       # bytes/s


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


def pair_cost(B: int, T: int, r_in: int, cc: int, r: int = 256,
              int8: bool = False) -> dict:
    """Work of one direct reverse pair launch over [B, T] output rows: the
    operations by type and the bytes that must move (each input read once,
    each output written once), from the shapes; frozen from the program's
    ``pair_cost`` (direct convolutions, no Winograd discount, not
    hoisted)."""
    rows = 2 * B * T                      # two nets per pair
    fg = rows * 2 * 2 * 3 * r * 2 * r
    cond = rows * 2 * 2 * cc * 2 * r
    rest = rows * 2 * (r * 2 * r + 2 * r * r + 3 * r_in * r + r * 2 * r_in)
    es = 2                                # bf16 storage
    c_bytes = 2 * B * T * cc * (1 if int8 else es)
    uv_bytes = 4 * B * T * r_in * es
    w_fg = 2 * 2 * 3 * r * 2 * r * (1 if int8 else es)
    w_cond = 2 * 2 * cc * 2 * r * (1 if int8 else es)
    w_bytes = w_fg + w_cond + 2 * es * (3 * r_in * r + 3 * r * r
                                        + r * 2 * r_in)
    return {"fg_cond_ops": fg + cond, "other_ops": rest,
            "bytes": c_bytes + uv_bytes + w_bytes}


def pair_i8_bound_s(B: int, T: int, r_in: int, cc: int, r: int = 256
                    ) -> float:
    """Least seconds of one ``pair_flow_i8`` launch: the filter|gate convs
    and the conditioning 1x1s at the int8 peak, the rest at the bf16 peak,
    or the bytes at the HBM rate, whichever is longer."""
    c = pair_cost(B, T, r_in, cc, r, int8=True)
    ops_s = c["fg_cond_ops"] / PEAK_INT8 + c["other_ops"] / PEAK_BF16
    return max(ops_s, c["bytes"] / HBM_BYTES_S)
