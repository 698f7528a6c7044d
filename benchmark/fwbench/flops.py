"""Yardsticks: the model's FLOPs from the configuration's shapes (each
family counts its own, ``fwbench/families/``), the work and least time of
one reverse pair launch (a frozen copy of the program's
``ops/pair_flow.py:pair_cost`` counts), and the card's published peaks.

Counts are FLOPs, two per multiply-add, of what the model asks for: its
convolutions and 1x1s over the audio's own length (not the padding, not a
recompute), the upsampler, and a term constant over time, such as the
speaker's, once per row.
"""

from __future__ import annotations

from . import families

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16 = 989e12          # FLOP/s
PEAK_INT8 = 1979e12         # OP/s
HBM_BYTES_S = 3.35e12       # bytes/s


def model_flops(config: dict, samples: float, rows: float) -> float:
    """FLOPs of one pass (reverse, or the forward of the likelihood) of a
    configuration file's model over ``samples`` audio samples in ``rows``
    utterances, counted by its family."""
    return families.of(config).model_flops(config["model"], samples, rows)


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
