"""The comparisons that decide ``correct``.

Synthesis (offline and served): a sample of the rows the timed path
returned, each recomputed alone by the plain reference (the program's rows
are batch-invariant: a row's audio depends on its mel, noise seed,
temperature and padded length only) from the same weights, mel and seed,
with the noise and the padding worked out again here.  Two numbers, over
the sampled rows: the worst row's relative RMS gap to the reference's
16-bit audio, and the largest gap of any sample, in 16-bit steps.

Training: the loss of each checked step, the first gradient as the
optimizer took it and the parameters' change after the checked steps,
each leaf's norm against the reference's (``leaf_gaps``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import noise, weights
from .references import load as load_reference


def pcm16(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 32768.0), -32768.0, 32767.0)


def reference_params(config: dict, seed: int, device, dtype):
    """The run's weights as the program got them (``dtype``), in fp32."""
    tree = weights.make(config, seed, device, dtype)
    return weights.map_leaves(lambda t: t.float(), tree)


def synth_rows(ref, params, model: dict, items: list, temp: float,
               hop: int, device, prec=None) -> list:
    """Reference audio [frames * hop] of each item (dict with mel
    [frames, mels], seed, pad_frames and speaker), one row at a time."""
    out = []
    for it in items:
        T = it["pad_frames"] * hop
        z = torch.from_numpy(noise.normal(it["seed"], T)).to(device) * temp
        mel = np.zeros((it["pad_frames"], it["mel"].shape[1]), np.float32)
        mel[: len(it["mel"])] = it["mel"]
        spk = (torch.tensor([it["speaker"]], device=device)
               if it.get("speaker") is not None else None)
        a = ref.reverse(params, model, z[None],
                        torch.from_numpy(mel)[None].to(device), spk,
                        pr=prec)[0]
        out.append(a[: len(it["mel"]) * hop])
    return out


def audio_numbers(got: list, want: list) -> dict:
    """rel_rms: the worst row's RMS gap over its reference's RMS, both as
    16-bit audio; max_abs_lsb: the largest gap of any sample."""
    rel, mx = 0.0, 0.0
    for g, w in zip(got, want):
        w = pcm16(w.float())
        g = g.to(w.device).float()
        if g.shape != w.shape:
            return {"rel_rms": float("inf"), "max_abs_lsb": float("inf")}
        d = g - w
        rel = max(rel, float(d.pow(2).mean().sqrt()
                             / w.pow(2).mean().sqrt().clamp(min=1.0)))
        mx = max(mx, float(d.abs().max()))
    return {"rel_rms": rel, "max_abs_lsb": mx}


def check_synthesis(run, items: list, *, control: bool = False) -> dict:
    """Fill ``run``'s checks for the sampled ``items`` (each with the
    program's int16 row under "got"); with ``control`` the reference in
    the lower precision takes the program's place."""
    cell = run.cell
    model = cell.model
    ref = load_reference(cell.config["reference"])
    ref.no_tf32()
    dt = getattr(torch, cell.config["precision"]["serve_weights"])
    params = reference_params(cell.config, run.seed, run.device, dt)
    hop = cell.config["audio"]["hop_size"]
    temp = cell.config["train"]["temp"]
    want = synth_rows(ref, params, model, items, temp, hop, run.device)
    if control:
        got = [pcm16(a) for a in synth_rows(
            ref, params, model, items, temp, hop, run.device,
            prec=ref.Prec("lower", cell.config["precision"]["int8"]))]
    else:
        got = [torch.from_numpy(np.asarray(it["got"]).astype(np.float32))
               for it in items]
    nums = audio_numbers(got, want)
    for k, v in nums.items():
        run.check(k, v)
    return nums


def leaf_gaps(got: list, want: list, keep=None) -> list:
    """Per leaf, |norm(got) - norm(want)| over the larger of norm(want)
    and the median leaf's norm (``keep``: the leaves compared)."""
    idx = range(len(want)) if keep is None else keep
    nw = np.array([float(want[i].float().norm()) for i in idx])
    ng = np.array([float(got[i].float().norm()) for i in idx])
    return (np.abs(ng - nw) / np.maximum(nw, np.median(nw))).tolist()
