"""Orthogonal leaves: a family can lay out square weight matrices that
``weights.make`` draws as the Q of a QR of a standard-normal matrix with
det +1, as WaveGlow's invertible 1x1 convolutions start (``glow.py``),
taking their values from the normal buffer in leaf order.

The layouts come from a toy family module in a temporary copy of the
harness, drawn in a process of its own on the copy's fwbench."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]

# A toy family whose tree is its model section's ``leaves``:
# [name, shape, [kind, arg]] in leaf order.
LEAVES_FAMILY = '''"""A toy family laid out by its model section's leaves."""


def layout(model):
    return {name: (tuple(shape), tuple(dist))
            for name, shape, dist in model["leaves"]}


def model_flops(model, samples, rows):
    return 0.0
'''

# Draws each job {key: [config, seed]} in float32 on the CPU; a ValueError
# is kept as its message.
DRAW = '''
import json, sys
from pathlib import Path
import torch
import fwbench
from fwbench import weights
assert Path(fwbench.__file__).resolve().parent == Path(sys.argv[1]).resolve()
out = {}
for key, (config, seed) in json.loads(Path(sys.argv[2]).read_text()).items():
    try:
        out[key] = {"leaves": weights.make(config, seed, "cpu"),
                    "n_params": weights.n_params(config)}
    except ValueError as e:
        out[key] = str(e)
torch.save(out, sys.argv[3])
'''

SEED = 2 ** 31 + 12345
KIND = [["a", [3, 8, 8], ["orthogonal", None]],
        ["u", [5], ["uniform", 0.5]],
        ["b", [6, 6], ["orthogonal", None]],
        ["n", [7], ["normal", [0.25, 2.0]]]]
# WaveGlow (glow.py): 12 flows, n_group 8, 2 channels out early every 4
# flows, so W is 8 x 8 in flows 0-3, 6 x 6 in 4-7 and 4 x 4 in 8-11
WIDTHS = [8] * 4 + [6] * 4 + [4] * 4
GLOW_SEEDS = range(10)
ERRORS = {"unknown": ([["W/7", [4, 4], ["laplace", 1.0]]],
                      ["leaf W/7", "'laplace'"]),
          "not_square": ([["W/3", [4, 3], ["orthogonal", None]]],
                         ["leaf W/3", "(4, 3)"])}


def _config(leaves) -> dict:
    return {"reference": "leaves", "model": {"leaves": leaves}}


def _glow(kind) -> list:
    return [[f"W/{k}", [n, n],
             ["orthogonal", None] if kind == "orthogonal"
             else ["normal", [0.0, n ** -0.5]]]
            for k, n in enumerate(WIDTHS)]


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orth")
    bench = tmp / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (bench / "fwbench" / "families" / "leaves.py").write_text(LEAVES_FAMILY)
    jobs = {"kind": [_config(KIND), SEED],
            "kind_again": [_config(KIND), SEED],
            "kind_other": [_config(KIND), SEED + 1]}
    for kind in ("orthogonal", "normal"):
        for s in GLOW_SEEDS:
            jobs[f"glow_{kind}_{s}"] = [_config(_glow(kind)), s]
    for key, (leaves, _) in ERRORS.items():
        jobs[key] = [_config(leaves), 0]
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, "-c", DRAW, str(bench / "fwbench"),
         str(tmp / "jobs.json"), str(tmp / "drawn.pt")],
        cwd=tmp, env=dict(os.environ, PYTHONPATH=str(bench)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return torch.load(tmp / "drawn.pt")


def _eye_gap(q: torch.Tensor) -> float:
    eye = torch.eye(q.shape[-1], dtype=q.dtype)
    return float((q.mT @ q - eye).abs().max())


def test_orthogonal_leaves_are_orthogonal_with_det_one(drawn):
    leaves = drawn["kind"]["leaves"]
    for name, shape in (("a", (3, 8, 8)), ("b", (6, 6))):
        q = leaves[name]
        assert q.dtype == torch.float32 and tuple(q.shape) == shape
        assert _eye_gap(q) < 1e-6
        det = torch.linalg.det(q.double())
        assert torch.allclose(det, torch.ones_like(det), atol=1e-5)


def test_a_seed_gives_the_same_bits_and_another_seed_others(drawn):
    same, again, other = (drawn[k]["leaves"]
                          for k in ("kind", "kind_again", "kind_other"))
    for name in ("a", "u", "b", "n"):
        assert torch.equal(same[name], again[name])
        assert not torch.equal(same[name], other[name])


def test_orthogonal_leaves_draw_from_the_normal_buffer_in_leaf_order(drawn):
    """The normal buffer holds a's 192 values, b's 36, then n's 7: n reads
    its own offset, and each Q is the Q of its own slice (Q^T A is upper
    triangular)."""
    leaves = drawn["kind"]["leaves"]
    gen = torch.Generator("cpu").manual_seed(SEED)
    uni = torch.rand(5, generator=gen) * 2.0 - 1.0
    nrm = torch.randn(192 + 36 + 7, generator=gen)
    assert torch.equal(leaves["u"], uni * 0.5)
    assert torch.equal(leaves["n"], nrm[228:] * 2.0 + 0.25)
    for name, a in (("a", nrm[:192].view(3, 8, 8)),
                    ("b", nrm[192:228].view(6, 6))):
        r = leaves[name].double().mT @ a.double()
        assert float(r.tril(-1).abs().max()) < 1e-5
    assert drawn["kind"]["n_params"] == 192 + 5 + 36 + 7


def _reverse_rms(ws: dict, seed: int, t: int = 4096) -> float:
    """The RMS of WaveGlow's reverse chain of W inverses (couplings left
    out) on unit noise: 4 channels in, 2 fresh ones added after flows 8
    and 4, as ``glow.py``'s ``infer`` adds the early outputs."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4, t, generator=g, dtype=torch.float64)
    for k in reversed(range(len(WIDTHS))):
        x = torch.linalg.inv(ws[f"W/{k}"].double()) @ x
        if k % 4 == 0 and k > 0:
            x = torch.cat([torch.randn(2, t, generator=g,
                                       dtype=torch.float64), x])
    return float(x.pow(2).mean().sqrt())


def test_waveglow_schedule_keeps_unit_noise_at_unit_rms(drawn):
    """Orthogonal W's keep the reverse's noise at RMS 1; W's drawn
    elementwise N(0, 1/n) blow it up, which is why the kind exists."""
    orth = [_reverse_rms(drawn[f"glow_orthogonal_{s}"]["leaves"], s)
            for s in GLOW_SEEDS]
    assert all(0.95 <= r <= 1.05 for r in orth), orth
    normal = sorted(_reverse_rms(drawn[f"glow_normal_{s}"]["leaves"], s)
                    for s in GLOW_SEEDS)
    assert (normal[4] + normal[5]) / 2 > 100, normal


@pytest.mark.parametrize("key", sorted(ERRORS))
def test_a_leaf_that_cannot_be_drawn_raises_naming_it(drawn, key):
    msg = drawn[key]
    assert isinstance(msg, str), msg
    for part in ERRORS[key][1]:
        assert part in msg
