"""Model families: FloWaveNet's yardsticks read exactly as they did before
they moved into ``fwbench/families/flowavenet.py``, and a second family
comes as new files only (a family module and a configuration naming it)."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fwbench import cells, flops, weights

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# Every frozen value below was read from the harness at commit dd3bd64,
# before the layouts and FLOP counts moved into family modules.
FROZEN = {
    "lj22k": {
        "layout": "72799b810e982aaf3a863f7491ac7416"
                  "07889e5bb5caa0e52a00eb3a9149d7d4",
        "n_params": 181129876,
        "flops_22050": 364450779000.0,
        "flops_8000": 132227040000.0},
    "lj8k_gin": {
        "layout": "f40a12e344bc8206e9a5c9d2af7701fb"
                  "392f225461cbb8648af7f91a03b62d8c",
        "n_params": 97937228,
        "flops_22050": 323940046368.0,
        "flops_8000": 117591405568.0},
}
SMALL = {"reference": "flowavenet",
         "model": {"n_block": 2, "n_flow": 2, "n_layer": 2, "affine": True,
                   "filter_size": 8, "num_mels": 4, "upsample_scales": [2, 2],
                   "gin_channels": 4, "n_speakers": 3}}
SMALL_SEED7 = ("dee37cb33877e4bc75e594ce4bb2157b"
               "c77277fdb7db51216a289ff42f84ec3e")


def _leaves(tree) -> list:
    out: list = []
    weights.map_leaves(out.append, tree)
    return out


def _layout_digest(config: dict) -> str:
    rows = [[p, list(shape), [dist[0], dist[1]]]
            for p, (shape, dist) in zip(weights.leaf_paths(config),
                                        _leaves(weights.layout(config)))]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_flowavenet_yardsticks_are_unchanged(name):
    config = cells.load_json(BENCH / "configs" / f"{name}.json")
    want = FROZEN[name]
    assert _layout_digest(config) == want["layout"]
    assert weights.n_params(config) == want["n_params"]
    assert flops.model_flops(config, 22050, 1) == want["flops_22050"]
    assert flops.model_flops(config, 8000, 1) == want["flops_8000"]


def test_flowavenet_weights_are_bit_identical():
    h = hashlib.sha256()
    for t in _leaves(weights.make(SMALL, 7, "cpu")):
        h.update(str((str(t.dtype), tuple(t.shape))).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == SMALL_SEED7


def test_a_family_with_no_module_names_the_file():
    config = {"reference": "no_such_family", "model": {}}
    path = BENCH / "fwbench" / "families" / "no_such_family.py"
    for call in (lambda: weights.make(config, 7, "cpu"),
                 lambda: flops.model_flops(config, 1.0, 1.0)):
        with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
            call()


TOY_FAMILY = '''"""A toy family: one dense layer of ``width`` channels."""


def layout(model):
    w = model["width"]
    return {"w": ((w, w), ("uniform", 0.5)),
            "b": ((w,), ("normal", (1.0, 0.25)))}


def model_flops(model, samples, rows):
    return 2.0 * model["width"] ** 2 * samples + 3.0 * rows
'''

# Run in a process of its own, on the copy's fwbench
TOY_RUN = '''
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
bench = root / "benchmark"
import fwbench
assert Path(fwbench.__file__).resolve().parent == (bench / "fwbench").resolve()
from fwbench import cells, flops, weights
cell = cells.find_cell("toy.offline", root, bench)
w = weights.make(cell.config, 7, "cpu")
run = cells.Run(cell, 7, 1.0, True, 0.0, window_s=0.5,
                counters={"synth.requested_samples": 1000.0, "synth.rows": 2})
out = {"family": cell.family.__file__,
       "leaves": {k: [list(v.shape), float(v.min()), float(v.max())]
                  for k, v in w.items()},
       "n_params": weights.n_params(cell.config),
       "flops": flops.model_flops(cell.config, 1000.0, 2),
       "mfu": cells.metric_reader("mfu.synth", bench).read(run),
       "per_layer": sorted(m["name"] for m in cell.per_layer)}
train = cells.find_cell("toy.train", root, bench)
try:
    train.driver().execute(cells.Run(train, 7, 1.0, False, 0.0))
except NotImplementedError as e:
    out["train"] = str(e)
try:
    cells.find_cell("ghost.offline", root, bench).family
except FileNotFoundError as e:
    out["ghost"] = str(e)
print(json.dumps(out))
'''


def test_a_second_family_comes_as_new_files(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (bench / "fwbench" / "families" / "toy.py").write_text(TOY_FAMILY)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, ref in (("toy", "toy"), ("ghost", "no_such_family")):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(
            {"reference": ref, "model": {"width": 6}}))
        man["configs"].append({"name": name, "source": "test",
                               "file": f"benchmark/configs/{name}.json",
                               "reduced": [], "why": "test"})
    for cell, conf, mix in (("toy.offline", "toy", "offline"),
                            ("toy.train", "toy", "train"),
                            ("ghost.offline", "ghost", "offline")):
        man["workloads"].append({"name": cell, "config": conf,
                                 "traffic": mix, "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("synth_rtf", "mfu.synth"):
            m["workloads"].append("toy.offline")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    env = dict(os.environ, PYTHONPATH=str(bench))
    proc = subprocess.run([sys.executable, "-c", TOY_RUN, str(tmp_path)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["family"] == str(bench / "fwbench" / "families" / "toy.py")
    (w_shape, w_lo, w_hi), (b_shape, b_lo, b_hi) = (got["leaves"]["w"],
                                                   got["leaves"]["b"])
    assert w_shape == [6, 6] and -0.5 <= w_lo < w_hi <= 0.5
    assert b_shape == [6] and b_lo != b_hi
    assert got["n_params"] == 42
    assert got["flops"] == 2.0 * 36 * 1000 + 3.0 * 2
    assert got["mfu"] == 100.0 * got["flops"] / 0.5 / flops.PEAK_BF16
    assert "mfu.synth" in got["per_layer"]
    assert "FloWaveNet" in got["train"] and "'toy'" in got["train"]
    assert str(bench / "fwbench" / "families" / "no_such_family.py") \
        in got["ghost"]
