"""The benchmark's CPU tests: a copy of the benchmark in a temporary
directory, with tiny cells beside the real ones, driven on the CPU through
``run.main(device=cpu)`` (the kernels' plain versions run there)."""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SHORT = {"dist": "normal", "mean_s": 0.25, "sd_s": 0.1, "min_s": 0.1,
         "max_s": 0.45}


def _tiny_config(preset: str, base: str) -> dict:
    from flowavenet_tpu_torch.config import get_config
    conf = json.loads((BENCH / "configs" / f"{base}.json").read_text())
    d = dataclasses.asdict(get_config(preset))
    conf.update({k: d[k] for k in ("audio", "model", "data", "train")})
    conf["preset"] = preset
    if conf["precision"]["int8"]:
        conf["precision"]["int8"] = {"fg": [0, 1], "cond": [0, 1]}
    return conf


def make_copy(dst: Path) -> Path:
    """A checkout-like root at ``dst``: BENCHMARK.json with tiny cells
    added, the benchmark's files, and tiny configurations, mixes and
    limits (the real cells' limits)."""
    bench = dst / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the training and serving drivers' metrics, for their tiny cells
    man["end_to_end"] += [
        {"name": "train_ksamples_per_s", "unit": "ksamples/s",
         "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": []},
        {"name": "serve_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": []}]
    for name, moves, real in (
            ("train.enqueue_ms", "train_ksamples_per_s", "lj22k.train"),
            ("train.data_wait_ms", "train_ksamples_per_s", "lj22k.train"),
            ("mfu.train", "train_ksamples_per_s", "lj22k.train"),
            ("device_idle.train", "train_ksamples_per_s", "lj22k.train"),
            ("serve.requests_per_dispatch", "serve_p95_ms", "lj22k.serve"),
            ("serve.worker_busy_pct", "serve_p95_ms", "lj22k.serve"),
            ("device_idle.serve", "serve_p95_ms", "lj22k.serve")):
        man["per_layer"].append({"name": name, "unit": "-", "better": "lower",
                                 "source": "program_span", "layer": "test",
                                 "moves": moves, "workloads": [real]})
    for m in man["end_to_end"]:
        if m["name"] == "train_ksamples_per_s":
            m["workloads"].append("lj22k.train")
        if m["name"] == "serve_p95_ms":
            m["workloads"].append("lj22k.serve")
    for name, preset, base in (("tiny", "tiny", "lj22k"),
                               ("tiny_gin", "tiny_gin", "lj8k_gin")):
        (bench / "configs" / f"{name}.json").write_text(
            json.dumps(_tiny_config(preset, base)))
        man["configs"].append({"name": name, "source": "test",
                               "file": f"benchmark/configs/{name}.json",
                               "reduced": [], "why": "test"})
    t = json.loads((BENCH / "traffic" / "offline.json").read_text())
    t.update(batch=4, lengths=SHORT, check_rows=8, trace_batches=1)
    (bench / "traffic" / "tiny_offline.json").write_text(json.dumps(t))
    t = json.loads((BENCH / "traffic" / "train.json").read_text())
    t.update(batch=2, crop_samples=2048, reference_rows=1,
             corpus={"utterances": 6, "lengths": SHORT}, trace_steps=1)
    (bench / "traffic" / "tiny_train.json").write_text(json.dumps(t))
    t = json.loads((BENCH / "traffic" / "serve.json").read_text())
    t.update(rate_per_s=3.0, lengths=SHORT, check_requests=8, order_seed=7,
             trace_seconds=1.0, drain_s=30, workers=16)
    t["server"]["max_batch"] = 4
    (bench / "traffic" / "tiny_serve.json").write_text(json.dumps(t))
    for cell, conf, mix, real in (
            ("tiny.offline", "tiny", "tiny_offline", "lj22k.offline"),
            ("tiny_gin.offline", "tiny_gin", "tiny_offline",
             "lj8k_gin.offline"),
            ("tiny.train", "tiny", "tiny_train", "lj22k.train"),
            ("tiny.serve", "tiny", "tiny_serve", "lj22k.serve")):
        man["workloads"].append({"name": cell, "config": conf,
                                 "traffic": mix, "chips": 1, "why": "test"})
        lim = BENCH / "limits" / f"{real}.json"
        if lim.exists():
            shutil.copy(lim, bench / "limits" / f"{cell}.json")
        for m in man["end_to_end"] + man["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    # a per-layer metric added as a file and an entry
    (bench / "metrics" / "test.rows_per_batch.py").write_text(
        "def read(run):\n"
        "    b = run.counters.get('synth.batches')\n"
        "    return run.counters['synth.rows'] / b if b else None\n")
    man["per_layer"].append({
        "name": "test.rows_per_batch", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "synthesis entry",
        "moves": "synth_rtf", "workloads": ["tiny.offline"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(man))
    return bench


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    make_copy(root)
    return root
