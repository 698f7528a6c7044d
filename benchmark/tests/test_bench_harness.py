"""The harness on the CPU: cells found by name from files alone, the
result line's keys, the refusal without a card, and no JAX in a run."""

import json
import subprocess
import sys

import pytest
import torch

import run as bench_run
from fwbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "flowavenet_tpu"}


def _main(root, *args, capsys=None):
    rc = bench_run.main(list(args), device=torch.device("cpu"), root=root,
                        bench=root / "benchmark")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def test_added_cell_and_metric_are_found(tiny_root):
    cell = cells.find_cell("tiny.offline", tiny_root, tiny_root / "benchmark")
    assert cell.config["preset"] == "tiny"
    assert cell.traffic["driver"] == "offline"
    names = {m["name"] for m in cell.per_layer}
    assert "test.rows_per_batch" in names and "mfu.synth" in names
    assert {m["name"] for m in cell.end_to_end} == {"synth_rtf", "setup_s"}
    real = cells.find_cell("lj8k_gin.offline")
    assert {m["name"] for m in real.end_to_end} == {"synth_rtf", "setup_s"}
    assert "roofline.pair_flow_i8" not in {m["name"] for m in real.per_layer}


def test_result_line(tiny_root, capsys):
    rc, res = _main(tiny_root, "--workload", "tiny.offline", "--seed",
                    "4000000007", "--seconds", "1", "--trace", "0",
                    capsys=capsys)
    assert rc == 0
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["metrics"]) == {"synth_rtf", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["count"] == 1
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line(tiny_root, capsys):
    rc, res = _main(tiny_root, "--workload", "tiny.offline", "--seed",
                    "4000000009", "--seconds", "1", "--trace", "1",
                    capsys=capsys)
    assert rc == 0
    assert res["metrics"]["test.rows_per_batch"]["value"] == 4
    assert "synth.dispatch_host_ms" in res["metrics"]
    assert {"device_ops", "idle_gaps"} <= set(res["breakdown"])
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_no_card_no_result(tiny_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = bench_run.main(["--workload", "tiny.offline", "--seed", "1",
                         "--seconds", "1"], root=tiny_root,
                        bench=tiny_root / "benchmark")
    assert rc == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", ["tiny.offline", "tiny.train",
                                  "tiny.serve", "tiny_gin.offline"])
def test_a_run_loads_no_jax(tiny_root, cell):
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(bench_run.BENCH)!r}, {str(bench_run.ROOT)!r}]\n"
        "import run\n"
        "from pathlib import Path\n"
        f"root = Path({str(tiny_root)!r})\n"
        f"rc = run.main(['--workload', {cell!r}, '--seed', '11', "
        "'--seconds', '1'], device=torch.device('cpu'), root=root, "
        "bench=root / 'benchmark')\n"
        "print('MODULES', sorted({m.split('.')[0] for m in sys.modules}))\n"
        "sys.exit(rc)\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("MODULES")][0]
    loaded = set(eval(line[len("MODULES "):]))
    assert "flowavenet_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
