"""The comparison that decides ``correct``, on the CPU: a sound run passes
the cells' limits, each fault that a cell can have fails them with the
timed path broken underneath (``fwbench/faults.py``), and the control (the
reference in the lower precision in the program's place) fails them at the
configuration's full width."""

import json

import pytest
import torch

import run as bench_run
from fwbench import cells, faults
from fwbench.trace import Tracer

CASES = [("tiny.offline", ""), ("tiny.offline", "half_batch"),
         ("tiny.offline", "altered_answer"),
         ("tiny.serve", ""), ("tiny.serve", "half_batch"),
         ("tiny.serve", "altered_answer"),
         ("tiny.train", ""), ("tiny.train", "unchanged_state"),
         ("tiny.train", "half_batch")]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_fails_and_sound_passes(tiny_root, capsys, cell, fault):
    with faults.planted(fault):
        rc = bench_run.main(["--workload", cell, "--seed", "4000000123",
                             "--seconds", "2"], device=torch.device("cpu"),
                            root=tiny_root, bench=tiny_root / "benchmark")
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(c["limit"] is not None for c in res["checks"].values())
    assert res["correct"] is (fault == ""), res["checks"]


@pytest.fixture(scope="module")
def short_lj22k(tiny_root):
    """lj22k at full width on rows of 0.1-0.45 s, two to a batch."""
    bench = tiny_root / "benchmark"
    t = json.loads((bench / "traffic" / "tiny_offline.json").read_text())
    t.update(batch=2, check_rows=2)
    (bench / "traffic" / "short_offline.json").write_text(json.dumps(t))
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "lj22k_short.offline",
                             "config": "lj22k", "traffic": "short_offline",
                             "chips": 1, "why": "test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    (bench / "limits" / "lj22k_short.offline.json").write_text(
        (bench / "limits" / "lj22k.offline.json").read_text())
    cell = cells.find_cell("lj22k_short.offline", tiny_root, bench)
    cells.set_routes(cell.config)
    run = cells.Run(cell, 4000000321, 0.1, False, 0.0, torch.device("cpu"))
    run.tracer = Tracer(False)
    torch.set_num_threads(4)
    cell.driver().execute(run)
    return cell, run


def test_control_fails_at_full_width(short_lj22k):
    cell, run = short_lj22k
    run.checks.clear()
    cell.driver().verify_run(run, control=True)
    assert not run.correct, run.checks


def test_program_passes_at_full_width(short_lj22k):
    cell, run = short_lj22k
    run.checks.clear()
    cell.driver().verify_run(run)
    assert run.correct, run.checks
