#!/usr/bin/env python3
"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names its
configuration and traffic mix; the mix names its driver.  The run sets the
configuration's route switches, makes the weights on the card from the
seed, warms up the cell's shapes, measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints one JSON
line last on stdout: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit (also the last lines on stderr).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result; if JAX or the JAX package is loaded once the
window has closed, with 3.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "flowavenet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(run, torch) -> dict:
    dev = run.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": run.cell.chips,
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    tr = run.tracer.result
    if run.trace and tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def metrics(run, cells) -> dict:
    out = {}
    if not run.trace:
        for m in run.cell.end_to_end:
            v = (run.setup_s if m["name"] == "setup_s"
                 else run.end_to_end[m["name"]])
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in run.cell.per_layer:
        v = cells.metric_reader(m["name"], run.cell.bench).read(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None, device=None, root: Path = ROOT,
         bench: Path = BENCH) -> int:
    """``device``: run there instead of looking for a card (the
    benchmark's tests drive a run on the CPU this way)."""
    args = parse(argv)
    from fwbench import cells
    from fwbench.trace import Tracer
    cell = cells.find_cell(args.workload, root, bench)
    cells.set_routes(cell.config)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    run = cells.Run(cell, args.seed, args.seconds, bool(args.trace),
                    T_START, device)
    run.tracer = Tracer(run.trace)
    driver = cell.driver()
    driver.execute(run)
    result = {"correct": False, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics(run, cells),
              "device": device_info(run, torch)}
    if run.trace and run.tracer.result is not None:
        result["breakdown"] = run.tracer.result.breakdown()
    driver.verify_run(run)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    result["correct"] = run.correct
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in run.checks}
    print(json.dumps({"setup_s": run.setup_s, "window_s": run.window_s,
                      **run.notes.get("diag", {})}), file=sys.stderr)
    print(json.dumps(result), flush=True)
    for n, v, lim in run.checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
