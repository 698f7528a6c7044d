#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, in one
process (one set-up of the card):

    python3 benchmark/readings.py --workload <cell> --seconds <s> \
        --seeds 11,12,... --control-seeds 21,22,23 [--out file.json]

For each of ``--seeds`` it runs the cell with a window of ``--seconds`` and
prints every compared number of the program against the reference; for
each of ``--control-seeds`` the same numbers with the reference in the
lower precision in the program's place (the control).  Limits are not
applied.  ``--fault NAME`` breaks the timed path as
``fwbench/faults.py`` describes and reads the program's numbers so.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from fwbench import cells, faults
    from fwbench.trace import Tracer
    cell = cells.find_cell(args.workload)
    cells.set_routes(cell.config)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    driver = cell.driver()
    rows = []
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        run = cells.Run(cell, seed, args.seconds, False, time.time(), dev)
        run.tracer = Tracer(False)
        with faults.planted(args.fault if not control else ""):
            driver.execute(run)
        torch.cuda.empty_cache()
        t_v = time.time()
        driver.verify_run(run, control=control)
        run.notes.setdefault("diag", {})["verify_s"] = time.time() - t_v
        row = {"seed": seed, "control": control, "fault": args.fault,
               "setup_s": run.setup_s, "window_s": run.window_s,
               "end_to_end": run.end_to_end,
               "memory_peak_bytes": run.memory_peak_bytes,
               "checks": {n: v for n, v, _ in run.checks},
               "diag": run.notes.get("diag", {}),
               "leaf_gaps": run.notes.get("leaf_gaps")}
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k != "leaf_gaps"}), flush=True)
        del run
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
