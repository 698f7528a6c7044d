#!/usr/bin/env python3
"""Find the knee of a serving cell once, by a sweep on the card:

    python3 benchmark/sweep_serve.py --workload lj22k.serve \
        --rates 4,6,8,10 --seconds 30 --seed 5

Runs the cell's open loop at each offered rate (one set-up, the server
started anew per rate) and prints, per rate, the requests outstanding at
the window's middle and end, p50 and p95 latency and the requests per
dispatch.  The knee is the highest rate at which no more requests are
outstanding at the end than at the middle.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    from fwbench import cells, weights
    from fwbench import traffic as tg
    from fwbench.trace import Tracer
    cell = cells.find_cell(args.workload)
    cells.set_routes(cell.config)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    drv = cell.driver()
    dev = torch.device("cuda", 0)
    cfg = cells.port_config(cell.config)
    dt = getattr(torch, cell.config["precision"]["serve_weights"])
    params = weights.make(cell.config, args.seed, dev, dt)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        run = cells.Run(cell, args.seed, args.seconds, False, time.time(),
                        dev)
        run.tracer = Tracer(False)
        res = drv.serve_window(run, cfg, params, rate, args.seconds,
                               warm=k == 0)
        lat = drv.latencies_ms(res["client"])
        st0, st1 = res["stats"]["start"], res["stats"]["end"]
        disp = st1["dispatches"] - st0["dispatches"]
        print(json.dumps({
            "rate": rate, "requests": len(lat),
            "outstanding_middle": drv.outstanding(res["client"],
                                                  args.seconds / 2),
            "outstanding_end": drv.outstanding(res["client"], args.seconds),
            "p50_ms": tg.percentile(lat, 50), "p95_ms": tg.percentile(lat, 95),
            "failed": sum(1 for x in lat if x == float("inf")),
            "requests_per_dispatch": (st1["requests"] - st0["requests"])
            / max(disp, 1),
            "busy_pct": 100 * (st1["busy_seconds"] - st0["busy_seconds"])
            / args.seconds,
            "warm_up_s": run.notes.get("warm_up_s")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
