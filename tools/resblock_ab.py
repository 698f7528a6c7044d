"""Time the bf16 fused ResBlock kernels of the PyTorch port on the card, for
one tree or several in turns.  No JAX.  Run from the repository root on a
machine with a CUDA card:

    python tools/resblock_ab.py              # this tree
    python tools/resblock_ab.py DIR [...]    # and each DIR (another commit,
                                             # e.g. unpacked by `git
                                             # archive`): DIR..., this,
                                             # this, DIR... reversed

For ``resblock_v2`` (lj22k blocks 0-5, Cc = 80 * 2^b) and ``resblock``
(blocks 6-7, cond_fg 2R = 512 wide) in bf16 at the geometry chip_smoke.py's
phase 2c gives them (batch 4 x 360 frames: T_k = 92160 >> (b + 1), R =
256, the coupling net's layer 0 at dilation 1), one launch per block on
seeded inputs: ``ms``, CUDA events over repeated wrapper calls (as
chip_smoke.py times kernels; the wrapper's per-launch weight packing
included), ``host_ms``, the host's wall time per call to enqueue them
(no synchronisation inside), ``kernel_ms``, the kernel's own device time
per launch from a ``torch.profiler`` trace (0 if the trace has none), and,
where the tree has them, the instance's registers and local bytes per
thread (``launch.kernel_attrs``) and the launch's tile and CTAs
(``launch.LAST_LAUNCH``; ``resblock``'s own in a tree from before
ops/launch.py).  Each tree runs in its own process, so it
imports its own package and builds its own kernels; its lines are printed
as JSON, one per block, then the per-kernel sums.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

B, T, R = 4, 92160, 256


def run_here(reps: int = 5) -> list:
    """Rows of this tree (the package imported from the working
    directory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flowavenet_tpu_torch.ops import resblock as rb
    try:
        from flowavenet_tpu_torch.ops import launch
    except ImportError:             # a tree from before ops/launch.py
        launch = None

    dev = torch.device("cuda", 0)
    dt = torch.bfloat16

    def events_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / reps

    def kernel_ms(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0)
                 or getattr(e, "cuda_time_total", 0)
                 for e in prof.key_averages() if "resblock" in e.key)
        return us / 1e3 / reps

    rows = []
    for bi in range(8):
        tk, cc = T >> (bi + 1), 80 << bi
        v2 = cc <= rb.V2_MAX_CC
        g = torch.Generator(device=dev).manual_seed(bi)

        def rn(*s, sc=1.0):
            return sc * torch.randn(*s, generator=g, device=dev)
        h = rn(B, tk, R).to(dt)
        w = [rn(3, R, 2 * R, sc=0.03), rn(R, R, sc=0.06), rn(R),
             rn(R, R, sc=0.06), rn(R)]
        if v2:
            c = torch.rand(B, tk, cc, generator=g, device=dev).to(dt)
            args = (h, c, w[0], rn(cc, 2 * R, sc=0.03), rn(2 * R), *w[1:])
            name, fn0 = "resblock_v2", rb.fused_gated_resblock_v2
        else:
            args = (h, rn(B, tk, 2 * R).to(dt), *w)
            name, fn0 = "resblock", rb.fused_gated_resblock

        def fn(fn0=fn0, args=args):
            with torch.no_grad():
                return fn0(*args, dilation=1, causal=False)
        row = {"name": name, "block": bi, "T_k": tk, "Cc": cc if v2 else 0,
               "ms": events_ms(fn), "host_ms": host_ms(fn),
               "kernel_ms": kernel_ms(fn)}
        if launch is not None:
            row["registers"], row["local_bytes"] = launch.kernel_attrs(
                name, dt)
            row.update(launch.LAST_LAUNCH.get(name, {}))
        else:
            if hasattr(rb, "kernel_attrs"):
                row["registers"], row["local_bytes"] = rb.kernel_attrs(dt,
                                                                       v2)
            row.update(getattr(rb, "LAST_LAUNCH", {}).get(name, {}))
        rows.append(row)
    return rows


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--here":
        print(json.dumps(run_here()))
        return 0
    here = os.getcwd()
    others = [os.path.abspath(d) for d in sys.argv[1:]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for tree in others + [here, here] + others[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--here"], cwd=tree, capture_output=True,
                             text=True, env={**os.environ, "PYTHONPATH": tree})
        if out.returncode:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        label = "this tree" if tree == here else tree
        for r in rows:
            print(json.dumps({"tree": label, **r}), flush=True)
        for name in ("resblock_v2", "resblock"):
            sel = [r for r in rows if r["name"] == name]
            print(f"{label}: {name} per sweep (blocks "
                  f"{sel[0]['block']}-{sel[-1]['block']}) "
                  f"{sum(r['ms'] for r in sel):.3f} ms by events, "
                  f"{sum(r['host_ms'] for r in sel):.3f} ms host, "
                  f"{sum(r['kernel_ms'] for r in sel):.3f} ms kernel; "
                  f"{sel[0].get('registers', '?')} registers, "
                  f"{sel[0].get('local_bytes', '?')} local bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
