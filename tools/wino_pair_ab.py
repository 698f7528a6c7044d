"""Time the bf16 Winograd reverse pairs of the PyTorch port on the card, for
one tree or several in turns.  No JAX.  Run from the repository root on a
machine with a CUDA card:

    python tools/wino_pair_ab.py              # this tree
    python tools/wino_pair_ab.py DIR [...]    # and each DIR (another
                                              # commit, e.g. unpacked by
                                              # `git archive`): DIR...,
                                              # this, this, DIR... reversed

For ``pair_flow_wino`` (F(2,3)), ``pair_flow_wino4`` (F(4,3)) and their
hoisted twins ``pair_flow_wino_hoisted`` / ``pair_flow_wino4_hoisted`` in
bf16 at the geometry chip_smoke.py's phase 2b gives lj22k blocks 0-2 (batch
4 x 360 frames: T_k = 92160 >> (b + 1), R_in 2^b, Cc 80 * 2^b, hoisted c
4R = 1024), one pair per block: ``ms``, CUDA events over repeated wrapper
calls (as chip_smoke.py times kernels), ``kernel_ms``, the kernel's own
device time per launch from a ``torch.profiler`` trace (0 if the trace has
none), and the instance's registers and local bytes per thread
(``launch.kernel_attrs``).  Each tree runs in its own process, so it
imports its own package and builds its own kernels; its lines are printed
as JSON, one per (kernel, block), then the per-kernel sums.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

KERNELS = (("pair_flow_wino", 6, False), ("pair_flow_wino4", 12, False),
           ("pair_flow_wino_hoisted", 6, True),
           ("pair_flow_wino4_hoisted", 12, True))


def _attrs(name: str, dtype, **options) -> tuple:
    """(registers, local bytes) per thread of kernel ``name`` in the tree
    this process imported: ``launch.kernel_attrs``, or in a tree from before
    ops/launch.py, ``pair_flow.kernel_attrs`` with the pair's options."""
    try:
        from flowavenet_tpu_torch.ops import launch
    except ImportError:
        from flowavenet_tpu_torch.ops import pair_flow as pf
        return pf.kernel_attrs(dtype, **options)
    return launch.kernel_attrs(name, dtype)


def run_here(reps: int = 5) -> list:
    """Rows of this tree (the package imported from the working
    directory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flowavenet_tpu_torch.config import lj22k
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda", 0)
    dt = torch.bfloat16
    cfg = lj22k().model

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

    def kernel_ms(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0)
                 or getattr(e, "cuda_time_total", 0)
                 for e in prof.key_averages()
                 if "pair_reverse_kernel" in e.key)
        return us / 1e3 / reps

    rows = []
    for bi in range(3):
        r_in, cc, tk = 1 << bi, cfg.num_mels << bi, 92160 >> (bi + 1)
        gen = torch.Generator().manual_seed(bi)
        block = fwn.init_block(gen, r_in, cc, cfg)
        block["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05,
                                                         generator=gen)
        pair = tree_map(lambda l: l.to(dev),
                        fwn._index(fwn._pair_params(block), 0))
        g = torch.Generator(device=dev).manual_seed(bi)
        u, v = (torch.randn(4, tk, r_in, generator=g, device=dev).to(dt)
                for _ in range(2))
        c = [torch.rand(4, tk, cc, generator=g, device=dev).to(dt)
             for _ in range(2)]
        for name, P, hoisted in KERNELS:
            ops = (pf.pair_reverse_operands_wino(pair, dt) if P == 6
                   else pf.pair_reverse_operands_wino4(pair, dt))
            cx = c
            if hoisted:
                ops, (we, wo) = pf.pop_cond_w(ops)
                cx = [pf.hoist_cond(c[0], we), pf.hoist_cond(c[1], wo)]

            def fn(ops=ops, cx=cx, hoisted=hoisted):
                return pf.fused_pair_reverse_wino(u, v, *cx, ops,
                                                  hoisted=hoisted)
            regs, local = _attrs(name, dt, phases=P, hoisted=hoisted)
            rows.append({"name": name, "block": bi, "T_k": tk,
                         "ms": events_ms(fn), "kernel_ms": kernel_ms(fn),
                         "registers": regs, "local_bytes": local})
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
        for name, _, _ in KERNELS:
            sel = [r for r in rows if r["name"] == name]
            print(f"{label}: {name} per sweep (blocks 0-2) "
                  f"{sum(r['ms'] for r in sel):.3f} ms by events, "
                  f"{sum(r['kernel_ms'] for r in sel):.3f} ms kernel; "
                  f"{sel[0]['registers']} registers, "
                  f"{sel[0]['local_bytes']} local bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
