"""Time the int8 reverse pair ``pair_flow_i8`` of the PyTorch port on the
card and compare its output bit for bit, for one tree or several in turns.
No JAX.  Run from the repository root on a machine with a CUDA card:

    python tools/pair_i8_ab.py              # this tree
    python tools/pair_i8_ab.py DIR [...]    # and each DIR (another commit,
                                            # e.g. unpacked by `git
                                            # archive`): DIR..., this,
                                            # this, DIR... reversed

One pair per lj22k block 0-4 (the blocks the default synthesis route runs
it on) at the offline benchmark's batch shape, 128 rows of 900 frames
(``--rows``, ``--frames``): T_k = 900 * 256 >> (b + 1), R_in 2^b, Cc 80 *
2^b, the conditioning quantized per row as the model does.  Inputs and the
pair's weights come from fixed seeds, so every tree gets the same ones.
Per (tree, block): ``ms``, CUDA events over repeated wrapper calls;
``kernel_ms``, the kernel's own device time per launch from a
``torch.profiler`` trace; registers and local bytes per thread
(``launch.kernel_attrs``); and ``sha256`` of the output's bytes (u'
then v').  Each tree runs in its own process, so it imports its own
package and builds its own kernel.  Prints one JSON line per row, per tree
the sums and whether every block's output is bit-identical to the first
tree's, then a JSON summary line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


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


def run_here(rows: int, frames: int, reps: int) -> list:
    """Rows of this tree (the package imported from the working
    directory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flowavenet_tpu_torch.config import lj22k
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.ops.conv import quantize_act
    from flowavenet_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda", 0)
    dt = torch.bfloat16
    cfg = lj22k()
    T = frames * cfg.audio.hop_size

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

    out = []
    for bi in range(5):
        r_in, cc, tk = 1 << bi, cfg.model.num_mels << bi, T >> (bi + 1)
        gen = torch.Generator().manual_seed(bi)
        block = fwn.init_block(gen, r_in, cc, cfg.model)
        # 0.05-scale zero convs, so the coupling nets move the output
        block["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05,
                                                         generator=gen)
        pair = tree_map(lambda l: l.to(dev),
                        fwn._index(fwn._pair_params(block), 0))
        ops = pf.pair_reverse_operands_int8(pair, dtype=dt)
        g = torch.Generator(device=dev).manual_seed(bi)
        u, v = (torch.randn(rows, tk, r_in, generator=g, device=dev).to(dt)
                for _ in range(2))
        (qa, sa), (qb, sb) = (
            quantize_act(torch.rand(rows, tk, cc, generator=g,
                                    device=dev).to(dt), per_row=True)
            for _ in range(2))
        crs = torch.cat([sa.reshape(-1, 1), sb.reshape(-1, 1)], 1)

        def fn():
            return pf.fused_pair_reverse(u, v, qa, qb, ops, int8=True,
                                         c_row_scales=crs)
        uo, vo = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(
            uo.contiguous().view(torch.int16).cpu().numpy().tobytes()
            + vo.contiguous().view(torch.int16).cpu().numpy().tobytes()
        ).hexdigest()
        regs, local = _attrs("pair_flow_i8", dt, int8=True)
        bound_ms, _ = pf.pair_bound_ms(rows, tk, r_in, cc, int8=True)
        out.append({"name": "pair_flow_i8", "block": bi, "rows": rows,
                    "T_k": tk, "ms": events_ms(fn), "kernel_ms":
                    kernel_ms(fn), "bound_ms": bound_ms, "registers": regs,
                    "local_bytes": local, "sha256": digest})
        del u, v, qa, qb, uo, vo
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="other trees")
    ap.add_argument("--here", action="store_true",
                    help="time this tree alone, one JSON line")
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--frames", type=int, default=900)
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if a.here:
        print(json.dumps(run_here(a.rows, a.frames, a.reps)))
        return 0
    here = os.getcwd()
    others = [os.path.abspath(d) for d in a.trees]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    first, summary = None, {}
    for tree in others + [here, here] + others[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), "--here",
               "--rows", str(a.rows), "--frames", str(a.frames),
               "--reps", str(a.reps)]
        out = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                             env={**os.environ, "PYTHONPATH": tree})
        if out.returncode:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        rows = json.loads(out.stdout.strip().splitlines()[-1])
        label = "this tree" if tree == here else tree
        for r in rows:
            print(json.dumps({"tree": label, **r}), flush=True)
        digests = [r["sha256"] for r in rows]
        first = first or digests
        same = digests == first
        ms = sum(r["ms"] for r in rows)
        kms = sum(r["kernel_ms"] for r in rows)
        print(f"{label}: pair_flow_i8 blocks 0-4 {ms:.3f} ms by events, "
              f"{kms:.3f} ms kernel; {rows[0]['registers']} registers, "
              f"{rows[0]['local_bytes']} local bytes; output bit-identical "
              f"to the first tree's: {same}", flush=True)
        summary.setdefault(label, []).append(
            {"ms": ms, "kernel_ms": kms, "bit_identical": same})
    print(json.dumps({"card": smi, "trees": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
