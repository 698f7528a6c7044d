"""Time the training pair kernels of the PyTorch port on the card, for one
tree or two in turns.  No JAX.  Run from the repository root on a machine with a CUDA card:

    python tools/train_pair_ab.py                # this tree
    python tools/train_pair_ab.py --parent DIR   # and DIR (another commit,
                                                 # e.g. unpacked by
                                                 # `git archive`): parent,
                                                 # this, this, parent
    python tools/train_pair_ab.py --phase4       # also chip_smoke.py's
                                                 # phase 4 rows of each tree
    python tools/train_pair_ab.py --fwd-tiles    # only pair_fwd of this
                                                 # tree at blocks 0-3 over
                                                 # several tiles

Times are CUDA events over repeated launches of ``fused_pair_train_fwd``
and ``fused_pair_train_bwd`` in bf16 at the training geometry of lj22k
block 0 (batch 8, T_k 3200, R_in 1, Cc 80), the FWN_TRAIN_KERNEL=1 route's.
Each tree runs in its own process, so it imports its own package and
builds its own kernels.  ``--fwd-tiles`` times ``fused_pair_forward``
(``pair_fwd``, the FWN_FWD_KERNEL=1 route's kernel) in bf16 at the
training geometry of lj22k blocks 0-3 (batch 8, T_k 6400 >> (b + 1),
R_in 2^b, Cc 80 * 2^b) with the tile that ``train_tc_t_tile`` picks and
with each tile of ``FWD_TILES`` that fits, one CTA per tile: ``ms`` is the
wrapper call's time on the card's timeline (CUDA events, as chip_smoke.py
times kernels), ``kernel_ms`` the kernel's own device time per launch from
a ``torch.profiler`` trace (0 if the trace has none).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FWD_TILES = (16, 20, 25, 32, 40, 48, 56, 64, 72)


def _case(bi: int = 0):
    """lj22k block bi's training pair (0.05-scale zero conv and ActNorm
    noise, seeded), bf16 inputs and cotangents at batch 8 x (3200 >> bi)."""
    import torch
    from flowavenet_tpu_torch.config import lj22k
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.utils.tree import tree_map
    dev = torch.device("cuda", 0)
    cfg = lj22k().model
    gen = torch.Generator().manual_seed(10)
    block = fwn.init_block(gen, 1 << bi, cfg.num_mels << bi, cfg)
    fl = block["flows"]
    for leaf in (fl["coupling"]["zero"]["w"], fl["actnorm"]["b"],
                 fl["actnorm"]["logs"]):
        leaf.normal_(0, 0.05, generator=gen)
    pair = tree_map(lambda l: l.to(dev), fwn._index(fwn._pair_params(block),
                                                    0))
    ops = pf.pair_forward_operands(pair, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(0)
    tk = 3200 >> bi
    x = [torch.randn(8, tk, 1 << bi, generator=g, device=dev).bfloat16()
         for _ in range(4)]
    c = [torch.rand(8, tk, cfg.num_mels << bi, generator=g, device=dev)
         .bfloat16() for _ in range(2)]
    scal = [torch.tensor(s, device=dev) for s in (0.7, 0.11, 1.3)]
    return ops, x, c, scal


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _kernel_ms(fn, reps: int, name: str) -> float:
    """Device time per call of the kernels whose name contains ``name``,
    summed from a torch.profiler trace of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or
             getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if name in e.key)
    return us / 1e3 / reps


def child(mode: str) -> dict:
    """Runs inside one tree: builds, times (and checks) its kernels."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flowavenet_tpu_torch.ops import _build
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    if mode == "build":
        _build.build("pair_flow_train")
        return {}
    if mode == "phase4":
        import chip_smoke as cs
        from flowavenet_tpu_torch.config import lj22k
        cfg = lj22k()
        rows = cs.train_kernel_checks(
            cs.randomized_params(cfg, cs.SEED), cfg, cfg.data.batch_size,
            cfg.data.max_time_steps, range(4), torch.device("cuda", 0))
        return {"phase4": [{k: v for k, v in r.items()
                            if not k.endswith("bound")} for r in rows]}
    if mode == "fwd_tiles":
        from flowavenet_tpu_torch.ops import pair_flow as pf
        pick, out = pft.train_tc_t_tile, []
        for bi in range(4):
            ops, (u, v, _, _), (ca, cb), _ = _case(bi)
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            tt0 = pick(8, u.shape[1], 256, u.shape[2], False, n_sm)
            for tt in (tt0,) + FWD_TILES:
                if not 0 < pft._library().pair_train_smem_bytes(
                        0, 1, 256, u.shape[2], tt) <= pft.SMEM_MAX:
                    continue
                pft.train_tc_t_tile = lambda *a, tt=tt: tt

                def fwd():
                    return pf.fused_pair_forward(u, v, ca, cb, ops)
                try:
                    ms = _time_ms(fwd, 10)
                    kms = _kernel_ms(fwd, 10, "pair_fwd_kernel")
                finally:
                    pft.train_tc_t_tile = pick
                out.append({"block": bi, "t_tile": tt, "default": tt == tt0,
                            "ctas": pft.LAST_LAUNCH["pair_fwd"]["ctas"],
                            "ms": ms, "kernel_ms": kms})
        return {"fwd_tiles": out}
    ops, (u, v, gu, gv), (ca, cb), scal = _case()
    fwd = _time_ms(lambda: pft.fused_pair_train_fwd(u, v, ca, cb, ops), 10)
    bwd = _time_ms(lambda: pft.fused_pair_train_bwd(
        u, v, ca, cb, gu, gv, *scal, ops), 5)
    return {"kernel": {"fwd_ms": fwd, "bwd_ms": bwd}}


def _run_tree(tree: str, mode: str) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", mode],
        cwd=tree, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": os.path.abspath(tree)})
    if proc.returncode != 0:
        raise RuntimeError(f"{tree} {mode} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another tree, run in turns with this")
    ap.add_argument("--phase4", action="store_true",
                    help="also chip_smoke.py's phase 4 rows of each tree")
    ap.add_argument("--fwd-tiles", action="store_true",
                    help="only pair_fwd of this tree over several tiles")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("train_pair_ab: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"this": here}
    if a.parent:
        trees["parent"] = os.path.abspath(a.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if a.fwd_tiles:
        for row in _run_tree(here, "fwd_tiles")["fwd_tiles"]:
            print("fwd_tiles: " + json.dumps(row), flush=True)
        return 0
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(trees)) as pool:
        list(pool.map(lambda t: _run_tree(t, "build"), trees.values()))
    order = (["parent", "this", "this", "parent"] if a.parent else ["this"])
    for name in order:
        res = _run_tree(trees[name], "time")
        print(f"{name}: " + json.dumps(res), flush=True)
    if a.phase4:
        for name, tree in trees.items():
            for row in _run_tree(tree, "phase4")["phase4"]:
                print(f"{name} phase4: " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
