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
    python tools/train_pair_ab.py --parent DIR --grads  # only the bf16
                                                 # pair_train_bwd outputs'
                                                 # hashes of each tree
    python tools/train_pair_ab.py --parent DIR --r32    # only the bf16
                                                 # pair_train_bwd at R = 32
                                                 # over R32_TILES, per tree

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

``--grads`` runs ``fused_pair_train_bwd`` in bf16 at lj22k blocks 0-3 (the
``time`` case's inputs at T_k 3200 >> b) and at a filter_size 48 block 0
(R padded to 64) in each tree and prints a SHA-256 of every output, so
two trees' gradients compare bit for bit.  ``--r32`` runs it at tiny's
block-0 widths (R 32, R_in 1, Cc 80, batch 2 x 1024) on each tile of
``R32_TILES`` (forced through ``train_tc_t_tile``), each tile in its own
process, since a fault ends the process's CUDA context: per tile, the
launch's outcome (a cudaError, or the worst gradient cosine to
``pair_train_bwd_ref``) beside where the backward's conditioning staging
ends against its shared-memory layout (``staging_extent``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FWD_TILES = (16, 20, 25, 32, 40, 48, 56, 64, 72)
# tiles of --r32: 16 (the 88-column staging still inside P3), 17 (past
# P3's end into the fp32 dnet rows), 21 (onto the zero row), 29 and up
# (past the dynamic allocation), as staging_extent reads them at R = 32
R32_TILES = (16, 17, 20, 21, 24, 28, 29, 32, 48, 72)


def staging_extent(TT: int, R: int = 32, Rin: int = 1, cols: int = 80):
    """Byte offsets of the tensor-core backward's shared memory at a tile
    (``tc_bwd_layout`` in csrc/pair_flow_train.cu: P0-P3, the fp32 dnet
    rows, the zero row) and where the conditioning staging of the cond
    weight gradient ends when it stages ``cols`` columns at the row stride
    cols + 8 from P3 (80 before the repair; tc_cond_cols(R) after)."""
    def a16(x):
        return (x + 15) & ~15
    n, ldr, ldf = TT + 20, R + 8, 2 * R + 8
    off = [0]
    for size in (2 * n * ldf, 2 * n * ldr, 2 * n * ldr, 2 * n * ldr,
                 4 * n * 2 * Rin, 16):
        off.append(a16(off[-1] + size))
    names = ("p0", "p1", "p2", "p3", "dnet", "zero", "end")
    return {**dict(zip(names, off)),
            "staging_end": off[3] + 2 * TT * (cols + 8)}


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


def _tiny_case():
    """tiny's block-0 training pair (R 32, R_in 1, Cc 80; 0.05-scale zero
    conv and ActNorm noise, seeded), bf16 inputs and cotangents at batch
    2 x 1024, as tests/test_torch_card.py's ``_tiny_train_pair``."""
    import torch
    from flowavenet_tpu_torch.config import tiny
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.utils.tree import tree_map
    dev = torch.device("cuda", 0)
    cfg = tiny().model
    gen = torch.Generator().manual_seed(32)
    block = fwn.init_block(gen, 1, cfg.num_mels, cfg)
    fl = block["flows"]
    for leaf in (fl["coupling"]["zero"]["w"], fl["actnorm"]["b"],
                 fl["actnorm"]["logs"]):
        leaf.normal_(0, 0.05, generator=gen)
    pair = tree_map(lambda l: l.to(dev), fwn._index(fwn._pair_params(block),
                                                    0))
    ops = pf.pair_forward_operands(pair, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(32)
    x = [torch.randn(2, 1024, 1, generator=g, device=dev).bfloat16()
         for _ in range(4)]
    c = [torch.rand(2, 1024, cfg.num_mels, generator=g, device=dev)
         .bfloat16() for _ in range(2)]
    scal = [torch.tensor(s, device=dev) for s in (0.7, 0.11, 1.3)]
    return ops, x, c, scal


def _fs48_case():
    """A filter_size 48 block 0 (R padded to 64 on the tensor cores) at the
    ``time`` case's batch and length."""
    import dataclasses

    import torch
    from flowavenet_tpu_torch.config import lj22k
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.utils.tree import tree_map
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(lj22k().model, filter_size=48)
    gen = torch.Generator().manual_seed(48)
    block = fwn.init_block(gen, 1, cfg.num_mels, cfg)
    fl = block["flows"]
    for leaf in (fl["coupling"]["zero"]["w"], fl["actnorm"]["b"],
                 fl["actnorm"]["logs"]):
        leaf.normal_(0, 0.05, generator=gen)
    pair = tree_map(lambda l: l.to(dev), fwn._index(fwn._pair_params(block),
                                                    0))
    ops = pf.pair_forward_operands(pair, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(48)
    x = [torch.randn(8, 3200, 1, generator=g, device=dev).bfloat16()
         for _ in range(4)]
    c = [torch.rand(8, 3200, cfg.num_mels, generator=g, device=dev)
         .bfloat16() for _ in range(2)]
    scal = [torch.tensor(s, device=dev) for s in (0.7, 0.11, 1.3)]
    return ops, x, c, scal


def _launch_layer():
    """(LAST_LAUNCH, the pair_flow_train library, SMEM_MAX) of the tree
    this process imported: ops/launch.py's, or in a tree from before that
    module, the training wrapper's own."""
    try:
        from flowavenet_tpu_torch.ops import launch
    except ImportError:
        from flowavenet_tpu_torch.ops import pair_flow_train as pft
        return pft.LAST_LAUNCH, pft._library(), pft.SMEM_MAX
    return (launch.LAST_LAUNCH, launch.library("pair_flow_train"),
            launch.SMEM_MAX)


def _sha(t) -> str:
    """SHA-256 of a tensor's bytes."""
    import hashlib

    import torch
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


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
    if mode == "grads":
        out = {}
        cases = [(f"lj22k block {bi}", lambda bi=bi: _case(bi))
                 for bi in range(4)] + [("filter_size 48 block 0",
                                         _fs48_case)]
        for name, make in cases:
            ops, (u, v, gu, gv), (ca, cb), scal = make()
            d = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal, ops)
            torch.cuda.synchronize()
            out[name] = {"t_tile": _launch_layer()[0]["pair_train_bwd"]
                         ["t_tile"],
                         "sha256": [_sha(t) for t in list(d[0]) +
                                    list(d[1:])]}
        return {"grads": out}
    if mode.startswith("r32:"):
        tt = int(mode[4:])
        ops, (u, v, gu, gv), (ca, cb), scal = _tiny_case()
        # the dynamic shared memory the launch sets: the larger of the
        # recompute's layout and the backward phases'
        res = {"tile": tt, "smem_bytes": _launch_layer()[1]
               .pair_train_smem_bytes(1, 1, 32, 1, tt)}
        pick = pft.train_tc_t_tile
        pft.train_tc_t_tile = lambda *a: tt
        try:
            d = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal, ops)
            torch.cuda.synchronize()
        except RuntimeError as e:
            res["error"] = str(e).splitlines()[0]
            return res
        finally:
            pft.train_tc_t_tile = pick
        dref = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, *scal, ops)
        cos = []
        for a, b in zip(list(d[0]) + list(d[1:]),
                        list(dref[0]) + list(dref[1:])):
            a, b = a.double().flatten(), b.double().flatten()
            if float(b.abs().max()) > 0:
                cos.append(float((a @ b) / (a.norm() * b.norm())
                                 .clamp_min(1e-30)))
        res.update(min_cos=min(cos), finite=all(
            bool(torch.isfinite(t.float()).all())
            for t in list(d[0]) + list(d[1:])))
        return res
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
        last, lib, smem_max = _launch_layer()
        pick, out = pft.train_tc_t_tile, []
        for bi in range(4):
            ops, (u, v, _, _), (ca, cb), _ = _case(bi)
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            tt0 = pick(8, u.shape[1], 256, u.shape[2], False, n_sm)
            for tt in (tt0,) + FWD_TILES:
                if not 0 < lib.pair_train_smem_bytes(
                        0, 1, 256, u.shape[2], tt) <= smem_max:
                    continue
                pft.train_tc_t_tile = lambda *a, tt=tt: tt

                def fwd():
                    return pft.fused_pair_forward(u, v, ca, cb, ops)
                try:
                    ms = _time_ms(fwd, 10)
                    kms = _kernel_ms(fwd, 10, "pair_fwd_kernel")
                finally:
                    pft.train_tc_t_tile = pick
                out.append({"block": bi, "t_tile": tt, "default": tt == tt0,
                            "ctas": last["pair_fwd"]["ctas"],
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
    ap.add_argument("--grads", action="store_true",
                    help="only the pair_train_bwd outputs' hashes per tree")
    ap.add_argument("--r32", action="store_true",
                    help="only pair_train_bwd at R = 32 over R32_TILES")
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
    if a.grads or a.r32:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(len(trees)) as pool:
            list(pool.map(lambda t: _run_tree(t, "build"), trees.values()))
    if a.grads:
        got = {name: _run_tree(tree, "grads")["grads"]
               for name, tree in trees.items()}
        for case, res in got["this"].items():
            same = all(g[case]["sha256"] == res["sha256"]
                       for g in got.values())
            print(f"grads {case}: tile {res['t_tile']}, "
                  f"{len(res['sha256'])} outputs, "
                  + ("bit-identical across trees" if same else
                     "DIFFER: " + json.dumps({n: g[case] for n, g in
                                              got.items()})), flush=True)
        return 0
    if a.r32:
        for tt in R32_TILES:
            at = staging_extent(tt)
            print(f"r32 tile {tt}: layout {json.dumps(at)}; the 80-column "
                  f"staging ends {at['staging_end'] - at['dnet']} bytes "
                  f"past P3's end, the 32-column one at "
                  f"{staging_extent(tt, cols=32)['staging_end']}",
                  flush=True)
            for name, tree in trees.items():
                print(f"r32 {name}: " + json.dumps(
                    _run_tree(tree, f"r32:{tt}")), flush=True)
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
