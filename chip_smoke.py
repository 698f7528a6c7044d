#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Builds the CUDA kernel from ``flowavenet_tpu_torch/ops/csrc`` and prints
   the build time, the card's name and power limit, and the versions.
2. Holds the fused pair kernel against its plain PyTorch version
   (``pair_reverse_ref``, TF32 off) at the lj22k geometry of every block
   the kernel routes (R_in = 2^bi, Cc = 80*2^bi, R = 256), at the batch
   shape of step 3, on a pair whose zero convs carry 0.05-scale weights
   so that the coupling nets move the output: fp32 (rel-to-max <= 1e-4),
   bf16 (rel <= 1e-2, corr >= 0.999) and bf16 with int8 (rel <= 1e-2,
   corr >= 0.9999), both at the kernel's tile.  Every mode is also held
   to an error of at most 1e-2 (fp32: 1e-4) of what the coupling nets
   add: the RMS of kernel minus plain over the RMS of plain minus the
   pass-through (the same pair with its zero convs zeroed, i.e. ActNorm
   only).  Prints the errors, the kernel's and the plain version's ms,
   and the H100 bound.
3. Drives ``synthesize_mels`` at the full lj22k width on 4 mels of unequal
   length, in bf16: seeded random weights written to a JAX-layout npz and
   read back with ``load_params``; the default int8 route (15 kernel
   launches per reverse), the FWN_INT8=0 route (12) and the plain route,
   which the int8 route must match to the JAX package's int8 test bar
   (corr > 0.998, rel < 0.08).  Each route runs one warm-up call and
   ``REPS`` timed calls; the median and the range are printed.
4. Prints a JSON line of main-path numbers, one JSON line of per-kernel
   numbers (times per reverse: the sum over the routed blocks, 3 pairs
   each), the card's name and power limit, and as its last line
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero without that line.
It exits non-zero too when CUDA is unavailable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

FRAMES = (180, 262, 301, 345)       # ~2.1-4.0 s of 22.05 kHz audio
SEED = 1234
REPS = 5                            # timed synthesize_mels calls per route


def check(ok: bool, what) -> None:
    """Fail the phase (also under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _errors(got, want):
    """(max |err|, rel-to-max, corr) of two arrays or tensors; fails on a
    non-finite ``got``."""
    if not isinstance(got, np.ndarray):
        got, want = (x.float().cpu().numpy() for x in (got, want))
    got, want = got.ravel(), want.ravel()
    check(bool(np.all(np.isfinite(got))), "non-finite output")
    err = float(np.abs(got - want).max())
    return (err, err / max(1e-6, float(np.abs(want).max())),
            float(np.corrcoef(got, want)[0, 1]))


def _update_err(got, want, passthru) -> float:
    """RMS(got - want) / RMS(want - passthru) over a list of tensors: the
    error as a share of what the coupling nets add to the pass-through."""
    d = [(g.float() - w.float()).pow(2).sum() for g, w in zip(got, want)]
    a = [(w.float() - p.float()).pow(2).sum()
         for w, p in zip(want, passthru)]
    return float((sum(d) / sum(a)).sqrt())


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def randomized_params(cfg, seed: int):
    """lj22k-shaped params from a torch.Generator: the port's init (he
    uniform weights, unit gains) with the zero convs and ActNorms perturbed
    by 0.01-scale noise, which keeps |log_s| far below 1 in every flow."""
    import torch
    from flowavenet_tpu_torch.models.flowavenet import init_flowavenet
    gen = torch.Generator().manual_seed(seed)
    params = init_flowavenet(gen, cfg.model)
    for bp in params["blocks"]:
        fl = bp["flows"]
        for leaf in (fl["coupling"]["zero"]["w"], fl["coupling"]["zero"]["b"],
                     fl["actnorm"]["b"], fl["actnorm"]["logs"]):
            leaf.add_(0.01 * torch.randn(leaf.shape, generator=gen))
    return params


def kernel_checks(params, cfg, B: int, T: int, blocks, dev):
    """Phase 2: kernel vs plain version per routed block and mode."""
    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.ops.conv import quantize_act
    from flowavenet_tpu_torch.utils.tree import tree_map

    rows = []
    for bi in blocks:
        r_in, cc, tk = 1 << bi, 80 << bi, T >> (bi + 1)
        pair = fwn._index(fwn._pair_params(params["blocks"][bi]), 0)
        # 0.05-scale zero convs: the coupling nets then carry a real share
        # of the output, so a wrong net cannot hide under the pass-through
        zero = pair["coupling"]["zero"]
        zero["w"] = 0.05 * torch.randn(
            zero["w"].shape, generator=torch.Generator().manual_seed(SEED + bi))
        pair = tree_map(lambda l: l.to(dev), pair)
        g = torch.Generator(device=dev).manual_seed(SEED + bi)
        u32 = torch.randn(B, tk, r_in, generator=g, device=dev)
        v32 = torch.randn(B, tk, r_in, generator=g, device=dev)
        ca32 = torch.rand(B, tk, cc, generator=g, device=dev)
        cb32 = torch.rand(B, tk, cc, generator=g, device=dev)
        for mode in ("fp32", "bf16", "int8"):
            dt = torch.float32 if mode == "fp32" else torch.bfloat16
            u, v = u32.to(dt), v32.to(dt)
            crs = None
            if mode == "int8":
                (qa, sa), (qb, sb) = (quantize_act(ca32.to(dt), per_row=True),
                                      quantize_act(cb32.to(dt), per_row=True))
                ca, cb = qa, qb
                crs = torch.cat([sa.reshape(-1, 1), sb.reshape(-1, 1)], 1)
                ops = pf.pair_reverse_operands_int8(pair, dtype=dt)
            else:
                ca, cb = ca32.to(dt), cb32.to(dt)
                ops = pf.pair_reverse_operands(pair, dtype=dt)
            int8 = mode == "int8"
            tt = pf.kernel_t_tile(dt)
            # zw, zb = 0: log_s = t = 0, the pair is its two ActNorms
            ops_pass = tuple(torch.zeros_like(o) if i in (11, 12) else o
                             for i, o in enumerate(ops))

            def kern():
                return pf.fused_pair_reverse(u, v, ca, cb, ops, int8=int8,
                                             c_row_scales=crs)

            def plain():
                return pf.pair_reverse_ref(u, v, ca, cb, ops, t_tile=tt,
                                           int8=int8, c_row_scales=crs)

            uk, vk = kern()
            torch.cuda.synchronize()
            ur, vr = plain()
            passthru = pf.pair_reverse_ref(u, v, ca, cb, ops_pass, t_tile=tt,
                                           int8=int8, c_row_scales=crs)
            e_u, e_v = _errors(uk, ur), _errors(vk, vr)
            err = max(e_u[0], e_v[0])
            rel = max(e_u[1], e_v[1])
            corr = min(e_u[2], e_v[2])
            upd = _update_err((uk, vk), (ur, vr), passthru)
            ms = _time_ms(kern, 5)
            plain_ms = _time_ms(plain, 2)
            bound = (pf.pair_bound_ms(B, tk, r_in, cc, int8=int8)
                     if mode != "fp32" else (None, None))
            print(f"block {bi} {mode:4s} T_k={tk:6d} R_in={r_in:2d} "
                  f"Cc={cc:4d}: max_abs={err:.3e} rel={rel:.3e} "
                  f"corr={corr:.7f} update_err={upd:.3e} kernel={ms:.3f} ms "
                  f"plain={plain_ms:.3f} ms bound={bound[0]} ms", flush=True)
            # fp32 differs only in summation order; bf16 and int8 share
            # every cast point with the plain version, so they differ by
            # one-ulp flips (rel <= 2^-7 of the largest output)
            if mode == "fp32":
                check(rel <= 1e-4 and upd <= 1e-4,
                      f"fp32 kernel vs plain: rel {rel} update {upd}")
            elif mode == "bf16":
                check(rel <= 1e-2 and corr >= 0.999 and upd <= 1e-2,
                      f"bf16 kernel vs plain: rel {rel} corr {corr} "
                      f"update {upd}")
            else:
                check(rel <= 1e-2 and corr >= 0.9999 and upd <= 1e-2,
                      f"int8 kernel vs plain: rel {rel} corr {corr} "
                      f"update {upd}")
            rows.append({"block": bi, "mode": mode, "max_abs_err": err,
                         "update_err": upd,
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound[0], "bound_by": bound[1]})
    return rows


def main_path(params, cfg, dev, frames):
    """Phase 3: synthesize_mels through the user-facing entry points."""
    import torch
    from flowavenet_tpu_torch.checkpoint.bridge import save_params
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.synthesis.synthesize import (load_params,
                                                           padded_frames,
                                                           synthesize_mels)

    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "flowavenet_tpu_torch", "smoke_ckpt")
    t0 = time.perf_counter()
    save_params(os.path.join(ckdir, "ckpt-0.npz"), params)
    loaded, _ = load_params(ckdir, cfg, compute_dtype=torch.bfloat16,
                            device=dev)
    print(f"checkpoint round trip: {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.RandomState(SEED)
    mels = [rng.rand(f, cfg.audio.num_mels).astype(np.float32)
            for f in frames]
    hop = cfg.audio.hop_size
    pad = padded_frames(max(frames), cfg)

    samples = sum(f * hop for f in frames)

    def run(name, model_cfg, expect):
        """One warm-up call (cuBLAS, allocator), then REPS timed calls; the
        launch counts are zeroed just before each call and must read
        ``expect`` just after it."""
        c = cfg.replace(model=model_cfg)
        walls = []
        for i in range(REPS + 1):
            torch.cuda.synchronize()
            for k in pf.LAUNCHES:
                pf.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            wavs = synthesize_mels(loaded, c, mels, seed=SEED,
                                   compute_dtype=torch.bfloat16, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(pf.LAUNCHES)
            check(counts == expect, (name, counts))
            if i:
                walls.append(wall * 1e3)
        med = float(np.median(walls))
        print(f"{name} route: median {med:.1f} ms per reverse "
              f"(min {min(walls):.1f}, max {max(walls):.1f}, {REPS} calls), "
              f"{samples / med:.1f} kHz/s, launches {counts}", flush=True)
        return wavs, med, walls, counts

    on = cfg.model
    off = dataclasses.replace(cfg.model, use_pallas=False)
    out = {}
    wavs, wall, walls, counts = run("int8", on,
                                    {"pair_flow": 0, "pair_flow_i8": 15})
    out["launches_i8"] = counts["pair_flow_i8"]
    out["wall_ms_i8"], out["walls_ms_i8"] = wall, walls
    for i, (w, f) in enumerate(zip(wavs, frames)):
        check(w.shape == (f * hop,) and bool(np.all(np.isfinite(w))),
              f"row {i}: shape {w.shape} or non-finite values")
        z = np.random.RandomState(SEED + i).randn(pad * hop)[: f * hop]
        check(np.abs(w - z * cfg.train.temp).max() > 1e-2,
              f"row {i} equals its input noise")
    fwn.PAIR_KERNEL_INT8 = False
    try:
        wavs_d, wall_d, walls_d, counts_d = run(
            "FWN_INT8=0", on, {"pair_flow": 12, "pair_flow_i8": 0})
    finally:
        fwn.PAIR_KERNEL_INT8 = True
    out["launches"] = counts_d["pair_flow"]
    out["wall_ms"], out["walls_ms"] = wall_d, walls_d
    wavs_p, wall_p, walls_p, _ = run("plain", off,
                                     {"pair_flow": 0, "pair_flow_i8": 0})
    out["wall_ms_plain"], out["walls_ms_plain"] = wall_p, walls_p
    for name, ws in (("int8", wavs), ("FWN_INT8=0", wavs_d)):
        _, rel, corr = _errors(np.concatenate(ws), np.concatenate(wavs_p))
        print(f"{name} route vs plain route: rel {rel:.4e} corr {corr:.6f}",
              flush=True)
        check(rel < 0.08 and corr > 0.998, (name, rel, corr))
    out["khz_per_s_i8"] = samples / wall
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from flowavenet_tpu_torch.config import lj22k
    from flowavenet_tpu_torch.ops import _build
    from flowavenet_tpu_torch.synthesis.synthesize import padded_frames

    # the plain versions run in full fp32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; card: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.load("pair_flow")
    print(f"build pair_flow: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.BUILD_INFO.get("pair_flow", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip())

    cfg = lj22k()
    params = randomized_params(cfg, SEED)
    B, T = len(FRAMES), padded_frames(max(FRAMES), cfg) * cfg.audio.hop_size
    # blocks 0-4 take the int8 kernel, blocks 0-3 the bf16 one
    rows = kernel_checks(params, cfg, B, T, range(5), dev)
    main_out = main_path(params, cfg, dev, FRAMES)

    def entry(name, mode, src_line, launches, blks):
        sel = [r for r in rows if r["mode"] == mode and r["block"] in blks]
        n_pair = cfg.model.n_flow // 2
        return {"name": name, "route": "cuda",
                "source": "flowavenet_tpu_torch/ops/csrc/pair_flow.cu",
                "replaces": f"flowavenet_tpu/ops/pallas_flow.py:{src_line}",
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in sel),
                "ms": n_pair * sum(r["ms"] for r in sel),
                "plain_ms": n_pair * sum(r["plain_ms"] for r in sel),
                "bound_ms": n_pair * sum(r["bound_ms"] for r in sel),
                "bound_by": "operations" if all(
                    r["bound_by"] == "operations" for r in sel) else "bytes",
                "library_ms": None}

    kernels = [entry("pair_flow", "bf16", 410, main_out["launches"],
                     range(4)),
               entry("pair_flow_i8", "int8", 514, main_out["launches_i8"],
                     range(5))]
    print(json.dumps({"main_path": {
        "khz_per_s_int8_route": main_out["khz_per_s_i8"],
        "reverse_ms_int8_route": main_out["wall_ms_i8"],
        "reverse_ms_bf16_route": main_out["wall_ms"],
        "reverse_ms_plain_route": main_out["wall_ms_plain"],
        "calls_ms_int8_route": main_out["walls_ms_i8"],
        "calls_ms_bf16_route": main_out["walls_ms"],
        "calls_ms_plain_route": main_out["walls_ms_plain"]}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
