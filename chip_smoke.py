#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Builds the four CUDA sources of ``flowavenet_tpu_torch/ops/csrc`` at
   once (one nvcc each) and prints the build times, ptxas' register and
   spill lines, the card's name and power limit, the versions, and the
   registers and local (spill) bytes per thread of each bf16 reverse pair,
   training pair and ResBlock instance (cudaFuncGetAttributes; all run on
   the tensor cores).
2. Holds the direct reverse pair kernel against its plain PyTorch version
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
   and the H100 bound; each int8 line also the instance's registers and
   local bytes (0 required).  ``i8_batch_shape`` then times
   ``pair_flow_i8`` on block 0 at the offline benchmark's batch shape (128
   rows of 900 frames) beside its bound.  Phase 2b (``variant_checks``)
   does the same for the Winograd pairs (F(2,3), F(4,3), also with hoisted
   conditioning; blocks 0-2, fp32 and bf16), the hoisted pairs (blocks 4-7
   fp32/bf16; int8 blocks 5-7, with the hoist matmul's ms; the plain
   version at the tile the launch recorded; the tensor-core rows with
   their tile, CTAs and the profiler's kernel ms) and the int8 res/skip
   pair (blocks 0-4);
   the bf16 Winograd rows print their instance's registers and local bytes,
   and each block's hoisted Winograd time is printed beside its dense
   twin's.
   Phase 2d (``hoisted_sweep``) runs the hoisted tensor-core pairs over
   several tiles and with their front and zero convs on CUDA cores, each
   point against its plain version, and (``hoisted_i8_batch_tiles``) the
   int8 hoisted pair at B = 1, 4 and 8 on its fixed tile and on the
   batch's wave-balanced one.  Phase 2c (``resblock_checks``) runs
   one coupling net per lj22k block through the fused ResBlock route
   (``coupling_reverse(use_pallas=True)``, launches checked exactly), a
   causal net, an lj8k_gin net with g and a filter_size 48 net (R padded),
   holds ``resblock`` and ``resblock_v2`` against their plain versions
   (each row with its design, registers and local bytes, tile and CTAs,
   CUDA-event and profiler kernel ms, plain and bound ms), and the route's
   fp32 gradients at the training geometry against use_pallas=False.
3. Drives ``synthesize_mels`` at the full lj22k width on 4 mels of unequal
   length, in bf16: seeded random weights written to a JAX-layout npz and
   read back with ``load_params``; every route of ``ROUTES`` (launches per
   reverse checked exactly) and the plain route, which each route must
   match to the JAX package's int8 test bar (corr > 0.998, rel < 0.08).
   Each route runs one warm-up call and ``REPS`` timed calls; the median
   and the range are printed.  ``batch_composition`` then synthesizes one
   mel alone and beside 1 and 3 companions on the int8, FWN_HOISTED=1
   and plain routes: the row must be bit-identical on each, and row 0's
   difference after the upsampler and after each block is printed, with
   each library product's on row 0 (also, recorded, with the products
   run as before synthesis was made batch-invariant);
   ``route_invariance`` holds rows of batches of 2 to 32 to themselves
   alone on every route at 60, 120 and 360 padded frames, and
   ``repair_cost`` times that synthesis path against the one before it
   and against every product one row at a time, in turns.  Phase 3c
   (``profile_phase``) traces one warm int8-route call with
   ``utils/profiling.py:trace`` and prints ``trace_split``'s reading (the
   window's wall time, the device's busy and idle share, the top device
   ops, the time per op class, the longest idle gaps), then CUDA-event
   times of the upsampler and each block.  ``bench_phase`` runs the
   port's bench (``flowavenet_tpu_torch/bench.py``) at its default batch
   and prints its JSON line.  Phase 3b (``odd_width_phase``) reverses
   lj22k models with num_mels 79 and filter_size 48, whose widths the
   kernels take only zero-padded, on the int8, FWN_INT8=0, FWN_WINO4=1
   and FWN_INT8_RS=1 routes (filter_size 48 also on FWN_INT8=0
   FWN_HOISTED=1 and FWN_HOISTED=1) against their plain route at the same
   bar, holds the bf16 forward and training pairs of their block 0
   against the plain versions at phase 4's bars, and (filter_size 48) the
   two hoisted Winograd pairs of block 0 against theirs at phase 2b's bf16
   bars.
4. Holds ``pair_fwd``, ``pair_train_fwd`` and ``pair_train_bwd`` against
   their plain versions at the lj22k training geometry of blocks 0-3
   (B = 8, T_k = 6400 >> (bi+1)) in fp32 and bf16 (bars in
   ``train_kernel_checks``), checks that two backward launches give the
   same bits, and prints kernel, plain and bound ms.  In bf16 all three
   run on the tensor cores; their design, registers and local bytes per
   thread and the tile, CTAs, workspace and gradient-slab bytes that the
   bf16 launches at lj22k block 0 used (``launch.LAST_LAUNCH``;
   for ``pair_fwd``, which runs on blocks 0-3, those of every block) are
   printed and put in the kernel line.
5. The audio frontend (``frontend_phase``): 12 speech-like utterances of
   2-4 s written as WAVs in the LJSpeech layout and preprocessed by the
   port's ``preprocess``; ``mel_spectrogram_torch`` on the card against
   the numpy mel (atol 2e-4).  Then trains lj22k at full width (batch 8 x
   6400 samples, bf16 compute, fp32 params) through the port's entry
   points on that corpus: DDI, then ``TRAIN_STEPS`` steps on the
   FWN_TRAIN_KERNEL=1 route and on the plain route from the same params
   (checks in ``training_phase``), each route's steps beside the same
   steps with synthesis's per-row products and with the library's (cuDNN
   convs; time and peak memory, in turns), one traced kernel-route step
   split by ``trace_split`` (and one with synthesis's products), and one
   FWN_FWD_KERNEL=1 eval step; then
   (``trainer_phase``) ``train()`` itself for 4 steps with
   ``tensorboard=True`` and ``profile_steps=2``, whose trace must hold
   the training pair kernels.
6. Serves lj22k over HTTP on the card (run after step 3, on its loaded
   params; checks in ``serving_phase``): ``SERVE_ROUNDS`` rounds of 8
   concurrent requests (lengths; requests/s, p50/p90 latency over all of
   them, with the spread), batch-composition invariance within a pow2
   batch and length bucket, ``STREAM_REQS`` 800-frame streams (time to
   the first byte, median and range; against one-shot audio), and
   time-parallel synthesis.
   Then (phase 7, ``gin_phase``) lj8k_gin at full width with speaker ids:
   synthesis, serving with X-Speaker-Id, DDI and training steps.
   Scale-out (phases (a)-(d)): the native C++ loader built on the
   card's host (``native_loader_phase``: its prefetched stream against
   ``batch_at``, both loaders' ms per batch, ``train(loader="native")``
   resumed bit for bit); an NCCL step at world size 1 on FWN_TRAIN_KERNEL=1
   and FWN_FWD_KERNEL=1, gradients and steps bit-identical to one device
   (``nccl_phase``); two gloo ranks on the one card on (2, 1) and (1, 2)
   meshes in fp32, gradients against one process, the 12 TP leaves of
   blocks 5-7, a TP checkpoint restored in one process, gloo's step time
   (``gloo_phase``); data-parallel synthesis and serving over
   ``make_data_mesh`` (``data_parallel_phase``: rows bit-identical).
8. The route-quality gate (``quality_gate_phase``, the port's
   ``quality_gate.py``): tiny trained on the card for ``GATE_STEPS`` steps
   on the four 22.05 kHz wavs of ``docs/runs/`` (the NLL must fall), every
   route of ``ROUTES`` and the plain route scored over ``GATE_SEEDS`` noise
   draws with each route's launches checked; the default int8 route must
   pass the JAX gate.  Then one bf16 FWN_TRAIN_KERNEL=1 step of tiny (the
   training pair at R = 32), its launches against their plain versions.
9. Prints a JSON line of main-path numbers, one JSON line of per-kernel
   numbers (per reverse for the reverse pairs, per train step for the
   training pair, per eval step for the forward pair: the sum over the
   routed blocks, 3 pairs each; each with its ``design``, tensor cores or
   CUDA cores, and ``pct_of_bound``, 100 * bound_ms / ms), the card's name
   and power limit, and as its last line ``{"ok": true, "device":
   {...}}``.

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

from flowavenet_tpu_torch.ops.launch import (LAST_LAUNCH, LAUNCHES,
                                             SMEM_MAX, kernel_attrs,
                                             library, uses_tensor_cores)
from flowavenet_tpu_torch.synthesis.routes import (
    ROUTES, patched as _patched, route_patches as _route_patches)

FRAMES = (180, 262, 301, 345)       # ~2.1-4.0 s of 22.05 kHz audio
SEED = 1234
REPS = 5                            # timed synthesize_mels calls per route
TRAIN_STEPS = 8                     # training steps per route
WARMUP_STEPS = 2                    # of which untimed


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


def _reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _counts(nonzero: bool = True) -> dict:
    """The launches of every kernel since the last reset, by name (those
    launched at least once, unless ``nonzero`` is False)."""
    return {k: v for k, v in LAUNCHES.items() if v or not nonzero}


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


def _kernel_ms(fn, reps: int, name: str = "pair_reverse_kernel") -> float:
    """Device time per call of the kernels whose name contains ``name``,
    summed from a torch.profiler trace of ``reps`` calls: the kernel's own
    time, without the wrapper's host work that CUDA events around short
    launches also see.  A trace that holds none of it (seen once in a
    whole run) is taken again, up to three in all; 0 if none holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0)
                 or getattr(e, "cuda_time_total", 0)
                 for e in prof.key_averages() if name in e.key)
        if us:
            break
    return us / 1e3 / reps


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
                regs, local = kernel_attrs("pair_flow_i8", dt)
                print(f"pair_flow_i8 block {bi}: numRegs {regs}, "
                      f"localSizeBytes {local}", flush=True)
                check(local == 0, ("pair_flow_i8 spills", regs, local))
            rows.append({"block": bi, "mode": mode, "max_abs_err": err,
                         "update_err": upd,
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound[0], "bound_by": bound[1]})
    return rows


def i8_batch_shape(params, cfg, dev, rows: int = 128, frames: int = 900):
    """``pair_flow_i8`` on lj22k block 0 at the offline benchmark's batch
    shape (128 rows of 900 padded frames): CUDA-event and profiler ms per
    launch beside ``pair_bound_ms``."""
    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.ops.conv import quantize_act
    from flowavenet_tpu_torch.utils.tree import tree_map

    dt, cc = torch.bfloat16, cfg.model.num_mels
    tk = frames * cfg.audio.hop_size // 2
    pair = tree_map(lambda l: l.to(dev),
                    fwn._index(fwn._pair_params(params["blocks"][0]), 0))
    ops = pf.pair_reverse_operands_int8(pair, dtype=dt)
    g = torch.Generator(device=dev).manual_seed(SEED)
    u, v = (torch.randn(rows, tk, 1, generator=g, device=dev).to(dt)
            for _ in range(2))
    (qa, sa), (qb, sb) = (
        quantize_act(torch.rand(rows, tk, cc, generator=g, device=dev
                                ).to(dt), per_row=True) for _ in range(2))
    crs = torch.cat([sa.reshape(-1, 1), sb.reshape(-1, 1)], 1)

    def kern():
        return pf.fused_pair_reverse(u, v, qa, qb, ops, int8=True,
                                     c_row_scales=crs)
    ms, kernel_ms = _time_ms(kern, 3), _kernel_ms(kern, 3)
    bound, by = pf.pair_bound_ms(rows, tk, 1, cc, int8=True)
    launch = dict(LAST_LAUNCH["pair_flow_i8"])
    print(f"pair_flow_i8 block 0 at the benchmark's batch ({rows} x "
          f"{frames} frames, T_k={tk}): kernel={ms:.3f} ms profiler_kernel="
          f"{kernel_ms:.3f} ms bound={bound:.3f} ms ({by}), "
          f"{100 * bound / kernel_ms:.2f} % of bound; tile "
          f"{launch['t_tile']}, {launch['ctas']} CTAs", flush=True)
    return {"rows": rows, "frames": frames, "T_k": tk, "ms": ms,
            "kernel_ms": kernel_ms, "bound_ms": bound, **launch}


# The other reverse-pair kernels: name -> (blocks, modes)
VARIANTS = {"pair_flow_wino": (range(3), ("fp32", "bf16")),
            "pair_flow_wino4": (range(3), ("fp32", "bf16")),
            "pair_flow_wino_hoisted": (range(3), ("fp32", "bf16")),
            "pair_flow_wino4_hoisted": (range(3), ("fp32", "bf16")),
            "pair_flow_hoisted": (range(4, 8), ("fp32", "bf16")),
            "pair_flow_hoisted_i8": (range(5, 8), ("int8",)),
            "pair_flow_i8rs": (range(5), ("int8",))}


def variant_checks(params, cfg, B: int, T: int, dev):
    """Phase 2b: the Winograd (also with hoisted conditioning, the port of
    _pair_kernel_wino_hoisted, which no model route runs), hoisted and
    int8 res/skip pairs vs their plain versions (TF32 off) at the lj22k
    geometry of the blocks each routes, at the batch shape of phase 3, with
    the kernel bars of phase 2 (fp32 rel <= 1e-4; bf16 rel <= 1e-2, corr
    >= 0.999; int8 rel <= 1e-2, corr >= 0.9999; update_err <= 1e-2, fp32
    1e-4).  The
    Winograd plain version runs at a wider tile than the kernel (its output
    does not depend on the tile); the int8 ones at the kernel's tile.
    Hoisted rows also time the cuBLAS hoist matmul of one pair (c_half @
    w_flow, both halves).  Each row's correctness call runs with the counts
    set to 0 just before it and must launch its kernel once."""
    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.ops.conv import quantize_act
    from flowavenet_tpu_torch.utils.tree import tree_map

    rows = []
    for name, (blocks, modes) in VARIANTS.items():
        attrs = ""
        if name.startswith("pair_flow_wino"):
            regs, local = kernel_attrs(name, torch.bfloat16)
            attrs = f" numRegs={regs} localSizeBytes={local}"
        for bi in blocks:
            r_in, cc, tk = 1 << bi, 80 << bi, T >> (bi + 1)
            pair = fwn._index(fwn._pair_params(params["blocks"][bi]), 0)
            zero = pair["coupling"]["zero"]
            zero["w"] = 0.05 * torch.randn(
                zero["w"].shape,
                generator=torch.Generator().manual_seed(SEED + bi))
            pair = tree_map(lambda l: l.to(dev), pair)
            g = torch.Generator(device=dev).manual_seed(SEED + bi)
            u32 = torch.randn(B, tk, r_in, generator=g, device=dev)
            v32 = torch.randn(B, tk, r_in, generator=g, device=dev)
            ca32 = torch.rand(B, tk, cc, generator=g, device=dev)
            cb32 = torch.rand(B, tk, cc, generator=g, device=dev)
            for mode in modes:
                dt = torch.float32 if mode == "fp32" else torch.bfloat16
                u, v = u32.to(dt), v32.to(dt)
                ca, cb = ca32.to(dt), cb32.to(dt)
                kw, hoist_ms, zi = {}, None, (11, 12)
                if name.startswith("pair_flow_wino"):
                    P = 12 if "wino4" in name else 6
                    ops = (pf.pair_reverse_operands_wino4(pair, dt) if P == 12
                           else pf.pair_reverse_operands_wino(pair, dt))
                    hoisted = name.endswith("hoisted")
                    c = (ca, cb)
                    if hoisted:
                        ops, (we, wo) = pf.pop_cond_w(ops)

                        def hoist(we=we, wo=wo):
                            return pf.hoist_cond(ca, we), pf.hoist_cond(cb, wo)
                        c = hoist()
                        hoist_ms = _time_ms(hoist, 5)
                        zi = (10, 11)

                    def kern(ops=ops, c=c, hoisted=hoisted):
                        return pf.fused_pair_reverse_wino(u, v, *c, ops,
                                                          hoisted=hoisted)

                    def plain(ops=ops, P=P, c=c, hoisted=hoisted):
                        return pf.pair_reverse_wino_ref(
                            u, v, *c, ops, t_tile=160 * P, hoisted=hoisted)
                    bound = pf.pair_bound_ms(
                        B, tk, r_in, c[0].shape[-1],
                        fg_mults=4 / 6 if P == 6 else 0.5, hoisted=hoisted)
                else:
                    if name == "pair_flow_i8rs":
                        (qa, sa), (qb, sb) = (quantize_act(ca, per_row=True),
                                              quantize_act(cb, per_row=True))
                        c = (qa, qb)
                        kw = dict(int8=True, c_row_scales=torch.cat(
                            [sa.reshape(-1, 1), sb.reshape(-1, 1)], 1))
                        ops = pf.pair_reverse_operands_int8(pair, dt, rs=True)
                        bound = pf.pair_bound_ms(B, tk, r_in, cc, int8=True,
                                                 rs=True)
                    else:
                        make = (pf.pair_reverse_operands_hoisted_int8
                                if name.endswith("i8")
                                else pf.pair_reverse_operands_hoisted)
                        ops, (we, wo) = make(pair, dt)

                        def hoist(we=we, wo=wo):
                            return pf.hoist_cond(ca, we), pf.hoist_cond(cb, wo)
                        c = hoist()
                        hoist_ms = _time_ms(hoist, 5)
                        kw = dict(hoisted=True, int8=name.endswith("i8"))
                        zi = (10, 11)
                        bound = pf.pair_bound_ms(B, tk, r_in, c[0].shape[-1],
                                                 int8=kw["int8"],
                                                 hoisted=True)

                    def kern(ops=ops, c=c, kw=kw):
                        return pf.fused_pair_reverse(u, v, *c, ops, **kw)

                    def plain(ops=ops, c=c, kw=kw, name=name):
                        # at the launch's tile: the int8 pairs' per-window
                        # scales follow it
                        return pf.pair_reverse_ref(
                            u, v, *c, ops,
                            t_tile=LAST_LAUNCH[name]["t_tile"], **kw)
                torch.cuda.synchronize()
                _reset_counts()
                uk, vk = kern()
                torch.cuda.synchronize()
                check(_counts() == {name: 1}, (name, "launch count",
                                                _counts()))
                ur, vr = plain()
                # zw, zb = 0: log_s = t = 0, the pair is its two ActNorms
                passthru = plain(ops=tuple(
                    torch.zeros_like(o) if i in zi else o
                    for i, o in enumerate(ops)))
                e_u, e_v = _errors(uk, ur), _errors(vk, vr)
                err, rel = max(e_u[0], e_v[0]), max(e_u[1], e_v[1])
                corr = min(e_u[2], e_v[2])
                upd = _update_err((uk, vk), (ur, vr), passthru)
                ms = _time_ms(kern, 3)
                plain_ms = _time_ms(plain, 1)
                launch = dict(LAST_LAUNCH[name])
                # the hoisted tensor-core pairs' launches are short enough
                # that the events also time the wrapper: their kernel time
                # comes from the profiler
                kernel_ms = (_kernel_ms(kern, 5) if name in HOISTED
                             and mode != "fp32" else None)
                print(f"{name} block {bi} {mode:4s} T_k={tk:6d} R_in="
                      f"{r_in:3d} Cc={cc:5d}: max_abs={err:.3e} rel={rel:.3e} "
                      f"corr={corr:.7f} update_err={upd:.3e} kernel={ms:.3f}"
                      f" ms plain={plain_ms:.3f} ms bound={bound[0]:.4f} ms"
                      f" tile={launch['t_tile']} ctas={launch['ctas']}"
                      + (f" profiler_kernel={kernel_ms:.4f} ms" if kernel_ms
                         is not None else "")
                      + (f" hoist_matmul={hoist_ms:.3f} ms" if hoist_ms
                         is not None else "")
                      + (attrs if mode == "bf16" else ""), flush=True)
                bars = {"fp32": (1e-4, -1.0), "bf16": (1e-2, 0.999),
                        "int8": (1e-2, 0.9999)}[mode]
                check(rel <= bars[0] and corr >= bars[1] and upd <= bars[0],
                      f"{name} block {bi} {mode} vs plain: rel {rel} corr "
                      f"{corr} update {upd}")
                rows.append({"name": name, "block": bi, "mode": mode,
                             "max_abs_err": err, "rel": rel, "corr": corr,
                             "update_err": upd, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound[0],
                             "bound_by": bound[1], "hoist_ms": hoist_ms,
                             "kernel_ms": kernel_ms, **launch})
    # each block's hoisted Winograd pair beside its dense twin, same run
    for twin in ("pair_flow_wino", "pair_flow_wino4"):
        for r in rows:
            if r["name"] == twin + "_hoisted" and r["mode"] == "bf16":
                d = next(x for x in rows if x["name"] == twin
                         and x["mode"] == "bf16" and x["block"] == r["block"])
                r["twin_ms"] = d["ms"]
                print(f"{r['name']} block {r['block']} bf16: {r['ms']:.3f} ms"
                      f" vs {twin} {d['ms']:.3f} ms "
                      f"({100 * (r['ms'] / d['ms'] - 1):+.1f} %)", flush=True)
    return rows


# The hoisted tensor-core pairs: name -> (blocks their routes run, mode)
HOISTED = {"pair_flow_hoisted": (range(4, 8), "bf16"),
           "pair_flow_hoisted_i8": (range(5, 8), "int8")}
# Tiles of phase 2d's sweep (those whose window fits in shared memory run)
SWEEP_TILES = (8, 11, 12, 16, 22, 32, 44, 56, 64, 72, 80)


def _hoisted_case(params, bi: int, B: int, T: int, dev, int8: bool):
    """The first pair of lj22k block ``bi`` (0.05-scale zero convs, as in
    phase 2b) on seeded bf16 inputs of B rows of T_k = T >> (bi + 1), as a
    hoisted pair: (kernel(), plain(tile)), the launch and its plain
    version at a given tile."""
    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.utils.tree import tree_map

    r_in, cc, tk = 1 << bi, 80 << bi, T >> (bi + 1)
    pair = fwn._index(fwn._pair_params(params["blocks"][bi]), 0)
    zero = pair["coupling"]["zero"]
    zero["w"] = 0.05 * torch.randn(
        zero["w"].shape, generator=torch.Generator().manual_seed(SEED + bi))
    pair = tree_map(lambda l: l.to(dev), pair)
    g = torch.Generator(device=dev).manual_seed(SEED + bi)
    u, v = (torch.randn(B, tk, r_in, generator=g, device=dev).bfloat16()
            for _ in range(2))
    ca, cb = (torch.rand(B, tk, cc, generator=g, device=dev).bfloat16()
              for _ in range(2))
    make = (pf.pair_reverse_operands_hoisted_int8 if int8
            else pf.pair_reverse_operands_hoisted)
    ops, (we, wo) = make(pair, torch.bfloat16)
    c = (pf.hoist_cond(ca, we), pf.hoist_cond(cb, wo))

    def kern():
        return pf.fused_pair_reverse(u, v, *c, ops, int8=int8, hoisted=True)

    def plain(tt):
        return pf.pair_reverse_ref(u, v, *c, ops, t_tile=tt, int8=int8,
                                   hoisted=True)
    return kern, plain


def hoisted_i8_batch_tiles(params, T: int, dev):
    """Phase 2d, the int8 hoisted pair's tile at B = 1, 4 and 8 rows
    (blocks 5-7, T_k = T >> (b + 1)): the tile the launch takes, fixed by
    T and the widths (``pair_flow.hoisted_launch_tile``), against the
    wave-balanced tile of the batch that the pair took before
    (``hoisted_t_tile(B, ...)``), each held to its plain version at its
    tile (rel <= 1e-2, corr >= 0.9999) and timed by profiler kernel ms per
    launch.  Returns one row per (B, block)."""
    import torch
    from flowavenet_tpu_torch.ops import pair_flow as pf

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib, pick = library("pair_flow"), pf._hoisted_tile
    rows = []
    for B in (1, 4, 8):
        for bi in range(5, 8):
            r_in, tk = 1 << bi, T >> (bi + 1)
            kern, plain = _hoisted_case(params, bi, B, T, dev, True)
            kern()
            fixed = LAST_LAUNCH["pair_flow_hoisted_i8"]["t_tile"]
            batch = pf.hoisted_t_tile(
                B, tk, n_sm, lambda tt, r_in=r_in: lib.pair_reverse_smem_bytes(
                    1, 4, 1, 256, r_in, tt))
            row = {"B": B, "block": bi, "fixed_tile": fixed,
                   "batch_tile": batch}
            for key, tt in (("fixed", fixed), ("batch", batch)):
                try:
                    pf._hoisted_tile = lambda *a, tt=tt: tt
                    uk, vk = kern()
                    ur, vr = plain(tt)
                    row[f"{key}_kernel_ms"] = _kernel_ms(kern, 5)
                finally:
                    pf._hoisted_tile = pick
                e_u, e_v = _errors(uk, ur), _errors(vk, vr)
                rel, corr = max(e_u[1], e_v[1]), min(e_u[2], e_v[2])
                check(rel <= 1e-2 and corr >= 0.9999,
                      ("hoisted_i8 batch tile", B, bi, key, rel, corr))
            print(f"pair_flow_hoisted_i8 B={B} block {bi}: fixed tile "
                  f"{fixed} ({B * -(-tk // fixed)} CTAs) "
                  f"{row['fixed_kernel_ms']:.4f} ms kernel, the batch's "
                  f"tile {batch} ({B * -(-tk // batch)} CTAs) "
                  f"{row['batch_kernel_ms']:.4f} ms", flush=True)
            rows.append(row)
    for B in (1, 4, 8):
        sel = [r for r in rows if r["B"] == B]
        print(f"pair_flow_hoisted_i8 B={B}, per reverse (3 pairs x blocks "
              f"5-7): fixed tiles "
              f"{3 * sum(r['fixed_kernel_ms'] for r in sel):.4f} ms kernel, "
              f"the batch's tiles "
              f"{3 * sum(r['batch_kernel_ms'] for r in sel):.4f} ms",
              flush=True)
    return rows


def hoisted_sweep(params, cfg, B: int, T: int, dev):
    """Phase 2d: the hoisted tensor-core pairs at phase 3's batch on every
    block their routes run, once per tile of ``SWEEP_TILES`` that fits
    (the rule's tile, ``pair_flow.hoisted_t_tile``, marked ``rule``), and
    at the rule's tile with the front and zero convs on CUDA cores
    (``pair_flow.front_zero_tc`` forced off; ``front_zero_tc`` False in
    the row): CUDA-event ms per call and profiler kernel ms per launch.
    The rule's tile is ``pair_flow.hoisted_launch_tile``'s: the int8
    pair's is fixed by T and the widths (``hoisted_i8_batch_tiles`` times
    it at other batches).  Every point is held to its plain version at
    that tile with phase 2b's bars, so the sweep also checks the tiles and
    the CUDA-core front and zero convs that the main path does not run."""
    from flowavenet_tpu_torch.ops import pair_flow as pf

    rows = []
    pick, front = pf._hoisted_tile, pf.front_zero_tc
    for name, (blocks, mode) in HOISTED.items():
        int8 = mode == "int8"
        for bi in blocks:
            r_in, tk = 1 << bi, T >> (bi + 1)
            kern, plain = _hoisted_case(params, bi, B, T, dev, int8)
            kern()
            rule = LAST_LAUNCH[name]["t_tile"]
            smem = library("pair_flow").pair_reverse_smem_bytes
            points = [(tt, True) for tt in sorted(set(SWEEP_TILES) | {rule})
                      if 0 < smem(1, 4 if int8 else 3, 1, 256, r_in, tt)
                      <= SMEM_MAX]
            if front(r_in):
                points.append((rule, False))
            for tt, fz in points:
                try:
                    pf._hoisted_tile = lambda *a, tt=tt: tt
                    pf.front_zero_tc = lambda r, fz=fz: fz and front(r)
                    uk, vk = kern()
                    ur, vr = plain(tt)
                    ms = _time_ms(kern, 5)
                    kms = _kernel_ms(kern, 5)
                finally:
                    pf._hoisted_tile, pf.front_zero_tc = pick, front
                e_u, e_v = _errors(uk, ur), _errors(vk, vr)
                rel, corr = max(e_u[1], e_v[1]), min(e_u[2], e_v[2])
                check(rel <= 1e-2 and corr >= (0.9999 if int8 else 0.999),
                      (name, bi, tt, fz, "sweep vs plain", rel, corr))
                row = {"name": name, "block": bi, "t_tile": tt,
                       "ctas": B * -(-tk // tt), "rule": tt == rule,
                       "front_zero_tc": fz and front(r_in), "ms": ms,
                       "kernel_ms": kms, "rel": rel}
                print(f"sweep {name} block {bi} R_in={r_in:3d} tile {tt:3d} "
                      f"({row['ctas']} CTAs{', rule' if row['rule'] else ''}"
                      f", front/zero on "
                      f"{'tensor' if row['front_zero_tc'] else 'CUDA'} cores)"
                      f": {ms:.4f} ms per call, {kms:.4f} ms kernel, rel "
                      f"{rel:.2e}", flush=True)
                rows.append(row)
    return rows


def _cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-30))


def train_kernel_checks(params, cfg, B: int, T: int, blocks, dev):
    """Phase 4: pair_fwd, pair_train_fwd and pair_train_bwd vs their plain
    versions at the training geometry of each block (a pair with 0.05-scale
    zero convs and ActNorm noise; the hinge margin set to half the pair's
    max|log_s| so the hinge is live; TF32 off).  fp32: rel-to-max <= 1e-4
    on outputs and statistics; the gradients' worst leaf error (rel-to-max)
    against the plain version run in fp64 at most twice the fp32 plain
    version's own (or 1e-4), and cosine >= 0.99999 per leaf.  (A relu
    pre-activation within fp32 rounding of 0 flips its mask between any
    two fp32 evaluation orders and moves a few rows' input gradients by up
    to ~2e-2 of the leaf's max, so the plain fp32 version is itself that
    far from fp64; rel-to-max 1e-4 holds for neither.)
    bf16: outputs rel <= 1e-2 and corr >= 0.999, statistics rel <= 1e-2,
    cosine >= 0.999 per gradient leaf.  Two backward launches must give the
    same bits."""
    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    from flowavenet_tpu_torch.utils.tree import tree_map

    rows = []
    margin0 = pft.HINGE_MARGIN
    for bi in blocks:
        r_in, cc, tk = 1 << bi, 80 << bi, T >> (bi + 1)
        gen = torch.Generator().manual_seed(SEED + 10 + bi)
        pair = tree_map(lambda l: l.clone(),
                        fwn._index(fwn._pair_params(params["blocks"][bi]), 0))
        for leaf, s in ((pair["coupling"]["zero"]["w"], 0.05),
                        (pair["actnorm"]["b"], 0.05),
                        (pair["actnorm"]["logs"], 0.05)):
            leaf.add_(s * torch.randn(leaf.shape, generator=gen))
        pair = tree_map(lambda l: l.to(dev), pair)
        g = torch.Generator(device=dev).manual_seed(SEED + bi)
        x32 = [torch.randn(B, tk, r_in, generator=g, device=dev)
               for _ in range(4)]
        c32 = [torch.rand(B, tk, cc, generator=g, device=dev)
               for _ in range(2)]
        scal = [torch.tensor(s, device=dev) for s in (0.7, 0.11, 1.3)]
        for mode in ("fp32", "bf16"):
            dt = torch.float32 if mode == "fp32" else torch.bfloat16
            u, v, gu, gv = (x.to(dt) for x in x32)
            ca, cb = (x.to(dt) for x in c32)
            ops = pf.pair_forward_operands(pair, dt)
            pft.HINGE_MARGIN = margin0
            mx = float(pft.pair_train_fwd_ref(u, v, ca, cb, ops)[3])
            pft.HINGE_MARGIN = 0.5 * mx
            try:
                want = pft.pair_train_fwd_ref(u, v, ca, cb, ops)
                got = pft.fused_pair_train_fwd(u, v, ca, cb, ops)
                fwd = pft.fused_pair_forward(u, v, ca, cb, ops)
                d1 = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal,
                                              ops)
                d2 = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal,
                                              ops)
                torch.cuda.synchronize()
                # tile, CTAs and allocations of these launches
                launch = {k: dict(LAST_LAUNCH[k])
                          for k in pft.TRAIN_KERNELS}
                dref = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, *scal,
                                              ops)
                errs = [_errors(a, b) for a, b in
                        list(zip(got[:2], want[:2]))
                        + list(zip(fwd[:2], want[:2]))]
                rel = max(e[1] for e in errs)
                corr = min(e[2] for e in errs)
                st_rel = max(abs(float(a) - float(b))
                             / max(abs(float(b)), 1e-6) for a, b in
                             list(zip(got[2:], want[2:])) + [(fwd[2],
                                                              want[2])])
                flat = lambda d: list(d[0]) + list(d[1:])
                same = all(torch.equal(a, b) for a, b in zip(flat(d1),
                                                             flat(d2)))
                # per leaf: rel-to-max, L2-relative error and cosine
                g_rel, g_l2, g_cos, g_err = 0.0, 0.0, 1.0, 0.0
                for a, b in zip(flat(d1), flat(dref)):
                    a, b = a.double(), b.double()
                    check(bool(torch.isfinite(a).all()), "non-finite grad")
                    if float(b.abs().max()) == 0.0:
                        continue
                    err = float((a - b).abs().max())
                    g_err = max(g_err, err)
                    g_rel = max(g_rel, err / float(b.abs().max()))
                    g_l2 = max(g_l2, float((a - b).norm() / b.norm()))
                    g_cos = min(g_cos, _cos(a, b))
                y64, k64, p64 = "", 0.0, 0.0
                if mode == "fp32":
                    # yardstick: the kernel and the fp32 plain version
                    # against the plain version in fp64
                    d64 = pft.pair_train_bwd_ref(
                        *(x.double() for x in (u, v, ca, cb, gu, gv)),
                        *scal, tuple(o.double() for o in ops))
                    worst = []
                    for a, b, e in zip(flat(d1), flat(dref), flat(d64)):
                        m = float(e.abs().max())
                        if m > 0:
                            worst.append((float((a.double() - e).abs().max())
                                          / m,
                                          float((b.double() - e).abs().max())
                                          / m))
                    k64 = max(w[0] for w in worst)
                    p64 = max(w[1] for w in worst)
                    y64 = f" | vs fp64: kernel {k64:.2e} plain fp32 {p64:.2e}"
                fwd_ms = _time_ms(
                    lambda: pft.fused_pair_train_fwd(u, v, ca, cb, ops), 5)
                pfw_ms = _time_ms(
                    lambda: pft.fused_pair_forward(u, v, ca, cb, ops), 5)
                bwd_ms = _time_ms(lambda: pft.fused_pair_train_bwd(
                    u, v, ca, cb, gu, gv, *scal, ops), 3)
                fwd_plain = _time_ms(
                    lambda: pft.pair_train_fwd_ref(u, v, ca, cb, ops), 2)
                pfw_plain = _time_ms(lambda: pft.pair_train_fwd_ref(
                    u, v, ca, cb, ops, stats=False), 2)
                bwd_plain = _time_ms(lambda: pft.pair_train_bwd_ref(
                    u, v, ca, cb, gu, gv, *scal, ops), 2)
            finally:
                pft.HINGE_MARGIN = margin0
            print(f"train block {bi} {mode:4s} T_k={tk:5d} R_in={r_in:2d} "
                  f"Cc={cc:4d}: out rel={rel:.3e} corr={corr:.7f} "
                  f"stats rel={st_rel:.3e} grad rel={g_rel:.3e} "
                  f"l2={g_l2:.3e} cos={g_cos:.8f} bwd deterministic={same}"
                  f"{y64} | ms: "
                  f"train_fwd {fwd_ms:.3f} (plain {fwd_plain:.3f}) "
                  f"fwd {pfw_ms:.3f} (plain {pfw_plain:.3f}) "
                  f"bwd {bwd_ms:.3f} (plain {bwd_plain:.3f})", flush=True)
            check(same, f"pair_train_bwd not deterministic (block {bi})")
            if mode == "fp32":
                check(rel <= 1e-4 and st_rel <= 1e-4
                      and k64 <= max(2.0 * p64, 1e-4) and g_cos >= 0.99999,
                      f"fp32 training kernels vs plain, block {bi}: out "
                      f"{rel} stats {st_rel} grads vs fp64 {k64} (plain "
                      f"fp32 {p64}) cos {g_cos}")
            else:
                check(rel <= 1e-2 and corr >= 0.999 and st_rel <= 1e-2
                      and g_cos >= 0.999,
                      f"bf16 training kernels vs plain, block {bi}: out "
                      f"{rel} corr {corr} stats {st_rel} grad cos {g_cos}")
            rows.append({"block": bi, "mode": mode, "T_k": tk,
                         "fwd_err": max(e[0] for e in errs[:2]),
                         "pfw_err": max(e[0] for e in errs[2:]),
                         "bwd_err": g_err,
                         "fwd_ms": fwd_ms, "pfw_ms": pfw_ms,
                         "bwd_ms": bwd_ms, "fwd_plain_ms": fwd_plain,
                         "pfw_plain_ms": pfw_plain, "bwd_plain_ms": bwd_plain,
                         "launch": launch,
                         "fwd_bound": pft.train_pair_bound_ms(B, tk, r_in,
                                                              cc),
                         "bwd_bound": pft.train_pair_bound_ms(
                             B, tk, r_in, cc, backward=True)})
    return rows


def resblock_checks(params, cfg, B: int, T: int, dev):
    """Phase 2c: the fused ResBlock route (no model route runs it, as in
    the JAX package).  One coupling net (flow 0, 0.05-scale zero conv) of
    each lj22k block b = 0-7 at the synthesis geometry of phase 3 (T_k = T
    >> (b+1), Cc = 80 * 2^b), through ``coupling_reverse(use_pallas=True)``
    with the counts set to 0 just before and read just after: exactly one
    ``resblock_v2`` launch on blocks 0-5 and one ``resblock`` on blocks 6-7
    (Cc > V2_MAX_CC).  Against use_pallas=False: fp32 update_err <= 1e-4
    (the error as a share of what the net adds to the pass-through x); in
    bf16 each route against the fp32 result, the kernel route's update_err
    at most 1.5x the plain route's (or 1e-2), as the two round at other
    points.  The kernel on the inputs the route gave it vs its plain
    version: fp32 rel <= 1e-4, bf16 rel <= 1e-2 and corr >= 0.999, with
    kernel, plain and bound ms.  Then, in fp32 and bf16, a causal net
    (block 0, v2), an lj8k_gin net with g (block 0, v1) and a filter_size
    48 net (block 0, v2, R run padded), and, at the training geometry (8 x
    6400), coupling_forward(use_pallas=True) plus backward against
    use_pallas=False on blocks 0 (v2) and 6 (v1), fp32: cosine >= 0.999
    for every parameter's gradient and for x and c.  Each row also carries
    its design, registers and local bytes, the launch's tile and CTAs and
    the profiler's kernel ms."""
    import torch
    from flowavenet_tpu_torch.config import lj8k_gin
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import resblock as rb
    from flowavenet_tpu_torch.utils.tree import leaves, tree_map

    def net(p, bi):
        cp = tree_map(lambda l: l.clone(),
                      fwn._index(p["blocks"][bi]["flows"], 0)["coupling"])
        cp["zero"]["w"] = 0.05 * torch.randn(
            cp["zero"]["w"].shape,
            generator=torch.Generator().manual_seed(SEED + 20 + bi))
        return tree_map(lambda l: l.to(dev), cp)

    real = {"resblock": rb.fused_gated_resblock,
            "resblock_v2": rb.fused_gated_resblock_v2}
    plain_of = {"resblock": rb.resblock_ref, "resblock_v2": rb.resblock_v2_ref}
    seen = []

    def spy(name):
        def run(*a, **kw):
            seen.append((name, a, kw))
            return real[name](*a, **kw)
        return run

    rows, sweep_launches = [], {}
    rb.fused_gated_resblock = spy("resblock")
    rb.fused_gated_resblock_v2 = spy("resblock_v2")
    try:
        def one(tag, cp, x, c, g=None, causal=False, mode="fp32",
                y32=None, x32=None, cc=0):
            """One net through both routes; returns (kernel route output,
            row)."""
            kw = dict(affine=True, causal=causal)
            torch.cuda.synchronize()
            _reset_counts()
            seen.clear()
            with torch.no_grad():
                yk = fwn.coupling_reverse(cp, x, c, g, use_pallas=True, **kw)
            torch.cuda.synchronize()
            counts = _counts()
            name = seen[0][0]
            want = "resblock_v2" if g is None and cc <= rb.V2_MAX_CC \
                else "resblock"
            check(counts == {want: 1} and name == want,
                  (tag, "resblock launches", counts))
            with torch.no_grad():
                yp = fwn.coupling_reverse(cp, x, c, g, **kw)
            if mode == "fp32":
                upd = _update_err([yk], [yp], [x])
                ok, upd_p = upd <= 1e-4, None
            else:
                upd = _update_err([yk], [y32], [x32])
                upd_p = _update_err([yp], [y32], [x32])
                ok = upd <= max(1.5 * upd_p, 1e-2)
            _, a, akw = seen[0]
            with torch.no_grad():
                got = real[name](*a, **akw)
                ref = plain_of[name](*a, **akw)
                torch.cuda.synchronize()
                errs = [_errors(g_, r_) for g_, r_ in zip(got, ref)]
                ms = _time_ms(lambda: real[name](*a, **akw), 5)
                plain_ms = _time_ms(lambda: plain_of[name](*a, **akw), 2)
            with torch.no_grad():
                kms = _kernel_ms(lambda: real[name](*a, **akw), 5,
                                 "resblock")
            launch = dict(LAST_LAUNCH[name])
            err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            corr = min(e[2] for e in errs)
            Bk, tk = a[0].shape[:2]
            bound = rb.resblock_bound_ms(
                Bk, tk, R=a[0].shape[-1], S=a[0].shape[-1],
                cc=a[1].shape[-1] if name == "resblock_v2" else 0,
                dtype=a[0].dtype)
            regs, local = kernel_attrs(name, a[0].dtype)
            design = ("tensor cores (mma.sync)"
                      if uses_tensor_cores(a[0].dtype) else "CUDA cores")
            print(f"{tag} {mode}: {name} route vs plain route update_err "
                  f"{upd:.3e}" + (f" (plain route {upd_p:.3e})" if upd_p
                                  is not None else "")
                  + f"; kernel vs plain version max_abs={err:.3e} "
                  f"rel={rel:.3e} corr={corr:.7f} kernel={ms:.3f} ms "
                  f"(profiler kernel {kms:.4f} ms) plain={plain_ms:.3f} ms "
                  f"bound={bound[0]:.4f} ms; {design}, {regs} registers, "
                  f"{local} local bytes, tile {launch['t_tile']} rows, "
                  f"{launch['ctas']} CTAs", flush=True)
            check(ok, (tag, mode, "route agreement", upd, upd_p))
            bars = (1e-4, -1.0) if mode == "fp32" else (1e-2, 0.999)
            check(rel <= bars[0] and corr >= bars[1],
                  (tag, mode, name, "kernel vs plain", rel, corr))
            return yk, {"tag": tag, "name": name, "mode": mode,
                        "max_abs_err": err, "rel": rel, "corr": corr,
                        "update_err": upd, "ms": ms, "kernel_ms": kms,
                        "plain_ms": plain_ms, "bound_ms": bound[0],
                        "bound_by": bound[1], "design": design,
                        "registers": regs, "local_bytes": local,
                        "t_tile": launch["t_tile"], "ctas": launch["ctas"]}

        for bi in range(cfg.model.n_block):
            r_in, cc, tk = 1 << bi, 80 << bi, T >> (bi + 1)
            cp = net(params, bi)
            g = torch.Generator(device=dev).manual_seed(SEED + 30 + bi)
            x32 = torch.randn(B, tk, 2 * r_in, generator=g, device=dev)
            c32 = torch.rand(B, tk, 2 * cc, generator=g, device=dev)
            y32, row = one(f"resblock block {bi}", cp, x32, c32, cc=cc)
            rows.append({**row, "block": bi, "sweep": True})
            _, row = one(f"resblock block {bi}", cp, x32.bfloat16(),
                         c32.bfloat16(), mode="bf16", y32=y32, x32=x32,
                         cc=cc)
            rows.append({**row, "block": bi, "sweep": True})
            sweep_launches[row["name"]] = sweep_launches.get(
                row["name"], 0) + 1
        # causal: block 0's net with causal convs (v2)
        g = torch.Generator(device=dev).manual_seed(SEED + 40)
        x0 = torch.randn(B, T >> 1, 2, generator=g, device=dev)
        c0 = torch.rand(B, T >> 1, 160, generator=g, device=dev)
        cnet = net(params, 0)
        y32, row = one("resblock causal block 0", cnet, x0, c0, causal=True,
                       cc=80)
        rows.append(row)
        rows.append(one("resblock causal block 0", cnet, x0.bfloat16(),
                        c0.bfloat16(), causal=True, mode="bf16", y32=y32,
                        x32=x0, cc=80)[1])
        # lj8k_gin block 0 with g (v1): g is the speaker embedding, constant
        # in time, at the block's level (2 * gin channels)
        gcfg = lj8k_gin()
        gnet = net({"blocks": [fwn.init_block(
            torch.Generator().manual_seed(SEED + 41), 1,
            gcfg.model.num_mels, gcfg.model, gcfg.model.gin_channels)]}, 0)
        tg = 360 * gcfg.audio.hop_size >> 1      # 360 frames, level 1
        xg = torch.randn(B, tg, 2, generator=g, device=dev)
        cg = torch.rand(B, tg, 160, generator=g, device=dev)
        emb = torch.randn(B, 1, 2 * gcfg.model.gin_channels, generator=g,
                          device=dev)
        ge = emb.expand(B, tg, emb.shape[-1])
        y32, row = one("resblock lj8k_gin block 0 with g", gnet, xg, cg,
                       g=ge, cc=80)
        rows.append(row)
        rows.append(one("resblock lj8k_gin block 0 with g", gnet,
                        xg.bfloat16(), cg.bfloat16(), g=ge.bfloat16(),
                        mode="bf16", y32=y32, x32=xg, cc=80)[1])
        # filter_size 48: R = 48, which both instances take only padded
        # (bf16 R 64, fp32 R 64), block 0's net (v2, Cc 80)
        fcfg = dataclasses.replace(cfg.model, filter_size=48)
        fnet = net({"blocks": [fwn.init_block(
            torch.Generator().manual_seed(SEED + 42), 1, 80, fcfg)]}, 0)
        y32, row = one("resblock filter_size 48 block 0", fnet, x0, c0,
                       cc=80)
        rows.append(row)
        rows.append(one("resblock filter_size 48 block 0", fnet,
                        x0.bfloat16(), c0.bfloat16(), mode="bf16", y32=y32,
                        x32=x0, cc=80)[1])
    finally:
        rb.fused_gated_resblock = real["resblock"]
        rb.fused_gated_resblock_v2 = real["resblock_v2"]

    # gradients at the training geometry, fp32
    tB, tT = cfg.data.batch_size, cfg.data.max_time_steps
    grads = {}
    for bi in (0, 6):
        r_in, cc, tk = 1 << bi, 80 << bi, tT >> (bi + 1)
        cp = net(params, bi)
        g = torch.Generator(device=dev).manual_seed(SEED + 50 + bi)
        x = torch.randn(tB, tk, 2 * r_in, generator=g, device=dev)
        c = torch.rand(tB, tk, 2 * cc, generator=g, device=dev)
        ct = torch.randn(tB, tk, 2 * r_in, generator=g, device=dev)
        gs = {}
        for on in (True, False):
            p = tree_map(lambda l: l.detach().clone().requires_grad_(), cp)
            xs = [x.clone().requires_grad_(), c.clone().requires_grad_()]
            _reset_counts()
            out, ld = fwn.coupling_forward(p, *xs, affine=True, causal=False,
                                           use_pallas=on)
            ((out * ct).sum() + 100.0 * ld).backward()
            torch.cuda.synchronize()
            want = ({"resblock_v2" if cc <= rb.V2_MAX_CC else "resblock": 1}
                    if on else {})
            check(_counts() == want, ("train geometry launches", bi,
                                      _counts()))
            gs[on] = [l.grad for l in leaves(p)] + [t.grad for t in xs]
        cos = [_cos(a, b) for a, b in zip(gs[True], gs[False])
               if a is not None and b is not None
               and float(b.abs().max()) > 0]
        check(len(cos) >= 20, ("gradients compared", len(cos)))
        grads[bi] = min(cos)
        print(f"resblock training geometry block {bi} (T_k {tk}): "
              f"{len(cos)} gradients, min cosine kernel vs plain route "
              f"{min(cos):.8f}", flush=True)
        check(min(cos) >= 0.999, ("resblock route gradient cosine", bi,
                                  min(cos)))
    return rows, sweep_launches, grads


def _write_corpus(d: str, cfg, n: int = 16, speakers: int = 1) -> None:
    """A seeded fwrec corpus: random audio aligned to random 80-bin mels,
    40-60 frames per utterance (longer than the crop), utterance i spoken
    by speaker i % ``speakers``."""
    from flowavenet_tpu_torch.data.records import FwRecordWriter
    rng = np.random.RandomState(SEED)
    hop, mels = cfg.audio.hop_size, cfg.audio.num_mels
    for name, count in (("train", n), ("test", 4)):
        with FwRecordWriter(os.path.join(d, f"{name}.fwrec")) as w:
            for i in range(count):
                f = int(rng.randint(40, 61))
                w.write((0.1 * rng.randn(f * hop)).astype(np.float32),
                        rng.rand(f, mels).astype(np.float32), i % speakers)


def training_phase(cfg, dev, data_dir: str, steps: int = TRAIN_STEPS):
    """Phase 5: lj22k training at full width, batch 8 x 6400 samples,
    bf16 compute with fp32 params, through the port's entry points
    (CropDataset, create_state, ddi_initialize, make_train_step,
    make_eval_step), on the corpus that the frontend phase preprocessed
    into ``data_dir``.  DDI, then ``steps`` steps on each
    route from identical params: FWN_TRAIN_KERNEL=1 and the plain route;
    each route's steps beside the same steps on the ``synthesis`` and
    ``library`` paths of ``_path_patches`` (``_timed_steps``: time and
    peak memory, in turns);
    then one more FWN_TRAIN_KERNEL=1 step under ``utils/profiling.py:
    trace``, split by ``trace_split``.
    Checks finite losses; the first-step loss of the two routes within rel
    1e-3, or the kernel route's no farther from the fp32 loss than the
    plain route's; at the params the plain route reached, the cosine of
    the two routes' global gradients on batch 0 in fp32 >= 0.999, and in
    bf16 each route's cosine to the fp32 gradient, the kernel route's no
    more than 0.01 below the plain route's; and
    the kernel launches per step the routing implies; a FWN_FWD_KERNEL=1
    eval step launches pair_fwd on blocks 0-3."""
    import torch
    from flowavenet_tpu_torch.data.dataset import CropDataset
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.training.train import to_device
    from flowavenet_tpu_torch.training.train_state import (
        create_state, ddi_initialize, make_eval_step, make_train_step)
    from flowavenet_tpu_torch.utils.profiling import trace
    from flowavenet_tpu_torch.utils.tree import leaves, tree_map

    ds = CropDataset(os.path.join(data_dir, "train.fwrec"),
                     hop_size=cfg.audio.hop_size,
                     max_time_steps=cfg.data.max_time_steps,
                     batch_size=cfg.data.batch_size, seed=cfg.train.seed)
    batches = [to_device(ds.batch_at(s), dev) for s in range(steps)]
    t0 = time.perf_counter()
    state0 = create_state(torch.Generator(dev).manual_seed(SEED), cfg)
    state0 = ddi_initialize(state0, cfg, batches[0])
    torch.cuda.synchronize()
    ddi_s = time.perf_counter() - t0
    print(f"training: DDI {ddi_s:.2f} s", flush=True)
    n_route = sum((cfg.model.num_mels << bi) <= fwn.TRAIN_KERNEL_MAX_CC
                  for bi in range(cfg.model.n_block)) * cfg.model.n_flow // 2

    def global_grad(params, dt):
        p = tree_map(lambda l: l.detach().requires_grad_(), params)
        total, _ = fwn.loss_fn(p, cfg.model, batches[0]["audio"],
                               batches[0]["mel"], compute_dtype=dt,
                               logs_l2=cfg.train.logs_l2,
                               logs_hinge=cfg.train.logs_hinge)
        flat = leaves(p)
        gs = torch.autograd.grad(total, flat, allow_unused=True)
        return float(total.detach()), torch.cat([
            (torch.zeros_like(x) if g is None else g).flatten()
            for g, x in zip(gs, flat)])

    out = {}
    saved = fwn.TRAIN_KERNEL
    try:
        for route, on in (("kernel", True), ("plain", False)):
            fwn.TRAIN_KERNEL = on
            step_fn = make_train_step(cfg)
            state = state0
            torch.cuda.reset_peak_memory_stats(dev)
            walls, losses, counts = [], [], None
            for s in range(steps):
                torch.cuda.synchronize()
                _reset_counts()
                t0 = time.perf_counter()
                state, m = step_fn(state, batches[s])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                counts = _counts(nonzero=False)
                losses.append(float(m["loss"]))
                want = n_route if on else 0
                check(counts["pair_train_fwd"] == want
                      and counts["pair_train_bwd"] == want
                      and counts["pair_fwd"] == 0,
                      (route, "launches", counts))
            check(all(np.isfinite(losses)), (route, "losses", losses))
            timed = walls[WARMUP_STEPS:]
            med = float(np.median(timed))
            out[route] = {
                "losses": losses, "ms": med, "ms_min": min(timed),
                "ms_max": max(timed), "walls": walls,
                "samples_per_s": cfg.data.batch_size
                * cfg.data.max_time_steps / (med / 1e3),
                "launches": {k: v for k, v in counts.items() if v},
                "max_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                "state": state}
            print(f"training {route} route: median {med:.1f} ms/step (min "
                  f"{min(timed):.1f}, max {max(timed):.1f}, {len(timed)} "
                  f"steps after {WARMUP_STEPS} warm-up), "
                  f"{out[route]['samples_per_s']:.0f} samples/s, launches "
                  f"per step {out[route]['launches']}, max memory "
                  f"{out[route]['max_mem_gb']:.2f} GB, losses "
                  f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
        # training's products against synthesis's schedule (the front conv
        # and conditioning per row) and the library's (cuDNN convs)
        for route, on in (("kernel", True), ("plain", False)):
            fwn.TRAIN_KERNEL = on
            out[route]["paths"] = r = _timed_steps(
                make_train_step(cfg), state0, batches,
                {"as trained": [], "synthesis": _path_patches("synthesis"),
                 "library": _path_patches("library")}, dev)
            print(f"training {route} route by product path: " + "; ".join(
                f"{k} median {v['median_ms']:.1f} ms/step, min "
                f"{min(v['ms']):.1f} (steps "
                f"{', '.join(f'{t:.1f}' for t in v['ms'])}; peak "
                f"{v['step_peak_gb']:.2f} GB above the state)"
                for k, v in r.items()), flush=True)
        # where the kernel route's step time goes: one traced step
        fwn.TRAIN_KERNEL = True
        step_fn = make_train_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with trace(os.path.join(data_dir, "profile_train")) as prof:
            float(step_fn(state0, batches[1])[1]["loss"])
        split = trace_split(prof, (time.perf_counter() - t0) * 1e3,
                            "FWN_TRAIN_KERNEL=1, one lj22k training step")
        with _patched(_path_patches("synthesis")):
            t0 = time.perf_counter()
            with trace(os.path.join(data_dir, "profile_train_rows")) as prof:
                float(step_fn(state0, batches[1])[1]["loss"])
            split_rows = trace_split(
                prof, (time.perf_counter() - t0) * 1e3, "FWN_TRAIN_KERNEL=1,"
                " one lj22k training step with synthesis's per-row products")
        # the gradients of both routes at the params the plain route
        # reached: at the DDI'd start the true gradient of the ActNorms and
        # biases is ~0 and bf16 rounding noise dominates it
        trained = out["plain"]["state"].params
        g = {}
        for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            for route, on in (("kernel", True), ("plain", False)):
                fwn.TRAIN_KERNEL = on
                g[route, name] = global_grad(trained, dt)
        fwn.TRAIN_KERNEL = False
        l32 = global_grad(state0.params, torch.float32)[0]
    finally:
        fwn.TRAIN_KERNEL = saved
    cos = _cos(g["kernel", "fp32"][1], g["plain", "fp32"][1])
    cos_k = _cos(g["kernel", "bf16"][1], g["plain", "fp32"][1])
    cos_p = _cos(g["plain", "bf16"][1], g["plain", "fp32"][1])
    l_k, l_p = out["kernel"]["losses"][0], out["plain"]["losses"][0]
    loss_rel = abs(l_k - l_p) / abs(l_p)
    k32 = abs(l_k - l32) / abs(l32)
    p32 = abs(l_p - l32) / abs(l32)
    print(f"training routes: first-step loss kernel {l_k:.6f} plain "
          f"{l_p:.6f} (rel {loss_rel:.3e}; vs the fp32 loss {l32:.6f}: "
          f"kernel {k32:.3e}, plain {p32:.3e}); global gradient cosine, "
          f"kernel vs plain route in fp32 {cos:.7f}; vs the plain fp32 "
          f"gradient: kernel route bf16 {cos_k:.6f}, plain route bf16 "
          f"{cos_p:.6f}", flush=True)
    # bf16 rounds at other points on the two routes (the scan route runs
    # its affine updates and convs in bf16, the kernel in fp32), so each
    # bf16 route is held to the fp32 result, no worse than the plain route
    check(loss_rel <= 1e-3 or k32 <= p32, ("first-step loss", l_k, l_p,
                                           l32))
    check(cos >= 0.999, ("fp32 gradient cosine", cos))
    check(cos_k >= cos_p - 0.01, ("bf16 gradient cosine vs fp32", cos_k,
                                  cos_p))

    eval_step = make_eval_step(cfg)
    evals = {}
    saved = fwn.PAIR_KERNEL_FWD
    try:
        for route, on in (("fwd_kernel", True), ("plain", False)):
            fwn.PAIR_KERNEL_FWD = on
            eval_step(state0.params, batches[1])
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            aux = eval_step(state0.params, batches[1])
            loss = float(aux["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            counts = _counts(nonzero=False)
            n_fwd = sum((cfg.model.num_mels << bi) <= fwn.PAIR_KERNEL_FWD_MAX_CC
                        for bi in range(cfg.model.n_block)
                        ) * cfg.model.n_flow // 2
            check(counts["pair_fwd"] == (n_fwd if on else 0)
                  and counts["pair_train_fwd"] == 0,
                  (route, "eval launches", counts))
            evals[route] = {"loss": loss, "ms": ms,
                            "launches": counts["pair_fwd"]}
            print(f"eval {route}: loss {loss:.6f}, {ms:.1f} ms, pair_fwd "
                  f"launches {counts['pair_fwd']}", flush=True)
    finally:
        fwn.PAIR_KERNEL_FWD = saved
    with torch.no_grad():
        e32 = float(fwn.loss_fn(state0.params, cfg.model, batches[1]["audio"],
                                batches[1]["mel"])[0])
    e_k, e_p = evals["fwd_kernel"]["loss"], evals["plain"]["loss"]
    e_rel = abs(e_k - e_p) / abs(e_p)
    print(f"eval routes: rel {e_rel:.3e}; vs the fp32 loss {e32:.6f}: "
          f"fwd kernel {abs(e_k - e32) / abs(e32):.3e}, plain "
          f"{abs(e_p - e32) / abs(e32):.3e}", flush=True)
    check(e_rel <= 1e-3 or abs(e_k - e32) <= abs(e_p - e32),
          ("eval loss fwd kernel vs plain", e_k, e_p, e32))
    for r in out.values():
        del r["state"]
    return {"routes": out, "ddi_s": ddi_s, "loss_rel": loss_rel,
            "loss_rel_fp32": (k32, p32), "grad_cos": cos,
            "grad_cos_bf16": (cos_k, cos_p), "eval": evals, "eval_rel": e_rel,
            "n_route": n_route, "profile_split": split,
            "profile_split_synthesis_products": split_rows}


def _timed_steps(step_fn, state0, batches, patches: dict,
                 dev, steps: int = 2) -> dict:
    """Training steps from ``state0`` under each set of ``patches`` (name
    -> list), in turns: each in order, then in reverse order, each turn
    one warm-up and ``steps`` timed steps on batches 0, 1, ...; host clock
    around synchronized steps.  Returns per name the timed steps (ms),
    their median and the steps' peak memory above what was allocated
    before the turn (GB)."""
    import torch
    names = list(patches)
    times = {k: [] for k in names}
    peak = {k: 0.0 for k in names}
    for which in names + names[::-1]:
        with _patched(patches[which]):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            state = state0
            for i in range(steps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step_fn(state, batches[i % len(batches)])
                float(m["loss"])
                if i:
                    times[which].append((time.perf_counter() - t0) * 1e3)
            del state, m
            peak[which] = max(peak[which], (torch.cuda.max_memory_allocated(
                dev) - base) / 1e9)
    return {k: {"ms": times[k], "median_ms": float(np.median(times[k])),
                "step_peak_gb": peak[k]} for k in names}


def main_path(params, cfg, dev, frames):
    """Phase 3: synthesize_mels through the user-facing entry points, on
    every route of ``ROUTES`` and the plain route."""
    import torch
    from flowavenet_tpu_torch.checkpoint.bridge import save_params
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
            _reset_counts()
            t0 = time.perf_counter()
            wavs = synthesize_mels(loaded, c, mels, seed=SEED,
                                   compute_dtype=torch.bfloat16, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts(nonzero=False)
            check(counts == {**{k: 0 for k in counts}, **expect},
                  (name, counts))
            if i:
                walls.append(wall * 1e3)
        med = float(np.median(walls))
        print(f"{name} route: median {med:.1f} ms per reverse "
              f"(min {min(walls):.1f}, max {max(walls):.1f}, {REPS} calls), "
              f"{samples / med:.1f} kHz/s, launches {counts}", flush=True)
        return wavs, med, walls, counts

    on = cfg.model
    off = dataclasses.replace(cfg.model, use_pallas=False)
    out = {"routes": {}}
    routes = {}
    for name, _, expect in ROUTES:
        with _patched(_route_patches(name)):
            wavs_r, wall, walls, counts = run(name, on, expect)
        routes[name] = wavs_r
        out["routes"][name] = {"ms": wall, "walls_ms": walls,
                               "launches": {k: v for k, v in counts.items()
                                            if v}}
    wavs = routes["int8"]
    for i, (w, f) in enumerate(zip(wavs, frames)):
        check(w.shape == (f * hop,) and bool(np.all(np.isfinite(w))),
              f"row {i}: shape {w.shape} or non-finite values")
        z = np.random.RandomState(SEED + i).randn(pad * hop)[: f * hop]
        check(np.abs(w - z * cfg.train.temp).max() > 1e-2,
              f"row {i} equals its input noise")
    wavs_p, wall_p, walls_p, _ = run("plain", off, {})
    out["wall_ms_plain"], out["walls_ms_plain"] = wall_p, walls_p
    for name, ws in routes.items():
        _, rel, corr = _errors(np.concatenate(ws), np.concatenate(wavs_p))
        print(f"{name} route vs plain route: rel {rel:.4e} corr {corr:.6f}",
              flush=True)
        out["routes"][name].update(rel_to_plain=rel, corr_to_plain=corr)
        check(rel < 0.08 and corr > 0.998, (name, rel, corr))
    out["khz_per_s_i8"] = samples / out["routes"]["int8"]["ms"]
    out["loaded"] = loaded
    return out


def _path_patches(path: str) -> list:
    """Patches that run the coupling nets' products another way than the
    port does, to measure what its batch-invariant products change and
    cost.  ``library``: as the port ran them before (cuDNN ``F.conv1d``
    convs; the front convs' products, the compute-dtype conditioning 1x1s
    and the hoist matmul each one product over the whole batch).
    ``per-row``: every product of the nets one row at a time (each conv's
    tap GEMM and every 1x1).  ``batched``: the port's tap GEMMs with every
    product over the whole batch (none per row).  ``synthesis``: the
    nets' products scheduled as in reverse (``apply_wavenet(per_row=
    True)``) in either direction, to time that schedule in training."""
    import torch
    import torch.nn.functional as F
    from flowavenet_tpu_torch.models import modules
    from flowavenet_tpu_torch.ops import conv
    from flowavenet_tpu_torch.ops import pair_flow as pf

    gemm, one = conv.dilated_conv1d, conv.conv1x1
    if path == "per-row":
        def conv_(x, kernel, bias, dilation=1, causal=False, per_row=False):
            return gemm(x, kernel, bias, dilation, causal, per_row=True)

        def one_(x, kernel, bias, per_row=False):
            return one(x, kernel, bias, per_row=True)
        return [(conv, "dilated_conv1d", conv_),
                (modules, "dilated_conv1d", conv_),
                (modules, "conv1x1", one_)]
    if path == "batched":
        def one_(x, kernel, bias, per_row=False):
            return one(x, kernel, bias)
        return [(conv, "conv1x1", one_), (modules, "conv1x1", one_)]
    if path == "synthesis":
        from flowavenet_tpu_torch.models import flowavenet as fwn
        net = fwn.apply_wavenet

        def net_(*a, **k):
            return net(*a, **{**k, "per_row": True})
        return [(fwn, "apply_wavenet", net_)]

    def conv_(x, kernel, bias, dilation=1, causal=False, per_row=False):
        k = kernel.shape[0]
        left = dilation * (k - 1) if causal else dilation * (k - 1) // 2
        xt = F.pad(x.transpose(1, 2), (left, dilation * (k - 1) - left))
        out = F.conv1d(xt, kernel.to(x.dtype).permute(2, 1, 0),
                       dilation=dilation).transpose(1, 2)
        return out if bias is None else out + bias.to(x.dtype)

    def one_(x, kernel, bias, per_row=False):
        return one(x, kernel, bias)

    def hoist_(c, w_flow):
        out = torch.mm(c.reshape(-1, c.shape[-1]), w_flow.to(c.dtype),
                       out_dtype=torch.float32)
        return out.reshape(*c.shape[:-1], -1).to(c.dtype)
    return [(conv, "dilated_conv1d", conv_), (modules, "dilated_conv1d", conv_),
            (modules, "conv1x1", one_), (pf, "hoist_cond", hoist_)]


def _op_split(run, n: int) -> dict:
    """Every library product (cuDNN ``conv1d``, cuBLAS ``matmul``,
    ``_int_mm``, the hoist matmul ``hoist_cond``) of one call of ``run()``
    on an ``n``-row batch, run again on row 0 alone with the same inputs:
    per stage (``utils/profiling.py:BlockStages``), product and shape of
    its second operand (the weight), how many calls give row 0 other bits
    and the largest difference.  Products already run one row at a time
    are not counted."""
    import torch
    import torch.nn.functional as F
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.utils.profiling import BlockStages

    real = {"conv1d": (F, F.conv1d), "matmul": (torch, torch.matmul),
            "_int_mm": (torch, torch._int_mm),
            "hoist_cond": (pf, pf.hoist_cond)}
    seen, st = [], BlockStages()

    def spy(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            seen.append((name, st.stage, a, k, out))
            return out
        return call
    with st, _patched([(o, name, spy(name, fn))
                       for name, (o, fn) in real.items()]):
        run()
    out = {}
    for name, where, a, k, got in seen:
        fn = real[name][1]
        if name == "_int_mm":            # [n * T, K] rows, row 0's first
            rows = a[0].shape[0] // n
            alone = fn(a[0][:rows].contiguous(), a[1])
            got = got[:rows]
        elif a[0].dim() == 3 and a[0].shape[0] == n:
            alone = fn(a[0][:1], *a[1:], **k)
            got = got[:1]
        else:
            continue
        d = float((alone.float() - got.float()).abs().max())
        w = "x".join(str(x) for x in a[1].shape)
        e = out.setdefault(f"{where} {name} {w}", {"calls": 0, "differ": 0,
                                                    "max_abs": 0.0})
        e["calls"] += 1
        e["differ"] += d > 0
        e["max_abs"] = max(e["max_abs"], d)
    return out


def _op_line(ops: dict) -> str:
    return ", ".join(f"{k} {v['differ']}/{v['calls']} {v['max_abs']:.3e}"
                     for k, v in ops.items())


def batch_composition(loaded, cfg, dev):
    """Phase 3, a row beside its companions: a 345-frame mel synthesized
    alone and beside 1 and 3 shorter companions (one reverse, the same
    padded length and the same noise for row 0), launches checked as in
    ``ROUTES``.  On the int8, FWN_HOISTED=1 and plain routes the row must
    be bit-identical at B = 1, 2 and 4: an item's audio depends only on
    its mel, seed, temperature and padded length, the contract of the JAX
    package's ``synthesize_mels``.  Row 0 of the upsampler's and of every
    ``block_reverse``'s output is compared stage by stage
    (``BlockStages``) and the largest difference per stage is printed
    beside the audio's gap (max |difference| over max |audio|); at B = 4
    every library product is run again on row 0 alone (``_op_split``)
    and none may differ.  Every batch size launches
    ``pair_flow_hoisted_i8`` on the same tile (block 5's, the last launch,
    is checked: the tile is fixed by T and the widths).  Recorded, not
    held, to show what each batch-invariant product repairs: FWN_HOISTED=1
    with that pair on the wave-balanced tile of each batch
    (``pair_flow.hoisted_t_tile(B, ...)``, the rule before the tile was
    fixed), and the int8, FWN_INT8=0 and FWN_HOISTED=1 routes with the
    nets' products on the ``library`` path of ``_path_patches`` (cuDNN
    convs, batched conditioning and hoist products)."""
    import torch
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.synthesis.synthesize import synthesize_mels
    from flowavenet_tpu_torch.utils.profiling import BlockStages

    rng = np.random.RandomState(SEED + 3)
    mels = [rng.rand(f, cfg.audio.num_mels).astype(np.float32)
            for f in (345, 301, 262, 180)]
    lib = library("pair_flow")

    def batch_rule(B, T, r, r_in, variant, n_sm):
        return pf.hoisted_t_tile(B, T, n_sm, lambda tt: (
            lib.pair_reverse_smem_bytes(1, variant, 1, r, r_in, tt)))
    plain = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  use_pallas=False))
    expects = {r[0]: r[2] for r in ROUTES}
    expects["plain"] = {}
    out = {}
    for route, label, extra, held in (
            ("int8", "", [], True), ("FWN_HOISTED=1", "", [], True),
            ("plain", "", [], True),
            ("FWN_HOISTED=1", ", the batch's tile",
             [(pf, "_hoisted_tile", batch_rule)], False),
            ("int8", ", library products", _path_patches("library"), False),
            ("FWN_INT8=0", ", library products", _path_patches("library"),
             False),
            ("FWN_HOISTED=1", ", library products",
             _path_patches("library"), False)):
        expect, name = expects[route], route + label
        rows, stages, tiles = {}, {}, set()

        def synth(n, **kw):
            return synthesize_mels(loaded, plain if route == "plain" else cfg,
                                   mels[:n], seed=SEED,
                                   compute_dtype=torch.bfloat16, device=dev,
                                   **kw)
        with _patched(_route_patches(route) + extra):
            for n in (1, 2, 4):
                torch.cuda.synchronize()
                _reset_counts()
                with BlockStages(rows=True) as st:
                    rows[n] = synth(n)[0]
                stages[n] = st.rows
                check(_counts() == expect, (name, n, _counts()))
                if "pair_flow_hoisted_i8" in expect:
                    tiles.add(LAST_LAUNCH["pair_flow_hoisted_i8"][
                        "t_tile"])
            ops = _op_split(lambda: synth(4), 4)
        check(len(tiles) <= 1 or not held,
              (name, "hoisted_i8 tile follows the batch", tiles))
        res = {"hoisted_i8_tiles": sorted(tiles),
               "row 0 by product at B = 4": ops}
        for n in (2, 4):
            _, rel, _ = _errors(rows[n], rows[1])
            by_stage = _stage_gaps(stages[1], stages[n])
            same = bool(np.array_equal(rows[n], rows[1]))
            res[f"beside {n - 1}"] = rel
            res[f"beside {n - 1}, bit-identical"] = same
            res[f"beside {n - 1}, by stage"] = by_stage
            print(f"{name} route, a 345-frame row beside {n - 1} "
                  f"companion(s) vs alone: gap {rel:.3e}, bit-identical "
                  f"{same}; row 0's max |difference| by stage: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in by_stage.items())
                  + (f"; pair_flow_hoisted_i8 tiles {sorted(tiles)} at B ="
                     f" 1, 2, 4" if tiles else ""), flush=True)
            check(not held or same, (name, n, "row follows its companions",
                                     rel, by_stage))
        print(f"{name} route, row 0's library products at B = 4 (calls "
              f"that differ from row 0 alone / calls, max |d|): "
              f"{_op_line(ops)}", flush=True)
        check(not held or not any(v["differ"] for v in ops.values()),
              (name, "a product follows the batch", ops))
        out[name] = res
    return out


def _timed_reverse(loaded, cfg, dev, B: int, frames: int, patches: dict,
                   calls: int = 2) -> dict:
    """``reverse`` of a B x frames batch (noise and mels of seed SEED on the
    card) under each set of ``patches`` (name -> list), in turns: each in
    order, then in reverse order, each turn one warm-up and ``calls``
    timed calls; host clock around synchronized calls.  Returns per name
    the timed calls (ms), their median and the peak memory (GB)."""
    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn

    g = torch.Generator(dev).manual_seed(SEED)
    z = torch.randn(B, frames * cfg.audio.hop_size, 1, generator=g,
                    device=dev) * cfg.train.temp
    c = torch.rand(B, frames, cfg.audio.num_mels, generator=g, device=dev)
    names = list(patches)
    times = {k: [] for k in names}
    peak = {k: 0.0 for k in names}
    for which in names + names[::-1]:
        with _patched(patches[which]):
            torch.cuda.reset_peak_memory_stats(dev)
            for i in range(calls + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fwn.reverse(loaded, cfg.model, z, c,
                            compute_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                if i:
                    times[which].append((time.perf_counter() - t0) * 1e3)
            peak[which] = max(peak[which],
                              torch.cuda.max_memory_allocated(dev) / 1e9)
    return {k: {"ms": times[k], "median_ms": float(np.median(times[k])),
                "max_mem_gb": peak[k]} for k in names}


def repair_cost(loaded, cfg, dev) -> dict:
    """Phase 3, the time of batch-invariant synthesis: ``reverse`` on the
    int8, FWN_INT8=0 and FWN_HOISTED=1 routes at the phase-3 batch (4 x
    360 frames) and at the bench's default batch of 7 s clips (600
    frames), the nets' products as the port runs them beside the
    ``library`` path of ``_path_patches`` (synthesis before it was made
    batch-invariant) and, on the int8 route, the ``per-row`` path (every
    product one row at a time), in turns (``_timed_reverse``; one timed
    call a turn at the bench's batch, which only the int8 route, the
    bench's, runs)."""
    from flowavenet_tpu_torch import bench

    out = {}
    for route in ("int8", "FWN_INT8=0", "FWN_HOISTED=1"):
        sizes = [(4, 360)] + ([(bench.DEFAULT_BATCH, 600)]
                              if route == "int8" else [])
        for B, frames in sizes:
            paths = {"batch-invariant": [],
                     "library": _path_patches("library")}
            if route == "int8":
                paths["per-row"] = _path_patches("per-row")
            with _patched(_route_patches(route)):
                r = _timed_reverse(loaded, cfg, dev, B, frames, paths,
                                   calls=2 if B < 32 else 1)
            key = f"{route}, {B} x {frames} frames"
            out[key] = r
            print(f"{route} route reverse, {B} x {frames} frames: " + "; ".join(
                f"{k} median {v['median_ms']:.1f} ms (calls "
                f"{', '.join(f'{t:.1f}' for t in v['ms'])}; peak "
                f"{v['max_mem_gb']:.2f} GB)" for k, v in r.items()),
                flush=True)
    return out


INVARIANCE_FRAMES = (60, 120, 360)  # padded lengths of route_invariance
INVARIANCE_BATCHES = (2, 4, 8, 16, 32)
INVARIANCE_ALONE = 4                # rows synthesized alone per length


def route_invariance(loaded, cfg, dev) -> dict:
    """Phase 3, every route at short and long padded lengths and at the
    server's dispatch sizes: at 60, 120 and 360 frames, 32 mels (T, T - 1,
    ... frames) and the first ``INVARIANCE_ALONE`` each synthesized alone
    at that padded length (seed SEED + i), then the first 2, 4, 8, 16 and
    32 together.  On every route of ``ROUTES`` and the plain route
    (use_pallas=False) the first ``INVARIANCE_ALONE`` rows of every batch
    must be bit-identical to themselves alone, and rows 8-15 of the
    32-row batch to themselves in the 16-row batch.  Recorded, not held,
    to show why synthesis runs the front convs, the conditioning products
    and the hoist matmul one row at a time: the plain route on the
    ``batched`` path of ``_path_patches`` (the first two over the whole
    batch) and FWN_HOISTED=1 on the ``library`` path (the hoist matmul
    too).  Prints per route the (length, batch) cells in which a row
    differs and the largest gap (max |difference| over max |audio|); for
    the first such cell, the library products of that batch that differ
    on row 0 (``_op_split``)."""
    import torch
    from flowavenet_tpu_torch.synthesis.synthesize import synthesize_mels

    rng = np.random.RandomState(SEED + 4)
    plain = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  use_pallas=False))
    nb = max(INVARIANCE_BATCHES)
    out = {}
    for route, path in ([(r[0], None) for r in ROUTES] + [("plain", None),
                         ("plain", "batched"), ("FWN_HOISTED=1", "library")]):
        c = plain if route == "plain" else cfg
        extra = _path_patches(path) if path else []
        name = route + (f", {path} products" if path else "")
        cells, worst, ops = [], 0.0, None

        def synth(ms, seed, T):
            return synthesize_mels(loaded, c, ms, seed=seed, bucket_frames=T,
                                   compute_dtype=torch.bfloat16, device=dev)
        with _patched(_route_patches(route) + extra):
            for T in INVARIANCE_FRAMES:
                mels = [rng.rand(T - i, cfg.audio.num_mels).astype(
                    np.float32) for i in range(nb)]
                want = {i: synth([m], SEED + i, T)[0]
                        for i, m in enumerate(mels[:INVARIANCE_ALONE])}
                rows = {}
                for B in INVARIANCE_BATCHES:
                    rows[B] = synth(mels[:B], SEED, T)
                    pairs = [(i, want[i]) for i in range(min(B,
                                                             INVARIANCE_ALONE))]
                    if B == nb:
                        pairs += [(i, rows[nb // 2][i]) for i in
                                  range(INVARIANCE_ALONE, nb // 2)]
                    bad = [i for i, w in pairs
                           if not np.array_equal(rows[B][i], w)]
                    for i, w in pairs:
                        if i in bad:
                            worst = max(worst, _errors(rows[B][i], w)[1])
                    cells += [(T, B, i) for i in bad]
                    if bad and ops is None:
                        ops = {"frames": T, "batch": B, "products": _op_split(
                            lambda: synth(mels[:B], SEED, T), B)}
        out[name] = {"rows_that_differ": cells, "max_gap": worst,
                     "first_cell_products": ops}
        print(f"{name} route, rows beside 1-31 companions (batches "
              f"{INVARIANCE_BATCHES}) vs alone at {INVARIANCE_FRAMES} padded "
              f"frames: "
              + (f"{len(cells)} rows differ, max gap {worst:.3e}, (frames, "
                 f"batch, row) {cells[:6]}" if cells else "all bit-identical"),
              flush=True)
        if ops:
            print(f"{name} route, row 0's library products at {ops['frames']} "
                  f"frames, B = {ops['batch']} (calls that differ from row 0 "
                  f"alone / calls, max |d|): {_op_line(ops['products'])}",
                  flush=True)
        check(path or not cells, (name, "rows follow their companions",
                                  cells[:6], worst))
    return out


ODD_FRAMES = (120, 97)               # two mels per odd-width reverse
# Models whose widths the pair kernels take only padded: an odd num_mels
# (Cc = 79 * 2^b, the per-level route) and a filter_size that divides
# neither 512 nor 32 (R = 48 runs as 64)
ODD_MODELS = {"num_mels=79": dict(num_mels=79),
              "filter_size=48": dict(filter_size=48)}


# The routes of ``ROUTES`` whose kernels run padded at those widths
_ODD = ("int8", "FWN_INT8=0", "FWN_INT8=0 FWN_WINO4=1", "FWN_INT8_RS=1")
ODD_ROUTES = {"num_mels=79": _ODD,
              "filter_size=48": _ODD + ("FWN_INT8=0 FWN_HOISTED=1",
                                        "FWN_HOISTED=1")}


def odd_width_phase(dev):
    """Phase 3b: lj22k at full depth with num_mels 79 or filter_size 48,
    bf16 synthesize_mels of two mels on the kernel routes of ``ROUTES``
    whose kernels run padded there (``ODD_ROUTES``; launch counts checked
    exactly, as for lj22k) against the plain route of the same params, at
    the bar of phase 3 (rel < 0.08, corr > 0.998)."""
    import torch
    from flowavenet_tpu_torch.config import lj22k
    from flowavenet_tpu_torch.synthesis.synthesize import synthesize_mels
    from flowavenet_tpu_torch.utils.tree import tree_map

    out = {}
    for i, (mname, kw) in enumerate(ODD_MODELS.items()):
        base = lj22k()
        cfg = base.replace(
            model=dataclasses.replace(base.model, **kw),
            audio=dataclasses.replace(
                base.audio, num_mels=kw.get("num_mels",
                                            base.audio.num_mels)))
        params = tree_map(lambda l: l.to(dev),
                          randomized_params(cfg, SEED + 10 + i))
        rng = np.random.RandomState(SEED + i)
        mels = [rng.rand(f, cfg.audio.num_mels).astype(np.float32)
                for f in ODD_FRAMES]

        def synth(model_cfg):
            return np.concatenate(synthesize_mels(
                params, cfg.replace(model=model_cfg), mels, seed=SEED,
                compute_dtype=torch.bfloat16, device=dev))
        want = synth(dataclasses.replace(cfg.model, use_pallas=False))
        for name, _, expect in (r for r in ROUTES
                                if r[0] in ODD_ROUTES[mname]):
            with _patched(_route_patches(name)):
                torch.cuda.synchronize()
                _reset_counts()
                got = synth(cfg.model)
                torch.cuda.synchronize()
                counts = _counts()
            check(counts == expect, (mname, name, "launches", counts))
            _, rel, corr = _errors(got, want)
            print(f"{mname} {name} route vs plain route: rel {rel:.4e} "
                  f"corr {corr:.6f}, launches {counts}", flush=True)
            check(rel < 0.08 and corr > 0.998, (mname, name, rel, corr))
            out[f"{mname} {name}"] = (rel, corr)
        out[f"{mname} training pairs"] = odd_width_train_pair(
            mname, params, cfg, dev)
        if "filter_size" in kw:
            out[f"{mname} hoisted Winograd pairs"] = odd_width_wino_hoisted(
                mname, params, cfg, dev)
    return out


def odd_width_wino_hoisted(mname: str, params, cfg, dev, tk: int = 1500):
    """Phase 3b's hoisted Winograd pairs: ``pair_flow_wino_hoisted`` and
    ``pair_flow_wino4_hoisted`` in bf16 on block 0's first pair of the
    filter_size 48 model (R run as 64, its hoisted c as 4 * 64 = 256), with
    0.05-scale zero-conv weights as in phase 2b, two rows of ``tk``
    frames, one launch each, vs ``pair_reverse_wino_ref(hoisted=True)`` at
    phase 2b's bf16 bars (rel <= 1e-2, corr >= 0.999, update_err <=
    1e-2).  Returns the worst (rel, corr)."""
    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.utils.tree import tree_map

    pair = tree_map(lambda l: l.clone(),
                    fwn._index(fwn._pair_params(params["blocks"][0]), 0))
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    zero = pair["coupling"]["zero"]
    zero["w"] = 0.05 * torch.randn(zero["w"].shape, generator=g, device=dev)
    dt, R = torch.bfloat16, cfg.model.filter_size
    u, v = (torch.randn(2, tk, 1, generator=g, device=dev).to(dt)
            for _ in range(2))
    ca, cb = (torch.rand(2, tk, cfg.model.num_mels, generator=g,
                         device=dev).to(dt) for _ in range(2))
    rk, cck = pf.kernel_widths(R, 4 * R, True, hoisted=True)
    worst = (0.0, 1.0)
    for name, P in (("pair_flow_wino_hoisted", 6),
                    ("pair_flow_wino4_hoisted", 12)):
        ops, (we, wo) = pf.pop_cond_w(
            pf.pair_reverse_operands_wino(pair, dt) if P == 6
            else pf.pair_reverse_operands_wino4(pair, dt))
        c = (pf.hoist_cond(ca, we), pf.hoist_cond(cb, wo))
        torch.cuda.synchronize()
        _reset_counts()
        got = pf.fused_pair_reverse_wino(u, v, *c, ops, hoisted=True)
        torch.cuda.synchronize()
        counts = _counts()
        check(counts == {name: 1}, (mname, name, "launches", counts))
        want = pf.pair_reverse_wino_ref(u, v, *c, ops, t_tile=160 * P,
                                        hoisted=True)
        passthru = pf.pair_reverse_wino_ref(
            u, v, *c, tuple(torch.zeros_like(o) if i in (10, 11) else o
                            for i, o in enumerate(ops)),
            t_tile=160 * P, hoisted=True)
        errs = [_errors(a, b) for a, b in zip(got, want)]
        rel, corr = max(e[1] for e in errs), min(e[2] for e in errs)
        upd = _update_err(got, want, passthru)
        print(f"{mname} {name} block 0 bf16 T_k={tk} R={R} (run as {rk}) "
              f"c={4 * R} (run as {cck}) vs plain: rel={rel:.3e} "
              f"corr={corr:.7f} update_err={upd:.3e}", flush=True)
        check(rel <= 1e-2 and corr >= 0.999 and upd <= 1e-2,
              (mname, name, rel, corr, upd))
        worst = (max(worst[0], rel), min(worst[1], corr))
    return worst


def odd_width_train_pair(mname: str, params, cfg, dev):
    """Phase 3b's training side: ``pair_fwd``, ``pair_train_fwd`` and
    ``pair_train_bwd`` in bf16 on block 0's first pair of an odd-width
    model (the FWN_TRAIN_KERNEL=1 and FWN_FWD_KERNEL=1 routes' block; Cc 79
    or R 48, zero-padded to 80 or 64 for the tensor cores), two rows of
    the training geometry's T_k, one launch each, vs their plain versions
    at phase 4's bf16 bars.  Returns (outputs rel, worst leaf gradient
    cosine)."""
    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    from flowavenet_tpu_torch.utils.tree import tree_map

    pair = tree_map(lambda l: l.clone(),
                    fwn._index(fwn._pair_params(params["blocks"][0]), 0))
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    for leaf in (pair["coupling"]["zero"]["w"], pair["actnorm"]["b"],
                 pair["actnorm"]["logs"]):
        leaf.add_(0.05 * torch.randn(leaf.shape, generator=g, device=dev))
    ops = pf.pair_forward_operands(pair, torch.bfloat16)
    tk = cfg.data.max_time_steps >> 1
    u, v, gu, gv = (torch.randn(2, tk, 1, generator=g, device=dev)
                    .bfloat16() for _ in range(4))
    ca, cb = (torch.rand(2, tk, cfg.model.num_mels, generator=g, device=dev)
              .bfloat16() for _ in range(2))
    scal = [torch.tensor(x, device=dev) for x in (0.7, 0.11, 1.3)]
    want = pft.pair_train_fwd_ref(u, v, ca, cb, ops)
    torch.cuda.synchronize()
    _reset_counts()
    got = pft.fused_pair_train_fwd(u, v, ca, cb, ops)
    fwd = pft.fused_pair_forward(u, v, ca, cb, ops)
    d = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal, ops)
    torch.cuda.synchronize()
    counts = _counts()
    check(counts == {k: 1 for k in pft.TRAIN_KERNELS},
          (mname, "training pair launches", counts))
    # pair_fwd's plain version is pair_train_fwd_ref without the last
    # three statistics: its (u3, v3, raw) are want[:3]
    errs = [_errors(a, b) for a, b in
            list(zip(got[:2], want[:2])) + list(zip(fwd[:2], want[:2]))]
    rel, corr = max(e[1] for e in errs), min(e[2] for e in errs)
    st_rel = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)
                 for a, b in list(zip(got[2:], want[2:]))
                 + [(fwd[2], want[2])])
    dref = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, *scal, ops)
    g_cos = 1.0
    for a, b in zip(list(d[0]) + list(d[1:]), list(dref[0]) + list(dref[1:])):
        check(a.shape == b.shape and bool(torch.isfinite(a.float()).all()),
              (mname, "training pair gradient", a.shape, b.shape))
        if float(b.float().abs().max()) > 0:
            g_cos = min(g_cos, _cos(a.double(), b.double()))
    print(f"{mname} forward and training pairs bf16 T_k={tk} "
          f"Cc={cfg.model.num_mels} "
          f"R={cfg.model.filter_size} vs plain: out rel={rel:.3e} "
          f"corr={corr:.7f} stats rel={st_rel:.3e} grad cos={g_cos:.8f}",
          flush=True)
    check(rel <= 1e-2 and corr >= 0.999 and st_rel <= 1e-2
          and g_cos >= 0.999, (mname, "training pairs", rel, corr, st_rel,
                               g_cos))
    return rel, g_cos


SERVE_FRAMES = (180, 205, 231, 262, 289, 301, 322, 345)   # 8 requests
SERVE_ROUNDS = 8                    # timed rounds of SERVE_FRAMES
STREAM_FRAMES = 800
STREAM_REQS = 5                     # timed /synthesize_stream requests


def _post(port: int, path: str, mel, seed: int, speaker=None):
    """POST one mel as .npy (with X-Speaker-Id when ``speaker`` is given);
    returns (status, headers, body, seconds to the first body byte, total
    seconds)."""
    import io
    from http.client import HTTPConnection
    buf = io.BytesIO()
    np.save(buf, mel)
    body = buf.getvalue()
    t0 = time.perf_counter()
    c = HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Length": str(len(body)), "X-Seed": str(seed)}
    if speaker is not None:
        headers["X-Speaker-Id"] = str(speaker)
    c.request("POST", path, body=body, headers=headers)
    r = c.getresponse()
    head = r.read(45)                 # the WAV header and one more byte
    t_first = time.perf_counter() - t0
    rest = r.read()
    return (r.status, dict(r.getheaders()), head + rest, t_first,
            time.perf_counter() - t0)


def _post_all(port: int, reqs):
    """POST (mel, seed[, speaker]) tuples concurrently to /synthesize."""
    import threading
    out = [None] * len(reqs)

    def go(i, *req):
        out[i] = _post(port, "/synthesize", *req)

    ts = [threading.Thread(target=go, args=(i, *r))
          for i, r in enumerate(reqs)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    check(all(o is not None and o[0] == 200 for o in out),
          ("serving status", [o and o[0] for o in out]))
    return out, wall


def _pcm(wav_bytes) -> np.ndarray:
    return np.frombuffer(wav_bytes[44:], "<i2")


def serving_phase(loaded, cfg, dev):
    """Phase 6: the HTTP service on the card, lj22k, bf16, the FWN_INT8=0
    route (Winograd blocks 0-2, direct block 3, plain blocks 4-7), device
    noise and pcm16 (the service's defaults).  Server A (the defaults,
    max_batch 16, 10 ms window): a warm-up round, then SERVE_ROUNDS rounds,
    one after another, of 8 concurrent /synthesize requests of 180-345
    frames with distinct X-Seed (lengths checked; requests/s over all
    rounds and per round, p50/p90 latency over every request; the 8 fall
    into 4 length buckets that dispatch one after another, so a latency
    includes the wait for the buckets ahead of it) and STREAM_REQS
    /synthesize_stream requests of 800 frames, one after another (time to
    the first audio byte, median and range; the first held against the
    one-shot audio of the same host noise).  Server B (max_batch 4, a 5 s
    window, so 4 requests posted together land in one drain, checked with
    /stats): 4
    requests of one bucket (301-345 frames, padded to 360), then the first
    again beside 3 other companions of that bucket: its bytes must be
    identical.  Then synthesize_time_parallel, rows_per_pass 8: with host
    noise against stream_reverse of the same mel, with device noise (and
    pcm16) against a one-shot reverse of the same positional noise."""
    import json as _json
    import threading
    import urllib.request

    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow as pf
    from flowavenet_tpu_torch.serving.server import serve
    from flowavenet_tpu_torch.synthesis import streaming
    from flowavenet_tpu_torch.synthesis.noise import frame_noise
    from flowavenet_tpu_torch.synthesis.synthesize import (pcm16_quantize,
                                                           synthesize_mels)

    hop, rate = cfg.audio.hop_size, cfg.audio.sample_rate
    rng = np.random.RandomState(SEED + 1)

    def mel(frames):
        return rng.rand(frames, cfg.audio.num_mels).astype(np.float32)

    def start(**kw):
        httpd = serve(loaded, cfg, port=0, device=dev, **kw)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, httpd.server_address[1]

    def stats(port):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats") as r:
            return _json.loads(r.read())

    out = {}
    saved = fwn.PAIR_KERNEL_INT8
    fwn.PAIR_KERNEL_INT8 = False
    httpd_a = httpd_b = None
    torch.cuda.synchronize()
    _reset_counts()
    try:
        httpd_a, port = start()
        reqs = [(mel(f), 1000 + i) for i, f in enumerate(SERVE_FRAMES)]
        _post_all(port, reqs)                       # warm-up round
        lat, walls = [], []
        for rnd in range(SERVE_ROUNDS):
            res, wall = _post_all(port, [(m, s_ + 100 * (rnd + 1))
                                         for m, s_ in reqs])
            for (m, _), r in zip(reqs, res):
                check(len(_pcm(r[2])) == m.shape[0] * hop
                      and int(r[1]["Content-Length"]) == len(r[2]),
                      ("served length", m.shape, len(r[2])))
            lat += [r[4] * 1e3 for r in res]
            walls.append(wall)
        lat.sort()
        rps = [len(reqs) / w for w in walls]
        out["serve_rounds"] = SERVE_ROUNDS
        out["serve_requests"] = len(lat)
        out["serve_requests_per_s"] = len(lat) / sum(walls)
        out["serve_requests_per_s_by_round"] = rps
        out["serve_audio_s_per_s"] = (SERVE_ROUNDS * sum(SERVE_FRAMES) * hop
                                      / rate / sum(walls))
        out["serve_p50_ms"] = float(np.percentile(lat, 50))
        out["serve_p90_ms"] = float(np.percentile(lat, 90))
        out["serve_latency_min_max_ms"] = [lat[0], lat[-1]]
        s_mel = mel(STREAM_FRAMES)
        firsts, totals, streamed = [], [], None
        for k in range(STREAM_REQS):
            st = _post(port, "/synthesize_stream", s_mel, 7 + k)
            check(st[0] == 200 and int(st[1]["Content-Length"]) == len(st[2])
                  and len(_pcm(st[2])) == STREAM_FRAMES * hop,
                  ("stream", st[0], len(st[2])))
            firsts.append(st[3] * 1e3)
            totals.append(st[4] * 1e3)
            streamed = streamed if streamed is not None else st[2]
        out["stream_requests"] = STREAM_REQS
        out["stream_first_byte_ms"] = float(np.median(firsts))
        out["stream_first_byte_min_max_ms"] = [min(firsts), max(firsts)]
        out["stream_first_byte_ms_each"] = firsts
        out["stream_total_ms"] = float(np.median(totals))
        out["stream_total_min_max_ms"] = [min(totals), max(totals)]
        a_stats = stats(port)
        one = synthesize_mels(loaded, cfg, [s_mel], seed=7, bucket_frames=1,
                              device=dev)[0]
        one16 = np.clip(np.rint(one * 32768.0), -32768, 32767)
        _, rel, corr = _errors(_pcm(streamed).astype(np.float32),
                               one16.astype(np.float32))
        out["stream_vs_one_shot"] = {"rel": rel, "corr": corr}
        print(f"serving, {SERVE_ROUNDS} rounds of {len(reqs)} concurrent "
              f"requests: {out['serve_requests_per_s']:.2f} requests/s "
              f"(rounds {min(rps):.2f}-{max(rps):.2f}), "
              f"{out['serve_audio_s_per_s']:.2f} s of audio per s; latency "
              f"over {len(lat)} requests p50 {out['serve_p50_ms']:.1f} ms, "
              f"p90 {out['serve_p90_ms']:.1f} ms (min {lat[0]:.1f}, max "
              f"{lat[-1]:.1f}); {STREAM_REQS} streams of {STREAM_FRAMES} "
              f"frames: first byte median {out['stream_first_byte_ms']:.1f}"
              f" ms (min {min(firsts):.1f}, max {max(firsts):.1f}), all "
              f"median {out['stream_total_ms']:.1f} ms; streamed vs one-shot"
              f" rel {rel:.4e} corr {corr:.6f}; stats {a_stats}", flush=True)
        check(rel < 0.08 and corr > 0.998, ("stream vs one-shot", rel, corr))

        httpd_b, port_b = start(max_batch=4, batch_window_ms=5000.0)
        same = [(mel(f), 2000 + i) for i, f in enumerate((301, 322, 345, 340))]
        first, _ = _post_all(port_b, same)
        s1 = stats(port_b)
        others = [same[0]] + [(mel(f), 3000 + i)
                              for i, f in enumerate((310, 333, 303))]
        second, _ = _post_all(port_b, others)
        s2 = stats(port_b)
        check(s1["dispatches"] == 1 and s1["max_dispatch_rows_seen"] == 4
              and s2["dispatches"] == 2, ("one drain per 4", s1, s2))
        check(first[0][2] == second[0][2],
              "re-served request differs in its pow2 batch and bucket")
        out["composition_identical"] = True
        print(f"serving: batch composition: 4 + 4 requests in 2 dispatches "
              f"of 4 rows, the re-served request bit-identical", flush=True)

        tp_mel = mel(STREAM_FRAMES)
        t0 = time.perf_counter()
        tpar = streaming.synthesize_time_parallel(
            loaded, cfg, tp_mel, seed=9, rows_per_pass=8, device=dev)
        torch.cuda.synchronize()
        t_tp = time.perf_counter() - t0
        ser = streaming.synthesize_streaming(loaded, cfg, tp_mel, seed=9,
                                             device=dev)
        _, rel_h, corr_h = _errors(tpar, ser)
        t0 = time.perf_counter()
        tdev = streaming.synthesize_time_parallel(
            loaded, cfg, tp_mel, seed=9, rows_per_pass=8, noise="device",
            pcm16=True, device=dev)
        t_tpd = time.perf_counter() - t0
        with torch.no_grad():
            z = frame_noise(9, [0], [cfg.train.temp], STREAM_FRAMES, hop,
                            device=dev)
            c = torch.from_numpy(tp_mel)[None].to(dev, torch.bfloat16)
            ref = pcm16_quantize(fwn.reverse(
                loaded, cfg.model, z.to(torch.bfloat16), c,
                compute_dtype=torch.bfloat16))[0, :, 0].cpu().numpy()
        _, rel_d, corr_d = _errors(tdev.astype(np.float32),
                                   ref.astype(np.float32))
        out["time_parallel"] = {"ms_host_noise": t_tp * 1e3,
                                "ms_device_noise_pcm16": t_tpd * 1e3,
                                "vs_stream": {"rel": rel_h, "corr": corr_h},
                                "device_noise_vs_one_shot": {
                                    "rel": rel_d, "corr": corr_d}}
        print(f"time-parallel ({STREAM_FRAMES} frames, 8 rows per pass): "
              f"host noise {t_tp * 1e3:.1f} ms, vs stream rel {rel_h:.4e} "
              f"corr {corr_h:.6f}; device noise + pcm16 {t_tpd * 1e3:.1f} "
              f"ms, vs one-shot of the same noise rel {rel_d:.4e} corr "
              f"{corr_d:.6f}", flush=True)
        check(tdev.dtype == np.int16 and tdev.shape == ref.shape,
              ("time-parallel pcm16", tdev.dtype, tdev.shape))
        check(rel_h < 0.08 and corr_h > 0.998, ("tp vs stream", rel_h,
                                                corr_h))
        check(rel_d < 0.08 and corr_d > 0.998, ("tp device noise", rel_d,
                                                corr_d))
        torch.cuda.synchronize()
        out["serve_launches"] = _counts()
        print(f"serving phase launches: {out['serve_launches']}", flush=True)
        check(out["serve_launches"].get("pair_flow_wino", 0) > 0
              and out["serve_launches"].get("pair_flow", 0) > 0
              and set(out["serve_launches"]) == {"pair_flow_wino",
                                                 "pair_flow"},
              ("serving launches", out["serve_launches"]))
    finally:
        fwn.PAIR_KERNEL_INT8 = saved
        for h in (httpd_a, httpd_b):
            if h is not None:
                h.shutdown()
                h.service.close()
    return out


GIN_FRAMES = (180, 262, 301, 345)   # ~2.2-4.1 s of 8 kHz audio
GIN_STEPS = 6                       # lj8k_gin training steps


def gin_phase(dev, tmpdir: str):
    """Phase 7: lj8k_gin at full width (5 blocks x 6 flows, R = 256, gin
    256, 7 speakers), global conditioning through the entry points; a gin
    model takes the plain scans everywhere, as in the JAX package (no
    kernel launches, checked).  Seeded random weights through a JAX-layout
    npz and ``load_params`` (bf16); ``synthesize_mels`` of 4 mels with
    speakers 0-3, REPS calls after a warm-up (median and range); one mel
    under speakers 0 and 5 must differ, and be identical under
    parity_drop_global_cond; the HTTP service with X-Speaker-Id (4
    concurrent requests, two ids on one mel that must differ, one stream);
    DDI and GIN_STEPS training steps at batch 8 x 2320 samples on a seeded
    7-speaker corpus (step time after WARMUP_STEPS, peak memory)."""
    import threading

    import torch
    from flowavenet_tpu_torch.checkpoint.bridge import save_params
    from flowavenet_tpu_torch.config import lj8k_gin
    from flowavenet_tpu_torch.data.dataset import CropDataset
    from flowavenet_tpu_torch.serving.server import serve
    from flowavenet_tpu_torch.synthesis.synthesize import (load_params,
                                                           synthesize_mels)
    from flowavenet_tpu_torch.training.train import to_device
    from flowavenet_tpu_torch.training.train_state import (
        create_state, ddi_initialize, make_train_step)

    cfg = lj8k_gin()
    hop = cfg.audio.hop_size
    ckdir = os.path.join(tmpdir, "gin_ckpt")
    save_params(os.path.join(ckdir, "ckpt-0.npz"),
                randomized_params(cfg, SEED + 2))
    loaded, _ = load_params(ckdir, cfg, compute_dtype=torch.bfloat16,
                            device=dev)
    rng = np.random.RandomState(SEED + 3)
    mels = [rng.rand(f, cfg.audio.num_mels).astype(np.float32)
            for f in GIN_FRAMES]
    out, walls = {}, []
    for i in range(REPS + 1):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        wavs = synthesize_mels(loaded, cfg, mels, seed=SEED,
                               speaker_ids=[0, 1, 2, 3],
                               compute_dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - t0) * 1e3)
        check(_counts() == {}, ("gin synthesis launched", _counts()))
    for w, f in zip(wavs, GIN_FRAMES):
        check(w.shape == (f * hop,) and bool(np.all(np.isfinite(w))),
              ("gin synthesis output", w.shape))
    out["synthesis_ms"] = float(np.median(walls))
    out["synthesis_calls_ms"] = walls
    one = {}
    for drop in (False, True):
        c = cfg.replace(model=dataclasses.replace(
            cfg.model, parity_drop_global_cond=drop))
        one[drop] = [synthesize_mels(loaded, c, mels[:1], seed=SEED,
                                     speaker_ids=[s_],
                                     compute_dtype=torch.bfloat16,
                                     device=dev)[0] for s_ in (0, 5)]
    diff = float(np.abs(one[False][0] - one[False][1]).max())
    check(diff > 1e-3, ("speakers 0 and 5 give the same audio", diff))
    check(np.array_equal(*one[True]),
          "parity_drop_global_cond audio depends on the speaker")
    print(f"lj8k_gin synthesis (4 mels of {GIN_FRAMES} frames, speakers "
          f"0-3, bf16): median {out['synthesis_ms']:.1f} ms (min "
          f"{min(walls):.1f}, max {max(walls):.1f}, {REPS} calls); speakers "
          f"0 vs 5 max |diff| {diff:.4f}; identical under "
          f"parity_drop_global_cond", flush=True)

    httpd = serve(loaded, cfg, port=0, device=dev)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        _post_all(port, [(mels[0], 1, 0)])              # warm-up
        res, wall = _post_all(port, [(m, 10 + i, i)
                                     for i, m in enumerate(mels)])
        for m, r in zip(mels, res):
            check(len(_pcm(r[2])) == m.shape[0] * hop, ("gin served length",
                                                        len(r[2])))
        a, b = (_post(port, "/synthesize", mels[1], 3, sid)[2]
                for sid in (1, 2))
        check(a != b, "X-Speaker-Id did not change the served audio")
        st = _post(port, "/synthesize_stream", mels[3], 4, 6)
        check(st[0] == 200 and len(_pcm(st[2])) == mels[3].shape[0] * hop,
              ("gin stream", st[0], len(st[2])))
    finally:
        httpd.shutdown()
        httpd.service.close()
    out["serve_4_requests_ms"] = wall * 1e3
    out["stream_first_byte_ms"] = st[3] * 1e3
    out["stream_total_ms"] = st[4] * 1e3
    print(f"lj8k_gin serving: 4 concurrent requests with X-Speaker-Id 0-3 in "
          f"{wall * 1e3:.1f} ms; ids 1 and 2 differ; stream of "
          f"{GIN_FRAMES[3]} frames first byte {st[3] * 1e3:.1f} ms, all "
          f"{st[4] * 1e3:.1f} ms", flush=True)

    cdir = os.path.join(tmpdir, "gin_corpus")
    os.makedirs(cdir)
    _write_corpus(cdir, cfg, speakers=cfg.model.n_speakers)
    ds = CropDataset(os.path.join(cdir, "train.fwrec"), hop_size=hop,
                     max_time_steps=cfg.data.max_time_steps,
                     batch_size=cfg.data.batch_size, seed=cfg.train.seed,
                     with_speaker=True)
    batches = [to_device(ds.batch_at(s_), dev) for s_ in range(GIN_STEPS)]
    check(len(set(batches[0]["speaker"].tolist())) > 1, "one speaker only")
    t0 = time.perf_counter()
    state = create_state(torch.Generator(dev).manual_seed(SEED), cfg)
    state = ddi_initialize(state, cfg, batches[0])
    torch.cuda.synchronize()
    out["ddi_s"] = time.perf_counter() - t0
    step_fn = make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    swalls, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        swalls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        check(_counts() == {}, ("gin training launched", _counts()))
    check(all(np.isfinite(losses)), ("gin losses", losses))
    timed = swalls[WARMUP_STEPS:]
    out["train_step_ms"] = float(np.median(timed))
    out["train_steps_ms"] = swalls
    out["train_max_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["train_losses"] = losses
    print(f"lj8k_gin training, batch {cfg.data.batch_size} x "
          f"{cfg.data.max_time_steps}: DDI {out['ddi_s']:.2f} s; median "
          f"{out['train_step_ms']:.1f} ms/step (min {min(timed):.1f}, max "
          f"{max(timed):.1f}, {len(timed)} steps after {WARMUP_STEPS} "
          f"warm-up), max memory {out['train_max_mem_gb']:.2f} GB, losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}", flush=True)
    return out


def _stage_gaps(rows_a, rows_b) -> dict:
    """Max |difference| of row 0 between two runs, per stage."""
    return {sa: float((a - b).abs().max())
            for (sa, a), (sb, b) in zip(rows_a, rows_b)}


# op classes of a trace, by kernel name (first match wins)
OP_CLASSES = (
    ("pair kernels", ("pair_reverse_kernel", "pair_fwd_kernel",
                      "pair_bwd_kernel", "reduce_slabs", "resblock")),
    ("_int_mm (int8 GEMM)", ("i8i8", "s8", "imma", "int8", "i8_i32")),
    ("cuDNN convs", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                     "implicit", "winograd", "fft")),
    ("cuBLAS GEMMs", ("gemm", "nvjet", "cutlass", "cublas", "xmma", "splitk",
                      "splitKreduce", "dot_kernel", "gemv")),
    ("copies", ("memcpy", "memset", "copy", "cat", "pad", "index",
                "gather", "scatter", "transpose", "permute")),
    ("elementwise and reductions", ("elementwise", "reduce", "vectorized",
                                    "unrolled", "at::native", "norm",
                                    "softmax")),
)


def _op_class(name: str) -> str:
    low = name.lower()
    for cls, keys in OP_CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def trace_split(prof, wall_ms: float, what: str, top: int = 12,
                gaps: int = 5) -> dict:
    """The device's share of a ``torch.profiler`` window: the window's span
    (first to last event), the number of device ops, busy time (the union
    of device intervals) and idle share, the top device ops by total time
    with calls, the time per op class, and the longest idle gaps
    (with the kernels around them and the innermost program span,
    ``utils/profiling.py:span``, open on the host at the gap's middle).
    A program span's projection onto the device timeline is no device
    work and is left out.  Returns None when the trace holds no device
    time."""
    from torch.autograd import DeviceType
    evs = list(prof.events())
    dev_evs = [e for e in evs if e.device_type == DeviceType.CUDA
               and not e.name.startswith("fwn.")]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in evs
             if e.device_type != DeviceType.CUDA
             and e.name.startswith("fwn.")]

    def open_span(t: float) -> str:
        inner = max(((s, n) for s, e, n in spans if s <= t < e),
                    default=(0.0, "-"))
        return inner[1]
    if not dev_evs:
        print(f"profile split, {what}: the trace holds no device time; see "
              f"the CUDA-event times", flush=True)
        return None
    t0 = min(e.time_range.start for e in evs)
    t1 = max(e.time_range.end for e in evs)
    iv = sorted((e.time_range.start, e.time_range.end, e.name)
                for e in dev_evs)
    busy, holes = 0.0, []
    cur_s, cur_e, cur_n = iv[0]
    if cur_s > t0:
        holes.append((cur_s - t0, t0, "(window start)", cur_n))
    for s, e, n in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            holes.append((s - cur_e, cur_e, cur_n, n))
            cur_s, cur_e, cur_n = s, e, n
        elif e > cur_e:
            cur_e, cur_n = e, n
    busy += cur_e - cur_s
    if t1 > cur_e:
        holes.append((t1 - cur_e, cur_e, cur_n, "(window end)"))
    span = t1 - t0
    by_name, by_cls = {}, {}
    for e in dev_evs:
        d = e.time_range.end - e.time_range.start
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + d, n + 1)
        c = _op_class(e.name)
        ct, cn = by_cls.get(c, (0.0, 0))
        by_cls[c] = (ct + d, cn + 1)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    holes = sorted(holes, reverse=True)[:gaps]
    out = {"wall_ms": wall_ms, "span_ms": span / 1e3,
           "device_ops": len(dev_evs),
           "busy_ms": busy / 1e3, "busy_share": busy / span,
           "idle_share": 1.0 - busy / span,
           "device_ms_by_class": {c: {"ms": t / 1e3, "calls": n}
                                  for c, (t, n) in sorted(
                                      by_cls.items(), key=lambda kv:
                                      -kv[1][0])},
           "top_ops": [{"name": k[:120], "ms": t / 1e3, "calls": n}
                       for k, (t, n) in ops],
           "idle_gaps": [{"ms": g / 1e3, "at_ms": (at - t0) / 1e3,
                          "after": a[:80], "before": b[:80],
                          "span": open_span(at + g / 2)}
                         for g, at, a, b in holes]}
    print(f"profile split, {what}: wall {wall_ms:.1f} ms (host clock); "
          f"{len(dev_evs)} device ops; "
          f"traced span {span / 1e3:.1f} ms, device busy {busy / 1e3:.1f} "
          f"ms ({100 * busy / span:.1f} %), idle {100 - 100 * busy / span:.1f}"
          f" %", flush=True)
    for c, r in out["device_ms_by_class"].items():
        print(f"  class {c}: {r['ms']:.2f} ms over {r['calls']} kernels",
              flush=True)
    for r in out["top_ops"]:
        print(f"  op {r['ms']:.3f} ms x{r['calls']}: {r['name']}", flush=True)
    for r in out["idle_gaps"]:
        print(f"  idle gap {r['ms']:.3f} ms at {r['at_ms']:.1f} ms in "
              f"{r['span']}, after {r['after']} before {r['before']}",
              flush=True)
    return out


FRONTEND_UTTS = 12                  # speech-like utterances of 2-4 s


def _speech_wav(rng, seconds: float, sr: int, b: int) -> np.ndarray:
    """A speech-like waveform: a harmonic series on a gliding f0 under a
    syllable envelope, plus noise (the bench's ``BENCH_MELS=speech``
    recipe)."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 110.0 + 70.0 * np.sin(2 * np.pi * (0.6 + 0.1 * (b % 7)) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum((0.5 ** k) * np.sin((k + 1) * phase) for k in range(8))
    envelope = np.clip(np.sin(2 * np.pi * 1.7 * t + b) + 0.7, 0, None)
    return (0.3 * voiced * envelope + 0.05 * rng.randn(n)).astype(np.float32)


def frontend_phase(cfg, dev, tmpdir: str) -> dict:
    """The audio frontend: FRONTEND_UTTS speech-like utterances of 2-4 s
    written with ``write_wav`` in the LJSpeech layout, run through the
    port's ``preprocess`` (4 worker processes) into ``<tmpdir>/corpus_out``
    (audios, mels, train.txt, train/test fwrec; the lj22k training phase
    trains on it); ``mel_spectrogram_torch`` on the card held against the
    numpy ``mel_spectrogram`` (normalized) of the same waveforms to atol
    2e-4, the JAX package's bar for its own device mel."""
    import torch
    from flowavenet_tpu_torch.audio.mel import (mel_spectrogram,
                                                mel_spectrogram_torch,
                                                normalize_mel)
    from flowavenet_tpu_torch.audio.preprocessing import preprocess
    from flowavenet_tpu_torch.audio.wavio import write_wav
    from flowavenet_tpu_torch.data.records import FwRecordReader

    sr = cfg.audio.sample_rate
    rng = np.random.RandomState(SEED + 5)
    book = os.path.join(tmpdir, "corpus", "LJSpeech-1.1")
    os.makedirs(os.path.join(book, "wavs"))
    wavs, lines = [], []
    for i in range(FRONTEND_UTTS):
        w = _speech_wav(rng, 2.0 + 2.0 * rng.rand(), sr, i)
        wavs.append(w)
        write_wav(os.path.join(book, "wavs", f"LJ001-{i:04d}.wav"), w, sr)
        lines.append(f"LJ001-{i:04d}|utterance {i}|utterance {i}")
    with open(os.path.join(book, "metadata.csv"), "w") as f:
        f.write("\n".join(lines))
    out_dir = os.path.join(tmpdir, "corpus_out")
    t0 = time.perf_counter()
    meta = preprocess(os.path.dirname(book), out_dir, cfg, num_workers=4)
    pre_s = time.perf_counter() - t0
    n_train = len(FwRecordReader(os.path.join(out_dir, "train.fwrec")))
    n_test = len(FwRecordReader(os.path.join(out_dir, "test.fwrec")))
    check(len(meta) == FRONTEND_UTTS and n_train + n_test == FRONTEND_UTTS,
          ("preprocess", len(meta), n_train, n_test))
    # the device mel of 4 of the waveforms (cut to one length) vs numpy
    n = min(len(w) for w in wavs[:4])
    batch = np.stack([w[:n] for w in wavs[:4]])
    t0 = time.perf_counter()
    got = mel_spectrogram_torch(torch.from_numpy(batch).to(dev), cfg.audio)
    torch.cuda.synchronize()
    mel_ms = (time.perf_counter() - t0) * 1e3
    want = np.stack([normalize_mel(mel_spectrogram(w, cfg.audio), cfg.audio)
                     for w in batch])
    err = float(np.abs(got.cpu().numpy() - want).max())
    print(f"frontend: preprocess of {FRONTEND_UTTS} utterances "
          f"({sum(len(w) for w in wavs) / sr:.1f} s of audio) {pre_s:.1f} s,"
          f" {n_train} train / {n_test} test records; mel_spectrogram_torch "
          f"on the card {tuple(got.shape)} vs numpy max |err| {err:.2e} "
          f"({mel_ms:.1f} ms with its first call)", flush=True)
    check(tuple(got.shape) == want.shape and err <= 2e-4,
          ("mel_spectrogram_torch vs numpy", err))
    return {"data_dir": out_dir, "utterances": FRONTEND_UTTS,
            "preprocess_s": pre_s, "mel_err": err, "train_records": n_train,
            "test_records": n_test}


def profile_phase(loaded, cfg, dev, tmpdir: str) -> dict:
    """Phase 3c, where the int8 route's synthesis time goes: one warm
    ``synthesize_mels`` of the phase-3 batch (FRAMES, mels of seed SEED)
    under ``utils/profiling.py:trace`` (launches checked: 15
    ``pair_flow_i8``), split by ``trace_split``; then the same call with
    CUDA events around the upsampler and each ``block_reverse``
    (``utils/profiling.py:BlockStages``), printed per stage beside the
    call's wall time."""
    import torch
    from flowavenet_tpu_torch.synthesis.synthesize import synthesize_mels
    from flowavenet_tpu_torch.utils.profiling import BlockStages, trace

    rng = np.random.RandomState(SEED)
    mels = [rng.rand(f, cfg.audio.num_mels).astype(np.float32)
            for f in FRAMES]

    def run():
        return synthesize_mels(loaded, cfg, mels, seed=SEED,
                               compute_dtype=torch.bfloat16, device=dev)
    run()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with trace(os.path.join(tmpdir, "profile_reverse")) as prof:
        run()
    wall = (time.perf_counter() - t0) * 1e3
    check(_counts() == {"pair_flow_i8": 15}, ("traced reverse", _counts()))
    split = trace_split(prof, wall, "int8 route, one synthesize_mels of "
                        f"the {len(FRAMES)}-mel batch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with BlockStages() as st:
        run()
    ms = st.ms()
    wall = (time.perf_counter() - t0) * 1e3
    print(f"int8 route by stage (CUDA events), call wall {wall:.1f} ms, "
          f"stages {sum(ms.values()):.1f} ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()), flush=True)
    return {"trace": split, "stage_ms": ms, "stage_wall_ms": wall}


def bench_phase(dev) -> dict:
    """The port's bench (``python -m flowavenet_tpu_torch.bench``) in this
    process at its defaults (lj22k, BENCH_BATCH x 7 s, synthetic mels on
    the card) with BENCH_ITERS=3: its JSON line is printed on its own
    line; every reverse launches 15 ``pair_flow_i8`` (4 reverses)."""
    from flowavenet_tpu_torch import bench
    env = {"BENCH_ITERS": "3", "BENCH_CONFIG": "lj22k",
           "BENCH_MELS": "synthetic", "BENCH_BATCH": None,
           "BENCH_SECONDS": None}
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _reset_counts()
        t0 = time.perf_counter()
        result = bench.main(["--device", "cuda"])
        seconds = time.perf_counter() - t0
        counts = _counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(counts == {"pair_flow_i8": 15 * 4}, ("bench launches", counts))
    check(result["value"] > 0, ("bench", result))
    print(f"bench: batch {bench.DEFAULT_BATCH} x 7 s, {seconds:.1f} s in "
          f"all, launches {counts}", flush=True)
    return {**result, "batch": bench.DEFAULT_BATCH, "seconds": seconds,
            "launches": counts}


GATE_STEPS = 400                    # tiny training steps of the gate
GATE_SEEDS = 2                      # noise draws per route
# launches per tiny reverse (2 blocks x 1 pair) on each route of ROUTES
GATE_LAUNCHES = {"int8": {"pair_flow_i8": 2},
                 "FWN_INT8=0": {"pair_flow_wino": 2},
                 "FWN_INT8=0 FWN_WINO4=1": {"pair_flow_wino4": 2},
                 "FWN_INT8=0 FWN_HOISTED=1": {"pair_flow_wino": 2},
                 "FWN_HOISTED=1": {"pair_flow_i8": 2},
                 "FWN_INT8_RS=1": {"pair_flow_i8rs": 2}}


def quality_gate_phase(dev, tmpdir: str) -> dict:
    """Phase 8, the route-quality gate (``flowavenet_tpu_torch/
    quality_gate.py``): tiny trained on the card by the port's trainer
    (its preset's float32) for ``GATE_STEPS`` steps on the four 22.05 kHz
    wavs of ``docs/runs/``; the first and last logged NLL (it must fall);
    every route of ``ROUTES`` and the plain route scored over
    ``GATE_SEEDS`` noise draws, each route's launches per reverse checked
    against ``GATE_LAUNCHES``; the default int8 route must pass the JAX
    gate (a FAIL of an opt-in route is printed, not fatal).  Then one bf16
    FWN_TRAIN_KERNEL=1 step of tiny from the trained params (block 0's
    pair on pair_train_fwd / pair_train_bwd at R = 32): each launch
    against its plain version on the inputs the step gave it at phase 4's
    bf16 bars (outputs rel <= 1e-2 and corr >= 0.999, statistics rel <=
    1e-2, gradient cosine >= 0.999), the step against the plain bf16
    route (loss rel <= 1e-2; the gradient's cosine to the fp32 plain
    route's no more than 0.01 below the plain bf16 route's, phase 5's
    bar: the two routes round to bf16 at other points), then one
    make_train_step step on that route, finite."""
    import torch
    from flowavenet_tpu_torch import quality_gate as qg
    from flowavenet_tpu_torch.config import tiny
    from flowavenet_tpu_torch.data.dataset import CropDataset
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    from flowavenet_tpu_torch.synthesis.synthesize import load_params
    from flowavenet_tpu_torch.training.train import to_device
    from flowavenet_tpu_torch.training.train_state import (create_state,
                                                           make_train_step)
    from flowavenet_tpu_torch.utils.tree import leaves, tree_map

    cfg = tiny()
    work = os.path.join(tmpdir, "gate")
    t0 = time.perf_counter()
    ckpt_dir, data_dir = qg.train_model(cfg, work, list(qg.DEFAULT_WAVS),
                                        GATE_STEPS, None, dev)
    train_s = time.perf_counter() - t0
    with open(os.path.join(work, "logs", "train", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    nll = [(r["step"], r["loss"]) for r in recs]
    print(f"quality gate: tiny trained {GATE_STEPS} steps in {train_s:.1f} s"
          f" (with preprocessing and DDI); NLL step {nll[0][0]} "
          f"{nll[0][1]:.4f} -> step {nll[-1][0]} {nll[-1][1]:.4f}",
          flush=True)
    check(nll[-1][1] < nll[0][1], ("gate NLL did not fall", nll))
    t0 = time.perf_counter()
    gate = qg.run_gate(cfg, ckpt_dir, data_dir, seeds=GATE_SEEDS,
                       frames=200, device=dev,
                       log=lambda m: print(m, flush=True))
    gate_s = time.perf_counter() - t0
    for r, v in gate["routes"].items():
        check(v["launches"] == GATE_LAUNCHES.get(r, {}),
              ("gate launches", r, v["launches"]))
    check(gate["routes"]["int8"]["verdict"] == "PASS",
          ("the default int8 route fails the gate", gate["routes"]["int8"]))

    # one bf16 step of tiny on FWN_TRAIN_KERNEL=1: its training pair
    # launches against their plain versions on the inputs they were given,
    # the step against the plain route
    params, _ = load_params(ckpt_dir, cfg, compute_dtype=torch.float32,
                            device=dev)
    bcfg = cfg.replace(train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16"))
    ds = CropDataset(os.path.join(data_dir, "train.fwrec"),
                     hop_size=cfg.audio.hop_size,
                     max_time_steps=cfg.data.max_time_steps,
                     batch_size=cfg.data.batch_size, seed=cfg.train.seed)
    batch = to_device(ds.batch_at(0), dev)
    seen = {}

    def keep(name, fn):
        def run(*args):
            out = fn(*args)
            seen[name] = (args, out)
            return out
        return run

    def loss_and_grad(on, dt=torch.bfloat16):
        fwn.TRAIN_KERNEL = on
        p = tree_map(lambda l: l.detach().requires_grad_(), params)
        total, _ = fwn.loss_fn(p, cfg.model, batch["audio"], batch["mel"],
                               compute_dtype=dt)
        flat = leaves(p)
        gs = torch.autograd.grad(total, flat, allow_unused=True)
        return float(total.detach()), torch.cat([
            (torch.zeros_like(q) if g is None else g).flatten()
            for g, q in zip(gs, flat)])

    saved = fwn.TRAIN_KERNEL
    try:
        _reset_counts()
        with _patched([(pft, k, keep(k, getattr(pft, k))) for k in
                      ("fused_pair_train_fwd", "fused_pair_train_bwd")]):
            l_k, g_k = loss_and_grad(True)
        torch.cuda.synchronize()
        step_counts = _counts()
        l_p, g_p = loss_and_grad(False)
        l32, g32 = loss_and_grad(False, torch.float32)
        fwn.TRAIN_KERNEL = True
        state = create_state(torch.Generator(dev).manual_seed(SEED), bcfg)
        state = state._replace(params=tree_map(lambda l: l.clone(), params))
        state, m = make_train_step(bcfg)(state, batch)
        torch.cuda.synchronize()
    finally:
        fwn.TRAIN_KERNEL = saved
    check(step_counts == {"pair_train_fwd": 1, "pair_train_bwd": 1},
          ("tiny kernel-route launches", step_counts))
    # phase 4's bf16 bars on the step's own launches
    args, got = seen["fused_pair_train_fwd"]
    with torch.no_grad():
        want = pft.pair_train_fwd_ref(*args)
    f_err = [_errors(a.detach(), b) for a, b in zip(got[:2], want[:2])]
    st_rel = max(abs(float(a) - float(b)) / max(1e-6, abs(float(b)))
                 for a, b in zip(got[2:], want[2:]))
    args, d = seen["fused_pair_train_bwd"]
    dref = pft.pair_train_bwd_ref(*args)
    b_cos = min(_cos(a, b) for a, b in zip(list(d[0]) + list(d[1:]),
                                            list(dref[0]) + list(dref[1:]))
                if float(b.float().abs().max()) > 0)
    rel, corr = max(e[1] for e in f_err), min(e[2] for e in f_err)
    # phase 5's bars on the step: the loss and gradient against the plain
    # bf16 route, both measured from the fp32 plain route
    cos_k, cos_p = _cos(g_k, g32), _cos(g_p, g32)
    l_rel = abs(l_k - l_p) / max(1e-12, abs(l_p))
    print(f"quality gate: tiny bf16 FWN_TRAIN_KERNEL=1 step (launches "
          f"{step_counts}): pair_train_fwd vs plain rel {rel:.3e} corr "
          f"{corr:.6f} statistics rel {st_rel:.3e}; pair_train_bwd vs "
          f"plain worst gradient cosine {b_cos:.6f}; loss {l_k:.6f}, plain "
          f"route {l_p:.6f} (rel {l_rel:.3e}), fp32 {l32:.6f}; gradient "
          f"cosine to fp32 {cos_k:.6f}, plain route's {cos_p:.6f}; a "
          f"make_train_step step: loss {float(m['loss']):.6f}", flush=True)
    check(rel <= 1e-2 and corr >= 0.999 and st_rel <= 1e-2
          and b_cos >= 0.999, ("tiny bf16 training pair", rel, corr, st_rel,
                               b_cos))
    check(np.isfinite(l_k) and bool(torch.isfinite(g_k).all())
          and l_rel <= 1e-2 and cos_k >= cos_p - 0.01,
          ("tiny bf16 step", l_rel, cos_k, cos_p))
    check(all(np.isfinite(float(v)) for v in m.values())
          and all(bool(torch.isfinite(l).all()) for l in
                  leaves(state.params)), "tiny bf16 step not finite")
    return {"train_s": train_s, "gate_s": gate_s, "steps": GATE_STEPS,
            "nll_first": nll[0], "nll_last": nll[-1], "gate": gate,
            "tiny_bf16_kernel_step": {
                "launches": step_counts, "fwd_rel": rel, "fwd_corr": corr,
                "fwd_stats_rel": st_rel, "bwd_worst_grad_cos": b_cos,
                "loss_rel_to_plain": l_rel, "grad_cos_to_fp32": cos_k,
                "plain_grad_cos_to_fp32": cos_p}}


def trainer_phase(cfg, dev, data_dir: str, tmpdir: str) -> dict:
    """The trainer's entry point, ``training/train.py:train``, on the
    frontend's corpus on the FWN_TRAIN_KERNEL=1 route: DDI and 4 steps
    with ``tensorboard=True`` and ``profile_steps=2`` (a summary at steps
    2 and 4, the synthesis probe at 4).  The profile window must hold the
    training pair kernels (``pair_fwd_kernel``, ``pair_bwd_kernel``) in
    its Chrome trace and the launch counts must show them; the TensorBoard
    event files are listed (the card's machine may lack the tensorboard
    package, and then the trainer says so and goes on)."""
    import glob

    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.training.train import train

    logdir = os.path.join(tmpdir, "trainer_logs")
    saved = fwn.TRAIN_KERNEL
    fwn.TRAIN_KERNEL = True
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        train(cfg, data_dir, logdir, train_steps=4, summary_interval=2,
              checkpoint_interval=4, eval_interval=4, log_every=1,
              tensorboard=True, profile_steps=2, device=dev)
        seconds = time.perf_counter() - t0
        counts = _counts()
    finally:
        fwn.TRAIN_KERNEL = saved
    traces = glob.glob(os.path.join(logdir, "profile", "*.pt.trace.json"))
    check(len(traces) == 1, ("profile window traces", traces))
    with open(traces[0]) as f:
        kernels = {e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"}
    found = {k: any(k in n for n in kernels)
             for k in ("pair_fwd_kernel", "pair_bwd_kernel")}
    events = glob.glob(os.path.join(logdir, "train", "events.out.*"))
    print(f"trainer: 4 steps with tensorboard and profile_steps=2 in "
          f"{seconds:.1f} s; launches {counts}; the profile window's trace "
          f"holds {found} among {len(kernels)} kernel names; TensorBoard "
          f"event files {len(events)}", flush=True)
    check(all(found.values()), ("profile window kernels", found))
    check(counts.get("pair_train_fwd", 0) > 0
          and counts.get("pair_train_bwd", 0) > 0, ("trainer", counts))
    return {"seconds": seconds, "launches": counts, "trace_kernels": found,
            "tensorboard_event_files": len(events)}


# ---------------------------------------------------------------------------
# Scale-out: the native loader, the process mesh and the data mesh
# ---------------------------------------------------------------------------

LOADER_BATCHES = 20                 # timed batch_at calls per loader


def native_loader_phase(cfg, dev, data_dir: str, tmpdir: str) -> dict:
    """Phase (a): the native C++ loader, built with the host compiler on
    the card's machine.  On the frontend's corpus its prefetched stream
    equals ``batch_at`` for steps 3-6; ms per batch of ``batch_at`` at 8 x
    6400 for both loaders (LOADER_BATCHES each, after one untimed), and of
    the prefetched streams; then ``train(loader="native")`` on the
    FWN_TRAIN_KERNEL=1 route: 4 steps in one run against 2 steps and a
    resumed run to 4, whose step-4 checkpoints must hold the same bits,
    with the loader in their metadata."""
    import torch
    from flowavenet_tpu_torch.checkpoint.checkpoint import read_meta
    from flowavenet_tpu_torch.data.dataset import CropDataset
    from flowavenet_tpu_torch.data.native_loader import (NativeCropDataset,
                                                         load_library)
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.training.train import train

    t0 = time.perf_counter()
    load_library()
    build_s = time.perf_counter() - t0
    path = os.path.join(data_dir, "train.fwrec")
    kw = dict(hop_size=cfg.audio.hop_size,
              max_time_steps=cfg.data.max_time_steps,
              batch_size=cfg.data.batch_size, seed=cfg.train.seed)
    nat, py = NativeCropDataset(path, **kw), CropDataset(path, **kw)
    it = nat.iterate(start_step=3)
    for s in range(3, 7):
        got, want = next(it), nat.batch_at(s)
        check(all(np.array_equal(got[k], want[k]) for k in want),
              ("native prefetch vs batch_at", s))
    out = {"build_s": build_s}
    for name, ds in (("python", py), ("native", nat)):
        ds.batch_at(0)
        t0 = time.perf_counter()
        for s in range(LOADER_BATCHES):
            ds.batch_at(s)
        out[f"{name}_batch_at_ms"] = ((time.perf_counter() - t0) * 1e3
                                      / LOADER_BATCHES)
        stream = ds.iterate(start_step=0)
        next(stream)
        t0 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(stream)
        out[f"{name}_stream_ms"] = ((time.perf_counter() - t0) * 1e3
                                    / LOADER_BATCHES)
        stream.close()
    nat.close()
    print(f"native loader: built in {build_s:.1f} s; batch_at at "
          f"{cfg.data.batch_size} x {cfg.data.max_time_steps}: python "
          f"{out['python_batch_at_ms']:.3f} ms, native "
          f"{out['native_batch_at_ms']:.3f} ms per batch; prefetched stream "
          f"python {out['python_stream_ms']:.3f}, native "
          f"{out['native_stream_ms']:.3f} ms per batch", flush=True)

    runs = {k: os.path.join(tmpdir, f"native_{k}") for k in ("a", "b")}
    tkw = dict(summary_interval=2, checkpoint_interval=2,
               probe_synthesis=False, log_every=1, loader="native",
               device=dev)
    saved = fwn.TRAIN_KERNEL
    fwn.TRAIN_KERNEL = True
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        train(cfg, data_dir, runs["a"], train_steps=4, **tkw)
        out["train_s"] = time.perf_counter() - t0
        out["launches"] = _counts()
        train(cfg, data_dir, runs["b"], train_steps=2, **tkw)
        train(cfg, data_dir, runs["b"], train_steps=4, **tkw)
    finally:
        fwn.TRAIN_KERNEL = saved
    ck = [os.path.join(runs[k], "pretrained", "ckpt-4.npz") for k in "ab"]
    with np.load(ck[0]) as fa, np.load(ck[1]) as fb:
        keys = [k for k in fa.files if k != "__meta__"]
        same = all(np.array_equal(fa[k], fb[k]) for k in keys)
    meta = read_meta(ck[0])
    print(f"native loader trainer: 4 steps in {out['train_s']:.1f} s, "
          f"launches {out['launches']}; resumed run == unbroken run bit for "
          f"bit: {same} ({len(keys)} leaves); loader {meta.get('loader')}",
          flush=True)
    check(same and meta.get("loader") == "native",
          ("native-loader resume", same, meta.get("loader")))
    check(out["launches"].get("pair_train_fwd", 0) > 0
          and out["launches"].get("pair_train_bwd", 0) > 0,
          ("native-loader trainer launches", out["launches"]))
    out["resume_bit_exact"] = same
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


SCALE_STEPS = 4                     # timed steps per path, in turns


def nccl_phase(cfg, dev, data_dir: str, backend: str = "nccl") -> dict:
    """Phase (b): the production scale-out path at world size 1: NCCL, a
    (1, 1) mesh, the state placed by ``put_tree``, lj22k bf16 at 8 x 6400
    on FWN_TRAIN_KERNEL=1 and FWN_FWD_KERNEL=1 (the log_s guards off, as
    that route needs).  The gradients (``grads_of`` with the mesh and
    without) and two whole steps (metrics and every state leaf) must be
    bit-identical to the one-device path; then SCALE_STEPS steps of each,
    in turns, timed on the host clock around synchronized steps."""
    import torch
    import torch.distributed as dist
    from flowavenet_tpu_torch.data.dataset import CropDataset
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.parallel.mesh import make_mesh
    from flowavenet_tpu_torch.parallel.multihost import put_tree, shutdown
    from flowavenet_tpu_torch.training.train import state_sharding, to_device
    from flowavenet_tpu_torch.training.train_state import (
        create_state, ddi_initialize, grads_of, make_train_step)
    from flowavenet_tpu_torch.utils.tree import leaves

    # without the log_s guards, which FWN_FWD_KERNEL=1 refuses
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, logs_hinge=0.0,
                                                 logs_l2=0.0))
    ds = CropDataset(os.path.join(data_dir, "train.fwrec"),
                     hop_size=cfg.audio.hop_size,
                     max_time_steps=cfg.data.max_time_steps,
                     batch_size=cfg.data.batch_size, seed=cfg.train.seed)
    batches = [to_device(ds.batch_at(s), dev) for s in range(2)]
    saved = fwn.TRAIN_KERNEL, fwn.PAIR_KERNEL_FWD
    fwn.TRAIN_KERNEL = fwn.PAIR_KERNEL_FWD = True
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        state0 = ddi_initialize(create_state(
            torch.Generator(dev).manual_seed(SEED), cfg), cfg, batches[0])
        mesh = make_mesh(cfg.mesh, dev)
        check(mesh.distributed and mesh.size == 1, ("nccl mesh", mesh))
        specs = state_sharding(state0, mesh, cfg.mesh)
        placed = put_tree(state0, mesh, specs)
        steps = {"one-device": (make_train_step(cfg), state0),
                 "nccl mesh": (make_train_step(cfg, mesh, specs.params),
                               placed)}
        dt = torch.bfloat16

        def loss_of(p):
            return fwn.loss_fn(p, cfg.model, batches[0]["audio"],
                               batches[0]["mel"], compute_dtype=dt)

        g1 = grads_of(loss_of, state0.params)[2]
        _reset_counts()
        g2 = grads_of(loss_of, placed.params, mesh)[2]
        torch.cuda.synchronize()
        grad_counts = _counts()
        grads_same = all(torch.equal(a, b)
                         for a, b in zip(leaves(g1), leaves(g2)))
        del g1, g2
        ends = {}
        for name, (fn, st) in steps.items():
            m = None
            for b in batches:
                st, m = fn(st, b)
            torch.cuda.synchronize()
            ends[name] = (st, m)
        (sa, ma), (sb, mb) = ends["one-device"], ends["nccl mesh"]
        step_same = (set(ma) == set(mb)
                     and all(torch.equal(ma[k], mb[k]) for k in ma)
                     and all(torch.equal(a, b)
                             for a, b in zip(leaves(sa), leaves(sb))))
        del ends, sa, sb
        walls = {k: [] for k in steps}
        order = list(steps) + list(steps)[::-1]
        _reset_counts()
        for i in range(SCALE_STEPS):
            for name in order[i % 2 * 2: i % 2 * 2 + 2]:
                fn, st = steps[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = fn(st, batches[i % 2])
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
                steps[name] = (fn, st)
        counts = _counts()
    finally:
        shutdown()
        fwn.TRAIN_KERNEL, fwn.PAIR_KERNEL_FWD = saved
    out = {"grads_bit_identical": grads_same,
           "steps_bit_identical": step_same,
           "grad_launches": grad_counts, "launches": counts,
           **{f"{k.replace(' ', '_').replace('-', '_')}_step_ms":
              float(np.median(v)) for k, v in walls.items()},
           "walls_ms": walls}
    print(f"nccl world size 1, mesh (1, 1): gradients bit-identical "
          f"{grads_same}, two steps bit-identical {step_same}; step ms "
          f"(median of {SCALE_STEPS}, in turns): one-device "
          f"{out['one_device_step_ms']:.1f}, nccl mesh "
          f"{out['nccl_mesh_step_ms']:.1f}; launches {counts}", flush=True)
    check(grads_same and step_same, ("nccl world size 1", grads_same,
                                     step_same))
    check(counts.get("pair_train_bwd", 0) > 0
          and counts.get("pair_fwd", 0) > 0, ("nccl launches", counts))
    return out


GLOO_BATCH = 4                      # global batch of phase (c), x 6400
GLOO_STEPS = 2                      # timed train steps per mesh
# the conditioning 1x1s JAX's rule splits at lj22k on a (1, 2) mesh:
# filter_c and gate_c of both layers of blocks 5-7
GLOO_TP_LEAVES = sorted(f"['blocks'][{b}]['flows']['coupling']['layers'][{l}]"
                        f"['{k}']['v']" for b in (5, 6, 7) for l in (0, 1)
                        for k in ("filter_c", "gate_c"))


def _sha(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def _gloo_rank(rank: int, port: int, cfg, shape: tuple, data_dir: str,
               out_dir: str, device: str) -> None:
    """One of two gloo ranks on the one card (phase (c)), started by
    ``torch.multiprocessing``: lj22k fp32 (TF32 off) gradients of a
    GLOO_BATCH x 6400 global batch over a ``shape`` mesh against the
    one-process gradients on the same batch (rank 0), then GLOO_STEPS
    timed train steps, and the gathered checkpoint with each rank's hashes
    of its params."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flowavenet_tpu_torch.checkpoint.checkpoint import (_paths,
                                                            save_checkpoint)
    from flowavenet_tpu_torch.data.dataset import CropDataset
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.parallel.mesh import make_mesh, param_sharding
    from flowavenet_tpu_torch.parallel.multihost import (
        gather_tree, host_batch_slice, initialize_distributed,
        make_global_batch, put_tree, sharded_paths, shutdown)
    from flowavenet_tpu_torch.training.train import (state_sharding,
                                                     to_device)
    from flowavenet_tpu_torch.training.train_state import (
        create_state, grads_of, make_train_step)
    from flowavenet_tpu_torch.utils.tree import tree_map

    dev = torch.device(device)
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, compute_dtype="float32"),
        data=dataclasses.replace(cfg.data, batch_size=GLOO_BATCH // shape[0]),
        mesh=dataclasses.replace(cfg.mesh, data_parallel=shape[0],
                                 model_parallel=shape[1]))
    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo",
                           device=dev)
    try:
        mesh = make_mesh(cfg.mesh, dev)
        ds = CropDataset(os.path.join(data_dir, "train.fwrec"),
                         hop_size=cfg.audio.hop_size,
                         max_time_steps=cfg.data.max_time_steps,
                         batch_size=GLOO_BATCH, seed=cfg.train.seed)
        full_b = ds.batch_at(0)
        rows = host_batch_slice(GLOO_BATCH, mesh)
        local = make_global_batch({k: v[rows] for k, v in full_b.items()},
                                  mesh)
        params = tree_map(lambda l: l.to(dev), randomized_params(cfg, SEED))
        specs = param_sharding(params, mesh, cfg.mesh)
        split = sharded_paths(specs)
        placed = put_tree(params, mesh, specs)

        def loss_on(b):
            return lambda p: fwn.loss_fn(p, cfg.model, b["audio"], b["mel"])

        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, grads = grads_of(loss_on(local), placed, mesh)
        torch.cuda.synchronize()
        grad_ms = (time.perf_counter() - t0) * 1e3
        grads = gather_tree(grads, mesh, specs)
        res = {"rank": rank, "shape": list(shape), "grad_ms": grad_ms,
               "split": {p: [int(x) for x in l.shape] for p, l in
                         _paths(grads) if p in split},
               "grad_launches": _counts()}
        if rank == 0:
            ref = grads_of(loss_on(to_device(full_b, dev)), params)[2]
            worst, worst_leaf = 0.0, None
            for (p, a), (_, b) in zip(_paths(grads), _paths(ref)):
                atol = max(5e-7, 5e-5 * float(b.abs().max()))
                r = float(((a - b).abs() / (atol + 5e-4 * b.abs())).max())
                if r > worst:
                    worst, worst_leaf = r, p
            res.update(worst_ratio=worst, worst_leaf=worst_leaf,
                       n_leaves=len(list(_paths(ref))))
            del ref
        del grads
        state = create_state(torch.Generator(dev).manual_seed(SEED), cfg)
        state = state._replace(params=params)
        st_specs = state_sharding(state, mesh, cfg.mesh)
        state = put_tree(state, mesh, st_specs)
        step = make_train_step(cfg, mesh, st_specs.params)
        walls = []
        _reset_counts()
        for _ in range(GLOO_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, local)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        res.update(step_walls_ms=walls, step_loss=float(m["loss"]),
                   step_launches=_counts())
        full = gather_tree(state, mesh, st_specs)
        if rank == 0:
            save_checkpoint(os.path.join(out_dir, "ckpt"), GLOO_STEPS, full)
        res["hashes"] = {p: _sha(l) for p, l in _paths(state.params)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        shutdown()


def gloo_phase(cfg, dev, data_dir: str, tmpdir: str) -> dict:
    """Phase (c): two ranks on the one card over gloo
    (``torch.multiprocessing``; NCCL refuses two ranks on one device), on
    meshes (2, 1) and (1, 2), fp32, TF32 off, global batch GLOO_BATCH x
    6400.  Per-leaf gradients against one process on the same batch at
    tests/test_parallel.py's bars (rtol 5e-4, atol max(5e-7, 5e-5 max|g|);
    the worst ratio of error to allowance must be <= 1); the (1, 2) mesh
    must split exactly GLOO_TP_LEAVES, shaped [6, 1, Cc, 256] with Cc
    2560, 5120 and 10240; its checkpoint, gathered to the one-device
    layout, restored in this process must hold each rank's params (shards
    and replicated leaves, by hash).  GLOO_STEPS train steps per mesh are
    timed: gloo's step time (host staging of every collective), not a
    scale-out rate."""
    import torch
    import torch.multiprocessing as mp
    from flowavenet_tpu_torch.checkpoint.checkpoint import restore_checkpoint
    from flowavenet_tpu_torch.training.train_state import create_state

    torch.cuda.empty_cache()
    out = {}
    for shape in ((2, 1), (1, 2)):
        d = os.path.join(tmpdir, f"gloo_{shape[0]}x{shape[1]}")
        os.makedirs(d)
        t0 = time.perf_counter()
        mp.spawn(_gloo_rank, args=(_free_port(), cfg, shape, data_dir, d,
                                   str(dev)), nprocs=2, join=True)
        secs = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        r0 = ranks[0]
        key = f"{shape[0]}x{shape[1]}"
        split = sorted(r0["split"])
        res = {"seconds": secs, "worst_ratio": r0["worst_ratio"],
               "worst_leaf": r0["worst_leaf"], "n_leaves": r0["n_leaves"],
               "split": r0["split"],
               "gloo_grad_ms": [r["grad_ms"] for r in ranks],
               "gloo_step_ms": [float(np.median(r["step_walls_ms"]))
                                for r in ranks],
               "step_losses": [r["step_loss"] for r in ranks],
               "launches": [r["step_launches"] for r in ranks]}
        print(f"gloo {key}: worst gradient error / allowance "
              f"{r0['worst_ratio']:.3f} ({r0['worst_leaf']}) over "
              f"{r0['n_leaves']} leaves; split {len(split)} leaves"
              + "".join(f"\n  {p} {s}" for p, s in sorted(
                  r0["split"].items()))
              + f"\n  gloo's step ms per rank (median of {GLOO_STEPS}) "
              f"{res['gloo_step_ms']}, losses {res['step_losses']}; "
              f"{secs:.1f} s with the spawn", flush=True)
        check(r0["worst_ratio"] <= 1.0, ("gloo gradients", key, res))
        check(len(set(res["step_losses"])) == 1
              and np.isfinite(res["step_losses"][0]), ("gloo losses", res))
        if shape == (1, 2):
            check(split == GLOO_TP_LEAVES
                  and sorted(r0["split"][p][2] for p in split)
                  == sorted([2560, 5120, 10240] * 4)
                  and all(r0["split"][p][:2] == [6, 1]
                          and r0["split"][p][3] == 256 for p in split),
                  ("TP leaves at lj22k", r0["split"]))
            template = create_state(torch.Generator().manual_seed(0), cfg)
            st, step = restore_checkpoint(
                os.path.join(d, "ckpt", f"ckpt-{GLOO_STEPS}.npz"), template)
            from flowavenet_tpu_torch.checkpoint.checkpoint import _paths
            ok = step == GLOO_STEPS
            for p, leaf in _paths(st.params):
                for m, rk in enumerate(ranks):
                    part = leaf
                    if p in split:
                        n = leaf.shape[2] // 2
                        part = leaf[:, :, m * n: (m + 1) * n]
                    ok = ok and _sha(part) == rk["hashes"][p]
            res["checkpoint_restores"] = ok
            print(f"gloo 1x2 checkpoint restored in one process holds every "
                  f"rank's params: {ok}", flush=True)
            check(ok, ("gloo 1x2 checkpoint", step))
        else:
            check(not split, ("gloo 2x1 split", split))
        out[key] = res
    return out


DP_STREAM_FRAMES = 800              # the time-parallel utterance


def data_parallel_phase(loaded, cfg, dev) -> dict:
    """Phase (d): data-parallel synthesis and serving on the one card.
    ``dispatch_mels`` over ``make_data_mesh(["cuda:0", "cuda:0"])`` (the
    phase-3 mels, 4 rows, 2 per replica) on the default int8 route and on
    FWN_INT8=0: every row bit-identical to the one-device call, the
    route's kernels launched on both shards (30 ``pair_flow_i8``; 18
    ``pair_flow_wino`` + 6 ``pair_flow``).  ``synthesize_time_parallel``
    of a DP_STREAM_FRAMES-frame mel over that mesh: bit-identical to one
    device.  The server with ``mesh=local_data_mesh(-1)`` (what
    ``--data_parallel -1`` builds: every card, here one) against the
    mesh-less server: a warm-up round each, then rounds of the 8
    SERVE_FRAMES requests in turns (A B B A), bytes identical, requests/s
    of each."""
    import threading

    import torch
    from flowavenet_tpu_torch.models import flowavenet as fwn
    from flowavenet_tpu_torch.parallel.mesh import make_data_mesh
    from flowavenet_tpu_torch.serving.server import serve
    from flowavenet_tpu_torch.synthesis.streaming import (
        synthesize_time_parallel)
    from flowavenet_tpu_torch.synthesis.synthesize import (
        dispatch_mels, local_data_mesh, materialize_wavs, synthesize_mels)

    bf16 = torch.bfloat16
    rng = np.random.RandomState(SEED)
    mels = [rng.rand(f, cfg.audio.num_mels).astype(np.float32)
            for f in FRAMES]
    mesh2 = make_data_mesh([dev, dev])
    want_launch = {"int8": {"pair_flow_i8": 30},
                   "FWN_INT8=0": {"pair_flow_wino": 18, "pair_flow": 6}}
    out = {}
    saved = fwn.PAIR_KERNEL_INT8
    try:
        for route, int8 in (("int8", True), ("FWN_INT8=0", False)):
            fwn.PAIR_KERNEL_INT8 = int8
            one = synthesize_mels(loaded, cfg, mels, seed=SEED,
                                  compute_dtype=bf16, device=dev)
            torch.cuda.synchronize()
            _reset_counts()
            wav, frames = dispatch_mels(loaded, cfg, mels, seed=SEED,
                                        compute_dtype=bf16,
                                        data_sharding=mesh2,
                                        batch_multiple=2)
            two = materialize_wavs(wav, frames, cfg)
            counts = _counts()
            same = all(np.array_equal(a, b) for a, b in zip(one, two))
            out[route] = {"rows_bit_identical": same, "launches": counts}
            print(f"data mesh of 2 replicas, {route}: {len(two)} rows "
                  f"bit-identical to one device {same}; launches {counts}",
                  flush=True)
            check(same and all(counts.get(k) == v for k, v in
                               want_launch[route].items()),
                  ("data-parallel dispatch", route, same, counts))
        fwn.PAIR_KERNEL_INT8 = True
        long = rng.rand(DP_STREAM_FRAMES, cfg.audio.num_mels).astype(
            np.float32)
        one = synthesize_time_parallel(loaded, cfg, long, seed=SEED,
                                       compute_dtype=bf16, device=dev)
        _reset_counts()
        two = synthesize_time_parallel(loaded, cfg, long, seed=SEED,
                                       compute_dtype=bf16,
                                       data_sharding=mesh2, batch_multiple=2)
        counts = _counts()
        same = np.array_equal(one, two)
        out["time_parallel"] = {"bit_identical": same, "launches": counts}
        print(f"time-parallel over the data mesh ({DP_STREAM_FRAMES} "
              f"frames): bit-identical to one device {same}; launches "
              f"{counts}", flush=True)
        check(same and counts.get("pair_flow_i8", 0) > 0,
              ("data-parallel time-parallel", same, counts))

        mesh_all = local_data_mesh(-1, dev.type)
        check(dev.type != "cuda" or mesh_all.size
              == torch.cuda.device_count(),
              ("--data_parallel -1 mesh", mesh_all.devices))
        servers = {}
        for name, kw in (("one-device", {"device": dev}),
                         ("data mesh", {"mesh": mesh_all})):
            httpd = serve(loaded, cfg, port=0, **kw)
            threading.Thread(target=httpd.serve_forever,
                             daemon=True).start()
            servers[name] = httpd
        reqs = [(rng.rand(f, cfg.audio.num_mels).astype(np.float32),
                 2000 + i) for i, f in enumerate(SERVE_FRAMES)]
        bodies, rps = {}, {k: [] for k in servers}
        try:
            for name, h in servers.items():
                _post_all(h.server_address[1], reqs)        # warm-up
            _reset_counts()
            for name in ("one-device", "data mesh", "data mesh",
                         "one-device"):
                res, wall = _post_all(servers[name].server_address[1], reqs)
                rps[name].append(len(reqs) / wall)
                bodies.setdefault(name, [r[2] for r in res])
            counts = _counts()
            stats = servers["data mesh"].service.stats
        finally:
            for h in servers.values():
                h.shutdown()
                h.service.close()
        same = bodies["one-device"] == bodies["data mesh"]
        out["serving"] = {
            "bytes_identical": same, "data_parallel": stats["data_parallel"],
            "requests_per_s_one_device": rps["one-device"],
            "requests_per_s_data_mesh": rps["data mesh"], "launches": counts}
        print(f"server with mesh=local_data_mesh(-1) "
              f"({mesh_all.size} card): bytes identical to the mesh-less "
              f"server {same}; requests/s one-device {rps['one-device']}, "
              f"data mesh {rps['data mesh']}; /stats data_parallel "
              f"{stats['data_parallel']}", flush=True)
        check(same and stats["data_parallel"] == mesh_all.size,
              ("data-parallel serving", same, stats))
    finally:
        fwn.PAIR_KERNEL_INT8 = saved
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from flowavenet_tpu_torch.config import lj22k
    from flowavenet_tpu_torch.ops import _build
    from flowavenet_tpu_torch.synthesis.synthesize import padded_frames

    t_start = time.perf_counter()
    # the plain versions run in full fp32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; card: {smi}", flush=True)
    # phase 1: all four sources at once, one nvcc each
    libs = ("pair_flow", "pair_flow_wino", "pair_flow_train", "resblock")
    t0 = time.perf_counter()
    _build.build_all(libs)
    print(f"build {' + '.join(libs)} in parallel: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        secs, log = _build.BUILD_INFO.get(name, (0.0, ""))
        print(f"build {name}: {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  ptxas:", line.strip())
        _build.load(name)
    # registers and local (spill) bytes per thread of every kernel's bf16
    # instance (cudaFuncGetAttributes)
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    tc = uses_tensor_cores(torch.bfloat16)
    attrs = {}
    for name in LAUNCHES:
        regs, local = kernel_attrs(name, torch.bfloat16)
        attrs[name] = {"registers": regs, "local_bytes": local}
        print(f"{name} bf16 ({'tensor cores' if tc else 'CUDA cores'}): "
              f"numRegs {regs}, localSizeBytes {local}", flush=True)

    cfg = lj22k()
    params = randomized_params(cfg, SEED)
    B, T = len(FRAMES), padded_frames(max(FRAMES), cfg) * cfg.audio.hop_size
    # phase 2: blocks 0-4 take the int8 kernel, blocks 0-3 the bf16 one
    rows = kernel_checks(params, cfg, B, T, range(5), dev)
    i8_batch = i8_batch_shape(params, cfg, dev)
    # phase 2b: the Winograd, hoisted and int8 res/skip pairs
    vrows = variant_checks(params, cfg, B, T, dev)
    # phase 2d: the hoisted tensor-core pairs over tiles, and with the front
    # and zero convs on CUDA cores; the int8 pair's fixed tile at B = 1, 4, 8
    srows = hoisted_sweep(params, cfg, B, T, dev)
    brows = hoisted_i8_batch_tiles(params, T, dev)
    # phase 2c: the fused ResBlock route, one coupling net per block
    rrows, r_launches, r_grads = resblock_checks(params, cfg, B, T, dev)
    import tempfile
    with tempfile.TemporaryDirectory(
            dir=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")) as tmp:
        # phase 3: synthesis on every route, the first slice's main path,
        # a row beside its companions, and where the int8 route's time goes
        main_out = main_path(params, cfg, dev, FRAMES)
        comp = batch_composition(main_out["loaded"], cfg, dev)
        invariance = route_invariance(main_out["loaded"], cfg, dev)
        cost = repair_cost(main_out["loaded"], cfg, dev)
        prof_out = profile_phase(main_out["loaded"], cfg, dev, tmp)
        # the port's bench at its default batch
        bench_out = bench_phase(dev)
        # phase 3b: widths the kernels take only padded, on the kernel
        # routes
        odd_out = odd_width_phase(dev)
        # phase 6 (run here, on the loaded bf16 params): serving
        loaded = main_out.pop("loaded")
        serve_out = serving_phase(loaded, cfg, dev)
        # phase (d): data-parallel synthesis and serving
        dp_out = data_parallel_phase(loaded, cfg, dev)
        del loaded
        # phase 4: the training kernels at the training geometry of
        # blocks 0-3
        tB, tT = cfg.data.batch_size, cfg.data.max_time_steps
        trows = train_kernel_checks(params, cfg, tB, tT, range(4), dev)
        # the audio frontend: a speech-like corpus through preprocess
        front = frontend_phase(cfg, dev, tmp)
        # phase 5: training on that corpus, then the trainer's entry point
        # with TensorBoard and a profile window
        tr = training_phase(cfg, dev, front["data_dir"])
        trainer = trainer_phase(cfg, dev, front["data_dir"], tmp)
        # phases (a)-(c): the native loader, the NCCL mesh at world size
        # 1, two gloo ranks on the one card
        native = native_loader_phase(cfg, dev, front["data_dir"], tmp)
        nccl = nccl_phase(cfg, dev, front["data_dir"])
        gloo = gloo_phase(cfg, dev, front["data_dir"], tmp)
        # phase 7: lj8k_gin, global conditioning end to end
        gin = gin_phase(dev, tmp)
        # phase 8: the route-quality gate on tiny trained on the card, and
        # one bf16 FWN_TRAIN_KERNEL=1 step of tiny (R = 32)
        gate = quality_gate_phase(dev, tmp)

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

    def tentry(name, replaces, key, err, launches, blks):
        """Per main-path step: the sum over the routed blocks' bf16 pairs
        (3 per block) at the training geometry."""
        sel = [r for r in trows if r["mode"] == "bf16" and r["block"] in blks]
        n_pair = cfg.model.n_flow // 2
        bkey = "bwd_bound" if key == "bwd" else "fwd_bound"
        return {"name": name, "route": "cuda",
                "source": "flowavenet_tpu_torch/ops/csrc/pair_flow_train.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r[err] for r in sel),
                "ms": n_pair * sum(r[f"{key}_ms"] for r in sel),
                "plain_ms": n_pair * sum(r[f"{key}_plain_ms"] for r in sel),
                "bound_ms": n_pair * sum(r[bkey][0] for r in sel),
                "bound_by": "operations" if all(
                    r[bkey][1] == "operations" for r in sel) else "bytes",
                "library_ms": None}

    n_tr = tr["n_route"] // (cfg.model.n_flow // 2)
    launches = {}
    for r in main_out["routes"].values():
        for k, v in r["launches"].items():
            launches[k] = max(launches.get(k, 0), v)

    def ventry(name, src_line, mode, source="pair_flow.cu", swept=False):
        """Per reverse on its route: the sum over the routed blocks' pairs
        (3 per block).  ``swept``: no route runs the kernel; one pair per
        block of phase 2b, whose correctness launches are counted."""
        sel = [r for r in vrows if r["name"] == name and r["mode"] == mode]
        n_pair = 1 if swept else cfg.model.n_flow // 2
        e = {"name": name, "route": "cuda",
             "source": f"flowavenet_tpu_torch/ops/csrc/{source}",
             "replaces": f"flowavenet_tpu/ops/pallas_flow.py:{src_line}",
             "launches": len(sel) if swept else launches.get(name, 0),
             "max_abs_err": max(r["max_abs_err"] for r in sel),
             "ms": n_pair * sum(r["ms"] for r in sel),
             "plain_ms": n_pair * sum(r["plain_ms"] for r in sel),
             "bound_ms": n_pair * sum(r["bound_ms"] for r in sel),
             "bound_by": "operations" if all(
                 r["bound_by"] == "operations" for r in sel) else "bytes",
             "library_ms": None}
        if sel[0]["hoist_ms"] is not None:
            e["hoist_matmul_ms"] = n_pair * sum(r["hoist_ms"] for r in sel)
        if sel[0]["kernel_ms"] is not None:
            # the hoisted tensor-core pairs: profiler kernel time per
            # reverse beside the CUDA-event ms, each block's launch and its
            # tile sweep (phase 2d)
            e["kernel_ms"] = n_pair * sum(r["kernel_ms"] for r in sel)
            e["per_block"] = [{k: r[k] for k in ("block", "t_tile", "ctas",
                                                 "ms", "kernel_ms")}
                              for r in sel]
            e["tile_sweep"] = [{k: v for k, v in r.items() if k != "name"}
                               for r in srows if r["name"] == name]
        if swept:
            e["launches_from"] = ("phase 2b, one bf16 pair per lj22k block "
                                  "0-2; no model route runs it")
            # each block's time beside its dense twin's in this run
            e["per_block"] = [{k: r[k] for k in ("block", "ms", "twin_ms")}
                              for r in sel]
        return e

    def rentry(name, src_line):
        """The bf16 sweep of phase 2c: one coupling net per lj22k block
        through coupling_reverse(use_pallas=True), summed over the blocks
        that take this kernel."""
        sel = [r for r in rrows if r.get("sweep") and r["name"] == name
               and r["mode"] == "bf16"]
        return {"name": name, "route": "cuda",
                "source": "flowavenet_tpu_torch/ops/csrc/resblock.cu",
                "replaces": f"flowavenet_tpu/ops/pallas_resblock.py:{src_line}",
                "launches": r_launches.get(name, 0),
                "launches_from": ("phase 2c, one bf16 coupling net per lj22k "
                                  "block through coupling_reverse(use_pallas"
                                  "=True); no model route runs it"),
                "max_abs_err": max(r["max_abs_err"] for r in sel),
                "ms": sum(r["ms"] for r in sel),
                "kernel_ms": sum(r["kernel_ms"] for r in sel),
                "plain_ms": sum(r["plain_ms"] for r in sel),
                "bound_ms": sum(r["bound_ms"] for r in sel),
                "bound_by": "operations" if all(
                    r["bound_by"] == "operations" for r in sel) else "bytes",
                "library_ms": None,
                "per_block": [{k: r[k] for k in ("block", "t_tile", "ctas",
                                                 "ms", "kernel_ms",
                                                 "bound_ms")}
                              for r in sel]}

    kernels = [
        entry("pair_flow", "bf16", 410, launches["pair_flow"], range(3, 4)),
        {**entry("pair_flow_i8", "int8", 514, launches["pair_flow_i8"],
                 range(5)), "batch_shape": i8_batch},
        ventry("pair_flow_i8rs", 546, "int8"),
        ventry("pair_flow_hoisted", 591, "bf16"),
        ventry("pair_flow_hoisted_i8", 575, "int8"),
        ventry("pair_flow_wino", 1279, "bf16", "pair_flow_wino.cu"),
        ventry("pair_flow_wino4", 1279, "bf16", "pair_flow_wino.cu"),
        ventry("pair_flow_wino_hoisted", 1378, "bf16", "pair_flow_wino.cu",
               swept=True),
        ventry("pair_flow_wino4_hoisted", 1378, "bf16", "pair_flow_wino.cu",
               swept=True),
        tentry("pair_fwd", "flowavenet_tpu/ops/pallas_flow.py:1565", "pfw",
               "pfw_err", tr["eval"]["fwd_kernel"]["launches"], range(4)),
        tentry("pair_train_fwd",
               "flowavenet_tpu/ops/pallas_flow_train.py:144", "fwd",
               "fwd_err", tr["routes"]["kernel"]["launches"].get(
                   "pair_train_fwd", 0), range(n_tr)),
        tentry("pair_train_bwd",
               "flowavenet_tpu/ops/pallas_flow_train.py:462", "bwd",
               "bwd_err", tr["routes"]["kernel"]["launches"].get(
                   "pair_train_bwd", 0), range(n_tr)),
        rentry("resblock", 58),
        rentry("resblock_v2", 278)]
    # device memory of one launch besides inputs and outputs, as phase 4's
    # bf16 launches at lj22k block 0 (the FWN_TRAIN_KERNEL=1 route's
    # geometry) allocated it
    row0 = next(r for r in trows if r["block"] == 0 and r["mode"] == "bf16")
    for k in kernels:
        if k["name"] in pft.TRAIN_KERNELS:
            k.update(row0["launch"][k["name"]])
            print(f"{k['name']} bf16 per launch at lj22k block 0: tile "
                  f"{k['t_tile']} rows, {k['ctas']} CTAs, workspace "
                  f"{k['workspace_bytes'] / 1e6:.1f} MB, gradient slabs "
                  f"{k.get('slab_bytes', 0) / 1e6:.1f} MB", flush=True)
        if k["name"] == "pair_fwd":
            # the FWN_FWD_KERNEL=1 route runs it on blocks 0-3
            k["per_block"] = [{"block": r["block"], "T_k": r["T_k"],
                               **r["launch"]["pair_fwd"],
                               "ms": r["pfw_ms"]}
                              for r in trows if r["mode"] == "bf16"]
            for b in k["per_block"]:
                print(f"pair_fwd bf16 block {b['block']} T_k={b['T_k']}: "
                      f"tile {b['t_tile']} rows, {b['ctas']} CTAs, "
                      f"workspace {b['workspace_bytes']} bytes, "
                      f"{b['ms']:.3f} ms per launch", flush=True)
    for k in kernels:
        k["design"] = ("tensor cores (mma.sync)"
                       if uses_tensor_cores(torch.bfloat16) else "CUDA cores")
        k.update(attrs.get(k["name"], {}))
        k["pct_of_bound"] = 100.0 * k["bound_ms"] / k["ms"]
    check(all(k["launches"] > 0 for k in kernels),
          ("a kernel of the main paths was never launched", kernels))
    # phase 8's launches by kernel: per tiny reverse of each gate route,
    # and the bf16 FWN_TRAIN_KERNEL=1 step of tiny
    gate_launches = {}
    for r, v in gate["gate"]["routes"].items():
        for name, n in v["launches"].items():
            gate_launches.setdefault(name, {})[r] = n
    for name, n in gate["tiny_bf16_kernel_step"]["launches"].items():
        gate_launches.setdefault(name, {})["tiny bf16 step"] = n
    for k in kernels:
        if k["name"] in gate_launches:
            k["quality_gate_launches"] = gate_launches[k["name"]]
    rk, rp = tr["routes"]["kernel"], tr["routes"]["plain"]
    routes = main_out["routes"]
    print(json.dumps({"main_path": {
        **{k: v for k, v in serve_out.items()},
        "khz_per_s_int8_route": main_out["khz_per_s_i8"],
        "reverse_ms_int8_route": routes["int8"]["ms"],
        "reverse_ms_bf16_route": routes["FWN_INT8=0"]["ms"],
        "reverse_ms_plain_route": main_out["wall_ms_plain"],
        "reverse_ms_by_route": {k: r["ms"] for k, r in routes.items()},
        "route_agreement": {k: (r["rel_to_plain"], r["corr_to_plain"])
                            for k, r in routes.items()},
        "odd_width_route_agreement": odd_out,
        "calls_ms_int8_route": routes["int8"]["walls_ms"],
        "calls_ms_bf16_route": routes["FWN_INT8=0"]["walls_ms"],
        "calls_ms_plain_route": main_out["walls_ms_plain"],
        "train_step_ms_kernel_route": rk["ms"],
        "train_step_ms_plain_route": rp["ms"],
        "train_steps_ms_kernel_route": rk["walls"],
        "train_steps_ms_plain_route": rp["walls"],
        "train_samples_per_s_kernel_route": rk["samples_per_s"],
        "train_samples_per_s_plain_route": rp["samples_per_s"],
        "train_max_mem_gb_kernel_route": rk["max_mem_gb"],
        "train_max_mem_gb_plain_route": rp["max_mem_gb"],
        "train_step_by_product_path": {"kernel route": rk["paths"],
                                       "plain route": rp["paths"]},
        "train_first_loss_rel": tr["loss_rel"],
        "train_first_loss_rel_to_fp32": tr["loss_rel_fp32"],
        "train_grad_cos_fp32": tr["grad_cos"],
        "train_grad_cos_bf16_to_fp32": tr["grad_cos_bf16"],
        "ddi_s": tr["ddi_s"],
        "eval_ms_fwd_kernel_route": tr["eval"]["fwd_kernel"]["ms"],
        "eval_ms_plain_route": tr["eval"]["plain"]["ms"],
        "resblock_route_grad_cos_min": r_grads,
        "batch_composition_gap": comp,
        "route_invariance": invariance,
        "batch_invariance_cost": cost,
        "profile_split_reverse_int8_route": prof_out,
        "profile_split_train_step_kernel_route": tr["profile_split"],
        "profile_split_train_step_synthesis_products":
            tr["profile_split_synthesis_products"],
        "bench": bench_out,
        "frontend": {k: v for k, v in front.items() if k != "data_dir"},
        "trainer": trainer,
        "hoisted_i8_batch_tiles": brows,
        "gin": gin,
        "quality_gate": gate,
        "scale_out": {"native_loader": native, "nccl_world_size_1": nccl,
                      "gloo_two_ranks": gloo, "data_parallel": dp_out},
        "seconds": time.perf_counter() - t_start}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
