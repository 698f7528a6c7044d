"""Exact-likelihood training through the package's ``make_train_step`` and
its loader, ``CropDataset`` (prefetch thread) over records of a seeded
speech-like corpus written at set-up.

Set-up builds the train state from the seed's weights, runs DDI on the
loader's batch 0 and drives the state through ``checked_steps`` steps of
the window's own call and feed (as ``train()`` does: batch 0 again first),
keeping what the check reads; the same state then runs the window.  The
loop synchronizes only at the window's end (and, in a traced run, where
the trace closes).

Traffic parameters: ``batch`` and ``crop_samples`` (the step's shape),
``corpus`` (utterances and their length distribution), ``checked_steps``,
``trace_steps``, ``prefetch``, ``reference_rows`` (rows per block of the
reference's gradient).

End-to-end: ``train_ksamples_per_s``, audio samples trained on (batch x
crop) over every step of the window, per second of the window.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from fwbench import records, verify, weights
from fwbench import traffic as tg
from fwbench.references import load as load_reference


def corpus(run, cfg) -> list:
    """(audio, mel, speaker) of the corpus's utterances: LJ lengths in an
    order drawn from the seed, speech-like audio through the frontend."""
    spec = run.cell.traffic["corpus"]
    g = tg.rng(run.seed, 3)
    secs = tg.shuffled(tg.length_quantiles(spec["lengths"],
                                           spec["utterances"]), g)
    audio = run.cell.config["audio"]
    n_sp = (cfg.model.n_speakers if cfg.model.gin_channels > 0 else 1)
    out = []
    for i, s in enumerate(secs):
        wav = records.speech_wav(g, float(s), audio["sample_rate"])
        a, m = records.process_wav(wav, audio)
        out.append((a, m, i % n_sp))
    return out


def _flowavenet_only(cell) -> None:
    """Refuse, before set-up, a configuration of another family:
    ``reference_steps`` passes FloWaveNet's ``logs_hinge`` and
    ``verify_run`` reads its ``blocks/<n_block - 1>/`` leaves."""
    if cell.config["reference"] != "flowavenet":
        raise NotImplementedError(
            f"{cell.name}: the training driver's reference step is "
            f"FloWaveNet's, and the configuration's family is "
            f"{cell.config['reference']!r}")


def execute(run) -> None:
    _flowavenet_only(run.cell)
    from fwbench.cells import port_config
    from flowavenet_tpu_torch.data.dataset import CropDataset

    cell, t = run.cell, run.cell.traffic
    cfg = port_config(cell.config, batch_size=t["batch"],
                      max_time_steps=t["crop_samples"])
    dev = run.device
    utts = corpus(run, cfg)
    tmp = tempfile.mkdtemp(prefix="fwbench-train-")
    try:
        path = os.path.join(tmp, "train.fwrec")
        records.write_records(path, utts)
        data = CropDataset(path, hop_size=cfg.audio.hop_size,
                           max_time_steps=t["crop_samples"],
                           batch_size=t["batch"], seed=run.seed,
                           with_speaker=cfg.model.gin_channels > 0)
        _train(run, cfg, dev, data, utts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _train(run, cfg, dev, data, utts) -> None:
    from flowavenet_tpu_torch.training.optimizer import make_optimizer
    from flowavenet_tpu_torch.training.train import to_device
    from flowavenet_tpu_torch.training.train_state import (TrainState,
                                                           ddi_initialize,
                                                           make_train_step)
    from flowavenet_tpu_torch.utils.tree import leaves
    t = run.cell.traffic
    params = weights.make(run.cell.config, run.seed, dev, torch.float32)
    opt = make_optimizer(cfg.train)
    state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                       params, opt.init(params))
    del params
    state = ddi_initialize(state, cfg, to_device(data.batch_at(0), dev))
    # what the check reads is kept on the host, out of the card's peak
    p0 = [p.detach().cpu() for p in leaves(state.params)]
    step = make_train_step(cfg)
    feed = data.iterate(start_step=0, prefetch=t["prefetch"])
    losses, g1 = [], None
    b1 = cfg.train.adam_b1
    for s in range(t["checked_steps"]):
        state, met = step(state, to_device(next(feed), dev))
        losses.append(met["loss"])
        if s == 0:
            # the first gradient as the optimizer took it: Adam's first
            # moment after one step is (1 - b1) g
            g1 = [(m.detach() / (1.0 - b1)).cpu()
                  for m in leaves(state.opt_state[1].mu)]
    p3 = [p.detach().cpu() for p in leaves(state.params)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.notes["prog"] = {"losses": [float(x) for x in losses],
                         "g1": g1, "p0": p0, "p3": p3}

    def one(record: bool):
        with run.span("data_wait", record):
            batch = to_device(next(feed), dev)
        with run.span("train_step", record):
            new, met = step(state, batch)
        return new, met["skipped_nonfinite"]

    run.window_started()
    skipped = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        state, sk = one(True)
        skipped.append(sk)
        run.attempted += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.window_s = time.perf_counter() - t0
    if run.trace:
        # the traced stretch follows the window: trace_steps more steps
        run.tracer.start()
        for _ in range(t["trace_steps"]):
            state, _ = one(False)
        run.tracer.stop()
        run.counters["trace.steps"] = t["trace_steps"]
    feed.close()
    samples = run.attempted * t["batch"] * t["crop_samples"]
    run.counters["train.samples"] = samples
    run.counters["train.steps"] = run.attempted
    run.failed = int(round(float(torch.stack(skipped).float().sum()))) \
        if skipped else 0
    run.end_to_end["train_ksamples_per_s"] = samples / run.window_s / 1e3
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.notes["utts"] = utts
    del state, step, skipped


def reference_steps(run, prec=None) -> dict:
    """The reference from the same weights and crops: its own DDI on batch
    0, then the checked steps on batches 0, 1, ... as the loader gave them."""
    cell, t = run.cell, run.cell.traffic
    model, tc = cell.model, cell.config["train"]
    ref = load_reference(cell.config["reference"])
    ref.no_tf32()
    dev = run.device
    hop = cell.config["audio"]["hop_size"]
    gin = model["gin_channels"] > 0

    def batch(step):
        b = records.crop_batch(run.notes["utts"], step, run.seed, t["batch"],
                               t["crop_samples"], hop)
        out = {"audio": torch.from_numpy(b["audio"]).to(dev),
               "mel": torch.from_numpy(b["mel"]).to(dev)}
        if gin:
            out["speaker"] = torch.from_numpy(b["speaker"]).to(dev)
        return out

    raw = weights.make(cell.config, run.seed, dev, torch.float32)
    b0 = batch(0)
    params = ref.ddi(raw, model, b0["audio"], b0["mel"], b0.get("speaker"))
    del raw
    p0 = [p.clone() for p in ref.leaves(params)]
    opt = ref.Adam(tc["learning_rate"], tc["grad_clip_norm"], tc["adam_b1"],
                   tc["adam_b2"], tc["adam_eps"])
    nll, g1 = [], None
    for s in range(t["checked_steps"]):
        params, _, n, g = ref.train_step(
            params, opt, model, b0 if s == 0 else batch(s), pr=prec,
            rows=t["reference_rows"], logs_hinge=tc["logs_hinge"],
            actnorm_hinge=tc["actnorm_hinge"])
        nll.append(n)
        if s == 0:
            g1 = g
    return {"losses": nll, "g1": g1, "p0": p0, "p3": ref.leaves(params)}


def verify_run(run, control: bool = False) -> None:
    """Compared, each as the median leaf's gap: the first gradient, the
    change after the checked steps, and the first gradient of the last
    block (where a row adds the fewest positions to each leaf, so the
    leaves follow the rows the step saw).  The losses and the worst leaf's
    gaps are kept as readings (PERF.md says why they are not compared)."""
    want = reference_steps(run)
    if control:
        ref = load_reference(run.cell.config["reference"])
        got = reference_steps(run, ref.Prec("lower"))
    else:
        got = run.notes["prog"]
    losses = [abs(a - b) for a, b in zip(got["losses"], want["losses"])]
    gg = verify.leaf_gaps(got["g1"], want["g1"])
    norms = [float(g.norm()) for g in want["g1"]]
    med = float(np.median(norms))
    # leaves whose reference gradient is nought to rounding move under Adam
    # by round-off alone: left out of the change
    keep = [i for i, n in enumerate(norms) if n >= 1e-3 * med]
    d_got = [a.float() - b.float() for a, b in zip(got["p3"], got["p0"])]
    d_want = [a - b for a, b in zip(want["p3"], want["p0"])]
    cg = verify.leaf_gaps(d_got, d_want, keep)
    paths = weights.leaf_paths(run.cell.config)
    last = f"blocks/{run.cell.model['n_block'] - 1}/"
    run.check("grad_gap", float(np.median(gg)))
    run.check("change_gap", float(np.median(cg)))
    run.check("grad_gap_last_block", float(np.median(
        [x for x, p in zip(gg, paths) if p.startswith(last)])))
    wg, wc = int(np.argmax(gg)), keep[int(np.argmax(cg))]
    dn = [float(d.norm()) for d in d_want]
    run.notes["diag"] = {
        "loss_gaps": losses, "losses": got["losses"],
        "ref_losses": want["losses"],
        "grad_gap_worst": [max(gg), paths[wg], norms[wg] / med],
        "change_gap_worst": [max(cg), paths[wc],
                             dn[wc] / float(np.median(dn))],
        "leaves_compared": len(keep), "leaves": len(norms)}
    run.notes["leaf_gaps"] = {"grad": gg, "change": cg, "paths": paths,
                              "keep": keep, "norms": norms}

