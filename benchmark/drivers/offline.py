"""Offline batch vocoding: one caller sends batches of utterances through
``dispatch_mels`` (device noise, 16-bit audio on the device) and reads each
back with ``materialize_wavs``, queueing batch i + 1 before it waits for
batch i.

Traffic parameters: ``batch`` (rows per call), ``lengths`` (the utterance
length distribution; every batch holds its ``batch`` quantiles, in an order
drawn from the seed, so every batch and every seed asks the same work),
``bucket_frames`` (the package's padding bucket), ``check_rows`` (rows
compared with the reference, the longest among them) and
``trace_batches`` (batches under the profiler in a traced run).

End-to-end: ``synth_rtf``, seconds of requested audio (padding not counted)
per second of the window, which runs from the first dispatch until the
last batch dispatched before ``--seconds`` has been read back.
"""

from __future__ import annotations

import time

import torch

from fwbench import traffic as tg
from fwbench import verify, weights


class Inputs:
    """The run's utterances: lengths from the traffic's quantiles, mels from
    one pool, noise seeds and speakers drawn from the seed."""

    def __init__(self, run, cfg):
        t = run.cell.traffic
        self.seed = run.seed
        self.batch = t["batch"]
        self.sr, self.hop = cfg.audio.sample_rate, cfg.audio.hop_size
        secs = tg.length_quantiles(t["lengths"], self.batch)
        self.frames = tg.frames_of(secs, self.sr, self.hop)
        self.pool = tg.mel_pool(run.seed, cfg.model.num_mels)
        self.n_speakers = (cfg.model.n_speakers if cfg.model.gin_channels > 0
                           else 0)

    def __call__(self, j: int) -> dict:
        g = tg.rng(self.seed, 1000 + j)
        frames = tg.shuffled(self.frames, g)
        offsets = g.integers(0, tg.MEL_POOL_FRAMES, self.batch)
        seeds = g.integers(0, 2 ** 32, self.batch)
        spk = (g.integers(0, self.n_speakers, self.batch)
               if self.n_speakers else None)
        return {"frames": [int(f) for f in frames],
                "mels": [tg.mel_at(self.pool, o, f)
                         for o, f in zip(offsets, frames)],
                "seeds": [int(s) for s in seeds],
                "speakers": None if spk is None else [int(s) for s in spk]}


def execute(run) -> None:
    from fwbench.cells import port_config
    from flowavenet_tpu_torch.synthesis.synthesize import (dispatch_mels,
                                                           materialize_wavs)
    cell, t = run.cell, run.cell.traffic
    cfg = port_config(cell.config)
    dev = run.device
    dt = getattr(torch, cell.config["precision"]["serve_weights"])
    params = weights.make(cell.config, run.seed, dev, dt)
    inputs = Inputs(run, cfg)
    hop = cfg.audio.hop_size

    done = []
    record = [True]              # the window's spans and counters

    def dispatch(inp):
        with run.span("dispatch", record[0]):
            return dispatch_mels(params, cfg, inp["mels"], seed=inp["seeds"],
                                 speaker_ids=inp["speakers"], noise="device",
                                 pcm16=True, bucket_frames=t["bucket_frames"],
                                 device=dev)

    def finish(j, inp, wav, frames):
        with run.span("materialize", record[0]):
            rows = materialize_wavs(wav, frames, cfg)
        if not record[0]:
            return
        run.count("synth.batches")
        run.count("synth.rows", len(rows))
        run.count("synth.requested_samples", sum(len(r) for r in rows))
        run.count("synth.padded_samples", wav.shape[0] * wav.shape[1])
        done.append((inp, int(wav.shape[1]) // hop, rows))

    # warm-up: every batch has the same lengths, so one batch holds every
    # shape the window uses
    record[0] = False
    finish(-1, None, *dispatch(inputs(-1)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    record[0] = True

    run.window_started()
    t0 = time.perf_counter()
    n = pipeline(inputs, dispatch, finish, 0,
                 lambda j: time.perf_counter() - t0 >= run.seconds)
    run.window_s = time.perf_counter() - t0
    run.attempted = n * inputs.batch
    run.failed = run.attempted - int(run.counters.get("synth.rows", 0))
    run.end_to_end["synth_rtf"] = (run.counters["synth.requested_samples"]
                                   / cfg.audio.sample_rate / run.window_s)
    if run.trace:
        # the traced stretch follows the window: trace_batches more
        # batches the same way, under the profiler
        record[0] = False
        run.tracer.start()
        pipeline(inputs, dispatch, finish, n,
                 lambda j: j >= n + t["trace_batches"])
        run.tracer.stop()
        run.counters["trace.batches"] = t["trace_batches"]
    run.notes["batch_rows"] = inputs.batch
    run.notes["batch_pad_frames"] = done[0][1] if done else 0
    run.notes["diag"] = {
        "batches": int(run.counters["synth.batches"]),
        "pad_frames": run.notes["batch_pad_frames"],
        "padded_share": (run.counters["synth.requested_samples"]
                         / run.counters["synth.padded_samples"])}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    run.notes["items"] = _sample(run, done, cfg)
    del params, done


def pipeline(inputs, dispatch, finish, j: int, stop) -> int:
    """Dispatch batch j + 1 before reading back batch j, from batch ``j``
    until ``stop(j)`` holds before a dispatch; returns the next batch
    index."""
    pending = None
    while not stop(j):
        inp = inputs(j)
        wav, frames = dispatch(inp)
        if pending is not None:
            finish(*pending)
        pending = (j, inp, wav, frames)
        j += 1
    if pending is not None:
        finish(*pending)
    return j


def _sample(run, done: list, cfg) -> list:
    """``check_rows`` completed rows drawn from the seed, and the longest."""
    hop, sq = cfg.audio.hop_size, cfg.model.squeeze_factor
    bucket = run.cell.traffic["bucket_frames"]
    flat = []
    for inp, pad_got, rows in done:
        usable = [tg.usable_frames(f, hop, sq) for f in inp["frames"]]
        pad = tg.padded_frames(max(usable), bucket, hop, sq)
        for i, row in enumerate(rows):
            flat.append({"mel": inp["mels"][i][: usable[i]],
                         "seed": inp["seeds"][i],
                         "speaker": (None if inp["speakers"] is None
                                     else inp["speakers"][i]),
                         "pad_frames": pad, "pad_got": pad_got,
                         "got": row})
    if not flat:
        return []
    g = tg.rng(run.seed, 7)
    n = min(run.cell.traffic["check_rows"], len(flat))
    pick = list(g.choice(len(flat), n, replace=False))
    longest = max(range(len(flat)), key=lambda k: len(flat[k]["mel"]))
    if longest not in pick:
        pick[0] = longest
    return [flat[k] for k in pick]


def verify_run(run, control: bool = False) -> None:
    items = run.notes["items"]
    if not items:
        run.check("rel_rms", float("inf"))
        return
    # the program must pad each row as the package's bucketing says
    run.check("pad_mismatch_rows", sum(it["pad_got"] != it["pad_frames"]
                                       for it in items))
    verify.check_synthesis(run, items, control=control)

