"""Open-loop serving: Poisson arrivals at a fixed rate to ``/synthesize`` of
the package's HTTP server (``serving/server.py:serve``), run in this
process on an OS-chosen port of 127.0.0.1, from a client in a child
process (``fwbench/loadgen.py``).

Traffic parameters: ``rate_per_s`` (fixed in the file: four fifths of the
knee a sweep found), ``lengths`` (utterance lengths: the window's requests
take their quantiles), ``order_seed`` (the fixed order of the lengths and
of the arrival gaps, the exponential's quantiles: every run offers the
same schedule), ``server`` (the server's options), ``check_requests`` (served
requests compared with the reference, the longest among them), ``drain_s``
(how long the client waits past the last due time), ``trace_seconds``
(the profiled stretch from the window's start in a traced run) and
``workers`` (client threads).

End-to-end: ``serve_p95_ms``, the 95th percentile over the requests due in
the window of the time from a request's due time to the last byte of its
WAV; a request that failed or never finished counts as infinitely late.
"""

from __future__ import annotations

import base64
import io
import json
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np
import torch

from fwbench import traffic as tg
from fwbench import verify, weights

LOADGEN = Path(__file__).resolve().parents[1] / "fwbench" / "loadgen.py"
NEVER_MS = 1e9          # latency written for a request that never finished


def plan(run, cfg, rate: float, seconds: float) -> list:
    """The window's requests: due times and lengths in the traffic's own
    fixed order (``order_seed``: near capacity the tail follows the order
    of bursts and long requests, so every seed gets the same schedule),
    and the run seed's mels, noise seeds and speakers."""
    t = run.cell.traffic
    o = tg.rng(t["order_seed"], 5)
    due = tg.arrivals(rate, seconds, o)
    secs = tg.shuffled(tg.length_quantiles(t["lengths"], len(due)), o)
    frames = tg.frames_of(secs, cfg.audio.sample_rate, cfg.audio.hop_size)
    g = tg.rng(run.seed, 5)
    offsets = g.integers(0, tg.MEL_POOL_FRAMES, len(due))
    seeds = g.integers(0, 2 ** 31, len(due))
    n_sp = cfg.model.n_speakers if cfg.model.gin_channels > 0 else 0
    spk = g.integers(0, n_sp, len(due)) if n_sp else [None] * len(due)
    return [{"due": float(d), "frames": int(f), "offset": int(o),
             "seed": int(s), "speaker": None if k is None else int(k)}
            for d, f, o, s, k in zip(due, frames, offsets, seeds, spk)]


def _keep(run, reqs: list) -> list:
    g = tg.rng(run.seed, 6)
    n = min(run.cell.traffic["check_requests"], len(reqs))
    pick = [int(i) for i in g.choice(len(reqs), n, replace=False)]
    longest = max(range(len(reqs)), key=lambda i: reqs[i]["frames"])
    if longest not in pick:
        pick[0] = longest
    return pick


def warm_up(service, cfg, t: dict) -> None:
    """Every padded length the lengths can take, at every power-of-two row
    count a drain can group, through the service's own dispatch path."""
    from flowavenet_tpu_torch.synthesis.synthesize import padded_frames
    hop, sr = cfg.audio.hop_size, cfg.audio.sample_rate
    spec = t["lengths"]
    lo = int(tg.frames_of(np.array([spec["min_s"]]), sr, hop)[0])
    hi = int(tg.frames_of(np.array([spec["max_s"]]), sr, hop)[0])
    pads = sorted({padded_frames(f, cfg, t["server"]["bucket_frames"])
                   for f in range(lo, hi + 1)})
    rows, n = [], 1
    while n <= t["server"]["max_batch"]:
        rows.append(n)
        n *= 2
    mel = np.zeros((1, cfg.audio.num_mels), np.float32)
    for pad in pads:
        for r in rows:
            reqs = [SimpleReq(np.repeat(mel, pad, 0), i) for i in range(r)]
            service._dispatch_group(reqs)
            for q in reqs:
                q.done.wait()
                if q.error:
                    raise RuntimeError(q.error)


class SimpleReq:
    """A request as the service's worker hands it to a dispatch."""

    def __init__(self, mel, seed):
        self.mel, self.seed, self.speaker_id, self.temp = mel, seed, None, None
        self.done = threading.Event()
        self.wav = None
        self.error = None


def serve_window(run, cfg, params, rate: float, seconds: float,
                 warm: bool = True) -> dict:
    """Start the server, warm it up, drive one open-loop window; returns
    the client's record and the service's counters at the window's start,
    middle and end."""
    from flowavenet_tpu_torch.serving.server import serve
    t = run.cell.traffic
    httpd = serve(params, cfg, host="127.0.0.1", port=0, device=run.device,
                  **t["server"])
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    service = httpd.service
    child = None
    try:
        if warm:
            t_w = time.perf_counter()
            warm_up(service, cfg, t)
            run.notes["warm_up_s"] = time.perf_counter() - t_w
        reqs = plan(run, cfg, rate, seconds)
        keep = _keep(run, reqs)
        child = subprocess.Popen(
            [sys.executable, str(LOADGEN)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
        child.stdin.write(json.dumps({
            "port": httpd.server_address[1], "seed": run.seed,
            "num_mels": cfg.audio.num_mels, "requests": reqs, "keep": keep,
            "drain_s": t["drain_s"], "workers": t["workers"]}) + "\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        stats = {}
        run.window_started()
        run.tracer.start()
        child.stdin.write("go\n")
        child.stdin.flush()
        t0 = time.perf_counter()
        stats["start"] = dict(service.stats)
        marks = [("trace", t["trace_seconds"]), ("middle", seconds / 2),
                 ("end", seconds)]
        for name, at in sorted(marks, key=lambda m: m[1]):
            time.sleep(max(0.0, t0 + at - time.perf_counter()))
            if name == "trace":
                run.tracer.stop()
            else:
                stats[name] = dict(service.stats)
        out, _ = child.communicate()
        child = None
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(
                run.device)
        rec = json.loads(out)
        return {"reqs": reqs, "keep": keep, "client": rec, "stats": stats}
    finally:
        if child is not None:
            child.kill()
            child.wait()
        httpd.shutdown()
        httpd.server_close()
        service.close()
        server.join(timeout=60)


def latencies_ms(client: dict) -> list:
    out = []
    for r in client["requests"]:
        ok = r["status"] == 200 and r["done"] is not None
        out.append((r["done"] - r["due"]) * 1e3 if ok else float("inf"))
    return out


def outstanding(client: dict, at: float) -> int:
    """Requests due by ``at`` and not finished by then."""
    return sum(1 for r in client["requests"]
               if r["due"] <= at and (r["done"] is None or r["done"] > at))


def execute(run) -> None:
    from fwbench.cells import port_config
    cell, t = run.cell, run.cell.traffic
    cfg = port_config(cell.config)
    dt = getattr(torch, cell.config["precision"]["serve_weights"])
    params = weights.make(cell.config, run.seed, run.device, dt)
    res = serve_window(run, cfg, params, t["rate_per_s"], run.seconds)
    del params
    lat = latencies_ms(res["client"])
    run.window_s = run.seconds
    run.attempted = len(lat)
    run.failed = sum(1 for x in lat if x == float("inf"))
    p95 = tg.percentile(lat, 95.0)
    run.end_to_end["serve_p95_ms"] = p95 if np.isfinite(p95) else NEVER_MS
    s0, s1 = res["stats"]["start"], res["stats"]["end"]
    for k in ("requests", "dispatches", "busy_seconds", "audio_seconds"):
        run.counters[f"service.{k}"] = s1[k] - s0[k]
    sent = [r["sent"] - r["due"] for r in res["client"]["requests"]
            if r["sent"] is not None]
    run.notes["diag"] = {
        "client_late_ms_max": max(sent) * 1e3 if sent else 0.0,
        "p50_ms": tg.percentile(lat, 50.0),
        "outstanding_middle": outstanding(res["client"], run.seconds / 2),
        "outstanding_end": outstanding(res["client"], run.seconds),
        "dispatches": run.counters["service.dispatches"],
        "warm_up_s": run.notes.get("warm_up_s")}
    run.notes["items"] = _items(run, cfg, res)


def _items(run, cfg, res) -> list:
    """The kept requests that finished, with their 16-bit audio."""
    hop, sq = cfg.audio.hop_size, cfg.model.squeeze_factor
    bucket = run.cell.traffic["server"]["bucket_frames"]
    pool = tg.mel_pool(run.seed, cfg.audio.num_mels)
    items = []
    for i in res["keep"]:
        body = res["client"]["kept"].get(str(i))
        if body is None:
            continue
        r = res["reqs"][i]
        with wave.open(io.BytesIO(base64.b64decode(body))) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        usable = tg.usable_frames(r["frames"], hop, sq)
        items.append({"mel": tg.mel_at(pool, r["offset"], r["frames"])[
            :usable], "seed": r["seed"], "speaker": r["speaker"],
            "pad_frames": tg.padded_frames(usable, bucket, hop, sq),
            "got": pcm})
    return items


def verify_run(run, control: bool = False) -> None:
    items = run.notes["items"]
    if not items:
        run.check("rel_rms", float("inf"))
        return
    verify.check_synthesis(run, items, control=control)

