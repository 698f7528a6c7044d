"""PyTorch port, the serving layer (serving/server.py): a
``SynthesisService(device="cpu")`` behind the HTTP handler on
127.0.0.1:0, on the tiny config's plain route in fp32, and its audio held
against the JAX package's ``dispatch_mels``."""

import dataclasses
import io
import json
import threading
import wave
from http.client import HTTPConnection

import jax
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import tiny as jtiny
from flowavenet_tpu.models.flowavenet import init_flowavenet as jinit
from flowavenet_tpu.synthesis import synthesize as jsyn
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.config import tiny
from flowavenet_tpu_torch.parallel.mesh import make_data_mesh
from flowavenet_tpu_torch.serving import server as tsrv
from flowavenet_tpu_torch.synthesis import streaming as tst

HOP = 256


def _plain(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 use_pallas=False))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _plain(jtiny()), _plain(tiny())
    params = jinit(jax.random.PRNGKey(0), jcfg.model)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(3)
    params = jax.tree.unflatten(treedef, [
        np.asarray(l) + 0.05 * r.randn(*l.shape).astype(np.float32)
        for l in leaves])
    return jcfg, cfg, params, to_torch(params)


def _start(tp, cfg, **kw):
    httpd = tsrv.serve(tp, cfg, port=0, bucket_frames=8, max_frames=24,
                       device="cpu", **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _stop(httpd):
    httpd.shutdown()
    httpd.service.close()


@pytest.fixture(scope="module")
def server(model):
    """max_frames 24 routes longer mels to the stream."""
    _, cfg, _, tp = model
    httpd = _start(tp, cfg, max_batch=4, batch_window_ms=20.0)
    yield httpd
    _stop(httpd)


def _mel(frames, seed):
    return np.random.RandomState(seed).rand(frames, 80).astype(np.float32)


def _post(httpd, path, mel, **headers):
    buf = io.BytesIO()
    np.save(buf, mel)
    body = buf.getvalue()
    c = HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=120)
    c.request("POST", path, body=body, headers={
        "Content-Length": str(len(body)),
        **{f"X-{k.title()}": str(v) for k, v in headers.items()}})
    r = c.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def _get(httpd, path):
    c = HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=30)
    c.request("GET", path)
    r = c.getresponse()
    return r.status, json.loads(r.read())


def _samples(wav_bytes):
    w = wave.open(io.BytesIO(wav_bytes))
    assert w.getsampwidth() == 2 and w.getframerate() == 22050
    return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _post_many(httpd, reqs):
    """POST (mel, seed) pairs concurrently; returns the bodies in order."""
    out = [None] * len(reqs)

    def go(i, mel, seed):
        out[i] = _post(httpd, "/synthesize", mel, seed=seed)

    ts = [threading.Thread(target=go, args=(i, m, s))
          for i, (m, s) in enumerate(reqs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(o[0] == 200 for o in out), [o[0] for o in out]
    return [o[2] for o in out]


def test_healthz_stats_and_unknown_path(server):
    code, h = _get(server, "/healthz")
    assert code == 200 and h["status"] == "ok" and h["model"] == "2x2"
    assert h["device"] == "cpu" and h["num_mels"] == 80
    code, s = _get(server, "/stats")
    assert code == 200 and "dispatches" in s
    code, _ = _get(server, "/nope")
    assert code == 404
    code, _, body = _post(server, "/synthesize", np.zeros((8, 3), np.float32))
    assert code == 400 and b"mel must be" in body


def test_round_trip_length_and_finite(server):
    code, hdr, body = _post(server, "/synthesize", _mel(13, 0), seed=1)
    assert code == 200 and hdr["Content-Type"] == "audio/wav"
    assert int(hdr["Content-Length"]) == len(body)
    pcm = _samples(body)
    assert pcm.shape == (13 * HOP,) and np.abs(pcm).max() > 0


def test_batch_composition_invariance(model):
    """Four requests of one bucket (17-24 frames, padded to 24) land in one
    drain (max_batch 4 closes it as soon as they are in; the 30 s window
    only bounds the wait); the first, re-posted beside three other
    companions of the same bucket, comes back bit-identical (the same pow2
    batch of 4 at the same length: its noise and arithmetic do not depend
    on its companions)."""
    _, cfg, _, tp = model
    httpd = _start(tp, cfg, max_batch=4, batch_window_ms=30000.0)
    svc = httpd.service
    a = [(_mel(f, 10 + i), 100 + i) for i, f in enumerate((17, 20, 22, 24))]
    b = [a[0]] + [(_mel(f, 20 + i), 200 + i)
                  for i, f in enumerate((23, 18, 21))]
    try:
        first = _post_many(httpd, a)
        assert svc.stats["dispatches"] == 1        # one drain, one group
        assert svc.stats["max_dispatch_rows_seen"] == 4
        second = _post_many(httpd, b)
        assert svc.stats["dispatches"] == 2
    finally:
        _stop(httpd)
    assert second[0] == first[0]
    assert all(len(_samples(x)) == f * HOP
               for x, f in zip(first, (17, 20, 22, 24)))


def test_queue_wait_and_dispatch_spans(model):
    """N requests posted at once: each waits in the queue until the worker
    drains it (``queue_wait_seconds`` > 0), and the worker's
    ``fwn.serve.dispatch`` spans hold all N requests between them."""
    from flowavenet_tpu_torch.utils import profiling
    _, cfg, _, tp = model
    seq0 = max((s.seq for s in profiling.spans()), default=0)
    httpd = _start(tp, cfg, max_batch=2, batch_window_ms=20.0)
    svc = httpd.service
    n = 5
    try:
        _post_many(httpd, [(_mel(9 + i, 40 + i), 300 + i) for i in range(n)])
    finally:
        _stop(httpd)
    assert svc.stats["requests"] == n
    assert svc.stats["queue_wait_seconds"] > 0
    spans = [s for s in profiling.spans()
             if s.seq > seq0 and s.name == "fwn.serve.dispatch"]
    assert len(spans) == svc.stats["dispatches"]
    assert sum(s.attrs["requests"] for s in spans) == n
    inner = [s for s in profiling.spans() if s.seq > seq0
             and s.name == "fwn.synth.dispatch"]
    assert {s.parent for s in inner} == {s.seq for s in spans}


def test_per_request_seed_and_temp(server):
    """X-Seed picks the noise (different seeds, different audio; the same
    seed, the same bytes); X-Temp scales it (temp 0: the audio no longer
    depends on the seed)."""
    mel = _mel(9, 3)
    s1 = _post(server, "/synthesize", mel, seed=1)[2]
    s1b = _post(server, "/synthesize", mel, seed=1)[2]
    s2 = _post(server, "/synthesize", mel, seed=2)[2]
    assert s1 == s1b and s1 != s2
    t0a = _post(server, "/synthesize", mel, seed=1, temp=0.0)[2]
    t0b = _post(server, "/synthesize", mel, seed=7, temp=0.0)[2]
    assert t0a == t0b and t0a != s1


def test_synthesize_stream_and_long_mel_routing(server, model):
    """/synthesize_stream returns a progressive WAV with exact
    Content-Length holding the streaming path's audio; a mel longer than
    max_frames on /synthesize is streamed server-side with the same
    bytes."""
    _, cfg, _, tp = model
    mel = _mel(48, 11)
    n0 = server.service.stats["streams"]
    code, hdr, body = _post(server, "/synthesize_stream", mel, seed=5,
                            chunk_frames=8)
    assert code == 200 and int(hdr["Content-Length"]) == len(body)
    ref = tst.synthesize_streaming(tp, cfg, mel, seed=5, chunk_frames=8,
                                   device="cpu")
    np.testing.assert_array_equal(
        _samples(body), np.clip(np.rint(ref * 32768.0), -32768, 32767))
    code, hdr, long_body = _post(server, "/synthesize", mel, seed=5)
    assert code == 200 and int(hdr["Content-Length"]) == len(long_body)
    ref = tst.synthesize_streaming(tp, cfg, mel, seed=5, device="cpu")
    np.testing.assert_array_equal(
        _samples(long_body), np.clip(np.rint(ref * 32768.0), -32768, 32767))
    assert server.service.stats["streams"] == n0 + 2


def test_close_rejects_and_fails_fast(model):
    """After close(): new submits raise at once, and a queued request that
    was never dispatched fails instead of sitting out its timeout; a
    service over a data mesh serves and closes the same way."""
    _, cfg, _, tp = model
    svc = tsrv.SynthesisService(tp, cfg, max_batch=2, batch_window_ms=5.0,
                                device="cpu")
    mel = _mel(8, 2)
    assert svc.submit(mel).dtype == np.int16           # device noise, pcm16
    with pytest.raises(ValueError, match="mel too long"):
        svc.submit(np.zeros((svc.max_frames + 1, 80), np.float32))
    svc.close()
    with pytest.raises(RuntimeError, match="service closed"):
        svc.submit(mel)
    ghost = tsrv._Request(mel, 0, None, None)
    svc._q.put(ghost)
    svc.close()
    assert ghost.done.is_set() and ghost.error == "service closed"
    # a data-parallel service (two CPU replicas) closes the same way
    msvc = tsrv.SynthesisService(tp, cfg, max_batch=2, batch_window_ms=5.0,
                                 mesh=make_data_mesh(["cpu", "cpu"]))
    assert msvc.submit(mel).dtype == np.int16
    assert msvc.stats["data_parallel"] == 2
    msvc.close()
    with pytest.raises(RuntimeError, match="service closed"):
        msvc.submit(mel)


def test_service_audio_matches_jax_dispatch(model):
    """Host noise, fp32: a service's audio equals the JAX package's
    dispatch_mels for the same group (pow2-padded, bucket 8) to rel-to-max
    5e-5 (the port's plain-route bar against JAX); device noise and pcm16
    (the serving defaults) equal JAX's within one PCM step."""
    jcfg, cfg, params, tp = model
    mels = [_mel(12, 1), _mel(9, 2), _mel(15, 3)]
    want, frames = jsyn.dispatch_mels(params, jcfg, mels, seed=[4, 5, 6],
                                      temp=[0.6, None, 0.8], bucket_frames=8,
                                      pad_batch=True)
    want = jsyn.materialize_wavs(want, frames, jcfg)
    got = tsrv.SynthesisService(tp, cfg, max_batch=3,
                                batch_window_ms=30000.0, bucket_frames=8,
                                noise="host", device="cpu")
    out = [None] * 3

    def go(i):
        out[i] = got.submit(mels[i], seed=4 + i, temp=[0.6, None, 0.8][i])

    ts = [threading.Thread(target=go, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    got.close()
    assert got.stats["dispatches"] == 1
    for g, w in zip(out, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max()
    dw, fr = jsyn.dispatch_mels(params, jcfg, mels[:1], seed=[4],
                                bucket_frames=8, pad_batch=True,
                                noise="device", pcm16=True)
    jq = jsyn.materialize_wavs(dw, fr, jcfg)[0]
    svc = tsrv.SynthesisService(tp, cfg, bucket_frames=8, device="cpu")
    tq = svc.submit(mels[0], seed=4)
    svc.close()
    assert tq.dtype == np.int16
    assert np.abs(tq.astype(int) - jq).max() <= 1


def test_service_needs_cuda_unless_cpu(model, monkeypatch):
    _, cfg, _, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsrv.SynthesisService(tp, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsrv.serve(tp, cfg, port=0)
