"""PyTorch port, data-parallel inference (parallel/mesh.py:DataMesh and the
``data_sharding`` / ``batch_multiple`` / ``mesh`` paths of synthesis and
serving): a data mesh of repeated CPU devices gives the one-device audio,
its row padding is the JAX package's, and the service reports its extent.
On the CPU a row's bits follow the batch size by <= 3e-8 (ROADMAP Queue
3), so the comparisons with one device take atol 1e-6."""

import dataclasses
import json
import threading
from http.client import HTTPConnection

import jax
import numpy as np
import pytest

from flowavenet_tpu.config import tiny as jtiny
from flowavenet_tpu.models.flowavenet import init_flowavenet as jinit
from flowavenet_tpu.synthesis import synthesize as jsyn
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.config import tiny
from flowavenet_tpu_torch.parallel.mesh import make_data_mesh
from flowavenet_tpu_torch.serving import server as tsrv
from flowavenet_tpu_torch.synthesis import streaming as tst
from flowavenet_tpu_torch.synthesis import synthesize as tsyn

ATOL = 1e-6


def _plain(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 use_pallas=False))


@pytest.fixture(scope="module")
def model():
    """Damped random tiny params (JAX's init, perturbed), bridged; the
    default route (the int8 pair's plain version on the CPU)."""
    params = jinit(jax.random.PRNGKey(0), jtiny().model)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(3)
    params = jax.tree.unflatten(treedef, [
        np.asarray(l) + 0.05 * r.randn(*l.shape).astype(np.float32)
        for l in leaves])
    return params, to_torch(params)


def _mel(frames, seed):
    return np.random.RandomState(seed).rand(frames, 80).astype(np.float32)


MELS = [_mel(12, 1), _mel(9, 2), _mel(15, 3)]


@pytest.mark.parametrize("noise", ["host", "device"])
def test_dispatch_over_data_mesh_equals_one_device(model, noise):
    """dispatch_mels over two CPU replicas: 3 mels, pow2-padded to 4 rows,
    2 per device; every row equals the one-device call's."""
    _, tp = model
    cfg = tiny()
    kw = dict(seed=[4, 5, 6], temp=[0.6, None, 0.8], bucket_frames=8,
              pad_batch=True, noise=noise)
    one, frames = tsyn.dispatch_mels(tp, cfg, MELS, device="cpu", **kw)
    mesh = make_data_mesh(["cpu", "cpu"])
    two, frames2 = tsyn.dispatch_mels(tp, cfg, MELS, data_sharding=mesh,
                                      batch_multiple=2, **kw)
    assert frames2 == frames
    assert isinstance(two, list) and [w.shape[0] for w in two] == [2, 2]
    for a, b in zip(tsyn.materialize_wavs(one, frames, cfg),
                    tsyn.materialize_wavs(two, frames, cfg)):
        np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="batch_multiple=2"):
        tsyn.dispatch_mels(tp, cfg, MELS, data_sharding=mesh, **kw |
                           {"pad_batch": False})


@pytest.mark.parametrize("n,pad,multiple", [(3, True, 3), (5, False, 2)])
def test_batch_multiple_pads_as_jax(model, n, pad, multiple):
    """batch_multiple rounds the (pow2-padded) rows up as the JAX package
    does (synthesize.py:248-249), each device of the mesh takes whole rows,
    and the audio is JAX's on the plain route (rel-to-max 5e-5, the port's
    plain-route bar)."""
    params, tp = model
    mels = [_mel(8 + 3 * i, 10 + i) for i in range(n)]
    kw = dict(seed=7, bucket_frames=8, pad_batch=pad,
              batch_multiple=multiple)
    jw, frames = jsyn.dispatch_mels(params, _plain(jtiny()), mels, **kw)
    mesh = make_data_mesh(["cpu"] * multiple)
    tw, tframes = tsyn.dispatch_mels(tp, _plain(tiny()), mels,
                                     data_sharding=mesh, **kw)
    assert tframes == frames
    assert sum(w.shape[0] for w in tw) == jw.shape[0]
    assert len({w.shape[0] for w in tw}) == 1
    want = jsyn.materialize_wavs(jw, frames, _plain(jtiny()))
    got = tsyn.materialize_wavs(tw, frames, _plain(tiny()))
    for a, b in zip(want, got):
        assert np.abs(b - a).max() <= 5e-5 * np.abs(a).max()


@pytest.mark.parametrize("noise", ["host", "device"])
def test_time_parallel_over_data_mesh_equals_one_device(model, noise):
    """synthesize_time_parallel with each pass's rows (3, rounded up to 4)
    split over two CPU replicas gives the one-device audio; rows that do
    not split raise."""
    _, tp = model
    cfg = tiny()
    mel = _mel(70, 5)
    kw = dict(seed=3, chunk_frames=8, rows_per_pass=3, noise=noise)
    one = tst.synthesize_time_parallel(tp, cfg, mel, device="cpu", **kw)
    mesh = make_data_mesh(["cpu", "cpu"])
    two = tst.synthesize_time_parallel(tp, cfg, mel, data_sharding=mesh,
                                       batch_multiple=2, **kw)
    np.testing.assert_allclose(two, one, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="do not split"):
        tst.synthesize_time_parallel(tp, cfg, mel, data_sharding=mesh, **kw)


def _get(port, path):
    conn = HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    return json.loads(conn.getresponse().read())


def test_service_over_data_mesh(model):
    """SynthesisService(mesh=2 CPU replicas): concurrent requests give the
    mesh-less service's audio, a stream its bytes (on the mesh's first
    device), and /stats and /healthz report data_parallel 2."""
    _, tp = model
    cfg = tiny()
    mesh = make_data_mesh(["cpu", "cpu"])
    kw = dict(max_batch=3, batch_window_ms=30000.0, bucket_frames=8,
              noise="host", pcm16=False)
    ref = tsrv.SynthesisService(tp, cfg, device="cpu", **kw)
    httpd = tsrv.serve(tp, cfg, port=0, mesh=mesh, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    svc = httpd.service
    try:
        assert svc.device == mesh.devices[0]
        for s in (ref, svc):
            out = [None] * 3

            def go(i, s=s, out=out):
                out[i] = s.submit(MELS[i], seed=4 + i)

            ts = [threading.Thread(target=go, args=(i,)) for i in range(3)]
            for t in ts:
                t.start()
            for i, t in enumerate(ts):
                t.join(timeout=120)
                assert not t.is_alive(), f"submit of MELS[{i}] still waiting"
            s.out = out
        for a, b in zip(ref.out, svc.out):
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL)
        assert svc.stats["dispatches"] == 1 and svc.stats["requests"] == 3
        long = _mel(40, 9)
        sa = b"".join(ref.stream(long, seed=2, chunk_frames=8)[1])
        sb = b"".join(svc.stream(long, seed=2, chunk_frames=8)[1])
        assert sa == sb
        port = httpd.server_address[1]
        assert _get(port, "/stats")["data_parallel"] == 2
        assert _get(port, "/healthz")["data_parallel"] == 2
        assert ref.stats["data_parallel"] == 1
    finally:
        httpd.shutdown()
        svc.close()
        ref.close()
