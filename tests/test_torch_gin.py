"""PyTorch port, global (speaker) conditioning through the entry points on
the CPU: ``synthesize_mels`` with speaker ids against the JAX package's
(host noise), the stream, the HTTP service's X-Speaker-Id, a training step
against the JAX package's and the trainer with a speaker corpus, all at the
``tiny_gin`` size."""

import dataclasses
import io
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import tiny_gin as jtiny_gin
from flowavenet_tpu.models.flowavenet import init_flowavenet as jinit
from flowavenet_tpu.synthesis import synthesize as jsyn
from flowavenet_tpu.training import train_state as jts
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.config import tiny_gin
from flowavenet_tpu_torch.data.records import FwRecordWriter
from flowavenet_tpu_torch.serving import server as tsrv
from flowavenet_tpu_torch.synthesis import streaming as tst
from flowavenet_tpu_torch.synthesis import synthesize as tsyn
from flowavenet_tpu_torch.training import optimizer as topt
from flowavenet_tpu_torch.training import train_state as tts
from flowavenet_tpu_torch.training.train import train as ttrain
from flowavenet_tpu_torch.utils.tree import tree_map

HOP = 256


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jtiny_gin(), tiny_gin()
    params = jinit(jax.random.PRNGKey(0), jcfg.model)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(7)
    params = jax.tree.unflatten(treedef, [
        np.asarray(l) + 0.1 * r.randn(*l.shape).astype(np.float32)
        for l in leaves])
    mels = [r.rand(n, 80).astype(np.float32) for n in (12, 7)]
    return jcfg, cfg, params, to_torch(params), mels


def test_synthesize_mels_with_speakers_matches_jax(setup):
    """speaker_ids through dispatch_mels (a gin model runs the plain scans,
    as in the JAX package): fp32, host noise, <= 1e-4 against JAX; the two
    speakers' audio differs; no ids raises as in JAX."""
    jcfg, cfg, params, tp, mels = setup
    want = jsyn.synthesize_mels(params, jcfg, mels, seed=5, speaker_ids=[1, 3],
                                bucket_frames=8)
    got = tsyn.synthesize_mels(tp, cfg, mels, seed=5, speaker_ids=[1, 3],
                               bucket_frames=8, pad_batch=True, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
    other = tsyn.synthesize_mels(tp, cfg, mels[:1], seed=5, speaker_ids=[2],
                                 bucket_frames=8, device="cpu")[0]
    assert np.abs(other - got[0]).max() > 1e-3
    with pytest.raises(ValueError, match="speaker ids"):
        tsyn.synthesize_mels(tp, cfg, mels, device="cpu")


def test_stream_with_speaker_equals_one_shot(setup):
    """stream_reverse and synthesize_time_parallel carry speaker_id into
    every window: the stream equals the one-shot audio of that speaker to
    rel-to-max 1e-5 (as tests/test_torch_streaming.py holds the plain
    route)."""
    _, cfg, _, tp, _ = setup
    mel = np.random.RandomState(2).rand(64, 80).astype(np.float32)
    one = tsyn.synthesize_mels(tp, cfg, [mel], seed=11, speaker_ids=[3],
                               bucket_frames=1, device="cpu")[0]
    kw = dict(seed=11, speaker_id=3, chunk_frames=16, device="cpu")
    for run in (tst.synthesize_streaming, tst.synthesize_time_parallel):
        audio = run(tp, cfg, mel, **kw)
        assert audio.shape == one.shape == (64 * HOP,)
        assert np.abs(audio - one).max() <= 1e-5 * np.abs(one).max()


def _post(port, path, mel, **headers):
    buf = io.BytesIO()
    np.save(buf, mel)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=buf.getvalue(),
        headers={k.replace("_", "-"): str(v) for k, v in headers.items()})
    with urllib.request.urlopen(req) as r:
        return r.read()


def test_server_speaker_header(setup):
    """X-Speaker-Id reaches the service's micro-batches and streams: its
    audio is the one-shot audio of that speaker (host noise, the service's
    bucket), another id changes it, and a request without the header is
    speaker 0."""
    _, cfg, _, tp, mels = setup
    httpd = tsrv.serve(tp, cfg, port=0, bucket_frames=8, max_frames=24,
                       noise="host", device="cpu", max_batch=4,
                       batch_window_ms=20.0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        mel = mels[0]
        b2 = _post(port, "/synthesize", mel, X_Seed=4, X_Speaker_Id=2)
        b0 = _post(port, "/synthesize", mel, X_Seed=4, X_Speaker_Id=0)
        bn = _post(port, "/synthesize", mel, X_Seed=4)
        assert b2 != b0 and bn == b0
        want = tsyn.synthesize_mels(tp, cfg, [mel], seed=4, speaker_ids=[2],
                                    bucket_frames=8, pad_batch=True,
                                    device="cpu")[0]
        np.testing.assert_array_equal(np.frombuffer(b2[44:], "<i2"),
                                      tsrv._pcm16(want))
        s2 = _post(port, "/synthesize_stream", mel, X_Seed=4,
                   X_Speaker_Id=2)
        s0 = _post(port, "/synthesize_stream", mel, X_Seed=4)
        assert s2 != s0 and len(s2) == 44 + 2 * mel.shape[0] * HOP
    finally:
        httpd.shutdown()
        httpd.service.close()


def test_train_step_with_speakers_matches_jax(setup):
    """One tiny_gin make_train_step step on a batch with "speaker" from the
    same params and a fresh optimizer state (fp32): loss and every metric
    1e-5 relative, updated params 1e-4 worst-leaf relative."""
    jcfg, cfg, params, tp, _ = setup
    r = np.random.RandomState(5)
    batch = {"audio": (0.3 * r.randn(2, 2048, 1)).astype(np.float32),
             "mel": r.rand(2, 2048 // HOP, 80).astype(np.float32),
             "speaker": np.array([3, 1], np.int32)}
    state = jts.create_state(jax.random.PRNGKey(0), jcfg)
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    jnew, jm = jax.jit(jts.make_train_step(jcfg))(
        state, jax.tree.map(jnp.asarray, batch))
    tstate = tts.TrainState(torch.zeros((), dtype=torch.int32), tp,
                            topt.make_optimizer(cfg.train).init(tp))
    tnew, tm = tts.make_train_step(cfg)(tstate,
                                        tree_map(torch.from_numpy, batch))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    flat_t = []
    tree_map(lambda l: flat_t.append(l.numpy()), tnew.params)
    leaves_j = jax.tree.leaves(jnew.params)
    assert len(flat_t) == len(leaves_j)
    for a, b in zip(flat_t, leaves_j):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-12)


def test_trainer_runs_a_speaker_corpus(tmp_path):
    """train(device="cpu") on a tiny_gin corpus with three speakers: DDI,
    two steps, a checkpoint and the synthesis probe with the record's
    speaker id."""
    cfg = tiny_gin()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=2))
    d = tmp_path / "data"
    os.makedirs(d)
    r = np.random.RandomState(0)
    with FwRecordWriter(str(d / "train.fwrec")) as w:
        for i in range(4):
            f = 12 + 3 * i
            w.write((0.1 * r.randn(f * HOP)).astype(np.float32),
                    r.rand(f, 80).astype(np.float32), i % 3)
    out = ttrain(cfg, str(d), str(tmp_path / "logs"), train_steps=2,
                 checkpoint_interval=2, eval_interval=2, log_every=1,
                 device="cpu")
    assert os.path.exists(os.path.join(out, "ckpt-2.npz"))
    wavs = os.listdir(tmp_path / "logs" / "train" / "wavs")
    assert "prediction-2.wav" in wavs, wavs
