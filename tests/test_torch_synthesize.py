"""PyTorch port, synthesis entry points and checkpoints: synthesize_mels
against the JAX package with host noise, seed and batch-composition
invariance within the port, the weight bridge, and the CLI on the CPU."""

import dataclasses
import wave

import jax
import numpy as np
import pytest
import torch

from flowavenet_tpu.checkpoint.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
from flowavenet_tpu.config import tiny as jtiny
from flowavenet_tpu.models.flowavenet import init_flowavenet as jinit
from flowavenet_tpu.synthesis import synthesize as jsyn
from flowavenet_tpu_torch.checkpoint import bridge
from flowavenet_tpu_torch.config import tiny
from flowavenet_tpu_torch.synthesis import synthesize as tsyn


def _jax_params(cfg, scale=0.1):
    """Init plus 0.1-scale noise, so reverse is not the identity."""
    params = jinit(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(7)
    return jax.tree.unflatten(treedef, [
        np.asarray(l) + scale * r.randn(*l.shape).astype(np.float32)
        for l in leaves])


@pytest.fixture(scope="module")
def setup():
    jcfg = jtiny()
    cfg = tiny()
    params = _jax_params(jcfg.model)
    rs = np.random.RandomState(0)
    mels = [rs.rand(n, 80).astype(np.float32) for n in (12, 7)]
    return jcfg, cfg, params, bridge.to_torch(params), mels


def test_synthesize_mels_matches_jax_fp32(setup):
    """Host noise is numpy on both sides, so the port reproduces the JAX
    package's synthesis: plain route, fp32, <= 1e-4."""
    jcfg, cfg, params, tp, mels = setup
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                  use_pallas=False))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_pallas=False))
    want = jsyn.synthesize_mels(params, jcfg, mels, seed=5,
                                bucket_frames=8)
    got = tsyn.synthesize_mels(tp, cfg, mels, seed=5, bucket_frames=8,
                               device="cpu")
    assert [w.shape for w in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_seed_and_batch_composition_invariance(setup):
    """On the default int8 route an item's audio depends only on (mel,
    seed, padded length): bit-identical whatever companion shares its
    batch; equal to float rounding when synthesized alone (1e-6: the CPU's
    matmul blocking follows the batch size, but every int8 code is the
    same); a different seed changes it."""
    _, cfg, _, tp, mels = setup
    loud = [mels[0], 5.0 * mels[1]]
    both = tsyn.synthesize_mels(tp, cfg, mels, seed=[3, 9], bucket_frames=16,
                                device="cpu")
    both_loud = tsyn.synthesize_mels(tp, cfg, loud, seed=[3, 1],
                                     bucket_frames=16, device="cpu")
    alone = tsyn.synthesize_mels(tp, cfg, mels[:1], seed=3,
                                 bucket_frames=16, device="cpu")
    other = tsyn.synthesize_mels(tp, cfg, mels[:1], seed=4,
                                 bucket_frames=16, device="cpu")
    np.testing.assert_array_equal(both[0], both_loud[0])
    np.testing.assert_allclose(both[0], alone[0], atol=1e-6)
    assert np.abs(other[0] - alone[0]).max() > 1e-3
    assert both[1].shape == (7 * cfg.audio.hop_size,)


def test_bridge_round_trip_bit_exact(setup, tmp_path):
    """numpy -> torch -> numpy, and through the npz layout, keep every
    leaf bit for bit; keys are the JAX package's keystr paths."""
    _, _, params, tp, _ = setup
    back = bridge.to_numpy(tp)
    jl = jax.tree_util.tree_flatten_with_path(params)[0]
    flat = bridge.flatten(back)
    assert sorted(flat) == sorted(jax.tree_util.keystr(k) for k, _ in jl)
    for k, leaf in jl:
        np.testing.assert_array_equal(flat[jax.tree_util.keystr(k)], leaf)
    path = bridge.save_params(str(tmp_path / "ckpt-3.npz"), tp, step=3)
    tree, step = bridge.load_params_npz(path)
    assert step == 3
    for k, v in bridge.flatten(tree).items():
        np.testing.assert_array_equal(v, flat[k])
    # and the JAX package restores what the port wrote
    restored, jstep = restore_checkpoint(path, params)
    assert jstep == 3
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_load_params_reads_jax_train_checkpoint(setup, tmp_path):
    """A TrainState checkpoint written by the JAX trainer's save_checkpoint
    (``.params`` prefix plus optimizer state) loads: fp32 leaves bit-exact,
    bf16 when the config computes in bf16."""
    from flowavenet_tpu.training.train_state import create_state
    jcfg, cfg, params, _, _ = setup
    state = create_state(jax.random.PRNGKey(0), jcfg)
    state = state._replace(params=params)
    save_checkpoint(str(tmp_path), 7, state)
    tp, step = tsyn.load_params(str(tmp_path), cfg, device="cpu")
    assert step == 7
    flat = bridge.flatten(bridge.to_numpy(tp))
    for k, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(flat[jax.tree_util.keystr(k)], leaf)
    tp16, _ = tsyn.load_params(str(tmp_path), cfg, compute_dtype="bfloat16",
                               device="cpu")
    assert tp16["blocks"][0]["flows"]["coupling"]["zero"]["w"].dtype == \
        torch.bfloat16


def test_cli_writes_wavs_on_cpu(setup, tmp_path):
    """The CLI with --device cpu: JAX checkpoint in, one 16-bit wav per mel
    out, at the mel's usable length."""
    jcfg, _, params, _, mels = setup
    ck, md, od = (tmp_path / d for d in ("ck", "mels", "out"))
    save_checkpoint(str(ck), 1, params)
    md.mkdir()
    for i, m in enumerate(mels):
        np.save(md / f"m{i}.npy", m)
    tsyn.main(["--saved_dir", str(ck), "--mels_dir", str(md),
               "--output_dir", str(od), "--config", "tiny",
               "--batch_size", "2", "--device", "cpu"])
    for i, m in enumerate(mels):
        with wave.open(str(od / f"m{i}.wav")) as w:
            assert w.getnframes() == m.shape[0] * 256
            assert w.getsampwidth() == 2


@pytest.mark.parametrize("kw", [
    dict(noise="device", data_sharding=("cpu", "cpu")),
    dict(noise="device", pcm16=True, batch_multiple=2)],
    ids=["kw0-device noise", "kw1-pcm16"])
def test_later_slices_raise(setup, kw):
    """Sharded dispatch (scale-out): over a data mesh of two CPU replicas
    (its data_sharding, one row each) the device-noise rows are the
    one-device call's (atol 1e-6: on the CPU a row's bits follow the batch
    size by <= 3e-8); batch_multiple=2 on the two mels leaves the rows,
    and the pcm16 audio, as they are."""
    _, cfg, _, tp, mels = setup
    kw = dict(kw)
    one = tsyn.synthesize_mels(tp, cfg, mels, device="cpu",
                               **{k: v for k, v in kw.items()
                                  if k not in ("data_sharding",
                                               "batch_multiple")})
    if "data_sharding" in kw:
        from flowavenet_tpu_torch.parallel.mesh import make_data_mesh
        kw["data_sharding"] = make_data_mesh(list(kw["data_sharding"]))
    wav, frames = tsyn.dispatch_mels(tp, cfg, mels, device="cpu", **kw)
    got = tsyn.materialize_wavs(wav, frames, cfg)
    for a, b in zip(one, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        if kw.get("pcm16"):
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_cli_stream_raises(setup, tmp_path):
    """--stream and --time_parallel exclude each other (as in the JAX
    CLI); --time_parallel 2 on the CPU splits each pass's windows over two
    CPU replicas and writes the wavs of --time_parallel 1 (within one PCM
    step: a row's bits follow the batch size by <= 3e-8 on the CPU)."""
    with pytest.raises(SystemExit):
        tsyn.main(["--stream", "--time_parallel", "1", "--device", "cpu"])
    _, _, params, _, mels = setup
    ck, md = tmp_path / "ck", tmp_path / "mels"
    save_checkpoint(str(ck), 1, params)
    md.mkdir()
    np.save(md / "m.npy", np.concatenate(mels * 3))
    pcm = []
    for n in ("1", "2"):
        od = tmp_path / f"out{n}"
        tsyn.main(["--saved_dir", str(ck), "--mels_dir", str(md),
                   "--output_dir", str(od), "--config", "tiny",
                   "--time_parallel", n, "--chunk_frames", "8",
                   "--device", "cpu"])
        with wave.open(str(od / "m.wav")) as w:
            pcm.append(np.frombuffer(w.readframes(w.getnframes()),
                                     "<i2").astype(np.int32))
    assert len(pcm[0]) == len(pcm[1]) > 0
    assert np.abs(pcm[0] - pcm[1]).max() <= 1
