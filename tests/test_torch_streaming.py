"""PyTorch port, streaming and time-parallel synthesis, device noise and
PCM16 (synthesis/streaming.py, synthesis/noise.py): chunk plans equal to
the JAX package's, streamed audio equal to one-shot audio and to the
time-parallel path, host and device noise equal to JAX's streams, PCM16
equal to host quantization."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import lj22k as jlj22k
from flowavenet_tpu.config import tiny as jtiny
from flowavenet_tpu.models.flowavenet import init_flowavenet as jinit
from flowavenet_tpu.synthesis import streaming as jst
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.config import lj22k, tiny
from flowavenet_tpu_torch.parallel.mesh import make_data_mesh
from flowavenet_tpu_torch.synthesis import noise as tnoise
from flowavenet_tpu_torch.synthesis import streaming as tst
from flowavenet_tpu_torch.synthesis import synthesize as tsyn


def _plain(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 use_pallas=False))


@pytest.fixture(scope="module")
def setup():
    """Damped random params (as tests/test_streaming.py uses) on the plain
    route, fp32, and a 64-frame mel: 7 windows of the default tiny plan."""
    jcfg, cfg = _plain(jtiny()), _plain(tiny())
    params = jinit(jax.random.PRNGKey(0), jcfg.model)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(3)
    params = jax.tree.unflatten(treedef, [
        np.asarray(l) + 0.05 * r.randn(*l.shape).astype(np.float32)
        for l in leaves])
    mel = np.random.RandomState(1).rand(64, 80).astype(np.float32)
    return jcfg, cfg, params, to_torch(params), mel


@pytest.mark.parametrize("which", ["tiny", "lj22k"])
def test_plan_chunks_matches_jax(which):
    """The same (chunk, halo, window, n_chunks, total) as the JAX package
    over a grid of lengths, chunk sizes and halos; and the same halo."""
    jcfg, cfg = (jtiny(), tiny()) if which == "tiny" else (jlj22k(), lj22k())
    assert tst.reverse_halo(cfg.model) == jst.reverse_halo(jcfg.model)
    for frames in (1, 7, 8, 33, 64, 129, 400, 801, 2000):
        for chunk in (None, 5, 32, 128):
            for halo in (None, 0, 3, 64):
                got = tst.plan_chunks(cfg, frames, chunk, halo)
                want = jst.plan_chunks(jcfg, frames, chunk, halo)
                assert dataclasses.astuple(got) == dataclasses.astuple(want)
    w = list(tst._window_starts(tst.plan_chunks(cfg, 801)))
    assert w == list(jst._window_starts(jst.plan_chunks(jcfg, 801)))


def test_streamed_equals_one_shot(setup):
    """Plain route, fp32: the concatenated chunks equal the one-shot
    reverse of the same noise to rel-to-max 1e-5.  (The JAX package is
    bit-exact here, tests/test_streaming.py:47, because XLA's CPU matmul is
    shape-independent per row; torch's CPU matmul blocking follows the
    window shape, which moves the sums by ~1e-6 of the largest sample.)"""
    _, cfg, _, tp, mel = setup
    chunks = list(tst.stream_reverse(tp, cfg, mel, seed=11, device="cpu"))
    assert len(chunks) > 3
    audio = np.concatenate([a for _, a in chunks])
    one = tsyn.synthesize_mels(tp, cfg, [mel], seed=11, bucket_frames=1,
                               device="cpu")[0]
    assert audio.shape == one.shape == (64 * cfg.audio.hop_size,)
    assert np.abs(audio - one).max() <= 1e-5 * np.abs(one).max()


def test_time_parallel_equals_streaming_and_jax(setup):
    """Host noise: the batched windows (3 rows per pass, a ragged last
    pass) equal the serial stream to rel-to-max 1e-5 (torch's CPU matmul
    blocking follows the batch shape), and JAX's streamed audio (the same
    RandomState stream) to 5e-5, the bar of test_plain_route_fp32_
    matches_jax."""
    jcfg, cfg, params, tp, mel = setup
    stream = tst.synthesize_streaming(tp, cfg, mel, seed=4, device="cpu")
    tpar = tst.synthesize_time_parallel(tp, cfg, mel, seed=4,
                                        rows_per_pass=3, device="cpu")
    scale = np.abs(stream).max()
    assert np.abs(tpar - stream).max() <= 1e-5 * scale
    want = jst.synthesize_streaming(params, jcfg, mel, seed=4)
    assert np.abs(stream - want).max() <= 5e-5 * scale


def test_device_noise_bits_and_normals_match_jax():
    """threefry2x32 bits equal jax.random.bits exactly for PRNGKey(s) and
    fold_in(PRNGKey(s), f); the normals are within 1e-6 of
    jax.random.normal (XLA's float32 erf_inv, reproduced op by op;
    measured 4.8e-7)."""
    for s in (0, 5, 2 ** 32 - 1, 123456789):
        key = jax.random.PRNGKey(np.uint32(s))
        np.testing.assert_array_equal(
            tnoise.random_bits(tnoise.prng_key([s]), 4096)[0].numpy(),
            np.asarray(jax.random.bits(key, (4096,))).astype(np.int64))
        got = tnoise.normal(tnoise.prng_key([s]), 50000)[0].numpy()
        want = np.asarray(jax.random.normal(key, (50000, 1)))[:, 0]
        assert np.abs(got - want).max() <= 1e-6
        for f in (0, 77, 40000):
            fk = jax.random.fold_in(key, f)
            tk = tnoise.fold_in(tnoise.prng_key(s), f)
            np.testing.assert_array_equal(
                [int(tk[0]), int(tk[1])],
                np.asarray(jax.random.key_data(fk)).astype(np.int64))
            z = tnoise.frame_noise(s, [f], [1.0], 1, 256)[0, :, 0].numpy()
            assert np.abs(z - np.asarray(jax.random.normal(fk, (256,)))
                          ).max() <= 1e-6


def test_device_noise_paths_match_jax(setup):
    """The serving path's per-row device noise (dispatch_mels) and the
    time-parallel path's positional device noise give JAX's audio on the
    plain route, fp32: rel-to-max 5e-5; positional noise makes the audio
    independent of the chunk plan (chunk 10 vs 16: 1e-5)."""
    from flowavenet_tpu.synthesis import synthesize as jsyn
    jcfg, cfg, params, tp, mel = setup
    mels = [mel[:12], mel[:7]]
    want = jsyn.synthesize_mels(params, jcfg, mels, seed=[5, 6],
                                temp=[0.5, None], bucket_frames=8,
                                pad_batch=True, noise="device")
    got = tsyn.synthesize_mels(tp, cfg, mels, seed=[5, 6], temp=[0.5, None],
                               bucket_frames=8, pad_batch=True,
                               noise="device", device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max()
    jt = jst.synthesize_time_parallel(params, jcfg, mel, seed=3,
                                      rows_per_pass=3, noise="device")
    tt = tst.synthesize_time_parallel(tp, cfg, mel, seed=3, rows_per_pass=3,
                                      noise="device", device="cpu")
    assert np.abs(tt - jt).max() <= 5e-5 * np.abs(jt).max()
    t16 = tst.synthesize_time_parallel(tp, cfg, mel, seed=3, chunk_frames=16,
                                       noise="device", device="cpu")
    assert np.abs(t16 - tt).max() <= 1e-5 * np.abs(tt).max()


def test_pcm16_equals_host_quantization(setup):
    """pcm16 (on the device the audio was made on) is exactly the WAV
    layer's host quantization of the same float audio: round-half-even of
    x * 32768, clipped; on both device-noise paths, and time-parallel over a
    data mesh."""
    _, cfg, _, tp, mel = setup
    f = tsyn.synthesize_mels(tp, cfg, [mel], seed=2, noise="device",
                             device="cpu")[0]
    q = tsyn.synthesize_mels(tp, cfg, [mel], seed=2, noise="device",
                             pcm16=True, device="cpu")[0]
    host = np.clip(np.rint(f * 32768.0), -32768, 32767).astype(np.int16)
    assert q.dtype == np.int16
    np.testing.assert_array_equal(q, host)
    tf = tst.synthesize_time_parallel(tp, cfg, mel, seed=2, noise="device",
                                      device="cpu")
    tq = tst.synthesize_time_parallel(tp, cfg, mel, seed=2, noise="device",
                                      pcm16=True, device="cpu")
    np.testing.assert_array_equal(
        tq, np.clip(np.rint(tf * 32768.0), -32768, 32767).astype(np.int16))
    x = torch.tensor([0.5 / 32768, 1.5 / 32768, -2.5 / 32768, 2.0, -2.0])
    assert tsyn.pcm16_quantize(x).tolist() == [0, 2, -2, 32767, -32768]
    with pytest.raises(ValueError, match="noise='device'"):
        tst.synthesize_time_parallel(tp, cfg, mel, pcm16=True, device="cpu")
    # over a data mesh of two CPU replicas too
    mesh = make_data_mesh(["cpu", "cpu"])
    mf = tst.synthesize_time_parallel(tp, cfg, mel, seed=2, noise="device",
                                      data_sharding=mesh, batch_multiple=2)
    mq = tst.synthesize_time_parallel(tp, cfg, mel, seed=2, noise="device",
                                      pcm16=True, data_sharding=mesh,
                                      batch_multiple=2)
    np.testing.assert_array_equal(
        mq, np.clip(np.rint(mf * 32768.0), -32768, 32767).astype(np.int16))


def test_cli_stream_and_time_parallel_write_wavs(setup, tmp_path):
    """--stream and --time_parallel 1 on the CPU (the tiny config's default
    route): one 16-bit wav per mel at its usable length, holding exactly
    the quantized output of synthesize_streaming / synthesize_time_parallel
    for the CLI's seed."""
    import wave

    from flowavenet_tpu.checkpoint.checkpoint import save_checkpoint
    _, _, params, tp, mel = setup
    ck, md = tmp_path / "ck", tmp_path / "mels"
    save_checkpoint(str(ck), 1, params)
    md.mkdir()
    np.save(md / "m.npy", mel[:40])
    for flag, run in ((["--stream"], tst.synthesize_streaming),
                      (["--time_parallel", "1"],
                       tst.synthesize_time_parallel)):
        od = tmp_path / flag[0].strip("-")
        tsyn.main(["--saved_dir", str(ck), "--mels_dir", str(md),
                   "--output_dir", str(od), "--config", "tiny",
                   "--device", "cpu", "--chunk_frames", "8", *flag])
        with wave.open(str(od / "m.wav")) as w:
            assert w.getnframes() == 40 * 256 and w.getsampwidth() == 2
            got = np.frombuffer(w.readframes(40 * 256), "<i2")
        want = run(tp, tiny(), mel[:40], seed=0, chunk_frames=8,
                   device="cpu")
        np.testing.assert_array_equal(
            got, np.clip(np.rint(want * 32768.0), -32768, 32767))
