"""PyTorch port, the native C++ loader (data/native_loader.py and its copy
of the C++ source): held against the JAX package's
``flowavenet_tpu.data.native_loader`` batch for batch, its errors, and the
port's trainer on ``loader="native"`` (resume, loader switches, a
JAX-written checkpoint)."""

import json
import os
import pathlib

import jax
import numpy as np
import pytest

from flowavenet_tpu.checkpoint import checkpoint as jckpt
from flowavenet_tpu.config import tiny
from flowavenet_tpu.data import native_loader as jnative
from flowavenet_tpu.data.records import FwRecordWriter
from flowavenet_tpu.training import train_state as jts
from flowavenet_tpu_torch import config as tconfig
from flowavenet_tpu_torch.checkpoint import checkpoint as tckpt
from flowavenet_tpu_torch.data import native_loader as tnative
from flowavenet_tpu_torch.ops import _build
from flowavenet_tpu_torch.training.train import train as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
TCFG = tconfig.tiny()


def _write(path, frames, hop=4, bins=3, seed=0):
    r = np.random.RandomState(seed)
    with FwRecordWriter(str(path)) as w:
        for i, f in enumerate(frames):
            w.write(r.randn(f * hop).astype(np.float32),
                    r.rand(f, bins).astype(np.float32), speaker_id=i % 3)


def test_package_copy_is_the_native_source():
    """The port's C++ source is byte-identical to native/fwrec_loader.cc,
    so both packages' loaders give one stream."""
    assert tnative.SOURCE.read_bytes() == \
        (ROOT / "native" / "fwrec_loader.cc").read_bytes()


def test_builds_into_the_port_build_dir():
    lib = pathlib.Path(_build.build_host(tnative.SOURCE))
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith(
        "libfwrec_loader-")
    assert _build.build_host(tnative.SOURCE) == lib       # hashed, reused


def test_missing_compiler_raises(monkeypatch):
    """No C++ compiler: the build raises, naming it (no Python fallback)."""
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    with pytest.raises(RuntimeError, match="no-such-c\\+\\+-compiler"):
        _build.build_host(tnative.SOURCE)


@pytest.mark.parametrize("speaker", [False, True])
def test_batches_equal_the_jax_loader(tmp_path, speaker):
    """batch_at and the prefetched iterate give the JAX package's native
    batches bit for bit (audio, mel, speaker) for the same (seed, step),
    long clips cropped and short ones padded."""
    p = tmp_path / "a.fwrec"
    _write(p, [50, 3, 70, 41, 9, 64])
    kw = dict(hop_size=4, max_time_steps=64, batch_size=5, seed=11,
              with_speaker=speaker)
    j = jnative.NativeCropDataset(str(p), **kw)
    t = tnative.NativeCropDataset(str(p), **kw)
    assert len(t) == len(j) == 6 and t.mel_bins == j.mel_bins == 3
    assert t.record_meta(2) == j.record_meta(2)
    for step in (0, 1, 7, 123):
        a, b = j.batch_at(step), t.batch_at(step)
        assert set(a) == set(b) == ({"audio", "mel", "speaker"} if speaker
                                    else {"audio", "mel"})
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    it = t.iterate(start_step=5, prefetch=2)
    for step in range(5, 9):
        got, want = next(it), j.batch_at(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    it.close()
    t.close()
    j.close()


def test_errors_match_the_jax_loader(tmp_path):
    """A misaligned record raises the same ValueError from batch_at and
    from iterate; a file that is not FwRecords raises ValueError."""
    p = tmp_path / "bad_align.fwrec"
    with FwRecordWriter(str(p)) as w:
        w.write(np.zeros(40, np.float32), np.zeros((10, 3), np.float32))
        w.write(np.zeros(12, np.float32), np.zeros((10, 3), np.float32))
    for mod in (jnative, tnative):
        ds = mod.NativeCropDataset(str(p), hop_size=4, max_time_steps=16,
                                   batch_size=2)
        with pytest.raises(ValueError, match="record 1.*misaligned"):
            ds.batch_at(0)
        with pytest.raises(ValueError, match="record 1.*misaligned"):
            next(ds.iterate())
        ds.close()
    bad = tmp_path / "bad.fwrec"
    bad.write_bytes(b"NOTMAGIC123456789")
    with pytest.raises(ValueError, match="cannot open"):
        tnative.NativeCropDataset(str(bad), hop_size=4, max_time_steps=16,
                                  batch_size=1)


def _corpus(d, n=5, frames=(20, 11, 40, 9, 33)):
    """A train.fwrec only (no test set: the trainer runs no eval steps)."""
    os.makedirs(d, exist_ok=True)
    r = np.random.RandomState(0)
    with FwRecordWriter(os.path.join(d, "train.fwrec")) as w:
        for i in range(n):
            f = frames[i % len(frames)]
            w.write(r.randn(f * 256).astype(np.float32) * 0.1,
                    r.rand(f, 80).astype(np.float32), i % 3)
    return d


def _leaves(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files if k != "__meta__"}


KW = dict(summary_interval=1, checkpoint_interval=1, eval_interval=100,
          probe_synthesis=False, device="cpu", log_every=0)


def test_trainer_native_loader_resumes_bit_exact(tmp_path):
    """train(loader="native"): the checkpoints record the loader, and a run
    resumed at step 1 ends at step 2 with the bits of an unbroken one."""
    data = _corpus(str(tmp_path / "data"))
    a = ttrain(TCFG, data, str(tmp_path / "a"), train_steps=2,
               loader="native", **KW)
    ttrain(TCFG, data, str(tmp_path / "b"), train_steps=1, loader="native",
           **KW)
    b = ttrain(TCFG, data, str(tmp_path / "b"), train_steps=2,
               loader="native", **KW)
    assert tckpt.read_meta(os.path.join(a, "ckpt-2.npz"))["loader"] == \
        "native"
    la, lb = _leaves(os.path.join(a, "ckpt-2.npz")), _leaves(
        os.path.join(b, "ckpt-2.npz"))
    assert set(la) == set(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_trainer_loader_switch(tmp_path):
    """A python-loader checkpoint is refused by a native run unless
    allow_loader_switch; a JAX-written native-loader checkpoint resumes."""
    data = _corpus(str(tmp_path / "data"))
    run = str(tmp_path / "py")
    ttrain(TCFG, data, run, train_steps=1, **KW)
    with pytest.raises(ValueError, match="allow_loader_switch"):
        ttrain(TCFG, data, run, train_steps=2, loader="native", **KW)
    ttrain(TCFG, data, run, train_steps=2, loader="native",
           allow_loader_switch=True, **KW)
    assert tckpt.read_meta(os.path.join(run, "pretrained", "ckpt-2.npz"))[
        "loader"] == "native"

    jrun = tmp_path / "jax"
    jstate = jts.create_state(jax.random.PRNGKey(0), tiny())
    jckpt.save_checkpoint(str(jrun / "pretrained"), 2, jstate,
                          extra_meta={"loader": "native"})
    out = ttrain(TCFG, data, str(jrun), train_steps=3, loader="native",
                 **KW)
    recs = [json.loads(l) for l in open(jrun / "train" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [3]          # resumed at step 2
    assert sorted(os.listdir(out)) == ["ckpt-2.npz", "ckpt-3.npz"]
    assert int(_leaves(os.path.join(out, "ckpt-3.npz"))[".step"]) == 3
