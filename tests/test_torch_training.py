"""PyTorch port, training (training/optimizer.py, train_state.py, train.py,
checkpoint/checkpoint.py, data/): held against the JAX package on the same
params, optimizer state and batches."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.checkpoint import checkpoint as jckpt
from flowavenet_tpu.config import tiny
from flowavenet_tpu.data.dataset import CropDataset as JCropDataset
from flowavenet_tpu.data.records import FwRecordWriter as JWriter
from flowavenet_tpu.models import flowavenet as jfwn
from flowavenet_tpu.training import optimizer as jopt
from flowavenet_tpu.training import train_state as jts
from flowavenet_tpu_torch import config as tconfig
from flowavenet_tpu_torch.checkpoint import checkpoint as tckpt
from flowavenet_tpu_torch.data.dataset import CropDataset as TCropDataset
from flowavenet_tpu_torch.data.records import FwRecordWriter as TWriter
from flowavenet_tpu_torch.models import flowavenet as tfwn
from flowavenet_tpu_torch.training import optimizer as topt
from flowavenet_tpu_torch.training import train_state as tts
from flowavenet_tpu_torch.training.train import train as ttrain
from flowavenet_tpu_torch.utils.tree import tree_map

JCFG = tiny()
TCFG = tconfig.tiny()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _to_torch_tree(tree):
    """A JAX tree (dicts, lists, optax NamedTuples) as the port's tree."""
    if isinstance(tree, dict):
        return {k: _to_torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch_tree(v) for v in tree]
    if isinstance(tree, tuple) and type(tree).__name__ == "EmptyState":
        return topt.EmptyState()
    if isinstance(tree, tuple) and type(tree).__name__ == "ScaleByAdamState":
        return topt.ScaleByAdamState(*[_to_torch_tree(x) for x in tree])
    if isinstance(tree, tuple) and type(tree).__name__ == \
            "ScaleByScheduleState":
        return topt.ScaleByScheduleState(_to_torch_tree(tree.count))
    if isinstance(tree, tuple):
        return tuple(_to_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _by_key_j(tree):
    return {jax.tree_util.keystr(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _by_key_t(tree):
    return {k: l.detach().numpy() for k, l in tckpt._paths(tree)}


def _torch_leaves(tree):
    out = []
    tree_map(lambda l: out.append(l.detach().numpy()), tree)
    return out


@pytest.mark.parametrize("case", ["clip", "no_clip", "lr_boundary"])
def test_optimizer_matches_optax(case):
    """Three updates of the hand-written chain vs optax's on the same
    random gradients: clip engaged (norm > 1) or not, and an LR boundary
    crossed at count 1.  Updates and state to 1e-6 relative; counts
    exact."""
    tc = dataclasses.replace(JCFG.train, lr_boundaries=((1, 2.0), (2, 4.0))
                             if case == "lr_boundary" else
                             JCFG.train.lr_boundaries)
    scale = 5.0 if case == "clip" else 1e-3
    r = np.random.RandomState(0)
    params = {"a": r.randn(3, 4).astype(np.float32),
              "b": [r.randn(5).astype(np.float32)]}
    jo = jopt.make_optimizer(tc)
    to = topt.make_optimizer(tconfig.TrainConfig(
        **dataclasses.asdict(tc) | {"lr_boundaries": tc.lr_boundaries}))
    js = jo.init(jax.tree.map(jnp.asarray, params))
    ts = to.init(tree_map(torch.from_numpy, params))
    for _ in range(3):
        g = {"a": scale * r.randn(3, 4).astype(np.float32),
             "b": [scale * r.randn(5).astype(np.float32)]}
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js)
        tu, ts = to.update(tree_map(torch.from_numpy, g), ts)
        for a, b in zip(_torch_leaves(tu), jax.tree.leaves(ju)):
            assert _rel(a, b) < 1e-6
    assert int(ts[1].count) == int(js[1].count) == 3
    assert int(ts[2].count) == int(js[2].count) == 3
    for a, b in zip(_torch_leaves((ts[1].mu, ts[1].nu)),
                    jax.tree.leaves((js[1].mu, js[1].nu))):
        assert _rel(a, b) < 1e-6
    if case != "lr_boundary":
        return
    sched_j, sched_t = jopt.lr_schedule(tc), topt.lr_schedule(to.cfg)
    for s in range(4):
        assert float(sched_t(torch.tensor(s, dtype=torch.int32))) == \
            float(sched_j(jnp.int32(s)))


@pytest.fixture(scope="module")
def step_case():
    """One JAX train step (jitted once) on the tiny model, guards live:
    the hinge margin lowered to 0.05 in both packages so the coupling and
    ActNorm hinges both contribute; and the same step on a batch holding a
    NaN.  Returns the inputs and the JAX results."""
    mp = pytest.MonkeyPatch()
    for mod in (jfwn, jts, tfwn):
        mp.setattr(mod, "LOGS_HINGE_MARGIN", 0.05)
    state = jts.create_state(jax.random.PRNGKey(0), JCFG)
    leaves, treedef = jax.tree.flatten(state.params)
    r = np.random.RandomState(5)
    params = jax.tree.unflatten(treedef, [
        np.asarray(l) + 0.05 * r.randn(*l.shape).astype(np.float32)
        for l in leaves])
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    T = 2048
    batch = {"audio": (0.3 * r.randn(2, T, 1)).astype(np.float32),
             "mel": r.rand(2, T // 256, 80).astype(np.float32)}
    bad = {"audio": batch["audio"].copy(), "mel": batch["mel"]}
    bad["audio"][0, 5, 0] = np.nan
    # the same step with every count at the first LR boundary (200k): the
    # schedule halves the rate there
    bnd = JCFG.train.lr_boundaries[0][0]
    late = state._replace(
        step=jnp.int32(bnd),
        opt_state=(state.opt_state[0],
                   state.opt_state[1]._replace(count=jnp.int32(bnd)),
                   state.opt_state[2]._replace(count=jnp.int32(bnd))))
    step = jax.jit(jts.make_train_step(JCFG))
    out = {k: (st, step(st, jax.tree.map(jnp.asarray, b)))
           for k, st, b in (("ok", state, batch), ("nan", state, bad),
                            ("lr_boundary", late, batch))}
    yield batch, bad, out
    mp.undo()


@pytest.mark.parametrize("which", ["ok", "nan", "lr_boundary"])
def test_train_step_matches_jax(step_case, which):
    """One make_train_step step from the same params, optimizer state and
    batch (fp32): loss and every aux metric 1e-5 relative; updated params
    and Adam mu/nu 1e-4 worst-leaf relative; counts and step exact.  The
    clip is engaged (grad norm > 1) and both hinges are live; with a NaN
    in the batch the step is skipped and the old state comes back; at the
    first LR boundary the rate is halved."""
    batch, bad, out = step_case
    state, (jstate, jm) = out[which]
    tstate = tts.TrainState(torch.tensor(int(state.step), dtype=torch.int32),
                            _to_torch_tree(jax.device_get(state.params)),
                            _to_torch_tree(jax.device_get(state.opt_state)))
    b = bad if which == "nan" else batch
    new, tm = tts.make_train_step(TCFG)(tstate, tree_map(torch.from_numpy,
                                                           b))
    assert set(tm) == set(jm)
    for k in jm:
        jv, tv = float(jm[k]), float(tm[k])
        if np.isfinite(jv):
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-8,
                                       err_msg=k)
        else:
            assert not np.isfinite(tv), k
    assert int(new.step) == int(jstate.step) == int(state.step) + 1
    if which == "lr_boundary":
        assert float(tm["learning_rate"]) == np.float32(
            JCFG.train.learning_rate / 2)
    if which == "ok":
        assert float(jm["grad_global_norm"]) > JCFG.train.grad_clip_norm
        assert float(jm["actnorm_hinge"]) > 0 and float(jm["logs_hinge"]) > 0
    assert float(tm["skipped_nonfinite"]) == float(which == "nan")
    kt, kj = _by_key_t(new), _by_key_j(jstate)
    assert set(kt) == set(kj)
    for k in kj:
        if ".mu" in k or ".nu" in k:
            assert _rel(kt[k], kj[k]) < 1e-4 or np.abs(kj[k]).max() == 0, k
        elif ".params" in k:
            assert _rel(kt[k], kj[k]) < 1e-4, k
    assert int(new.opt_state[1].count) == int(jstate.opt_state[1].count)
    assert int(new.opt_state[2].count) == int(jstate.opt_state[2].count)


def _random_jax_state(seed):
    state = jts.create_state(jax.random.PRNGKey(seed), JCFG)
    r = np.random.RandomState(seed)
    leaves, treedef = jax.tree.flatten(state)
    leaves = [np.asarray(l) if np.asarray(l).dtype.kind == "i"
              else np.asarray(l) + r.randn(*np.shape(l)).astype(np.float32)
              for l in leaves]
    leaves[0] = np.int32(7)                   # .step
    return jax.tree.unflatten(treedef, leaves)


def test_checkpoints_cross_packages(tmp_path):
    """A JAX-written TrainState checkpoint restores in the port, and a
    port-written one restores in JAX's restore_checkpoint: the same keys
    and identical leaves both ways."""
    jstate = _random_jax_state(1)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 7, jstate)
    target = tts.create_state(torch.Generator().manual_seed(0), TCFG)
    tstate, step = tckpt.restore_checkpoint(jpath, target)
    assert step == 7 and int(tstate.step) == 7
    kt, kj = _by_key_t(tstate), _by_key_j(jstate)
    assert set(kt) == set(kj)
    for k in kj:
        np.testing.assert_array_equal(kt[k], kj[k], err_msg=k)
    tpath = tckpt.save_checkpoint(str(tmp_path / "t"), 7, tstate,
                                  extra_meta={"loader": "python"})
    keys_j = set(np.load(jpath).files)
    keys_t = set(np.load(tpath).files)
    assert keys_j == keys_t
    assert {".step", ".opt_state[1].count", ".opt_state[2].count"} <= keys_t
    back, step = jckpt.restore_checkpoint(tpath, _random_jax_state(2))
    assert step == 7
    kb = _by_key_j(back)
    for k in kj:
        np.testing.assert_array_equal(kb[k], kj[k], err_msg=k)
    assert tckpt.latest_checkpoint(str(tmp_path / "t")) == tpath


def _corpus(d, n=5, frames=(20, 11, 40, 9, 33), seed=0):
    """A seeded corpus written by the port's writer (and the same records
    by the JAX writer under j_*.fwrec)."""
    os.makedirs(d, exist_ok=True)
    r = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        f = frames[i % len(frames)]
        recs.append((r.randn(f * 256).astype(np.float32) * 0.1,
                     r.rand(f, 80).astype(np.float32), i % 3))
    for name in ("train", "test"):
        with TWriter(os.path.join(d, f"{name}.fwrec")) as w:
            for a, m, s in recs:
                w.write(a, m, s)
        with JWriter(os.path.join(d, f"j_{name}.fwrec")) as w:
            for a, m, s in recs:
                w.write(a, m, s)
    return d


def test_data_matches_jax_package(tmp_path):
    """The port's FwRecordWriter writes the JAX writer's bytes, and
    CropDataset.batch_at gives bit-identical batches in both packages
    (short clips padded, long ones cropped)."""
    d = _corpus(str(tmp_path))
    for ext in (".fwrec", ".fwidx.npy"):
        with open(os.path.join(d, "train" + ext), "rb") as f1, \
                open(os.path.join(d, "j_train" + ext), "rb") as f2:
            assert f1.read() == f2.read()
    kw = dict(hop_size=256, max_time_steps=2048, batch_size=3, seed=75,
              with_speaker=True)
    jd = JCropDataset(os.path.join(d, "train.fwrec"), **kw)
    td = TCropDataset(os.path.join(d, "train.fwrec"), **kw)
    for step in (0, 1, 17):
        a, b = jd.batch_at(step), td.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    it = td.iterate(start_step=1)
    np.testing.assert_array_equal(next(it)["audio"], jd.batch_at(1)["audio"])


def _ckpt_leaves(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files if k != "__meta__"}


def test_trainer_resume_is_bit_exact(tmp_path):
    """train(device="cpu") on tiny: DDI and 4 steps in one run (metrics
    JSONL, checkpoints at 2 and 4, a synthesis probe at 4) against 2 steps,
    then a resumed run to 4: the step-4 checkpoints agree bit for bit.
    log_every=0 is taken as every step."""
    data = _corpus(str(tmp_path / "data"))
    kw = dict(summary_interval=2, checkpoint_interval=2, eval_interval=4,
              device="cpu", log_every=0)
    a = ttrain(TCFG, data, str(tmp_path / "a"), train_steps=4, **kw)
    ttrain(TCFG, data, str(tmp_path / "b"), train_steps=2,
           probe_synthesis=False, **kw)
    b = ttrain(TCFG, data, str(tmp_path / "b"), train_steps=4,
               probe_synthesis=False, **kw)
    la = _ckpt_leaves(os.path.join(a, "ckpt-4.npz"))
    lb = _ckpt_leaves(os.path.join(b, "ckpt-4.npz"))
    assert set(la) == set(lb) and int(la[".step"]) == 4
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    recs = [json.loads(l) for l in open(tmp_path / "a" / "train" /
                                        "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2, 4]
    assert all(np.isfinite(r["loss"]) and r["samples_per_sec"] > 0
               for r in recs)
    test_recs = [json.loads(l) for l in open(tmp_path / "a" / "test" /
                                             "metrics.jsonl")]
    assert [r["step"] for r in test_recs] == [1, 2, 4]
    assert os.path.exists(tmp_path / "a" / "train" / "wavs" /
                          "prediction-4.wav")
    # the JAX package reads the port's trainer checkpoint
    jstate, step = jckpt.restore_checkpoint(
        os.path.join(a, "ckpt-4.npz"),
        jts.create_state(jax.random.PRNGKey(0), JCFG))
    assert step == 4


def test_trainer_checkpoints_on_sigterm(tmp_path, monkeypatch):
    """SIGTERM during training finishes the step in flight, checkpoints it
    and returns; the caller's SIGTERM handler is restored afterwards."""
    import signal
    from flowavenet_tpu_torch.training import train as ttrain_mod
    data = _corpus(str(tmp_path / "data"))
    real = ttrain_mod.make_train_step

    def make(cfg):
        step_fn = real(cfg)
        calls = []

        def step(state, batch):
            calls.append(1)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(state, batch)
        return step

    monkeypatch.setattr(ttrain_mod, "make_train_step", make)
    before = signal.getsignal(signal.SIGTERM)
    out = ttrain(TCFG, data, str(tmp_path / "run"), train_steps=50,
                 summary_interval=100, checkpoint_interval=100,
                 probe_synthesis=False, device="cpu")
    assert sorted(os.listdir(out)) == ["ckpt-2.npz"]
    assert signal.getsignal(signal.SIGTERM) == before
