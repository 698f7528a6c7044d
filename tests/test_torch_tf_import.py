"""PyTorch port, the TF checkpoint importer (``checkpoint/tf_import.py``)
and its CLI (``checkpoint/import_cli.py``): held against
``flowavenet_tpu.checkpoint.tf_import`` on the TF goldens of
``tests/fixtures`` and on a reference-named export of the tiny preset;
the CLI's checkpoint is read back by the JAX package's
``restore_checkpoint``."""

import os

import jax
import numpy as np
import pytest
import torch

from flowavenet_tpu.checkpoint import checkpoint as jckpt
from flowavenet_tpu.checkpoint import tf_import as jtf
from flowavenet_tpu.config import ModelConfig as JModelConfig
from flowavenet_tpu.config import tiny as jtiny
from flowavenet_tpu.models.flowavenet import init_flowavenet
from flowavenet_tpu.training import train_state as jts
from flowavenet_tpu_torch.checkpoint import checkpoint as tckpt
from flowavenet_tpu_torch.checkpoint import import_cli
from flowavenet_tpu_torch.checkpoint import tf_import as ttf
from flowavenet_tpu_torch.config import ModelConfig as TModelConfig
from flowavenet_tpu_torch.config import tiny as ttiny
from flowavenet_tpu_torch.training.train_state import create_state

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
VARIANTS = ["", "causal", "additive", "gin", "mid"]


def _fixture(variant):
    """(TF variables, JAX config, port config) of a TF golden, with the
    geometry ``tests/test_tf_parity.py`` builds for it."""
    fx = np.load(os.path.join(FIXDIR, f"full_model_golden"
                              f"{'_' + variant if variant else ''}.npz"))
    if "geom" in fx.files:
        nb, nf, nl, fs, nm = (int(v) for v in fx["geom"])
        scales = tuple(int(v) for v in fx["scales"])
    else:
        nb, nf, nl, fs, nm, scales = 2, 2, 2, 16, 8, (4, 4)
    kw = dict(n_block=nb, n_flow=nf, n_layer=nl, filter_size=fs,
              num_mels=nm, upsample_scales=scales,
              causal=variant == "causal", affine=variant != "additive",
              gin_channels=4 if variant == "gin" else -1, n_speakers=3,
              parity_drop_global_cond=variant == "gin")
    tf_vars = {k[len("var:"):]: fx[k] for k in fx.files
               if k.startswith("var:")}
    return tf_vars, JModelConfig(**kw), TModelConfig(**kw)


def _assert_same_tree(jtree, ttree):
    """Leaf for leaf: the same keystr paths in the same order, dtypes and
    bits."""
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = list(tckpt._paths(ttree))
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [k for k, _ in tflat]
    for (p, a), (_, b) in zip(flat, tflat):
        assert isinstance(b, np.ndarray) and b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v or "affine")
def test_import_matches_jax_importer_on_tf_goldens(variant):
    tf_vars, jcfg, tcfg = _fixture(variant)
    _assert_same_tree(jtf.import_tf_checkpoint(tf_vars, jcfg),
                      ttf.import_tf_checkpoint(tf_vars, tcfg))


@pytest.mark.parametrize("variant", ["", "mid"], ids=["affine", "mid"])
def test_import_refuses_a_missing_variable_as_jax_does(variant):
    """Without one 1x1 of the last ResBlock both importers raise KeyError
    (the mid golden's four same-shape 1x1s are told apart by creation
    order)."""
    tf_vars, jcfg, tcfg = _fixture(variant)
    last = max((k for k in tf_vars if "ResBlock" in k
                and k.endswith("kernel") and "Conv_" not in k),
               key=jtf._keras_index)
    del tf_vars[last]
    with pytest.raises(KeyError):
        jtf.import_tf_checkpoint(tf_vars, jcfg)
    with pytest.raises(KeyError):
        ttf.import_tf_checkpoint(tf_vars, tcfg)


def test_scope_matcher_takes_what_jax_takes():
    """Creation order (the keras counter) breaks ties; a used name is not
    taken twice; the shape filter applies."""
    names = {"s/R/conv1d_12/kernel": np.zeros((1, 4, 4)),
             "s/R/conv1d_3/kernel": np.ones((1, 4, 4)),
             "s/R/conv1d/kernel": np.full((1, 8, 4), 2.0),
             "s/R/conv1d_7/kernel": np.full((1, 4, 4), 3.0)}
    jm, tm = jtf._ScopeMatcher(names), ttf._ScopeMatcher(names)
    for shape in [(1, 4, 4), None, (1, 4, 4), (1, 4, 4)]:
        np.testing.assert_array_equal(tm.take("s/R", "kernel", shape),
                                      jm.take("s/R", "kernel", shape))
    assert tm.used == jm.used == set(names)
    for m in (jm, tm):
        with pytest.raises(KeyError):
            m.take("s/R", "kernel")


def _tiny_export():
    """The tiny preset's params (JAX init plus noise) under the reference's
    TF variable names."""
    from test_tf_import import export_reference_names
    cfg = jtiny().model
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda l: np.asarray(l) + 0.1 * rng.randn(*l.shape).astype(
            np.float32), init_flowavenet(jax.random.PRNGKey(3), cfg))
    return export_reference_names(params, cfg), cfg


def test_import_cli_writes_a_checkpoint_the_jax_package_restores(tmp_path):
    """``--config tiny --step 7 --device cpu``: the JAX package's
    ``restore_checkpoint`` reads the checkpoint into its tiny TrainState
    at step 7, with the JAX importer's params bit for bit and a fresh
    optimizer state; the port's reads it too."""
    tf_vars, jcfg = _tiny_export()
    npz = str(tmp_path / "tf.npz")
    np.savez(npz, **tf_vars)
    import_cli.main(["--npz", npz, "--out_dir", str(tmp_path / "out"),
                     "--config", "tiny", "--step", "7", "--device", "cpu"])
    path = str(tmp_path / "out" / "ckpt-7.npz")
    assert tckpt.latest_checkpoint(str(tmp_path / "out")) == path
    template = jts.create_state(jax.random.PRNGKey(0), jtiny())
    state, step = jckpt.restore_checkpoint(path, template)
    assert step == 7 and int(state.step) == 7
    _assert_same_tree(jtf.import_tf_checkpoint(tf_vars, jcfg),
                      jax.tree.map(np.asarray, state.params))
    for a, b in zip(jax.tree.leaves(state.opt_state),
                    jax.tree.leaves(template.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tstate, tstep = tckpt.restore_checkpoint(
        path, create_state(torch.Generator().manual_seed(0), ttiny()))
    assert tstep == 7


def test_import_cli_refuses_another_models_variables(tmp_path):
    """The tiny preset's variables under ``--config lj22k``: the importer
    raises KeyError, as the JAX one does, before anything is written."""
    tf_vars, _ = _tiny_export()
    npz = str(tmp_path / "tf.npz")
    np.savez(npz, **tf_vars)
    with pytest.raises(KeyError):
        import_cli.main(["--npz", npz, "--out_dir", str(tmp_path / "out"),
                         "--config", "lj22k", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "out")
