"""PyTorch port, likelihood side (models/flowavenet.py: forward, ddi,
loss_fn): held against the JAX package on the same weights and inputs, the
TF goldens, and the routing of the training and forward-kernel routes."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import tiny
from flowavenet_tpu.models import flowavenet as jfwn
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.models import flowavenet as tfwn
from flowavenet_tpu_torch.ops import pair_flow as tpf
from flowavenet_tpu_torch.utils.tree import tree_map

CFG = tiny().model
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
T = 1024


def _randomized(cfg, scale=0.05, seed=3):
    params = jfwn.init_flowavenet(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(l) + scale * r.randn(*l.shape).astype(np.float32)
        for l in leaves])


@pytest.fixture(scope="module")
def model():
    params = _randomized(CFG)
    r = np.random.RandomState(4)
    x = (0.3 * r.randn(2, T, 1)).astype(np.float32)
    c = r.rand(2, T // CFG.hop_size, CFG.num_mels).astype(np.float32)
    return params, to_torch(params), x, c


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _grad_tree(params_t):
    flat = []
    tree_map(lambda l: flat.append(
        (l.grad if l.grad is not None else torch.zeros_like(l)).numpy()),
        params_t)
    return flat


def test_forward_and_stats_match_jax(model):
    """fp32 forward with return_stats (scan route, remat on): log_p,
    logdet, per-block logdets, max|log_s|, logs_mean_sq, logs_hinge vs JAX:
    1e-5 relative (the hinge is 0 on both sides at margin 5)."""
    params, tp, x, c = model
    lp_j, ld_j, st_j = jfwn.forward(params, CFG, jnp.asarray(x),
                                    jnp.asarray(c), return_stats=True)
    lp_t, ld_t, st_t = tfwn.forward(tp, CFG, torch.from_numpy(x),
                                    torch.from_numpy(c), return_stats=True)
    np.testing.assert_allclose(float(lp_t), float(lp_j), rtol=1e-5)
    np.testing.assert_allclose(float(ld_t), float(ld_j), rtol=1e-5)
    assert set(st_t) == set(st_j)
    for k in st_j:
        np.testing.assert_allclose(float(st_t[k]), float(st_j[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)


def test_ddi_matches_jax(model):
    """DDI (fp32) sets every ActNorm as the JAX package does: worst-leaf
    relative 1e-4 over the whole params tree, and the post-DDI NLL to
    1e-5."""
    params, tp, x, c = model
    pj = jfwn.ddi(params, CFG, jnp.asarray(x), jnp.asarray(c))
    pt = tfwn.ddi(tp, CFG, torch.from_numpy(x), torch.from_numpy(c))
    flat_t = []
    tree_map(lambda l: flat_t.append(l.numpy()), pt)
    leaves_j = jax.tree.leaves(pj)
    assert len(flat_t) == len(leaves_j)
    assert max(_rel(a, b) for a, b in zip(flat_t, leaves_j)) < 1e-4
    lj, _ = jfwn.loss_fn(pj, CFG, jnp.asarray(x), jnp.asarray(c))
    lt, _ = tfwn.loss_fn(pt, CFG, torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def test_full_model_golden_nll():
    """TF golden (affine): weights through the JAX importer, bridged; the
    port's fp32 log_p and logdet reproduce TF's at the JAX package's own
    bar (test_tf_parity.py:77, rtol 2e-5)."""
    from flowavenet_tpu.checkpoint.tf_import import import_tf_checkpoint
    from flowavenet_tpu.config import ModelConfig
    from flowavenet_tpu_torch.config import ModelConfig as TModelConfig
    fx = np.load(os.path.join(FIXDIR, "full_model_golden.npz"))
    nb, nf, nl, fs, nm = (int(v) for v in fx["geom"])
    geom = dict(n_block=nb, n_flow=nf, n_layer=nl, filter_size=fs,
                num_mels=nm, upsample_scales=tuple(int(v)
                                                   for v in fx["scales"]),
                n_speakers=3)
    tf_vars = {k[len("var:"):]: fx[k] for k in fx.files
               if k.startswith("var:")}
    params = to_torch(import_tf_checkpoint(tf_vars, ModelConfig(**geom)))
    lp, ld = tfwn.forward(params, TModelConfig(**geom),
                          torch.from_numpy(np.array(fx["x"])),
                          torch.from_numpy(np.array(fx["c"])))
    np.testing.assert_allclose(float(lp), float(fx["log_p"]), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(float(ld), float(fx["logdet"]), rtol=2e-5,
                               atol=2e-6)


def test_nll_golden():
    """The JAX package's pinned NLL (test_model.py:220): its init at
    PRNGKey(1234), bridged, then the port's DDI and forward: rtol 2e-5."""
    from flowavenet_tpu.config import ModelConfig
    from flowavenet_tpu_torch.config import ModelConfig as TModelConfig
    fx = np.load(os.path.join(FIXDIR, "nll_golden.npz"))
    geom = dict(n_block=3, n_flow=2, n_layer=2, filter_size=16, num_mels=8,
                upsample_scales=(4, 4))
    params = to_torch(jfwn.init_flowavenet(jax.random.PRNGKey(1234),
                                           ModelConfig(**geom)))
    r = np.random.RandomState(99)
    x = torch.from_numpy(r.randn(2, 512, 1).astype(np.float32))
    c = torch.from_numpy(r.rand(2, 32, 8).astype(np.float32))
    cfg = TModelConfig(**geom)
    params = tfwn.ddi(params, cfg, x, c)
    lp, ld = tfwn.forward(params, cfg, x, c)
    np.testing.assert_allclose(float(lp), float(fx["log_p"]), rtol=2e-5)
    np.testing.assert_allclose(float(ld), float(fx["logdet"]), rtol=2e-5)


def _loss_and_grads(tp, x, c, **kw):
    p = tree_map(lambda l: l.clone().requires_grad_(), tp)
    total, aux = tfwn.loss_fn(p, CFG, torch.from_numpy(x),
                              torch.from_numpy(c), **kw)
    total.backward()
    return float(total.detach()), {k: float(v.detach())
                                   for k, v in aux.items()}, _grad_tree(p)


@pytest.mark.parametrize("route", ["train", "fwd"])
def test_kernel_routes_match_scan_and_jax(model, monkeypatch, route):
    """The training route (every block, FWN_TRAIN_MAX_CC raised) and the
    forward-kernel route, on the CPU through the kernels' plain versions:
    loss, every statistic the route reports and the whole gradient tree
    vs the port's own scan route and vs the JAX package's same route (its
    Pallas kernels in interpret mode).  Loss and statistics 1e-5 relative;
    gradients 1e-4 worst-leaf relative.  The guards are on for the
    training route (logs_l2 0.05, logs_hinge 1.0) and off for the forward
    route, which refuses them."""
    params, tp, x, c = model
    kw = dict(logs_l2=0.05, logs_hinge=1.0) if route == "train" else {}
    monkeypatch.setattr(jfwn, "PAIR_KERNEL_CPU_INTERPRET", True)
    if route == "train":
        for mod in (jfwn, tfwn):
            monkeypatch.setattr(mod, "TRAIN_KERNEL_MAX_CC", 10 ** 9)
    l0, a0, g0 = _loss_and_grads(tp, x, c, **kw)
    flag = "TRAIN_KERNEL" if route == "train" else "PAIR_KERNEL_FWD"
    monkeypatch.setattr(tfwn, flag, True)
    monkeypatch.setattr(jfwn, flag, True)
    n0 = dict(tpf.LAUNCHES)
    l1, a1, g1 = _loss_and_grads(tp, x, c, **kw)
    assert tpf.LAUNCHES == n0            # CPU: plain versions, no launch
    # jitted: half the time of eager dispatch; on the train route the
    # gradients move by at most 5e-7 relative, the loss not at all
    (lj, aj), gj = jax.jit(jax.value_and_grad(
        lambda p: jfwn.loss_fn(p, CFG, jnp.asarray(x), jnp.asarray(c), **kw),
        has_aux=True))(params)
    keys = (["loss", "logdet", "max_log_s", "logs_mean_sq", "logs_hinge",
             "logs_penalty"] if route == "train" else ["loss", "logdet"])
    for k in keys:
        np.testing.assert_allclose(a1[k], a0[k], rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(a1[k], float(aj[k]), rtol=1e-5,
                                   atol=1e-9)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(l1, float(lj), rtol=1e-5)
    if route == "fwd":
        assert a1["max_log_s"] == 0.0 == float(aj["max_log_s"])
    leaves_j = jax.tree.leaves(gj)
    assert max(_rel(a, b) for a, b in zip(g1, g0)) < 1e-4
    assert max(_rel(a, b) for a, b in zip(g1, leaves_j)) < 1e-4


def test_forward_kernel_route_refuses_guards(model, monkeypatch):
    _, tp, x, c = model
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_FWD", True)
    with pytest.raises(ValueError, match="FWN_FWD_KERNEL"):
        tfwn.loss_fn(tp, CFG, torch.from_numpy(x), torch.from_numpy(c),
                     logs_hinge=1.0)


def test_remat_changes_no_number(model):
    """torch.utils.checkpoint on the scan route (cfg.remat, the default)
    changes neither the loss nor a gradient: the same to the bit."""
    _, tp, x, c = model
    outs = []
    for remat in (True, False):
        p = tree_map(lambda l: l.clone().requires_grad_(), tp)
        cfg = dataclasses.replace(CFG, remat=remat)
        total, _ = tfwn.loss_fn(p, cfg, torch.from_numpy(x),
                                torch.from_numpy(c))
        total.backward()
        outs.append((float(total.detach()), _grad_tree(p)))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_array_equal(a, b)
