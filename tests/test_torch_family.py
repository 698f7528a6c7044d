"""PyTorch port, the generic flow family and global conditioning
(models/flowavenet.py): causal and additive couplings, odd n_flow (the
generic flow scan), logs_clamp, n_layer = 3, odd num_mels (the per-level
conditioning squeeze) and speaker conditioning held against the JAX
package's forward / reverse / ddi / loss_fn and gradients on the same
weights and inputs; the four TF goldens of the variant matrix; the route
predicates against the JAX package's for every combination."""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import tiny, tiny_gin
from flowavenet_tpu.models import flowavenet as jfwn
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.config import ModelConfig as TModelConfig
from flowavenet_tpu_torch.models import flowavenet as tfwn
from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.utils.tree import tree_map

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
BASE = tiny().model
VARIANTS = {
    "causal": dict(causal=True),
    "additive": dict(affine=False),
    "n_flow3": dict(n_flow=3),
    "logs_clamp": dict(logs_clamp=3.0),
    "n_layer3": dict(n_layer=3),
    "odd_mels": dict(num_mels=79),
    "gin": dataclasses.asdict(tiny_gin().model),
}
T = 1024


def _cfgs(name):
    """(JAX config, port config) of a variant: the tiny model changed."""
    j = dataclasses.replace(BASE, **VARIANTS[name])
    return j, TModelConfig(**dataclasses.asdict(j))


def _randomized(cfg, scale=0.05, seed=3):
    params = jfwn.init_flowavenet(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(l) + scale * r.randn(*l.shape).astype(np.float32)
        for l in leaves])


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    params = _randomized(jcfg)
    r = np.random.RandomState(4)
    x = (0.3 * r.randn(2, T, 1)).astype(np.float32)
    c = r.rand(2, T // jcfg.hop_size, jcfg.num_mels).astype(np.float32)
    g = (np.array([1, 3], np.int32) if jcfg.gin_channels > 0 else None)
    return request.param, jcfg, tcfg, params, to_torch(params), x, c, g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _jg(g):
    return None if g is None else jnp.asarray(g)


def _tg(g):
    return None if g is None else torch.from_numpy(g)


def test_loss_stats_and_gradients_match_jax(model):
    """fp32 loss_fn with the guards on (logs_l2 0.05, logs_hinge 1.0) and
    remat: loss, log_p, logdet, every statistic and the whole gradient tree
    vs JAX's value_and_grad, at test_torch_forward.py's bars: scalars 1e-5
    relative, gradients 1e-4 worst-leaf relative."""
    name, jcfg, tcfg, params, tp, x, c, g = model
    kw = dict(logs_l2=0.05, logs_hinge=1.0)
    (lj, aj), gj = jax.value_and_grad(
        lambda p: jfwn.loss_fn(p, jcfg, jnp.asarray(x), jnp.asarray(c),
                               _jg(g), **kw), has_aux=True)(params)
    p = tree_map(lambda l: l.clone().requires_grad_(), tp)
    total, at = tfwn.loss_fn(p, tcfg, torch.from_numpy(x),
                             torch.from_numpy(c), _tg(g), **kw)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(lj), rtol=1e-5)
    assert set(at) == set(aj)
    for k in aj:
        np.testing.assert_allclose(float(at[k]), float(aj[k]), rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    flat = []
    tree_map(lambda l: flat.append(np.zeros(l.shape, np.float32)
                                   if l.grad is None else l.grad.numpy()), p)
    leaves_j = jax.tree.leaves(gj)
    assert len(flat) == len(leaves_j)
    assert max(_rel(a, b) for a, b in zip(flat, leaves_j)) < 1e-4, name


def test_ddi_matches_jax(model):
    """DDI in fp32: worst-leaf relative 1e-4 over the whole tree."""
    name, jcfg, tcfg, params, tp, x, c, g = model
    pj = jfwn.ddi(params, jcfg, jnp.asarray(x), jnp.asarray(c), _jg(g))
    pt = tfwn.ddi(tp, tcfg, torch.from_numpy(x), torch.from_numpy(c),
                  _tg(g))
    flat_t = []
    tree_map(lambda l: flat_t.append(l.numpy()), pt)
    leaves_j = jax.tree.leaves(pj)
    assert len(flat_t) == len(leaves_j)
    assert max(_rel(a, b) for a, b in zip(flat_t, leaves_j)) < 1e-4, name


def test_reverse_matches_jax(model):
    """fp32 reverse vs JAX's reverse (its XLA scans: no kernel routes on
    the CPU): 5e-5, as test_torch_reverse.py holds the plain route.  The
    port runs its default routes (the variants are not kernel-eligible,
    except odd num_mels, whose per-level route is checked with the kernels
    off here and on, through their plain versions, below)."""
    name, jcfg, tcfg, params, tp, _, c, g = model
    r = np.random.RandomState(0)
    z = r.randn(2, T, 1).astype(np.float32)
    want = np.asarray(jfwn.reverse(params, jcfg, jnp.asarray(z),
                                   jnp.asarray(c), _jg(g)))
    off = dataclasses.replace(tcfg, use_pallas=False)
    n0 = dict(launch.LAUNCHES)
    for cfg in (tcfg, off) if name != "odd_mels" else (off,):
        got = tfwn.reverse(tp, cfg, torch.from_numpy(z), torch.from_numpy(c),
                           _tg(g)).numpy()
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)
    assert launch.LAUNCHES == n0
    if name == "odd_mels":
        # the per-level route on the int8 pair (mel halves quantized per
        # row): the JAX package's int8 bar (test_pallas_flow.py:698)
        assert tfwn._pair_kernel_mode(tcfg, 79) == "int8"
        got = tfwn.reverse(tp, tcfg, torch.from_numpy(z),
                           torch.from_numpy(c)).numpy()
        assert _rel(got, want) < 0.08
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.998


def test_gin_speakers_change_the_audio_and_parity_drops_them():
    """Two speaker ids give different audio; with parity_drop_global_cond
    they give the same audio, equal to JAX's at 5e-5."""
    jcfg, tcfg = _cfgs("gin")
    params = _randomized(jcfg)
    tp = to_torch(params)
    r = np.random.RandomState(1)
    z = torch.from_numpy(r.randn(1, T, 1).astype(np.float32))
    c = torch.from_numpy(r.rand(1, T // jcfg.hop_size, jcfg.num_mels)
                         .astype(np.float32))
    a, b = (tfwn.reverse(tp, tcfg, z, c, torch.tensor([s])) for s in (0, 2))
    assert float((a - b).abs().max()) > 1e-3
    # without g the kernel routes are eligible: plain here, as JAX on CPU
    drop = dataclasses.replace(tcfg, parity_drop_global_cond=True,
                               use_pallas=False)
    a, b = (tfwn.reverse(tp, drop, z, c, torch.tensor([s])) for s in (0, 2))
    assert torch.equal(a, b)
    want = np.asarray(jfwn.reverse(
        params, dataclasses.replace(jcfg, parity_drop_global_cond=True),
        jnp.asarray(z.numpy()), jnp.asarray(c.numpy()), jnp.asarray([0])))
    np.testing.assert_allclose(a.numpy(), want, atol=5e-5, rtol=5e-5)
    with pytest.raises(ValueError, match="speaker ids"):
        tfwn.reverse(tp, tcfg, z, c)


@pytest.mark.parametrize("variant", ["causal", "additive", "gin", "mid"])
def test_tf_golden_nll_and_inversion(monkeypatch, variant):
    """The TF goldens of the variant matrix (weights through the JAX
    importer, bridged): the port's fp32 log_p and logdet at rtol 2e-5 and
    atol 2e-6, and its reverse of TF's latent recovering x at atol 5e-4,
    the JAX package's own bars (test_tf_parity.py:77-89).  The gin golden
    runs with parity_drop_global_cond, as the reference drops g.  Reverse
    runs with FWN_INT8=0 (the Winograd pairs' plain versions on the
    eligible blocks), as test_torch_reverse.py does for the others."""
    from flowavenet_tpu.checkpoint.tf_import import import_tf_checkpoint
    from flowavenet_tpu.config import ModelConfig
    from flowavenet_tpu_torch.ops.squeeze import unsqueeze
    fx = np.load(os.path.join(FIXDIR, f"full_model_golden_{variant}.npz"))
    nb, nf, nl, fs, nm = (int(v) for v in fx["geom"])
    geom = dict(n_block=nb, n_flow=nf, n_layer=nl, filter_size=fs,
                num_mels=nm, upsample_scales=tuple(int(v)
                                                   for v in fx["scales"]),
                causal=variant == "causal", affine=variant != "additive",
                gin_channels=4 if variant == "gin" else -1, n_speakers=3,
                parity_drop_global_cond=variant == "gin")
    tf_vars = {k[len("var:"):]: fx[k] for k in fx.files
               if k.startswith("var:")}
    params = to_torch(import_tf_checkpoint(tf_vars, ModelConfig(**geom)))
    cfg = TModelConfig(**geom)
    g = torch.from_numpy(np.array(fx["g"])) if variant == "gin" else None
    c = torch.from_numpy(np.array(fx["c"]))
    lp, ld = tfwn.forward(params, cfg, torch.from_numpy(np.array(fx["x"])),
                          c, g)
    np.testing.assert_allclose(float(lp), float(fx["log_p"]), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(float(ld), float(fx["logdet"]), rtol=2e-5,
                               atol=2e-6)
    z = torch.from_numpy(np.array(fx["z"]))
    for _ in range(nb):
        z = unsqueeze(z)
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", False)
    x = tfwn.reverse(params, cfg, z, c, g)
    np.testing.assert_allclose(x.numpy(), fx["x"], atol=5e-4)


def test_route_predicates_match_jax(monkeypatch):
    """Every route predicate of the port against the JAX package's, over
    every combination of global conditioning, affine, causal, n_layer,
    logs_clamp, use_pallas, n_flow and the switches FWN_INT8, FWN_WINO,
    FWN_HOISTED, FWN_TRAIN_KERNEL and FWN_FWD_KERNEL, at every lj22k
    conditioning width: the reverse pair mode (_pair_kernel_mode), the
    forward-kernel route (JAX block_forward:592-593, :621-622), the
    one-time int8 mel quantization (reverse:1060-1061) and the deep-block
    int8 scan's quantization (block_reverse:819)."""
    monkeypatch.setattr(jfwn, "PAIR_KERNEL_CPU_INTERPRET", True)
    names = ("PAIR_KERNEL_INT8", "PAIR_KERNEL_WINO", "PAIR_KERNEL_HOISTED",
             "TRAIN_KERNEL", "PAIR_KERNEL_FWD")
    widths = [80 << k for k in range(8)]
    seen = set()
    for switches in itertools.product((False, True), repeat=len(names)):
        for n, v in zip(names, switches):
            monkeypatch.setattr(jfwn, n, v)
            monkeypatch.setattr(tfwn, n, v)
        for has_g, affine, causal, nl, clamp, on, nf in itertools.product(
                (False, True), (True, False), (False, True), (2, 3),
                (0.0, 3.0), (True, False), (6, 3)):
            cfg = dataclasses.replace(BASE, affine=affine, causal=causal,
                                      n_layer=nl, logs_clamp=clamp,
                                      use_pallas=on, n_flow=nf)
            ok = jfwn._pair_kernel_eligible(cfg, has_g)
            assert tfwn._pair_kernel_eligible(cfg, has_g) == ok
            assert tfwn._int8_mel(cfg, has_g) == bool(
                jfwn.PAIR_KERNEL_INT8 and not has_g and nf % 2 == 0
                and jfwn._pair_kernel_eligible(cfg, False))
            for cc in widths:
                mode = jfwn._pair_kernel_mode(cfg, cc, has_g)
                assert tfwn._pair_kernel_mode(cfg, cc, has_g) == mode
                want = None
                if ok and jfwn.TRAIN_KERNEL and cc <= jfwn.TRAIN_KERNEL_MAX_CC:
                    want = "train"
                elif (ok and jfwn.PAIR_KERNEL_FWD
                      and cc <= jfwn.PAIR_KERNEL_FWD_MAX_CC):
                    want = "fwd"
                assert tfwn._forward_route(cfg, cc, has_g) == want
                seen.add((mode, want))
    assert {m for m, _ in seen} == {"int8", "wino", "direct", "hoisted",
                                    None}
    assert {w for _, w in seen} == {"train", "fwd", None}


def test_bridge_carries_speaker_weights_both_ways(tmp_path):
    """speaker_emb and the g convs cross the npz bridge unchanged, and the
    port's init builds the JAX package's gin tree."""
    from flowavenet_tpu_torch.checkpoint.bridge import (flatten,
                                                        load_params_npz,
                                                        save_params)
    jcfg, tcfg = _cfgs("gin")
    params = _randomized(jcfg)
    path = save_params(str(tmp_path / "ckpt-0.npz"), to_torch(params))
    back, _ = load_params_npz(path)
    fj = {jax.tree_util.keystr(k): np.asarray(v)
          for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    fb = flatten(back)
    assert sorted(fb) == sorted(fj)
    assert any("speaker_emb" in k for k in fj)
    assert any("filter_g" in k for k in fj)
    for k in fj:
        np.testing.assert_array_equal(fb[k], fj[k])
    ti = flatten(tfwn.init_flowavenet(torch.Generator().manual_seed(0),
                                      tcfg))
    assert sorted(ti) == sorted(fj)
    for k in fj:
        assert tuple(ti[k].shape) == fj[k].shape, k
