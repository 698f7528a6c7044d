"""PyTorch port, one-shot synthesis (models/flowavenet.py:reverse): every
route held against the JAX package's ``reverse`` on the same weights and
inputs, the TF goldens, routing, scope and batch-composition invariance."""

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

CFG = tiny().model
OFF = dataclasses.replace(CFG, use_pallas=False)
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
T = 2048


def _randomized(cfg, scale=0.1):
    """Init weights plus 0.1-scale noise (as test_pallas_flow.py does): at
    init the zero convs and ActNorms make reverse the identity."""
    params = jfwn.init_flowavenet(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(7)
    return jax.tree.unflatten(treedef, [
        np.asarray(l) + scale * r.randn(*l.shape).astype(np.float32)
        for l in leaves])


@pytest.fixture(scope="module")
def model():
    params = _randomized(CFG)
    rs = np.random.RandomState(0)
    z = rs.randn(2, T, 1).astype(np.float32)
    mel = rs.rand(2, T // CFG.hop_size, CFG.num_mels).astype(np.float32)
    return params, to_torch(params), z, mel


def _corr_close(got, want, corr_min=0.998, rel_max=0.08):
    """The JAX package's int8 route bar (test_pallas_flow.py:698)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(got))
    rel = float(np.abs(got - want).max()) / max(1e-6, np.abs(want).max())
    corr = float(np.corrcoef(got.ravel(), want.ravel())[0, 1])
    assert rel < rel_max and corr > corr_min, (rel, corr)


def test_plain_route_fp32_matches_jax(model):
    """use_pallas=False in fp32 vs JAX's XLA pair-scan: <= 5e-5 (same
    math; summation order and the cond row permutation differ)."""
    params, tp, z, mel = model
    want = np.asarray(jfwn.reverse(params, OFF, jnp.asarray(z),
                                   jnp.asarray(mel)))
    got = tfwn.reverse(tp, OFF, torch.from_numpy(z), torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("int8", [True, False])
def test_pair_routes_match_jax_routes(model, monkeypatch, int8):
    """The default int8 route and the FWN_INT8=0 route (direct pair; JAX
    with FWN_WINO=0), the port's pair at its own tile on the CPU vs the JAX
    kernels in interpret mode: the JAX package's _corr_close bar.  (Their
    int8 activation windows differ with the tile, so int8 is not exact.)"""
    params, tp, z, mel = model
    monkeypatch.setattr(jfwn, "PAIR_KERNEL_CPU_INTERPRET", True)
    monkeypatch.setattr(jfwn, "PAIR_KERNEL_INT8", int8)
    monkeypatch.setattr(jfwn, "PAIR_KERNEL_WINO", False)
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", int8)
    want = np.asarray(jfwn.reverse(params, CFG, jnp.asarray(z),
                                   jnp.asarray(mel)))
    got = tfwn.reverse(tp, CFG, torch.from_numpy(z), torch.from_numpy(mel))
    _corr_close(got.numpy(), want)
    if not int8:
        # fp32 without int8 is the same math at any tile: the float bar
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=5e-5)


def test_bf16_matches_jax_bf16(model):
    """bf16 compute, plain route, vs JAX bf16: corr >= 0.999 (the two
    frameworks round to bf16 at slightly different points)."""
    params, tp, z, mel = model
    want = np.asarray(jfwn.reverse(params, OFF, jnp.asarray(z),
                                   jnp.asarray(mel),
                                   compute_dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    got = tfwn.reverse(tp, OFF, torch.from_numpy(z), torch.from_numpy(mel),
                       compute_dtype=torch.bfloat16).float().numpy()
    assert np.all(np.isfinite(got))
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.999


@pytest.mark.parametrize("variant", ["", "mid"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_reverse_recovers_tf_golden_audio(monkeypatch, variant, use_pallas):
    """TF golden weights (imported with the JAX importer, then bridged):
    the port's fp32 reverse of TF's latent recovers x at atol 5e-4 (the JAX
    package's own bar, test_tf_parity.py:89), on the plain route and on
    the direct pair route."""
    from flowavenet_tpu.checkpoint.tf_import import import_tf_checkpoint
    from flowavenet_tpu.config import ModelConfig
    from flowavenet_tpu_torch.config import ModelConfig as TModelConfig
    from flowavenet_tpu_torch.ops.squeeze import unsqueeze
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", False)
    suffix = f"_{variant}" if variant else ""
    fx = np.load(os.path.join(FIXDIR, f"full_model_golden{suffix}.npz"))
    nb, nf, nl, fs, nm = (int(v) for v in fx["geom"])
    scales = tuple(int(v) for v in fx["scales"])
    geom = dict(n_block=nb, n_flow=nf, n_layer=nl, filter_size=fs,
                num_mels=nm, upsample_scales=scales, n_speakers=3)
    tf_vars = {k[len("var:"):]: fx[k] for k in fx.files
               if k.startswith("var:")}
    params = import_tf_checkpoint(tf_vars, ModelConfig(**geom))
    cfg = TModelConfig(**geom, use_pallas=use_pallas)
    z = torch.from_numpy(np.array(fx["z"]))
    for _ in range(nb):
        z = unsqueeze(z)
    x = tfwn.reverse(to_torch(params), cfg, z,
                     torch.from_numpy(np.array(fx["c"])))
    np.testing.assert_allclose(x.numpy(), fx["x"], atol=5e-4)


@pytest.mark.parametrize("deep", [False, True])
def test_int8_route_batch_composition_invariant(model, monkeypatch, deep):
    """Per-row conditioning scales: a row's audio is bit-identical whatever
    its batch companion holds (as test_pallas_flow.py:763 holds the JAX
    package).  ``deep`` sends every block down the plain scan with int8
    conditioning instead of the fused pair."""
    _, tp, z, mel = model
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", True)
    if deep:
        monkeypatch.setattr(tfwn, "_pair_max_cc", lambda: 0)
    quiet = np.random.RandomState(3).rand(*mel[1:].shape).astype(np.float32)
    outs = [tfwn.reverse(tp, CFG, torch.from_numpy(z), torch.from_numpy(
        np.concatenate([mel[:1], comp]))) for comp in (quiet, 5.0 * quiet)]
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())


def test_routing_follows_width_and_int8_switch(monkeypatch):
    """Fused pair on cc_half <= 1280 with int8 (blocks 0-4 of lj22k),
    <= 640 without (blocks 0-3); plain scan otherwise or with
    use_pallas=False."""
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", True)
    assert tfwn._pair_kernel_mode(CFG, 1280) == "int8"
    assert tfwn._pair_kernel_mode(CFG, 2560) is None
    assert tfwn._pair_kernel_mode(OFF, 80) is None
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", False)
    assert tfwn._pair_kernel_mode(CFG, 640) == "direct"
    assert tfwn._pair_kernel_mode(CFG, 1280) is None
    lj = [(80 << bi) for bi in range(8)]
    assert sum(tfwn._pair_kernel_mode(CFG, c) is not None for c in lj) == 4
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", True)
    assert sum(tfwn._pair_kernel_mode(CFG, c) is not None for c in lj) == 5


@pytest.mark.parametrize("change,match", [
    (dict(causal=True), "causal"), (dict(affine=False), "additive"),
    (dict(gin_channels=4), "global conditioning"),
    (dict(n_flow=3), "odd n_flow"), (dict(logs_clamp=3.0), "logs_clamp"),
    (dict(n_layer=3), "n_layer")])
def test_paths_outside_the_slice_raise(model, change, match):
    """Paths this slice does not port raise NotImplementedError naming the
    JAX code they would need."""
    _, tp, z, mel = model
    with pytest.raises(NotImplementedError, match=match):
        tfwn.reverse(tp, dataclasses.replace(CFG, **change),
                     torch.from_numpy(z), torch.from_numpy(mel))


def test_shape_errors_name_the_constraint(model):
    _, tp, z, mel = model
    with pytest.raises(ValueError, match="misaligned"):
        tfwn.reverse(tp, CFG, torch.from_numpy(z), torch.from_numpy(mel[:, 1:]))
