"""PyTorch port, primitives: config, flags, squeeze layouts, convs,
upsampler and the WaveNet coupling net, held against the JAX package on the
same numpy inputs (CPU)."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu import config as jcfg
from flowavenet_tpu.models import modules as jmod
from flowavenet_tpu.ops import conv as jconv
from flowavenet_tpu_torch import config as tcfg
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.models import modules as tmod
from flowavenet_tpu_torch.models.upsample import apply_upsample
from flowavenet_tpu_torch.ops import conv as tconv
from flowavenet_tpu_torch.ops import squeeze as tsq

# the JAX package's ops/__init__ re-exports a function named ``squeeze``
jsq = importlib.import_module("flowavenet_tpu.ops.squeeze")

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_match_and_round_trip(name):
    """Every preset equals the JAX package's field for field, and the JSON
    written by either package loads in the other unchanged."""
    t, j = tcfg.get_config(name), jcfg.get_config(name)
    assert t.to_json() == j.to_json()
    assert tcfg.Config.from_json(j.to_json()) == t
    assert jcfg.Config.from_json(t.to_json()) == j


@pytest.mark.parametrize("raw,want", [("0", False), ("off", False),
                                      ("1", True), ("yes", True)])
def test_env_flag_parses_like_jax(monkeypatch, raw, want):
    from flowavenet_tpu.utils.flags import env_flag as jflag
    from flowavenet_tpu_torch.utils.flags import env_flag as tflag
    monkeypatch.setenv("FWN_INT8", raw)
    assert tflag("FWN_INT8", default=True) is jflag("FWN_INT8") is want


def test_env_flag_rejects_garbage(monkeypatch):
    from flowavenet_tpu_torch.utils.flags import env_flag
    monkeypatch.setenv("FWN_INT8", "maybe")
    with pytest.raises(ValueError, match="FWN_INT8"):
        env_flag("FWN_INT8")


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_squeeze_layouts_bit_exact(rng, k):
    """Layouts are pure data movement: bit-exact."""
    x = rng.randn(2, 64, 5).astype(np.float32)
    np.testing.assert_array_equal(tsq.squeeze(_t(x)).numpy(),
                                  np.asarray(jsq.squeeze(jnp.asarray(x))))
    x2 = rng.randn(2, 32, 6).astype(np.float32)
    np.testing.assert_array_equal(tsq.unsqueeze(_t(x2)).numpy(),
                                  np.asarray(jsq.unsqueeze(jnp.asarray(x2))))
    np.testing.assert_array_equal(
        tsq.squeeze_to_level(_t(x), k).numpy(),
        np.asarray(jsq.squeeze_to_level(jnp.asarray(x), k)))
    np.testing.assert_array_equal(tsq.squeeze_level_cond_perm(k, 5),
                                  jsq.squeeze_level_cond_perm(k, 5))
    np.testing.assert_array_equal(
        tsq.change_order(_t(x2)).numpy(),
        np.asarray(jsq.change_order(jnp.asarray(x2))))


def test_cond_perm_reshape_equals_squeeze(rng):
    """The free reshape view with permuted weight rows equals the squeezed
    conditioning through a 1x1 (same products, reordered sum: 1e-5)."""
    k, c = 3, 5
    x = _t(rng.randn(2, 64, c).astype(np.float32))
    w = _t(rng.randn(c << k, 7).astype(np.float32))
    perm = torch.as_tensor(tsq.squeeze_level_cond_perm(k, c))
    a = tsq.squeeze_to_level(x, k) @ w
    b = x.reshape(2, 64 >> k, c << k) @ w[perm]
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


def test_wn_conv_matches_tf_golden():
    """Non-causal weight-normed dilated conv vs the TF golden, at the
    JAX package's own bar (test_tf_parity.py: atol 2e-5)."""
    fx = np.load(os.path.join(FIXDIR, "wnconv_golden.npz"))
    p = {"v": _t(fx["v"]), "g": _t(fx["g"]), "b": _t(fx["b"])}
    out = tconv.wn_conv1d(_t(fx["x"]), p, dilation=int(fx["d"]))
    np.testing.assert_allclose(out.numpy(), fx["out_noncausal"], atol=2e-5)
    with pytest.raises(NotImplementedError, match="causal"):
        tconv.wn_conv1d(_t(fx["x"]), p, dilation=int(fx["d"]), causal=True)


def test_upsample_matches_tf_golden():
    """Dense phase-matmul upsampler vs the TF golden: atol 2e-5, as
    test_tf_parity.py:31 holds the JAX package."""
    fx = np.load(os.path.join(FIXDIR, "upsample_golden.npz"))
    scales = tuple(int(s) for s in fx["scales"])
    params = [{"v": _t(fx[f"v{i}"]), "g": _t(fx[f"g{i}"]),
               "b": _t(fx[f"b{i}"])} for i in range(len(scales))]
    out = apply_upsample(params, _t(fx["c"]), scales)
    np.testing.assert_allclose(out.numpy(), fx["out"], atol=2e-5)


def test_upsample_matches_jax_lj22k_scales(rng):
    """The lj22k scales (16, 16) vs the JAX dense upsampler, fp32: 1e-5
    (same taps, fp32 accumulation)."""
    from flowavenet_tpu.models.upsample import apply_upsample as jup
    from flowavenet_tpu.models.upsample import init_upsample
    params = init_upsample(jax.random.PRNGKey(1), (16, 16))
    c = rng.rand(2, 5, 80).astype(np.float32)
    want = np.asarray(jup(params, jnp.asarray(c), (16, 16)))
    got = apply_upsample(to_torch(params), _t(c), (16, 16)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("per_row", [False, True])
def test_quantize_act_matches_jax(rng, per_row):
    """int8 codes and scales are bit-exact (same max-abs, same division,
    round-half-even)."""
    x = (rng.randn(3, 40, 16) * np.array([1.0, 5.0, 0.1])[:, None, None]
         ).astype(np.float32)
    qt, st = tconv.quantize_act(_t(x), per_row=per_row)
    qj, sj = jconv.quantize_act(jnp.asarray(x), per_row=per_row)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_conv1x1_int8_matches_jax(rng):
    """int8 1x1 (torch._int_mm) vs JAX's int32 einsum: the int32 sums are
    exact on both sides, so only the fp32 dequant order can differ: 1e-6
    relative."""
    x = rng.randn(2, 24, 32).astype(np.float32)
    k = rng.randn(1, 32, 16).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    qj, sj = jconv.quantize_act(jnp.asarray(x), per_row=True)
    want = np.asarray(jconv.conv1x1_int8(qj, sj, jnp.asarray(k),
                                         jnp.asarray(b), jnp.float32))
    qt, st = tconv.quantize_act(_t(x), per_row=True)
    got = tconv.conv1x1_int8(qt, st, _t(k), _t(b), torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="M > 16"):
        tconv.conv1x1_int8(qt[:, :8], st, _t(k), _t(b), torch.float32)


def _wavenet_params(cin, r, cc, out):
    p = jmod.init_wavenet(jax.random.PRNGKey(3), in_channels=cin,
                          out_channels=out, num_layers=2,
                          residual_channels=r, cin_channels=cc)
    leaves, treedef = jax.tree.flatten(p)
    rs = np.random.RandomState(7)
    return jax.tree.unflatten(treedef, [
        np.asarray(l) + 0.1 * rs.randn(*l.shape).astype(np.float32)
        for l in leaves])


def test_apply_wavenet_fp32_matches_jax(rng):
    """The coupling net in fp32 vs JAX apply_wavenet: <= 1e-5 (same math,
    different summation order)."""
    p = _wavenet_params(2, 32, 24, 4)
    x = rng.randn(2, 50, 2).astype(np.float32)
    c = rng.randn(2, 50, 24).astype(np.float32)
    want = np.asarray(jmod.apply_wavenet(p, jnp.asarray(x), jnp.asarray(c),
                                         causal=False))
    got = tmod.apply_wavenet(to_torch(p), _t(x), _t(c)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_apply_wavenet_int8_cond_matches_jax(rng):
    """The deep-block route's int8 conditioning ((q, scale) pairs): the
    int8 codes are identical, so the nets agree to fp32 rounding: 1e-5."""
    p = _wavenet_params(2, 32, 24, 4)
    x = rng.randn(2, 50, 2).astype(np.float32)
    c = rng.randn(2, 50, 24).astype(np.float32)
    cj = jconv.quantize_act(jnp.asarray(c), per_row=True)
    want = np.asarray(jmod.apply_wavenet(p, jnp.asarray(x), cj,
                                         causal=False))
    ct = tconv.quantize_act(_t(c), per_row=True)
    got = tmod.apply_wavenet(to_torch(p), _t(x), ct).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_init_matches_jax_tree_structure():
    """init_flowavenet builds the JAX package's tree: same keys, shapes and
    dtypes at every leaf (values differ: another generator)."""
    from flowavenet_tpu.models.flowavenet import init_flowavenet as jinit
    from flowavenet_tpu_torch.checkpoint.bridge import flatten
    from flowavenet_tpu_torch.models.flowavenet import init_flowavenet
    cfg = tcfg.tiny().model
    tp = init_flowavenet(torch.Generator().manual_seed(0), cfg)
    jp = jinit(jax.random.PRNGKey(0), jcfg.tiny().model)
    ft = flatten(tp)
    fj = {jax.tree_util.keystr(k): v
          for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert sorted(ft) == sorted(fj)
    for k in fj:
        assert tuple(ft[k].shape) == fj[k].shape, k
        assert ft[k].dtype == torch.float32, k
