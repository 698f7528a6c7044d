"""PyTorch port, hoisted-conditioning and int8 res/skip reverse pairs
(``_pair_kernel_hoisted``, ``_pair_kernel_hoisted_i8``,
``_pair_kernel_i8rs``): the plain versions held against the JAX kernels in
interpret mode, their operand folding against JAX's, and the tiny model
forced onto the hoisted routes against JAX's plain ``reverse``.  The CUDA
kernels are held against the plain versions on the card
(tests/test_torch_card.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import tiny
from flowavenet_tpu.models import flowavenet as jfwn
from flowavenet_tpu.ops import pallas_flow as jpf
from flowavenet_tpu.ops.conv import quantize_act as jquant
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.models import flowavenet as tfwn
from flowavenet_tpu_torch.ops import pair_flow as tpf
from flowavenet_tpu_torch.ops.conv import quantize_act

CFG = tiny().model
OFF = dataclasses.replace(CFG, use_pallas=False)
T = 100
JAX_TILE = 64    # JAX's _fit_tile keeps 64 for T = 100: two tiles, halo 16


def _randomized(cfg, scale=0.1):
    params = jfwn.init_flowavenet(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(7)
    return jax.tree.unflatten(treedef, [
        np.asarray(l) + scale * r.randn(*l.shape).astype(np.float32)
        for l in leaves])


def _rel_corr(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.isfinite(got))
    rel = np.abs(got - want).max() / np.abs(want).max()
    return rel, np.corrcoef(got.ravel(), want.ravel())[0, 1]


@pytest.fixture(scope="module")
def params():
    p = _randomized(CFG)
    return p, to_torch(p)


@pytest.fixture(scope="module")
def jax_runs(params):
    """One JAX interpret-mode call per kernel on block 0's pair, B = 2,
    T = 100, fp32 storage.  hoisted / hoisted_i8 take the cond
    pre-activations c @ w_flow; i8rs takes per-row int8 conditioning."""
    jp_all, tp_all = params
    jp = jax.tree.map(lambda l: l[0], jfwn._pair_params(jp_all["blocks"][0]))
    tpair = tfwn._index(tfwn._pair_params(tp_all["blocks"][0]), 0)
    rng = np.random.RandomState(0)
    u, v = (rng.randn(2, T, 1).astype(np.float32) for _ in range(2))
    ca, cb = (rng.randn(2, T, CFG.num_mels).astype(np.float32)
              for _ in range(2))
    out = {}
    f32 = jnp.float32
    for name, make in (("hoisted", jpf.pair_reverse_operands_hoisted),
                       ("hoisted_i8", jpf.pair_reverse_operands_hoisted_int8)):
        ops, (we, wo) = make(jp, dtype=f32)
        ce, co = jnp.asarray(ca) @ we, jnp.asarray(cb) @ wo
        got = jpf.fused_pair_reverse(jnp.asarray(u), jnp.asarray(v), ce, co,
                                     ops, t_tile=JAX_TILE, interpret=True,
                                     hoisted=True, int8=name != "hoisted")
        out[name] = (np.array(ce), np.array(co), ops, got)
    (qa, sa), (qb, sb) = (jquant(jnp.asarray(ca), per_row=True),
                          jquant(jnp.asarray(cb), per_row=True))
    crs = jnp.concatenate([sa.reshape(-1, 1), sb.reshape(-1, 1)], 1)
    saved = jpf.INT8_RS
    try:
        jpf.INT8_RS = True
        ops = jpf.pair_reverse_operands_int8(jp, dtype=f32)
    finally:
        jpf.INT8_RS = saved
    got = jpf.fused_pair_reverse(jnp.asarray(u), jnp.asarray(v), qa, qb, ops,
                                 t_tile=JAX_TILE, interpret=True, int8=True,
                                 c_row_scales=crs)
    out["i8rs"] = (None, None, ops, got)
    return tpair, (u, v, ca, cb), out


@pytest.mark.parametrize("name", ["hoisted", "hoisted_i8", "i8rs"])
def test_plain_version_matches_jax_kernel(jax_runs, name):
    """Each plain version at the JAX kernel's geometry (tile 64, halo 16:
    the same int8 activation windows) vs the JAX kernel, fp32 storage:
    rel-to-max <= 1e-5 for all three.  The int8 plain versions quantize
    the same windows with the same scales, so only the fp32 summation
    order differs (measured rel 2.4e-7); a wrong res/skip or gate-code
    scale moves the output by far more.  The operands equal JAX's
    folding: int8 codes exactly, floats to 1e-6."""
    tpair, (u, v, ca, cb), out = jax_runs
    ce, co, jops, want = out[name]
    f32 = torch.float32
    if name == "i8rs":
        tops = tpf.pair_reverse_operands_int8(tpair, f32, rs=True)
        (qa, sa), (qb, sb) = (quantize_act(torch.from_numpy(c), True)
                              for c in (ca, cb))
        crs = torch.cat([sa.reshape(-1, 1), sb.reshape(-1, 1)], 1)
        got = tpf.pair_reverse_ref(torch.from_numpy(u), torch.from_numpy(v),
                                   qa, qb, tops, t_tile=JAX_TILE, halo=16,
                                   int8=True, c_row_scales=crs)
    else:
        make = (tpf.pair_reverse_operands_hoisted if name == "hoisted"
                else tpf.pair_reverse_operands_hoisted_int8)
        tops, (we, wo) = make(tpair, f32)
        ce_t = tpf.hoist_cond(torch.from_numpy(ca), we)
        np.testing.assert_allclose(ce_t.numpy(), ce, rtol=1e-5, atol=1e-5)
        got = tpf.pair_reverse_ref(
            *map(torch.from_numpy, (u, v, ce, co)), tops, t_tile=JAX_TILE,
            halo=16, int8=name == "hoisted_i8", hoisted=True)
    assert len(tops) == len(jops)
    for a, b in zip(tops, jops):
        b = np.asarray(b)
        if b.dtype == np.int8:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
    for g, w in zip(got, want):
        rel, _ = _rel_corr(g, w)
        assert rel <= 1e-5, rel


def _model_inputs():
    rs = np.random.RandomState(1)
    z = rs.randn(2, 4096, 1).astype(np.float32)
    mel = rs.rand(2, 16, CFG.num_mels).astype(np.float32)
    return z, mel


@pytest.mark.parametrize("int8", [False, True])
def test_hoisted_model_routing_matches_jax_plain(params, monkeypatch, int8):
    """Every tiny block forced onto the hoisted route (FWN_HOISTED with
    FWN_MAX_CC below every width and Winograd off, as
    test_hoisted_in_model_routing and test_hoisted_int8_model_routing_
    matches_xla force the JAX package), vs JAX's plain reverse: fp32
    rel-to-max <= 1e-5; with FWN_INT8 the JAX int8 bar (rel < 0.08, corr
    > 0.998).  The hoisted blocks take the unquantized conditioning even
    on the int8 route."""
    jp, tp = params
    for n, val in (("PAIR_KERNEL_INT8", int8), ("PAIR_KERNEL_HOISTED", True),
                   ("PAIR_KERNEL_MAX_CC", 1), ("PAIR_KERNEL_WINO", False)):
        monkeypatch.setattr(tfwn, n, val)
    assert {tfwn._pair_kernel_mode(CFG, 80 << k) for k in (0, 1)} == {
        "hoisted"}
    z, mel = _model_inputs()
    want = np.asarray(jfwn.reverse(jp, OFF, jnp.asarray(z), jnp.asarray(mel)))
    got = tfwn.reverse(tp, CFG, torch.from_numpy(z),
                       torch.from_numpy(mel)).numpy()
    rel, corr = _rel_corr(got, want)
    if int8:
        assert rel < 0.08 and corr > 0.998, (rel, corr)
    else:
        assert rel <= 1e-5, rel


def test_int8_rs_model_routing_matches_jax_plain(params, monkeypatch):
    """FWN_INT8_RS=1: both tiny blocks take the int8 pair with int8
    res/skip; vs JAX's plain reverse at the JAX int8 bar."""
    jp, tp = params
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", True)
    monkeypatch.setattr(tfwn, "INT8_RS", True)
    z, mel = _model_inputs()
    want = np.asarray(jfwn.reverse(jp, OFF, jnp.asarray(z), jnp.asarray(mel)))
    got = tfwn.reverse(tp, CFG, torch.from_numpy(z),
                       torch.from_numpy(mel)).numpy()
    rel, corr = _rel_corr(got, want)
    assert rel < 0.08 and corr > 0.998, (rel, corr)
    monkeypatch.setattr(tfwn, "INT8_RS", False)
    plain_i8 = tfwn.reverse(tp, CFG, torch.from_numpy(z),
                            torch.from_numpy(mel)).numpy()
    assert np.abs(plain_i8 - got).max() > 0   # the res/skip codes differ


def test_bound_counts_the_routed_work():
    """The hoisted bound drops the cond 1x1s; the Winograd bound counts
    4/6 (F(2,3)) or 6/12 (F(4,3)) of the direct fg-conv operations."""
    d = tpf.pair_cost(1, 1, 16, 1280)
    h = tpf.pair_cost(1, 1, 16, 1024, hoisted=True)
    assert h["cond_ops"] == 0 and h["fg_ops"] == d["fg_ops"]
    w = tpf.pair_cost(1, 1, 1, 80, fg_mults=4 / 6)
    assert w["fg_ops"] == pytest.approx(tpf.pair_cost(1, 1, 1, 80)["fg_ops"]
                                        * 4 / 6)
    ms, by = tpf.pair_bound_ms(4, 5760, 32, 1024, int8=True, hoisted=True)
    assert by == "operations" and ms > 0
