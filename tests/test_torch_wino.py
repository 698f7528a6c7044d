"""PyTorch port, Winograd reverse pair (``_pair_kernel_wino``, F(2,3) and
F(4,3)) and the route switches: the plain version ``pair_reverse_wino_ref``
held against the JAX kernel in interpret mode, ``_pair_kernel_mode``
against the JAX package's for every switch combination, and the tiny
model's FWN_INT8=0 route against JAX's plain ``reverse``.  The CUDA kernel
is held against the plain version on the card (tests/test_torch_card.py,
chip_smoke.py)."""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import tiny
from flowavenet_tpu.models import flowavenet as jfwn
from flowavenet_tpu.ops import pallas_flow as jpf
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.models import flowavenet as tfwn
from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.ops import pair_flow as tpf

CFG = tiny().model
OFF = dataclasses.replace(CFG, use_pallas=False)
T = 100          # not a multiple of 48 (JAX's tile alignment) nor of 6, 12


def _randomized(cfg, scale=0.1):
    """Init plus 0.1-scale noise (at init a pair is the identity)."""
    params = jfwn.init_flowavenet(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(7)
    return jax.tree.unflatten(treedef, [
        np.asarray(l) + scale * r.randn(*l.shape).astype(np.float32)
        for l in leaves])


@pytest.fixture(scope="module")
def params():
    p = _randomized(CFG)
    return p, to_torch(p)


@pytest.fixture(scope="module")
def jax_runs(params):
    """One JAX interpret-mode call per variant (the slow part), made when a
    test first asks for it: block 0's pair, B = 2, T = 100.  F(2,3) in fp32
    runs on three JAX tiles of 48 (the tile shrunk as test_wino_multi_tile
    does), the others on one.  The hoisted variants
    (``_pair_kernel_wino_hoisted``) get the conditioning pre-activations
    c_half @ hoist_w, rounded once to the storage type, which the port's
    runs are handed as they are."""
    jp_all, tp_all = params
    jp = jax.tree.map(lambda l: l[0], jfwn._pair_params(jp_all["blocks"][0]))
    tpair = tfwn._index(tfwn._pair_params(tp_all["blocks"][0]), 0)
    rng = np.random.RandomState(0)
    x = [rng.randn(2, T, 1).astype(np.float32) for _ in range(2)]
    x += [rng.randn(2, T, CFG.num_mels).astype(np.float32) for _ in range(2)]
    return tpair, x, functools.cache(lambda name: _jax_run(jp, x, name))


def _jax_run(jp, x, name):
    """The variant's outputs, and its hoisted pre-activations or None."""
    P = 12 if name.startswith("f43") else 6
    jdt = jnp.bfloat16 if "bf16" in name else jnp.float32
    hoisted = name.endswith("hoisted")
    hoist = None
    saved = jpf.WINO_T_TILE
    try:
        jpf.WINO_T_TILE = 48 if name == "f23_fp32" else saved
        make = (jpf.pair_reverse_operands_wino4 if P == 12
                else jpf.pair_reverse_operands_wino)
        args = [jnp.asarray(a, jdt) for a in x]
        ops = make(jp, dtype=jdt)
        if hoisted:
            # pop cond_w; the hoist matmul sums in fp32 and rounds once
            ops = list(ops)
            cond_w = ops.pop(3)
            w = jnp.concatenate([cond_w[:, l] for l in range(2)], -1)
            args[2:] = [jnp.dot(args[2 + f], w[f],
                                preferred_element_type=jnp.float32
                                ).astype(jdt) for f in range(2)]
            hoist = [np.array(a.astype(jnp.float32)) for a in args[2:]]
        got = jpf.fused_pair_reverse_wino(
            *args, tuple(ops), interpret=True, phases=P, hoisted=hoisted)
    finally:
        jpf.WINO_T_TILE = saved
    return [np.asarray(g.astype(jnp.float32)) for g in got], hoist


@pytest.mark.parametrize("name", ["f23_fp32", "f43_fp32", "f23_bf16"])
def test_plain_wino_matches_jax_kernel(jax_runs, name):
    """The plain version at two of its own tiles (several windows, a ragged
    last one) vs the JAX kernel.  fp32: rel-to-max <= 1e-5 (measured
    2e-7: summation order).  bf16: the same rounding points (the input
    transforms round each operation in bf16); measured bit-identical,
    asserted at one bf16 ulp of the largest output (2^-7)."""
    tpair, x, run = jax_runs
    out, _ = run(name)
    P = 12 if name.startswith("f43") else 6
    dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
    make = (tpf.pair_reverse_operands_wino4 if P == 12
            else tpf.pair_reverse_operands_wino)
    ops = make(tpair, dtype=dt)
    assert tuple(ops[2].shape[2:4]) == (4 if P == 6 else 6, CFG.filter_size)
    bar = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    for tile in (2 * P, 5 * P):
        got = tpf.pair_reverse_wino_ref(
            *[torch.from_numpy(a).to(dt) for a in x], ops, t_tile=tile)
        for g, w in zip(got, out):
            g = g.float().numpy()
            assert np.all(np.isfinite(g))
            assert np.abs(g - w).max() <= bar * np.abs(w).max(), (name, tile)


@pytest.mark.parametrize("name", ["f23_fp32", "f43_fp32", "f23_bf16",
                                  "f43_bf16"])
def test_plain_wino_hoisted_matches_jax_kernel(jax_runs, name):
    """_pair_kernel_wino_hoisted: the plain version (hoisted) at two of its
    own tiles vs the JAX kernel on the same pre-activations, with the
    operands of pop_cond_w (F(2,3)) and pair_reverse_operands_wino4(
    hoisted=True) (F(4,3)), bars as the Winograd pair's above."""
    tpair, x, run = jax_runs
    name = name + "_hoisted"
    out, hoist = run(name)
    P = 12 if name.startswith("f43") else 6
    dt = torch.bfloat16 if "bf16" in name else torch.float32
    if P == 12:
        ops, (w_e, w_o) = tpf.pair_reverse_operands_wino4(tpair, dt,
                                                          hoisted=True)
    else:
        ops, (w_e, w_o) = tpf.pop_cond_w(
            tpf.pair_reverse_operands_wino(tpair, dt))
    assert len(ops) == 14 and tuple(w_e.shape) == (CFG.num_mels,
                                                   4 * CFG.filter_size)
    # the port's hoist of the same mel halves agrees with JAX's
    ce = tpf.hoist_cond(torch.from_numpy(x[2]).to(dt), w_e).float().numpy()
    bar = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    assert np.abs(ce - hoist[0]).max() <= bar * np.abs(ce).max()
    args = [torch.from_numpy(a).to(dt) for a in x[:2] + hoist]
    for tile in (2 * P, 5 * P):
        got = tpf.pair_reverse_wino_ref(*args, ops, t_tile=tile,
                                        hoisted=True)
        for g, w in zip(got, out):
            g = g.float().numpy()
            assert np.all(np.isfinite(g))
            assert np.abs(g - w).max() <= bar * np.abs(w).max(), (name, tile)
    n0 = dict(launch.LAUNCHES)
    got = tpf.fused_pair_reverse_wino(*args, ops, hoisted=True)
    assert launch.LAUNCHES == n0                  # CPU: the plain version
    for g, w in zip(got, out):
        assert np.abs(g.float().numpy() - w).max() <= bar * np.abs(w).max()


def test_wino_operands_match_jax_folding(params):
    """The G-transform runs in fp32, then the weights are cast: the port's
    F(2,3) and F(4,3) operands equal JAX's to fp32 rounding."""
    jp_all, tp_all = params
    jp = jax.tree.map(lambda l: l[0], jfwn._pair_params(jp_all["blocks"][1]))
    tpair = tfwn._index(tfwn._pair_params(tp_all["blocks"][1]), 0)
    for jmake, tmake in ((jpf.pair_reverse_operands_wino,
                          tpf.pair_reverse_operands_wino),
                         (jpf.pair_reverse_operands_wino4,
                          tpf.pair_reverse_operands_wino4)):
        jops, tops = jmake(jp, jnp.float32), tmake(tpair, torch.float32)
        assert len(jops) == len(tops) == 15
        for a, b in zip(tops, jops):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_pair_kernel_mode_matches_jax_for_every_switch(monkeypatch):
    """The port's _pair_kernel_mode returns what the JAX package's returns
    for every combination of FWN_INT8, FWN_WINO, FWN_WINO4,
    FWN_WINO_MAX_CC, FWN_MAX_CC, FWN_HOISTED and FWN_INT8_RS, at every
    lj22k conditioning width, with the kernels on and off."""
    monkeypatch.setattr(jfwn, "PAIR_KERNEL_CPU_INTERPRET", True)
    names = ("PAIR_KERNEL_INT8", "PAIR_KERNEL_WINO", "PAIR_KERNEL_WINO4",
             "PAIR_KERNEL_WINO_MAX_CC", "PAIR_KERNEL_MAX_CC",
             "PAIR_KERNEL_HOISTED")
    values = ((True, False), (True, False), (False, True), (320, 640),
              (None, 160, 2560), (False, True))
    widths = [80 << k for k in range(8)]
    seen = set()
    for combo in itertools.product(*values):
        for rs in (False, True):
            monkeypatch.setattr(jpf, "INT8_RS", rs)
            monkeypatch.setattr(tfwn, "INT8_RS", rs)
            for n, v in zip(names, combo):
                monkeypatch.setattr(jfwn, n, v)
                monkeypatch.setattr(tfwn, n, v)
            assert tfwn._pair_max_cc() == jfwn._pair_max_cc()
            for cfg in (CFG, OFF):
                for cc in widths:
                    want = jfwn._pair_kernel_mode(cfg, cc, False)
                    assert tfwn._pair_kernel_mode(cfg, cc) == want, (combo,
                                                                     cc)
                    seen.add(want)
    assert seen == {"int8", "wino", "wino4", "direct", "hoisted", None}


@pytest.mark.parametrize("wino4", [False, True])
def test_reverse_int8_off_matches_jax_plain(params, monkeypatch, wino4):
    """FWN_INT8=0: both tiny blocks (cc_half 80, 160) take the Winograd
    pair (F(4,3) with FWN_WINO4); fp32 against JAX's plain reverse (the XLA
    pair-scan): rel-to-max <= 1e-5."""
    jp, tp = params
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_INT8", False)
    monkeypatch.setattr(tfwn, "PAIR_KERNEL_WINO4", wino4)
    assert {tfwn._pair_kernel_mode(CFG, 80 << k) for k in (0, 1)} == {
        "wino4" if wino4 else "wino"}
    rs = np.random.RandomState(0)
    z = rs.randn(2, 2048, 1).astype(np.float32)
    mel = rs.rand(2, 8, CFG.num_mels).astype(np.float32)
    want = np.asarray(jfwn.reverse(jp, OFF, jnp.asarray(z), jnp.asarray(mel)))
    n0 = dict(launch.LAUNCHES)
    got = tfwn.reverse(tp, CFG, torch.from_numpy(z),
                       torch.from_numpy(mel)).numpy()
    assert launch.LAUNCHES == n0                  # CPU: plain versions
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
