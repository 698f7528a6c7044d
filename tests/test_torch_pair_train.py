"""PyTorch port, forward and training pairs (ops/pair_flow_train.py, its
fused_pair_forward included): the plain versions and the training
route's autograd.Function held against the JAX Pallas kernels
``_pair_kernel_fws``/``_pair_kernel_bwd``/``_pair_kernel_fw`` in interpret
mode (as tests/test_pallas_train.py runs them), on primal, statistics and
every gradient.  The CUDA kernels are held against the plain versions on
the card by tests/test_torch_card.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import tiny
from flowavenet_tpu.models import flowavenet as jfwn
from flowavenet_tpu.ops import pallas_flow as jpf
from flowavenet_tpu.ops import pallas_flow_train as jpft
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.models import flowavenet as tfwn
from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.ops import pair_flow as tpf
from flowavenet_tpu_torch.ops import pair_flow_train as tpft
from flowavenet_tpu_torch.utils.tree import tree_map

CFG = tiny().model
MARGIN = 0.3   # below the perturbed pair's |log_s|: the hinge is live


@pytest.fixture(scope="module")
def pair():
    """(JAX pair, torch pair) of block 0: init plus 0.1-scale noise on
    every leaf (test_pallas_train.py's pattern; at init a pair is the
    identity and most gradient paths are degenerate)."""
    params = jfwn.init_flowavenet(jax.random.PRNGKey(0), CFG)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(1)
    params = jax.tree.unflatten(treedef, [
        np.asarray(l) + 0.1 * r.randn(*l.shape).astype(np.float32)
        for l in leaves])
    jp = jax.tree.map(lambda l: l[0], jfwn._pair_params(params["blocks"][0]))
    tp = tfwn._index(tfwn._pair_params(to_torch(params)["blocks"][0]), 0)
    return jp, tp


def _data(T, seed=2, B=2):
    r = np.random.RandomState(seed)
    Cc = CFG.num_mels
    return [0.3 * r.randn(B, T, 1).astype(np.float32),
            0.3 * r.randn(B, T, 1).astype(np.float32),
            r.randn(B, T, Cc).astype(np.float32),
            r.randn(B, T, Cc).astype(np.float32),
            r.randn(B, T, 1).astype(np.float32),
            r.randn(B, T, 1).astype(np.float32)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _worst_leaf(tree_t, tree_j):
    """Worst leaf relative error of the port's .grad tree vs the JAX
    gradient tree (a leaf no path reaches, layer 1's unused res conv, has
    no .grad in torch and a zero gradient in JAX)."""
    flat_t = []
    tree_map(lambda l: flat_t.append(l.grad if l.grad is not None
                                     else torch.zeros_like(l)), tree_t)
    leaves_j = jax.tree.leaves(tree_j)
    assert len(flat_t) == len(leaves_j)
    return max(_rel(a.numpy(), b) for a, b in zip(flat_t, leaves_j))


def _weighted(out, wu, wv):
    """The scalar both sides differentiate: a weighted sum of the outputs
    and the three differentiable statistics (the JAX test's loss)."""
    u3, v3, raw, _mx, sq, hq = out
    return ((u3 * wu).sum() + (v3 * wv).sum() + 0.7 * raw + 0.11 * sq
            + 1.3 * hq)


@pytest.mark.parametrize("T", [200, 300])
def test_train_pair_matches_jax_kernel(pair, monkeypatch, T):
    """fp32: primal, all four statistics and every gradient (pair params
    through the operand folding, u, v, c_a, c_b) of the port's training
    route (PairTrain on the CPU: the plain version and autograd through
    it) vs the JAX kernels in interpret mode, hinge live.  T=200: one JAX
    tile with both sequence edges inside it; T=300: past the CUDA kernel's
    largest tile (256) with a ragged tail, several JAX backward tiles.
    Bars: 1e-5 relative on the statistics and the primal, 1e-4 worst-leaf
    relative on the gradients (fp32 summation order only)."""
    monkeypatch.setattr(jpft, "HINGE_MARGIN", MARGIN)
    monkeypatch.setattr(tpft, "HINGE_MARGIN", MARGIN)
    jp, tp = pair
    u, v, ca, cb, wu, wv = _data(T)

    def loss_j(p, u, v, ca, cb):
        ops = jpf.pair_forward_operands(p, jnp.float32)
        out = jfwn._pair_train_fused(True, ops, u, v, ca, cb)
        return _weighted(out, wu, wv), out

    (lj, outj), gj = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(
        jp, *map(jnp.asarray, (u, v, ca, cb)))

    tpl = tree_map(lambda l: l.clone().requires_grad_(), tp)
    xs = [torch.from_numpy(x).requires_grad_() for x in (u, v, ca, cb)]
    ops = tpf.pair_forward_operands(tpl, torch.float32)
    outt = tpft.PairTrain.apply(*xs, *ops)
    lt = _weighted(outt, torch.from_numpy(wu), torch.from_numpy(wv))
    lt.backward()

    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    for a, b in zip(outt[:2], outj[:2]):
        assert _rel(a.detach().numpy(), b) < 1e-5
    for a, b in zip(outt[2:], outj[2:]):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5)
    assert float(outt[5]) > 0.0                      # the hinge is live
    gt = [x.grad.numpy() for x in xs]
    for name, a, b in zip(("u", "v", "c_a", "c_b"), gt, gj[1:]):
        assert _rel(a, b) < 1e-4, name
    assert _worst_leaf(tpl, gj[0]) < 1e-4


def test_train_pair_backward_ref_matches_jax_bwd(pair, monkeypatch):
    """The backward's plain version vs ``fused_pair_train_bwd`` on the same
    folded operands and cotangents: every operand gradient and du, dv,
    dc_a, dc_b to 1e-4 worst-leaf relative."""
    monkeypatch.setattr(jpft, "HINGE_MARGIN", MARGIN)
    monkeypatch.setattr(tpft, "HINGE_MARGIN", MARGIN)
    jp, tp = pair
    u, v, ca, cb, wu, wv = _data(160, seed=4)
    jops = jpf.pair_forward_operands(jp, jnp.float32)
    dj = jpft.fused_pair_train_bwd(*map(jnp.asarray, (u, v, ca, cb, wu, wv)),
                                   0.7, 0.11, 1.3, jops, interpret=True)
    tops = tpf.pair_forward_operands(tp, torch.float32)
    dt = tpft.fused_pair_train_bwd(
        *map(torch.from_numpy, (u, v, ca, cb, wu, wv)), torch.tensor(0.7),
        torch.tensor(0.11), torch.tensor(1.3), tops)
    for a, b in zip(dt[0], dj[0]):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) < 1e-4
    for a, b in zip(dt[1:], dj[1:]):
        assert _rel(a.numpy(), b) < 1e-4


@pytest.fixture(scope="module")
def bwd_bf16(pair):
    """bf16 inputs and cotangents of block 0 at T = 160 and the JAX
    backward ``fused_pair_train_bwd`` of them in interpret mode, as a flat
    list of the 15 operand gradients, du, dv, dc_a, dc_b in float64."""
    jp, _ = pair
    xs = [torch.from_numpy(x).bfloat16() for x in _data(160, seed=4)]
    jx = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in xs]
    saved = jpft.HINGE_MARGIN
    jpft.HINGE_MARGIN = MARGIN
    try:
        dj = jpft.fused_pair_train_bwd(
            *jx, 0.7, 0.11, 1.3, jpf.pair_forward_operands(jp, jnp.bfloat16),
            interpret=True)
    finally:
        jpft.HINGE_MARGIN = saved
    return xs, [np.asarray(b, np.float64) for b in list(dj[0]) + list(dj[1:])]


def _plain_bwd_bf16(tp, xs):
    """The port's plain bf16 backward of ``xs``, flat as in bwd_bf16."""
    dt = tpft.fused_pair_train_bwd(
        *xs, torch.tensor(0.7), torch.tensor(0.11), torch.tensor(1.3),
        tpf.pair_forward_operands(tp, torch.bfloat16))
    return [a.double().numpy() for a in list(dt[0]) + list(dt[1:])]


def _cosine(a, b):
    return float((a.ravel() @ b.ravel())
                 / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_train_pair_backward_ref_matches_jax_bwd_bf16(pair, bwd_bf16,
                                                      monkeypatch):
    """bf16: the backward's plain version (autograd through
    pair_train_fwd_ref, every product operand rounded at the JAX
    backward's cast points) vs ``fused_pair_train_bwd`` in interpret mode
    on the same bf16 folded operands, inputs and cotangents.  Bars per
    leaf (15 operand gradients, du, dv, dc_a, dc_b): cosine >= 0.995 and
    rel-to-max <= 0.3.  The gap is not the cast points: the JAX backward
    recomputes its gates as rnd(rnd(tanh) * rnd(sigmoid)) (_net_fwd_res),
    a forward one bf16 rounding away from the one _pair_kernel_fws and the
    port compute, rnd(tanh * sigmoid)
    (test_train_pair_backward_gap_to_jax_is_the_gate_recompute)."""
    monkeypatch.setattr(tpft, "HINGE_MARGIN", MARGIN)
    _, tp = pair
    xs, dj = bwd_bf16
    for a, b in zip(_plain_bwd_bf16(tp, xs), dj):
        assert a.shape == b.shape
        assert _cosine(a, b) >= 0.995 and _rel(a, b) <= 0.3


class _JaxGate(torch.autograd.Function):
    """A gate as the JAX backward recomputes and differentiates it
    (_net_fwd_res, _net_bwd): t = rnd(tanh(f)) and s = rnd(sigmoid(g)),
    the output rnd(t * s), and the pre-activation cotangent
    [dg s (1 - t^2) | dg t s (1 - s)] from the rounded t and s with dg
    unrounded."""

    @staticmethod
    def forward(ctx, fg, dt):
        r = fg.shape[-1] // 2
        t = torch.tanh(fg[..., :r]).to(dt).to(fg.dtype)
        s = torch.sigmoid(fg[..., r:]).to(dt).to(fg.dtype)
        ctx.save_for_backward(t, s)
        return (t * s).to(dt).to(fg.dtype)

    @staticmethod
    def backward(ctx, dg):
        t, s = ctx.saved_tensors
        return torch.cat([dg * s * (1 - t * t), dg * t * s * (1 - s)],
                         -1), None


class _NoRound:
    """_RoundGrad without its rounding: the identity, gradient unrounded."""

    @staticmethod
    def apply(x, dtype):
        return x


def test_train_pair_backward_gap_to_jax_is_the_gate_recompute(
        pair, bwd_bf16, monkeypatch):
    """Where the bf16 gap to ``_pair_kernel_bwd`` comes from.  With the
    plain version's gates computed as the JAX backward recomputes them
    (_JaxGate in place of pair_flow._gate), the gap falls from 0.234 to
    fp32-accumulation noise: per leaf rel-to-max <= 1.5e-2 and cosine >=
    0.99999 (measured 7.1e-3 and 0.999995).  And the cast points of
    _RoundGrad bring the plain version closer to JAX: the mean over the 19
    leaves of the L2-relative error is <= 1.6e-3 with them and at least
    1.25x that without (measured 1.24e-3 and 2.00e-3)."""
    monkeypatch.setattr(tpft, "HINGE_MARGIN", MARGIN)
    monkeypatch.setattr(tpf, "_gate",
                        lambda fg, rnd: _JaxGate.apply(fg, torch.bfloat16))
    _, tp = pair
    xs, dj = bwd_bf16

    def mean_l2(grads):
        return float(np.mean([np.linalg.norm(a - b) / np.linalg.norm(b)
                              for a, b in zip(grads, dj)]))

    grads = _plain_bwd_bf16(tp, xs)
    for a, b in zip(grads, dj):
        assert _cosine(a, b) >= 0.99999 and _rel(a, b) <= 1.5e-2
    with_cast = mean_l2(grads)
    monkeypatch.setattr(tpft, "_RoundGrad", _NoRound)
    without = mean_l2(_plain_bwd_bf16(tp, xs))
    assert with_cast <= 1.6e-3 and 1.25 * with_cast <= without


@pytest.mark.parametrize("T", [192, 300])
def test_forward_pair_matches_jax_kernel(pair, T):
    """pair_fwd's plain version (the port of ``_pair_kernel_fw``) vs
    ``fused_pair_forward`` in interpret mode: outputs and the raw -log_s
    sum to 1e-5 relative; and the model-level autograd.Function
    (``_pair_fwd_fused``, torch-recompute backward) vs JAX's custom_vjp on
    every gradient, 1e-4 worst-leaf relative."""
    jp, tp = pair
    u, v, ca, cb, wu, wv = _data(T, seed=5)

    def loss_j(p, u, v, ca, cb):
        out = jfwn._pair_fwd_fused(True, p, u, v, ca, cb)
        return (out[0] * wu).sum() + (out[1] * wv).sum() + 0.7 * out[2], out

    (lj, outj), gj = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(
        jp, *map(jnp.asarray, (u, v, ca, cb)))
    tops = tpf.pair_forward_operands(tp, torch.float32)
    plain = tpft.fused_pair_forward(*map(torch.from_numpy, (u, v, ca, cb)),
                                   tops)
    for a, b in zip(plain, outj):
        assert _rel(a.numpy(), b) < 1e-5

    tpl = tree_map(lambda l: l.clone().requires_grad_(), tp)
    xs = [torch.from_numpy(x).requires_grad_() for x in (u, v, ca, cb)]
    outt = tfwn._pair_fwd_fused(tpl, *xs)
    lt = ((outt[0] * torch.from_numpy(wu)).sum()
          + (outt[1] * torch.from_numpy(wv)).sum() + 0.7 * outt[2])
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    for name, x, b in zip(("u", "v", "c_a", "c_b"), xs, gj[1:]):
        assert _rel(x.grad.numpy(), b) < 1e-4, name
    assert _worst_leaf(tpl, gj[0]) < 1e-4


def test_forward_operands_match_jax_folding(pair):
    """pair_forward_operands (ActNorm in forward form, s = exp(+3 logs))
    vs the JAX folding: 1e-6 relative."""
    jp, tp = pair
    jops = jpf.pair_forward_operands(jp, jnp.float32)
    tops = tpf.pair_forward_operands(tp, torch.float32)
    assert len(tops) == len(jops) == 15
    for a, b in zip(tops, jops):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_wrappers_take_plain_version_on_cpu(pair):
    """CPU tensors: no kernel launch is counted; the plain version's bf16
    run is finite and keeps the storage type."""
    _, tp = pair
    u, v, ca, cb, _, _ = _data(100, seed=6)
    before = dict(launch.LAUNCHES)
    bf = [torch.from_numpy(x).bfloat16() for x in (u, v, ca, cb)]
    out = tpft.fused_pair_train_fwd(*bf, tpf.pair_forward_operands(
        tp, torch.bfloat16))
    assert out[0].dtype == torch.bfloat16 and out[1].dtype == torch.bfloat16
    assert all(bool(torch.isfinite(x.float()).all()) for x in out)
    assert launch.LAUNCHES == before


def test_train_t_tile_fills_the_card():
    """At least one tile per SM where T allows, within [32, 256] rows: the
    lj22k training geometry of blocks 0-3 at batch 8."""
    assert [tpft.train_t_tile(8, 6400 >> (b + 1), 132)
            for b in range(4)] == [128, 64, 32, 32]
    assert tpft.train_t_tile(1, 100000, 132) == 256


def test_backward_bound_is_three_forwards():
    """The backward's operations are 3x the forward's (recompute, input
    gradients, weight gradients), JAX's cost estimate at
    pallas_flow_train.py:734-736."""
    f = tpft.train_pair_cost(8, 3200, 1, 80)
    b = tpft.train_pair_cost(8, 3200, 1, 80, backward=True)
    assert b["ops"] == 3 * f["ops"]
    ms, by = tpft.train_pair_bound_ms(8, 3200, 1, 80, backward=True)
    assert by == "operations" and ms > 0
