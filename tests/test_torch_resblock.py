"""PyTorch port, fused gated ResBlock (ops/resblock.py): the plain versions
of ``_resblock_kernel`` and ``_resblock_kernel_v2`` held against the JAX
kernels in interpret mode, their autograd against ``jax.vjp`` of the JAX
custom VJPs, and ``apply_wavenet(use_pallas=True)`` against the JAX
package's, with its v1/v2 routing.  The CUDA kernels are held against the
plain versions on the card (tests/test_torch_card.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowavenet_tpu.ops.pallas_resblock as jrb
from flowavenet_tpu.models import modules as jmod
from flowavenet_tpu.ops.conv import wn_kernel
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.models import modules as tmod
from flowavenet_tpu_torch.ops import resblock as trb

R, CC, B, T = 16, 8, 2, 86          # T: not a multiple of 16 (ragged tile)


def _layer_args(seed: int, dtype=np.float32):
    """One randomized layer's ResBlock inputs, as numpy: (h, cond_fg, c,
    w_conv, w_cond, b_all, w_res, b_res, w_skip, b_skip)."""
    p = jmod.init_wavenet(jax.random.PRNGKey(seed), in_channels=4,
                          out_channels=8, num_layers=1, residual_channels=R,
                          cin_channels=CC)["layers"][0]
    rng = np.random.RandomState(seed)
    p = jax.tree.map(lambda l: l + 0.2 * rng.randn(*l.shape).astype(
        np.float32), p)
    k, b = jmod._fused_fg_kernel(p["filter"], p["gate"])
    kc, bc = jmod._fused_fg_kernel(p["filter_c"], p["gate_c"])
    h = rng.randn(B, T, R).astype(np.float32)
    c = rng.randn(B, T, CC).astype(np.float32)
    cond = jmod._cond_fg(jnp.asarray(c), None, p, b)
    out = (h, cond, c, k, kc[0], bc + b, wn_kernel(p["res"])[0],
           p["res"]["b"], wn_kernel(p["skip"])[0], p["skip"]["b"])
    return tuple(np.array(a, np.float32) for a in out)


def _split(args, v2):
    h, cond, c, k, kc, ball, wr, br, ws, bs = args
    return ((h, c, k, kc, ball, wr, br, ws, bs) if v2
            else (h, cond, k, wr, br, ws, bs))


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal,dilation", [(False, 1), (False, 3),
                                             (True, 1), (True, 3)])
def test_plain_matches_jax_kernel(v2, dtype, causal, dilation):
    """The plain version vs the JAX kernel (interpret, tile 32: three tiles
    and a ragged one), with h and the conditioning in the storage type.
    fp32: rel-to-max <= 1e-5 (summation order).  bf16: the same cast
    points; within one bf16 ulp of the largest output (2^-7 of it)."""
    args = _split(_layer_args(1 + dilation + 2 * causal), v2)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jin = [jnp.asarray(a).astype(jdt) if i < 2 else jnp.asarray(a)
           for i, a in enumerate(args)]
    fn = jrb.fused_gated_resblock_v2 if v2 else jrb.fused_gated_resblock
    want = fn(*jin, dilation=dilation, causal=causal, t_tile=32,
              interpret=True)
    tin = [torch.from_numpy(a).to(tdt) if i < 2 else torch.from_numpy(a)
           for i, a in enumerate(args)]
    ref = trb.resblock_v2_ref if v2 else trb.resblock_ref
    got = ref(*tin, dilation=dilation, causal=causal)
    bar = 2.0 ** -7 if dtype == "bf16" else 1e-5
    for g, w in zip(got, want):
        assert g.dtype == tdt
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == (B, T, R)
        assert np.abs(g - w).max() <= bar * np.abs(w).max()


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_vjp(v2, causal):
    """The Functions' outputs and backward (the JAX package's _fgr_bwd /
    _fgr2_bwd ported line by line) vs jax.vjp of the JAX custom VJPs,
    fp32, for one set of cotangents: rel-to-max <= 1e-5 per input."""
    args = _split(_layer_args(7 + causal), v2)
    rng = np.random.RandomState(11)
    cts = [rng.randn(B, T, R).astype(np.float32) for _ in range(2)]
    fn = jrb.fused_gated_resblock_v2 if v2 else jrb.fused_gated_resblock
    out, vjp = jax.vjp(lambda *a: fn(*a, dilation=3, causal=causal,
                                     t_tile=32, interpret=True),
                       *[jnp.asarray(a) for a in args])
    want = vjp(tuple(jnp.asarray(x) for x in cts))
    tin = [torch.from_numpy(a).requires_grad_() for a in args]
    tfn = trb.fused_gated_resblock_v2 if v2 else trb.fused_gated_resblock
    got = tfn(*tin, dilation=3, causal=causal)
    for g, w in zip(got, out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    torch.autograd.backward(got, [torch.from_numpy(x) for x in cts])
    assert len(want) == len(tin)
    for x, w in zip(tin, want):
        w = np.asarray(w)
        assert x.grad.shape == w.shape
        assert np.abs(x.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("route", ["v2", "v1_g", "v1_narrow_v2"])
def test_apply_wavenet_use_pallas_matches_jax(monkeypatch, route):
    """apply_wavenet(use_pallas=True), port (plain versions on the CPU) vs
    JAX (its Pallas ResBlocks in interpret mode, as
    test_pallas_resblock.py:89-97 runs them), fp32, causal: rel-to-max <=
    1e-5.  Routes: no g takes v2; a global condition takes v1; with
    V2_MAX_CC patched below Cc on both sides v1 without g.  Only layer 0
    (need_residual) goes through a ResBlock: one call per net."""
    gin = 6 if route == "v1_g" else 0
    p = jmod.init_wavenet(jax.random.PRNGKey(3), in_channels=2,
                          out_channels=4, num_layers=2, residual_channels=R,
                          cin_channels=CC, gin_channels=gin)
    rng = np.random.RandomState(5)
    p = jax.tree.map(lambda l: np.asarray(l) + 0.1 * rng.randn(
        *l.shape).astype(np.float32), p)
    x = rng.randn(2, 64, 2).astype(np.float32)
    c = rng.rand(2, 64, CC).astype(np.float32)
    g = rng.randn(2, 64, gin).astype(np.float32) if gin else None
    if route == "v1_narrow_v2":
        monkeypatch.setattr(jrb, "V2_MAX_CC", CC - 1)
        monkeypatch.setattr(trb, "V2_MAX_CC", CC - 1)
    o1, o2 = jrb.fused_gated_resblock, jrb.fused_gated_resblock_v2
    monkeypatch.setattr(jrb, "fused_gated_resblock", lambda *a, **k: o1(
        *a, **{**k, "interpret": True}))
    monkeypatch.setattr(jrb, "fused_gated_resblock_v2", lambda *a, **k: o2(
        *a, **{**k, "interpret": True}))
    want = np.asarray(jmod.apply_wavenet(
        p, jnp.asarray(x), jnp.asarray(c),
        None if g is None else jnp.asarray(g), causal=True, use_pallas=True))
    calls = {"v1": 0, "v2": 0}
    t1, t2 = trb.fused_gated_resblock, trb.fused_gated_resblock_v2

    def count(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(trb, "fused_gated_resblock", count("v1", t1))
    monkeypatch.setattr(trb, "fused_gated_resblock_v2", count("v2", t2))
    got = tmod.apply_wavenet(
        to_torch(p), torch.from_numpy(x), torch.from_numpy(c),
        None if g is None else torch.from_numpy(g), causal=True,
        use_pallas=True).numpy()
    assert calls == ({"v1": 0, "v2": 1} if route == "v2"
                     else {"v1": 1, "v2": 0})
    plain = tmod.apply_wavenet(
        to_torch(p), torch.from_numpy(x), torch.from_numpy(c),
        None if g is None else torch.from_numpy(g), causal=True).numpy()
    for a in (got, plain):
        assert np.abs(a - want).max() <= 1e-5 * np.abs(want).max()


def test_bound_counts_and_tiles():
    """The bound follows JAX's operation count; _plan_tiles is JAX's."""
    for args in ((86, 32), (48, 32), (46080, 64), (10, 512)):
        assert trb._plan_tiles(*args) == jrb._plan_tiles(*args)
    ms, by = trb.resblock_bound_ms(4, 46080, cc=160)
    ops = 2 * 4 * 46080 * (256 * (3 * 512 + 512) + 160 * 512)
    assert by == "operations" and ms == pytest.approx(ops / 989e12 * 1e3)
    with pytest.raises(ValueError, match="HALO"):
        trb.resblock_ref(*[torch.zeros(1)] * 7, dilation=17, causal=False)
