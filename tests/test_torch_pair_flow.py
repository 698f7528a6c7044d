"""PyTorch port, fused reverse pair (ops/pair_flow.py): the plain tiled
version held against the JAX Pallas kernel in interpret mode, the operand
folding against the JAX folding, and the wrapper's CPU contract.  The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_card.py and chip_smoke.py."""

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
from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.ops import pair_flow as tpf
from flowavenet_tpu_torch.ops.conv import quantize_act

CFG = tiny().model


def _randomized(cfg, scale=0.1):
    """Init weights plus 0.1-scale noise (as test_pallas_flow.py does): at
    init the zero conv and ActNorm make a pair the identity."""
    params = jfwn.init_flowavenet(jax.random.PRNGKey(0), cfg)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(7)
    return jax.tree.unflatten(treedef, [
        np.asarray(l) + scale * r.randn(*l.shape).astype(np.float32)
        for l in leaves])


@pytest.fixture(scope="module")
def pairs():
    """(JAX pair, torch pair) of blocks 0 and 1 of the randomized tiny
    model."""
    cfg = CFG
    params = _randomized(cfg)
    tp = to_torch(params)
    out = []
    for bi in range(2):
        jp = jax.tree.map(lambda l: l[0],
                          jfwn._pair_params(params["blocks"][bi]))
        tpair = tfwn._index(tfwn._pair_params(tp["blocks"][bi]), 0)
        out.append((jp, tpair))
    return out


def _inputs(rng, T, r_in, cc, B=2):
    return [rng.randn(B, T, r_in).astype(np.float32),
            rng.randn(B, T, r_in).astype(np.float32),
            rng.randn(B, T, cc).astype(np.float32),
            rng.randn(B, T, cc).astype(np.float32)]


@pytest.mark.parametrize("bi,T,jax_tile,tile", [(0, 200, 64, 48),
                                                 (0, 96, 96, 32),
                                                 (1, 128, 64, 40)])
def test_plain_pair_fp32_matches_jax_kernel(pairs, rng, bi, T, jax_tile,
                                            tile):
    """fp32, non-int8: the plain version at its own tile (several tiles, a
    ragged last one) vs the JAX kernel in interpret mode at its tile.  The
    bar is the one the JAX package holds its own kernel to
    (test_pallas_flow.py:59): 2e-5."""
    jp, tpair = pairs[bi]
    r_in, cc = 1 << bi, CFG.num_mels << bi
    u, v, ca, cb = _inputs(rng, T, r_in, cc)
    ops = jpf.pair_reverse_operands(jp, dtype=jnp.float32)
    uj, vj = jpf.fused_pair_reverse(*map(jnp.asarray, (u, v, ca, cb)), ops,
                                    t_tile=jax_tile, interpret=True)
    tops = tpf.pair_reverse_operands(tpair, dtype=torch.float32)
    ut, vt = tpf.pair_reverse_ref(*map(torch.from_numpy, (u, v, ca, cb)),
                                  tops, t_tile=tile)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=2e-5,
                               atol=2e-5)


def test_plain_pair_int8_matches_jax_kernel_at_its_tile(pairs, rng):
    """int8 with per-row c scales, at the JAX kernel's own geometry (tile
    64, which _fit_tile keeps for T=192; halo 16), so every per-window
    activation scale is the same.  Measured worst case: rel 2.1e-7, corr
    1 - 6e-15 (only fp32 summation order differs).  Asserted at 10x inside
    the JAX package's int8 bar (_corr_close, test_pallas_flow.py:698):
    rel < 0.008, corr > 0.9998."""
    jp, tpair = pairs[0]
    T = 192
    u, v, ca, cb = _inputs(rng, T, 1, CFG.num_mels)
    (qa, sa), (qb, sb) = (jquant(jnp.asarray(ca), per_row=True),
                          jquant(jnp.asarray(cb), per_row=True))
    crs = jnp.concatenate([sa.reshape(-1, 1), sb.reshape(-1, 1)], 1)
    ops = jpf.pair_reverse_operands_int8(jp, dtype=jnp.float32)
    uj, vj = jpf.fused_pair_reverse(jnp.asarray(u), jnp.asarray(v), qa, qb,
                                    ops, t_tile=64, interpret=True,
                                    int8=True, c_row_scales=crs)
    tops = tpf.pair_reverse_operands_int8(tpair, dtype=torch.float32)
    (tqa, tsa), (tqb, tsb) = (quantize_act(torch.from_numpy(ca), True),
                              quantize_act(torch.from_numpy(cb), True))
    tcrs = torch.cat([tsa.reshape(-1, 1), tsb.reshape(-1, 1)], 1)
    np.testing.assert_array_equal(tqa.numpy(), np.asarray(qa))
    ut, vt = tpf.pair_reverse_ref(torch.from_numpy(u), torch.from_numpy(v),
                                  tqa, tqb, tops, t_tile=64, halo=16,
                                  int8=True, c_row_scales=tcrs)
    for got, want in ((ut.numpy(), np.asarray(uj)),
                      (vt.numpy(), np.asarray(vj))):
        rel = np.abs(got - want).max() / np.abs(want).max()
        corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert rel < 0.008 and corr > 0.9998, (rel, corr)


@pytest.mark.parametrize("int8", [False, True])
def test_operands_match_jax_folding(pairs, int8):
    """Weight folding (weight norm, exp(3*scale), ActNorm halves, int8
    per-channel quantization) vs the JAX folding: float operands to 1e-6
    relative (rsqrt/exp rounding); int8 codes identical."""
    jp, tpair = pairs[1]
    if int8:
        jops = jpf.pair_reverse_operands_int8(jp, dtype=jnp.float32)
        tops = tpf.pair_reverse_operands_int8(tpair, dtype=torch.float32)
    else:
        jops = jpf.pair_reverse_operands(jp, dtype=jnp.float32)
        tops = tpf.pair_reverse_operands(tpair, dtype=torch.float32)
    assert len(tops) == len(jops) == (17 if int8 else 15)
    for i, (a, b) in enumerate(zip(tops, jops)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, i
        if b.dtype == np.int8:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


def test_plain_pair_fp32_tile_invariant(pairs, rng):
    """Without int8 the tile geometry changes only summation order: three
    tilings (one tile, several, a ragged last one) agree to 1e-5."""
    _, tpair = pairs[0]
    u, v, ca, cb = map(torch.from_numpy, _inputs(rng, 150, 1, CFG.num_mels))
    ops = tpf.pair_reverse_operands(tpair, dtype=torch.float32)
    outs = [tpf.pair_reverse_ref(u, v, ca, cb, ops, t_tile=t, halo=h)
            for t, h in ((150, 10), (32, 10), (64, 16))]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_wrapper_runs_plain_version_on_cpu(pairs, rng):
    """A CPU tensor takes the plain version at the kernel's tile, and no
    kernel launch is counted."""
    _, tpair = pairs[0]
    u, v, ca, cb = map(torch.from_numpy, _inputs(rng, 100, 1, CFG.num_mels))
    ops = tpf.pair_reverse_operands(tpair, dtype=torch.float32)
    before = dict(launch.LAUNCHES)
    got = tpf.fused_pair_reverse(u, v, ca, cb, ops)
    want = tpf.pair_reverse_ref(u, v, ca, cb, ops,
                                t_tile=tpf.kernel_t_tile(torch.float32))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert launch.LAUNCHES == before
    with pytest.raises(ValueError, match="per-row"):
        tpf.fused_pair_reverse(u, v, ca, cb, ops, int8=True)


def test_int8_weight_packing_layout(rng):
    """The kernel's __dp4a weight words hold 4 consecutive input channels,
    lowest channel in the lowest byte (little endian)."""
    wq = torch.from_numpy(rng.randint(-127, 128, (2, 3, 8, 5)).astype(
        np.int8))
    words = tpf._pack_int8(wq)
    assert tuple(words.shape) == (2, 3, 2, 5) and words.dtype == torch.int32
    raw = words.numpy().view(np.int8).reshape(2, 3, 2, 5, 4)
    np.testing.assert_array_equal(
        raw.transpose(0, 1, 2, 4, 3).reshape(2, 3, 8, 5), wq.numpy())


def test_pair_cost_matches_jax_estimate():
    """Operations per net per output row: 2.097152 M + 2048*Cc + 2560*R_in
    at R = 256 (the count at pallas_flow.py:944-946 plus the final 1x1)."""
    for r_in, cc in ((1, 80), (16, 1280)):
        c = tpf.pair_cost(1, 1, r_in, cc)
        per_net = (c["fg_cond_ops"] + c["other_ops"]) / 2
        assert per_net == 2 * 1048576 + 2048 * cc + 2560 * r_in
        ms, by = tpf.pair_bound_ms(4, 46080, r_in, cc, int8=True)
        assert by == "operations" and ms > 0
