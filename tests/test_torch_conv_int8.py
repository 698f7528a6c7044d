"""PyTorch port, ``ops/conv.py:conv1x1_int8`` on every shape: the int8 1x1
of the deep blocks' scan route held bit for bit against the JAX package's
``conv1x1_int8`` where ``torch._int_mm`` alone would refuse the shape (M <=
16, K or N not a multiple of 8), and a one-frame ``reverse`` of a model
whose deepest block takes that route, against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.config import tiny
from flowavenet_tpu.models import flowavenet as jfwn
from flowavenet_tpu.ops import conv as jconv
from flowavenet_tpu_torch.checkpoint.bridge import to_torch
from flowavenet_tpu_torch.config import ModelConfig as TModelConfig
from flowavenet_tpu_torch.models import flowavenet as tfwn
from flowavenet_tpu_torch.ops import conv as tconv


@pytest.mark.parametrize("n", [512, 36])
@pytest.mark.parametrize("k", [80, 79, 10240])
@pytest.mark.parametrize("m", [1, 8, 16, 17])
def test_conv1x1_int8_matches_jax_bit_for_bit(m, k, n):
    """M rows as (B, T) with one scale per batch row; the int32 sums are
    exact on both sides and the dequantization runs in the same order, so
    the outputs are identical."""
    b, t = (1, m) if m % 2 else (2, m // 2)
    r = np.random.RandomState(m * 7 + k + n)
    x = (r.randn(b, t, k) * np.array([1.0, 3.0])[:b, None, None]
         ).astype(np.float32)
    w = r.randn(1, k, n).astype(np.float32)
    bias = r.randn(n).astype(np.float32)
    qj, sj = jconv.quantize_act(jnp.asarray(x), per_row=True)
    want = np.asarray(jconv.conv1x1_int8(qj, sj, jnp.asarray(w),
                                         jnp.asarray(bias), jnp.float32))
    qt, st = tconv.quantize_act(torch.from_numpy(x), per_row=True)
    got = tconv.conv1x1_int8(qt, st, torch.from_numpy(w),
                             torch.from_numpy(bias), torch.float32)
    assert got.shape == (b, t, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_one_frame_reverse_with_a_deep_int8_block_matches_jax():
    """``tiny`` with six blocks: block 5's conditioning half is 2560 wide,
    past the int8 pair's 1280, so it runs the int8 scan, whose 1x1s see
    M = 4 rows for a one-frame mel.  The port's default routes (the int8
    pair's plain version on blocks 0-4) against JAX's fp32 scans on the
    CPU at the JAX package's int8 bar (tests/test_pallas_flow.py:698)."""
    jcfg = dataclasses.replace(tiny().model, n_block=6)
    tcfg = TModelConfig(**dataclasses.asdict(jcfg))
    assert tfwn._pair_kernel_mode(tcfg, 80 << 5) is None
    assert tfwn._pair_kernel_mode(tcfg, 80 << 4) == "int8"
    params = jfwn.init_flowavenet(jax.random.PRNGKey(0), jcfg)
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(5)
    params = jax.tree.unflatten(treedef, [
        np.asarray(l) + 0.05 * r.randn(*l.shape).astype(np.float32)
        for l in leaves])
    z = r.randn(1, jcfg.hop_size, 1).astype(np.float32)
    c = r.rand(1, 1, jcfg.num_mels).astype(np.float32)
    want = np.asarray(jfwn.reverse(params, jcfg, jnp.asarray(z),
                                   jnp.asarray(c)))
    got = tfwn.reverse(to_torch(params), tcfg, torch.from_numpy(z),
                       torch.from_numpy(c)).numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 0.08
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.998
