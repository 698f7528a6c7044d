"""PyTorch port on the card: the CUDA pair kernel against its plain version
and the fused-pair route of ``reverse`` against the CPU.  Every test here
needs a CUDA device and skips without one.  This file imports neither JAX
nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.config import lj22k, tiny
from flowavenet_tpu_torch.models import flowavenet as fwn
from flowavenet_tpu_torch.ops import pair_flow as pf
from flowavenet_tpu_torch.ops.conv import quantize_act
from flowavenet_tpu_torch.utils.tree import tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # the plain versions must run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair(bi: int, dev):
    cfg = lj22k().model
    gen = torch.Generator().manual_seed(bi)
    block = fwn.init_block(gen, 1 << bi, cfg.num_mels << bi, cfg)
    block["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05, generator=gen)
    return tree_map(lambda l: l.to(dev),
                    fwn._index(fwn._pair_params(block), 0))


@pytest.mark.cuda
@pytest.mark.parametrize("bi", [0, 3])
@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_kernel_matches_plain(cuda, bi, mode):
    """lj22k widths of block bi, two rows, a ragged last tile.  fp32:
    rel-to-max <= 1e-4 (summation order only); bf16 and int8: rel-to-max
    <= 1e-2 and corr >= 0.9999 (the same cast points; one-ulp flips).
    Every mode is also held to its error as a share of what the coupling
    nets add to the pass-through (the pair with its zero convs zeroed):
    RMS ratio <= 1e-4 in fp32, <= 1e-2 in bf16 and int8."""
    r_in, cc, T = 1 << bi, 80 << bi, 1000
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(7)
    u, v = (torch.randn(2, T, r_in, generator=g, device=cuda).to(dt)
            for _ in range(2))
    c = [torch.rand(2, T, cc, generator=g, device=cuda).to(dt)
         for _ in range(2)]
    pair = _pair(bi, cuda)
    crs = None
    if mode == "int8":
        q = [quantize_act(x, per_row=True) for x in c]
        c = [q[0][0], q[1][0]]
        crs = torch.cat([q[0][1].reshape(-1, 1), q[1][1].reshape(-1, 1)], 1)
        ops = pf.pair_reverse_operands_int8(pair, dt)
    else:
        ops = pf.pair_reverse_operands(pair, dt)
    n0 = dict(pf.LAUNCHES)
    got = pf.fused_pair_reverse(u, v, *c, ops, int8=mode == "int8",
                                c_row_scales=crs)
    torch.cuda.synchronize()
    name = "pair_flow_i8" if mode == "int8" else "pair_flow"
    assert pf.LAUNCHES[name] == n0[name] + 1
    tt = pf.kernel_t_tile(dt)
    want = pf.pair_reverse_ref(u, v, *c, ops, t_tile=tt,
                               int8=mode == "int8", c_row_scales=crs)
    ops_pass = tuple(torch.zeros_like(o) if i in (11, 12) else o
                     for i, o in enumerate(ops))          # zw = zb = 0
    passthru = pf.pair_reverse_ref(u, v, *c, ops_pass, t_tile=tt,
                                   int8=mode == "int8", c_row_scales=crs)
    bar = 1e-4 if mode == "fp32" else 1e-2
    err2 = upd2 = 0.0
    for a, b, p in zip(got, want, passthru):
        a, b, p = (x.float().cpu().numpy() for x in (a, b, p))
        assert np.all(np.isfinite(a))
        assert np.abs(a - b).max() <= bar * np.abs(b).max()
        if mode != "fp32":
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.9999
        err2 += float(np.square(a - b).sum())
        upd2 += float(np.square(b - p).sum())
    assert np.sqrt(err2 / upd2) <= bar


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    pair = _pair(0, cuda)
    ops = pf.pair_reverse_operands(pair, torch.float32)
    u = torch.zeros(1, 64, 1, device=cuda)
    c = torch.zeros(1, 64, 80, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        pf.fused_pair_reverse(u, u, c.cpu(), c, ops)
    with pytest.raises(TypeError):
        pf.fused_pair_reverse(u, u, c, c,
                              pf.pair_reverse_operands(pair, torch.bfloat16))


@pytest.mark.cuda
def test_reverse_direct_route_on_card_matches_cpu(cuda, monkeypatch):
    """The tiny model's fused-pair route in fp32: the kernel on the card vs
    the plain tiled version on the CPU, same tile: 1e-4 (summation order
    over 2 blocks)."""
    monkeypatch.setattr(fwn, "PAIR_KERNEL_INT8", False)
    cfg = tiny().model
    params = fwn.init_flowavenet(torch.Generator().manual_seed(0), cfg)
    r = torch.Generator().manual_seed(1)
    params = tree_map(lambda l: l + 0.1 * torch.randn(l.shape, generator=r),
                      params)
    z = torch.randn(2, 2048, 1, generator=r)
    mel = torch.rand(2, 8, 80, generator=r)
    want = fwn.reverse(params, cfg, z, mel).numpy()
    n0 = pf.LAUNCHES["pair_flow"]
    got = fwn.reverse(tree_map(lambda l: l.to(cuda), params), cfg,
                      z.to(cuda), mel.to(cuda)).cpu().numpy()
    assert pf.LAUNCHES["pair_flow"] == n0 + cfg.n_block * cfg.n_flow // 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
