"""PyTorch port on the card: the CUDA pair and ResBlock kernels against
their plain versions, the fused-pair routes of ``reverse`` against the CPU, and the
device noise against the CPU's.  Every test here
needs a CUDA device and skips without one.  This file imports neither JAX
nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_card.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.config import lj22k, tiny
from flowavenet_tpu_torch.models import flowavenet as fwn
from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.ops import pair_flow as pf
from flowavenet_tpu_torch.ops import resblock as rb
from flowavenet_tpu_torch.ops.conv import quantize_act
from flowavenet_tpu_torch.utils.profiling import BlockStages
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
    n0 = dict(launch.LAUNCHES)
    got = pf.fused_pair_reverse(u, v, *c, ops, int8=mode == "int8",
                                c_row_scales=crs)
    torch.cuda.synchronize()
    name = "pair_flow_i8" if mode == "int8" else "pair_flow"
    assert launch.LAUNCHES[name] == n0[name] + 1
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
    monkeypatch.setattr(fwn, "PAIR_KERNEL_WINO", False)
    cfg = tiny().model
    params = fwn.init_flowavenet(torch.Generator().manual_seed(0), cfg)
    r = torch.Generator().manual_seed(1)
    params = tree_map(lambda l: l + 0.1 * torch.randn(l.shape, generator=r),
                      params)
    z = torch.randn(2, 2048, 1, generator=r)
    mel = torch.rand(2, 8, 80, generator=r)
    want = fwn.reverse(params, cfg, z, mel).numpy()
    n0 = launch.LAUNCHES["pair_flow"]
    got = fwn.reverse(tree_map(lambda l: l.to(cuda), params), cfg,
                      z.to(cuda), mel.to(cuda)).cpu().numpy()
    assert launch.LAUNCHES["pair_flow"] == n0 + cfg.n_block * cfg.n_flow // 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _check(got, want, passthru, bar, corr_min):
    """rel-to-max <= bar, corr >= corr_min (None: not checked) and the error
    as a share of what the coupling nets add (RMS ratio) <= bar."""
    err2 = upd2 = 0.0
    for a, b, p in zip(got, want, passthru):
        a, b, p = (x.float().cpu().numpy() for x in (a, b, p))
        assert np.all(np.isfinite(a))
        assert np.abs(a - b).max() <= bar * np.abs(b).max()
        if corr_min is not None:
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= corr_min
        err2 += float(np.square(a - b).sum())
        upd2 += float(np.square(b - p).sum())
    assert np.sqrt(err2 / upd2) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("phases", [6, 12])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_wino_kernel_matches_plain(cuda, phases, mode):
    """pair_flow_wino / pair_flow_wino4 vs pair_reverse_wino_ref at block 1's
    lj22k widths, two rows, T = 1000 (not a multiple of the tile or of P):
    the bars of test_kernel_matches_plain (bf16 corr >= 0.999)."""
    r_in, cc, T = 2, 160, 1000
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(8)
    u, v = (torch.randn(2, T, r_in, generator=g, device=cuda).to(dt)
            for _ in range(2))
    c = [torch.rand(2, T, cc, generator=g, device=cuda).to(dt)
         for _ in range(2)]
    make = (pf.pair_reverse_operands_wino if phases == 6
            else pf.pair_reverse_operands_wino4)
    ops = make(_pair(1, cuda), dt)
    name = "pair_flow_wino" if phases == 6 else "pair_flow_wino4"
    n0 = launch.LAUNCHES[name]
    got = pf.fused_pair_reverse_wino(u, v, *c, ops)
    torch.cuda.synchronize()
    assert launch.LAUNCHES[name] == n0 + 1
    want = pf.pair_reverse_wino_ref(u, v, *c, ops, t_tile=60)
    ops_pass = tuple(torch.zeros_like(o) if i in (11, 12) else o
                     for i, o in enumerate(ops))
    passthru = pf.pair_reverse_wino_ref(u, v, *c, ops_pass, t_tile=60)
    _check(got, want, passthru, 1e-4 if mode == "fp32" else 1e-2,
           None if mode == "fp32" else 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hoisted", "hoisted_i8", "i8rs"])
def test_hoisted_and_rs_kernels_match_plain(cuda, kind):
    """pair_flow_hoisted (fp32 and bf16), pair_flow_hoisted_i8 and
    pair_flow_i8rs (bf16) vs pair_reverse_ref at the launch's tile, block
    5's widths (R_in 32, hoisted c 1024 wide) or block 0's (i8rs): rel <=
    1e-4 in fp32, <= 1e-2 with corr >= 0.9999 otherwise, and the update
    bar."""
    bi = 0 if kind == "i8rs" else 5
    r_in, cc, T = 1 << bi, 80 << bi, 600
    pair = _pair(bi, cuda)
    for dt in ((torch.float32, torch.bfloat16) if kind == "hoisted"
               else (torch.bfloat16,)):
        g = torch.Generator(device=cuda).manual_seed(9)
        u, v = (torch.randn(2, T, r_in, generator=g, device=cuda).to(dt)
                for _ in range(2))
        ca, cb = (torch.rand(2, T, cc, generator=g, device=cuda).to(dt)
                  for _ in range(2))
        kw = {}
        if kind == "i8rs":
            q = [quantize_act(x, per_row=True) for x in (ca, cb)]
            c = [q[0][0], q[1][0]]
            kw = dict(int8=True, c_row_scales=torch.cat(
                [q[0][1].reshape(-1, 1), q[1][1].reshape(-1, 1)], 1))
            ops = pf.pair_reverse_operands_int8(pair, dt, rs=True)
            name = "pair_flow_i8rs"
        else:
            make = (pf.pair_reverse_operands_hoisted if kind == "hoisted"
                    else pf.pair_reverse_operands_hoisted_int8)
            ops, (we, wo) = make(pair, dt)
            c = [pf.hoist_cond(ca, we), pf.hoist_cond(cb, wo)]
            kw = dict(hoisted=True, int8=kind == "hoisted_i8")
            name = "pair_flow_" + kind
        n0 = launch.LAUNCHES[name]
        got = pf.fused_pair_reverse(u, v, *c, ops, **kw)
        torch.cuda.synchronize()
        assert launch.LAUNCHES[name] == n0 + 1
        # the launch's tile: the int8 pairs' per-window scales follow it
        tt = launch.LAST_LAUNCH[name]["t_tile"]
        want = pf.pair_reverse_ref(u, v, *c, ops, t_tile=tt, **kw)
        # zw = zb = 0 (operands 11, 12; 10, 11 without cond_w)
        zi = (11, 12) if kind == "i8rs" else (10, 11)
        ops_pass = tuple(torch.zeros_like(o) if i in zi else o
                         for i, o in enumerate(ops))
        passthru = pf.pair_reverse_ref(u, v, *c, ops_pass, t_tile=tt, **kw)
        fp32 = dt == torch.float32
        _check(got, want, passthru, 1e-4 if fp32 else 1e-2,
               None if fp32 else 0.9999)


@pytest.mark.cuda
def test_hoist_cond_rounds_once(cuda):
    """The hoist matmul on the card (bf16 in, fp32 sums on the tensor
    cores) vs the fp32 product of the same bf16 values rounded once to
    bf16, at block 7's K = 10240: every element within one bf16 step
    (2^-7 relative) plus 1e-5 of the largest, the fp32 summation order
    being the only difference."""
    g = torch.Generator(device=cuda).manual_seed(3)
    c = torch.rand(2, 360, 10240, generator=g, device=cuda).bfloat16()
    w = (torch.randn(10240, 1536, generator=g, device=cuda)
         * 0.01).bfloat16()
    got = pf.hoist_cond(c, w)
    want = torch.matmul(c.float(), w.float())
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want).abs()
    assert torch.all(err <= want.abs() * 2 ** -7
                     + 1e-5 * want.abs().max()), float(err.max())


@pytest.mark.cuda
def test_device_noise_on_card_matches_cpu(cuda):
    """threefry bits on the card equal the CPU's exactly; the normals agree
    to 1e-6 (log1p/sqrt may round differently on the card)."""
    from flowavenet_tpu_torch.synthesis import noise
    seeds = [0, 5, 2 ** 32 - 1]
    b_gpu = noise.random_bits(noise.prng_key(seeds, cuda), 5000).cpu()
    b_cpu = noise.random_bits(noise.prng_key(seeds), 5000)
    assert torch.equal(b_gpu, b_cpu)
    z_gpu = noise.row_noise(seeds, [1.0, 0.5, 0.7], 5000, cuda).cpu()
    z_cpu = noise.row_noise(seeds, [1.0, 0.5, 0.7], 5000)
    assert float((z_gpu - z_cpu).abs().max()) <= 1e-6
    f_gpu = noise.frame_noise(9, [0, 100], [0.7, 0.7], 4, 256, cuda).cpu()
    f_cpu = noise.frame_noise(9, [0, 100], [0.7, 0.7], 4, 256)
    assert float((f_gpu - f_cpu).abs().max()) <= 1e-6


def _train_case(bi: int, dt, dev, T: int = 300, B: int = 2):
    """lj22k widths of block bi: a pair with 0.05-scale zero convs and
    0.05-scale ActNorm noise, inputs, cotangents and the three scalar
    cotangents, all from seeds."""
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    cfg = lj22k().model
    gen = torch.Generator().manual_seed(10 + bi)
    block = fwn.init_block(gen, 1 << bi, cfg.num_mels << bi, cfg)
    fl = block["flows"]
    fl["coupling"]["zero"]["w"].normal_(0, 0.05, generator=gen)
    fl["actnorm"]["b"].normal_(0, 0.05, generator=gen)
    fl["actnorm"]["logs"].normal_(0, 0.05, generator=gen)
    pair = tree_map(lambda l: l.to(dev), fwn._index(fwn._pair_params(block),
                                                    0))
    ops = pf.pair_forward_operands(pair, dt)
    r_in, cc = 1 << bi, 80 << bi
    g = torch.Generator(device=dev).manual_seed(bi)
    x = [torch.randn(B, T, r_in, generator=g, device=dev).to(dt)
         for _ in range(4)]
    c = [torch.rand(B, T, cc, generator=g, device=dev).to(dt)
         for _ in range(2)]
    scal = [torch.tensor(s, device=dev) for s in (0.7, 0.11, 1.3)]
    return pft, ops, x[0], x[1], c[0], c[1], x[2], x[3], scal


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("bi", [0, 3])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_train_kernels_match_plain(cuda, monkeypatch, bi, mode):
    """pair_fwd, pair_train_fwd and pair_train_bwd vs their plain versions
    (pair_train_fwd_ref and autograd through it), T=300 (a ragged last
    tile), hinge live.  fp32: rel-to-max <= 1e-4 on outputs, statistics
    and every gradient; bf16: outputs rel <= 1e-2 and corr >= 0.999,
    cosine >= 0.999 per gradient.  Two backward launches give the same
    bits."""
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    pft, ops, u, v, ca, cb, gu, gv, (gr, gq, gh) = _train_case(bi, dt, cuda)
    mx = pft.pair_train_fwd_ref(u, v, ca, cb, ops)[3]
    monkeypatch.setattr(pft, "HINGE_MARGIN", 0.5 * float(mx))
    want = pft.pair_train_fwd_ref(u, v, ca, cb, ops)
    n0 = dict(launch.LAUNCHES)
    got = pft.fused_pair_train_fwd(u, v, ca, cb, ops)
    fwd = pft.fused_pair_forward(u, v, ca, cb, ops)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["pair_train_fwd"] == n0["pair_train_fwd"] + 1
    assert launch.LAUNCHES["pair_fwd"] == n0["pair_fwd"] + 1
    assert float(want[5]) > 0.0
    for a, b in list(zip(got[:2], want[:2])) + list(zip(fwd[:2], want[:2])):
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        rel = float((a - b).abs().max() / b.abs().max())
        if mode == "fp32":
            assert rel <= 1e-4
        else:
            assert rel <= 1e-2 and _cos(a - a.mean(), b - b.mean()) >= 0.999
    for a, b in list(zip(got[2:], want[2:])) + [(fwd[2], want[2])]:
        assert abs(float(a) - float(b)) <= 1e-3 * abs(float(b)) + 1e-6
    d1 = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, gr, gq, gh, ops)
    d2 = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, gr, gq, gh, ops)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["pair_train_bwd"] == n0["pair_train_bwd"] + 2
    dref = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, gr, gq, gh, ops)
    flat = lambda d: list(d[0]) + list(d[1:])
    for a, a2, b in zip(flat(d1), flat(d2), flat(dref)):
        assert torch.equal(a, a2)
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        if mode == "fp32":
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        elif float(b.abs().max()) > 0:
            assert _cos(a, b) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("bi", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_train_tc_kernels_match_plain(cuda, monkeypatch, bi, mode):
    """pair_fwd, pair_train_fwd and pair_train_bwd vs their plain versions
    at the lj22k widths of blocks 0-3, T=300 (a ragged last tile of the
    tensor-core instances' tiles), hinge live; in bf16 all three run on
    the tensor cores (launch.uses_tensor_cores).  bf16: outputs rel-to-max
    <= 1e-2 with corr >= 0.999, statistics (pair_fwd: the -log_s sum) rel
    <= 1e-2, cosine >= 0.999 per gradient leaf; fp32 (CUDA cores):
    rel-to-max <= 1e-4 on outputs, statistics and every gradient."""
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    pft, ops, u, v, ca, cb, gu, gv, (gr, gq, gh) = _train_case(bi, dt, cuda)
    assert launch.uses_tensor_cores(dt) == (mode == "bf16")
    mx = pft.pair_train_fwd_ref(u, v, ca, cb, ops)[3]
    monkeypatch.setattr(pft, "HINGE_MARGIN", 0.5 * float(mx))
    want = pft.pair_train_fwd_ref(u, v, ca, cb, ops)
    n0 = dict(launch.LAUNCHES)
    got = pft.fused_pair_train_fwd(u, v, ca, cb, ops)
    fwd = pft.fused_pair_forward(u, v, ca, cb, ops)
    d = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, gr, gq, gh, ops)
    torch.cuda.synchronize()
    for k in pft.TRAIN_KERNELS:
        assert launch.LAUNCHES[k] == n0[k] + 1
    assert float(want[5]) > 0.0
    bar = 1e-4 if mode == "fp32" else 1e-2
    for a, b in list(zip(got[:2], want[:2])) + list(zip(fwd[:2], want[:2])):
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max() / b.abs().max()) <= bar
        if mode == "bf16":
            assert _cos(a - a.mean(), b - b.mean()) >= 0.999
    for a, b in list(zip(got[2:], want[2:])) + [(fwd[2], want[2])]:
        assert abs(float(a) - float(b)) <= bar * abs(float(b)) + 1e-6
    dref = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, gr, gq, gh, ops)
    for a, b in zip(list(d[0]) + list(d[1:]), list(dref[0]) + list(dref[1:])):
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        if mode == "fp32":
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        elif float(b.abs().max()) > 0:
            assert _cos(a, b) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("bi", [0, 3])
def test_train_tc_kernels_are_deterministic_and_row_local(cuda, bi):
    """bf16, on the tensor cores: two launches of each kernel give the same
    bits, and a batch row's outputs and its du, dv, dc_a, dc_b computed
    alone equal the same row computed beside its companion (tiles never
    span two rows; only the weight gradients sum over the batch)."""
    pft, ops, u, v, ca, cb, gu, gv, scal = _train_case(bi, torch.bfloat16,
                                                       cuda)

    def run(rows):
        x = [t[rows].contiguous() for t in (u, v, ca, cb, gu, gv)]
        f = pft.fused_pair_train_fwd(*x[:4], ops)
        d = pft.fused_pair_train_bwd(*x, *scal, ops)
        return list(f[:2]) + list(d[1:]), list(f[2:]) + list(d[0])

    both, s1 = run(slice(0, 2))
    again, s2 = run(slice(0, 2))
    alone, _ = run(slice(1, 2))
    torch.cuda.synchronize()
    for x, y, z in zip(both, again, alone):
        assert torch.equal(x, y)
        assert torch.equal(x[1:2], z)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))


@pytest.mark.cuda
def test_train_launchers_refuse_mismatched_flags(cuda):
    """The C launchers refuse a tc flag that does not name the instance
    (fp32 on the tensor cores, the bf16 pair_fwd / pair_train_fwd /
    pair_train_bwd off them) and widths the tensor-core instances do not
    take (R = 48, R = 16, Cc = 88), returning cudaErrorInvalidValue before
    anything is launched."""
    import ctypes
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    lib = launch.library("pair_flow_train")
    ptrs = (ctypes.c_void_p * 40)()            # never dereferenced

    def dims(R, Cc):
        return (ctypes.c_int * 7)(1, 120, 1, R, Cc, 64, 1)
    fwd, bwd = lib.pair_train_fwd_launch, lib.pair_train_bwd_launch
    bad = [fwd(1, 1, 0, ptrs, dims(256, 80), 5.0, None),   # bf16 train off
           fwd(1, 0, 0, ptrs, dims(256, 80), 5.0, None),   # bf16 fwd off
           fwd(0, 1, 1, ptrs, dims(256, 80), 5.0, None),   # fp32 tc
           bwd(1, 0, ptrs, dims(256, 80), 5.0, None),      # bf16 bwd off
           bwd(0, 1, ptrs, dims(256, 80), 5.0, None),      # fp32 tc
           fwd(1, 1, 1, ptrs, dims(48, 80), 5.0, None),    # R=48
           bwd(1, 1, ptrs, dims(16, 80), 5.0, None),       # R=16
           bwd(1, 1, ptrs, dims(256, 88), 5.0, None)]      # Cc=88
    torch.cuda.synchronize()
    assert all(err != 0 for err in bad), bad


@pytest.mark.cuda
@pytest.mark.parametrize("phases", [6, 12])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_wino_hoisted_kernel_matches_plain(cuda, phases, mode):
    """pair_flow_wino[4]_hoisted vs pair_reverse_wino_ref(hoisted=True) at
    block 1's lj22k widths, two rows, T = 1000, on the pre-activations of
    hoist_cond: the bars of test_wino_kernel_matches_plain."""
    r_in, cc, T = 2, 160, 1000
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(8)
    u, v = (torch.randn(2, T, r_in, generator=g, device=cuda).to(dt)
            for _ in range(2))
    ca, cb = (torch.rand(2, T, cc, generator=g, device=cuda).to(dt)
              for _ in range(2))
    if phases == 6:
        ops, (we, wo) = pf.pop_cond_w(
            pf.pair_reverse_operands_wino(_pair(1, cuda), dt))
    else:
        ops, (we, wo) = pf.pair_reverse_operands_wino4(_pair(1, cuda), dt,
                                                       hoisted=True)
    c = [pf.hoist_cond(ca, we), pf.hoist_cond(cb, wo)]
    name = ("pair_flow_wino" if phases == 6 else "pair_flow_wino4") \
        + "_hoisted"
    n0 = launch.LAUNCHES[name]
    got = pf.fused_pair_reverse_wino(u, v, *c, ops, hoisted=True)
    torch.cuda.synchronize()
    assert launch.LAUNCHES[name] == n0 + 1
    want = pf.pair_reverse_wino_ref(u, v, *c, ops, t_tile=60, hoisted=True)
    ops_pass = tuple(torch.zeros_like(o) if i in (10, 11) else o
                     for i, o in enumerate(ops))       # zw = zb = 0
    passthru = pf.pair_reverse_wino_ref(u, v, *c, ops_pass, t_tile=60,
                                        hoisted=True)
    _check(got, want, passthru, 1e-4 if mode == "fp32" else 1e-2,
           None if mode == "fp32" else 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("phases", [6, 12])
def test_wino_hoisted_launch_uses_the_reported_smem(cuda, phases):
    """pair_wino_smem_bytes, which the wrapper checks against the card's
    limit, is the dynamic shared memory that the tensor-core hoisted
    Winograd launch sets (cudaFuncGetAttributes after it), and that of its
    dense twin at the same widths and tile: no Winograd instance pads its
    u/v windows."""
    import ctypes
    lib = launch.library("pair_flow_wino")
    got = {}
    for kind in ("wino", "wino_hoisted") if phases == 6 else (
            "wino4", "wino4_hoisted"):
        kern, _, _, name = _tc_case(kind, 1, cuda, T=300)
        kern(slice(0, 2))
        torch.cuda.synchronize()
        out = (ctypes.c_int * 3)()
        assert lib.pair_wino_attrs(1, phases, int("hoisted" in kind), out) == 0
        got[kind] = (out[2], launch.LAST_LAUNCH[name]["t_tile"])
    (dense, tt), (hoisted, tt_h) = got.values()
    want = lib.pair_wino_smem_bytes(1, phases, 1, 256, 2, tt)
    assert tt_h == tt == pf.wino_t_tile(torch.bfloat16, phases)
    assert hoisted == dense == want > 0


def _resblock_args(cuda, dt, v2: bool, cc: int, T: int = 700, B: int = 2,
                   R: int = 256):
    """Seeded ResBlock inputs at the lj22k width R: h, the conditioning
    (cond_fg, or v2's c), weights scaled like the weight-normed convs and
    fp32 biases."""
    g = torch.Generator(device=cuda).manual_seed(cc + v2)
    rn = lambda *s, sc=1.0: sc * torch.randn(*s, generator=g, device=cuda)
    h = rn(B, T, R).to(dt)
    cond = (torch.rand(B, T, cc, generator=g, device=cuda) if v2
            else rn(B, T, 2 * R)).to(dt)
    w = [rn(3, R, 2 * R, sc=0.03), rn(R, R, sc=0.06), rn(R), rn(R, R,
                                                              sc=0.06),
         rn(R)]
    if v2:
        return (h, cond, w[0], rn(cc, 2 * R, sc=0.03), rn(2 * R), *w[1:])
    return (h, cond, *w)


@pytest.mark.cuda
@pytest.mark.parametrize("v2", [False, True], ids=["resblock", "resblock_v2"])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("causal,dilation", [(False, 1), (True, 3)])
def test_resblock_kernels_match_plain(cuda, v2, mode, causal, dilation):
    """resblock / resblock_v2 vs resblock_ref / resblock_v2_ref at R = 256,
    T = 700 (a ragged last tile), Cc = 2560 for v2 (lj22k block 5, several
    c chunks): fp32 rel-to-max <= 1e-4, bf16 rel <= 1e-2 and corr >= 0.999.
    The Function's backward (the JAX package's _fgr_bwd / _fgr2_bwd) vs
    autograd through the plain version: fp32 rel-to-max <= 1e-4 per input,
    bf16 cosine >= 0.99 (the two round to bf16 at other points)."""
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    args = _resblock_args(cuda, dt, v2, 2560)
    name = "resblock_v2" if v2 else "resblock"
    fn = rb.fused_gated_resblock_v2 if v2 else rb.fused_gated_resblock
    ref = rb.resblock_v2_ref if v2 else rb.resblock_ref
    n0 = launch.LAUNCHES[name]
    xs = [a.clone().requires_grad_() for a in args]
    got = fn(*xs, dilation=dilation, causal=causal)
    torch.cuda.synchronize()
    assert launch.LAUNCHES[name] == n0 + 1
    want = ref(*args, dilation=dilation, causal=causal)
    for a, b in zip(got, want):
        a, b = a.detach().float(), b.float()
        assert bool(torch.isfinite(a).all())
        rel = float((a - b).abs().max() / b.abs().max())
        if mode == "fp32":
            assert rel <= 1e-4
        else:
            assert rel <= 1e-2 and _cos(a - a.mean(), b - b.mean()) >= 0.999
    cts = [torch.randn(a.shape, device=cuda).to(dt) for a in got]
    torch.autograd.backward(got, cts)
    ys = [a.clone().requires_grad_() for a in args]
    torch.autograd.backward(ref(*ys, dilation=dilation, causal=causal), cts)
    for x, y in zip(xs, ys):
        a, b = x.grad.float(), y.grad.float()
        assert bool(torch.isfinite(a).all())
        if mode == "fp32":
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
        else:
            assert _cos(a, b) >= 0.99


@pytest.mark.cuda
def test_resblock_rejects_bad_inputs(cuda):
    args = _resblock_args(cuda, torch.float32, False, 512, T=64)
    with pytest.raises(ValueError, match="must be on"):
        rb.fused_gated_resblock(args[0], args[1].cpu(), *args[2:],
                                dilation=1, causal=False)
    with pytest.raises(ValueError, match="S == R"):
        rb.fused_gated_resblock(*args[:5], args[5][:, :128], args[6][:128],
                                dilation=1, causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("causal,dilation", [(False, 1), (True, 3),
                                             (False, 16), (True, 16)])
@pytest.mark.parametrize("v2,cc", [(True, 80), (True, 2560), (False, 512)],
                         ids=["v2_cc80", "v2_cc2560", "v1"])
def test_resblock_tc_kernels_match_plain(cuda, v2, cc, causal, dilation, B):
    """The bf16 tensor-core instances (direct_layer_tc_bf with dense or
    hoisted conditioning, res/skip through tc_rows) vs the plain versions
    at R = 256, Cc 80 and 2560 (v2) or cond_fg 2R wide (v1), T = 997 (odd,
    a ragged last tile): rel-to-max <= 1e-2 and corr >= 0.999; one launch
    on the tile _tc_tile gives; two launches give the same bits."""
    args = _resblock_args(cuda, torch.bfloat16, v2, cc, T=997, B=B)
    name = "resblock_v2" if v2 else "resblock"
    fn = rb.fused_gated_resblock_v2 if v2 else rb.fused_gated_resblock
    ref = rb.resblock_v2_ref if v2 else rb.resblock_ref
    n0 = launch.LAUNCHES[name]
    got = fn(*args, dilation=dilation, causal=causal)
    again = fn(*args, dilation=dilation, causal=causal)
    torch.cuda.synchronize()
    assert launch.LAUNCHES[name] == n0 + 2
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    tt = rb._tc_tile(B, 997, 256, dilation, n_sm)
    assert launch.LAST_LAUNCH[name] == {"t_tile": tt,
                                        "ctas": B * -(-997 // tt)}
    want = ref(*args, dilation=dilation, causal=causal)
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-2
        assert _cos(a - a.mean(), b - b.mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("gin", [0, 6], ids=["v2", "v1_g"])
def test_resblock_route_takes_filter_size_48(cuda, mode, gin):
    """R = 48 (filter_size 48), which neither instance takes unpadded,
    through apply_wavenet(use_pallas=True) (no g: v2 at Cc 80; a global
    condition: v1) against use_pallas=False, at the ResBlock route bars
    (chip_smoke.py phase 2c): fp32 update_err <= 1e-4; bf16 each route
    against the fp32 plain result, the kernel route's update_err at most
    1.5x the plain route's or 1e-2.  update_err: RMS of the difference over
    the RMS of the net's output."""
    from flowavenet_tpu_torch.models import modules as tmod
    gen = torch.Generator().manual_seed(48)
    p = tmod.init_wavenet(gen, in_channels=2, out_channels=4, num_layers=2,
                          residual_channels=48, cin_channels=80,
                          gin_channels=gin)
    p["zero"]["w"].normal_(0, 0.05, generator=gen)
    p = tree_map(lambda l: l.to(cuda), p)
    g = torch.Generator(device=cuda).manual_seed(49)
    x = torch.randn(2, 700, 2, generator=g, device=cuda)
    c = torch.rand(2, 700, 80, generator=g, device=cuda)
    gc = (torch.randn(2, 1, gin, generator=g, device=cuda).expand(2, 700, gin)
          if gin else None)

    def run(dt, on):
        with torch.no_grad():
            return tmod.apply_wavenet(
                p, x.to(dt), c.to(dt), None if gc is None else gc.to(dt),
                causal=False, use_pallas=on).float()
    name = "resblock" if gin else "resblock_v2"
    n0 = launch.LAUNCHES[name]
    ref32 = run(torch.float32, False)

    def err(a):
        return float((a - ref32).pow(2).mean().sqrt()
                     / ref32.pow(2).mean().sqrt())
    if mode == "fp32":
        assert err(run(torch.float32, True)) <= 1e-4
    else:
        k, pl = err(run(torch.bfloat16, True)), err(run(torch.bfloat16,
                                                        False))
        assert k <= max(1.5 * pl, 1e-2), (k, pl)
    torch.cuda.synchronize()
    assert launch.LAUNCHES[name] == n0 + 1


@pytest.mark.cuda
def test_resblock_launcher_refuses_bf16_off_tc_and_unpadded_widths(cuda):
    """The C launcher is the guard against a wrapper that forgets to pad or
    picks the wrong instance: bf16 with tc = 0 and fp32 with tc = 1, R =
    48 and 16 on the tensor cores, v2's Cc = 79 there, R = 48 (not
    dividing the 512 threads) on CUDA cores, and a bf16 launch without the
    bias vector return cudaErrorInvalidValue before anything runs."""
    import ctypes
    lib = launch.library("resblock")
    buf = torch.zeros(16, device=cuda)
    ptrs = (ctypes.c_void_p * 11)(*[buf.data_ptr()] * 11)   # never read
    nob = (ctypes.c_void_p * 11)(*[buf.data_ptr()] * 11)
    nob[4] = None

    def go(dtype, v2, tc, R, Cc, p=ptrs):
        dims = (ctypes.c_int * 7)(1, 100, R, Cc, 16, 1, 1)
        return lib.resblock_launch(dtype, v2, tc, p, dims, None)
    bad = [go(1, 0, 0, 256, 0), go(1, 1, 0, 256, 80),       # bf16 off tc
           go(0, 0, 1, 256, 0), go(0, 1, 1, 256, 80),       # fp32 on tc
           go(1, 0, 1, 48, 0), go(1, 1, 1, 48, 80),         # tc, R = 48
           go(1, 1, 1, 16, 80), go(1, 1, 1, 256, 79),       # R 16, Cc 79
           go(0, 0, 0, 48, 0), go(0, 1, 0, 48, 79),         # fp32, R = 48
           go(1, 1, 1, 256, 80, nob)]                       # no bias
    torch.cuda.synchronize()
    assert all(e == 1 for e in bad), bad                    # InvalidValue


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "FWN_HOISTED=1"])
def test_synthesis_row_does_not_follow_its_companions(cuda, monkeypatch,
                                                      route):
    """lj22k, bf16: one 360-frame mel synthesized alone and beside 1 and 3
    companions of the same length (same noise, seed + i per row) gives the
    same bits on both routes: an item's audio depends only on its mel,
    seed, temperature and padded length, the contract of the JAX
    package's ``synthesize_mels``.  The default route's deep blocks run
    the plain pair-scan, whose convs are one GEMM over their taps
    (``ops/conv.py:dilated_conv1d``) and whose compute-dtype conditioning
    products run one row at a time; on FWN_HOISTED=1 every batch
    size launches pair_flow_hoisted_i8 on the same tile (block 5's, the
    last launch, at T_k = 1440: the rule's tile at the reference batch, 44
    rows on an H100 SXM).  Row 0's largest difference after the upsampler
    and after each block (``utils/profiling.py:BlockStages``) is printed
    with the audio's gap; rows 1-3 of the 4-row batch equal each of them
    synthesized alone."""
    from flowavenet_tpu_torch.synthesis.synthesize import synthesize_mels
    if route == "FWN_HOISTED=1":
        monkeypatch.setattr(fwn, "PAIR_KERNEL_HOISTED", True)
    cfg = lj22k()
    gen = torch.Generator().manual_seed(360)
    params = fwn.init_flowavenet(gen, cfg.model)
    for bp in params["blocks"]:
        bp["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05, generator=gen)
    params = tree_map(lambda l: l.to(cuda), params)
    rng = np.random.RandomState(360)
    mels = [rng.rand(360, cfg.audio.num_mels).astype(np.float32)
            for _ in range(4)]
    rows, by_stage, tiles = {}, {}, set()
    for n in (1, 2, 4):
        with BlockStages(rows=True) as st:
            batch = synthesize_mels(params, cfg, mels[:n], seed=0,
                                    compute_dtype=torch.bfloat16, device=cuda)
        rows[n] = batch[0]
        by_stage[n] = st.rows
        if route == "FWN_HOISTED=1":
            tiles.add(launch.LAST_LAUNCH["pair_flow_hoisted_i8"]["t_tile"])
    if route == "FWN_HOISTED=1":
        assert len(tiles) == 1, tiles
    top = float(np.abs(rows[1]).max())
    for n in (2, 4):
        gap = float(np.abs(rows[n] - rows[1]).max()) / top
        split = [f"{name} {float((a - b).abs().max()):.3e}"
                 for (name, a), (_, b) in zip(by_stage[1], by_stage[n])]
        print(f"{route}: row 0 beside {n - 1} companions vs alone: gap "
              f"{gap:.3e}; by stage (upsampler, blocks 7..0): "
              f"{', '.join(split)}"
              + (f", pair_flow_hoisted_i8 tile {tiles}" if tiles else ""))
        assert np.array_equal(rows[n], rows[1]), (n, gap, split)
    # the other rows of the 4-row batch, each alone (seed 0 + i)
    for i in (1, 2, 3):
        alone = synthesize_mels(params, cfg, [mels[i]], seed=i,
                                compute_dtype=torch.bfloat16, device=cuda)
        assert np.array_equal(batch[i], alone[0]), i


@pytest.mark.cuda
def test_bench_runs_the_default_route(cuda, monkeypatch, capsys):
    """``python -m flowavenet_tpu_torch.bench`` at lj22k, batch 4 x 7 s,
    one timed call: one JSON line with the top-level bench's keys on
    stdout, a positive rate, and 15 pair_flow_i8 launches per reverse
    (the first call and the timed one)."""
    from flowavenet_tpu_torch import bench
    for k, v in {"BENCH_BATCH": "4", "BENCH_ITERS": "1",
                 "BENCH_CONFIG": "lj22k", "BENCH_MELS": "synthetic"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_SECONDS", raising=False)
    n0 = dict(launch.LAUNCHES)
    result = bench.main(["--device", "cuda"])
    torch.cuda.synchronize()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == result
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["metric"] == "synthesis_khz_per_sec_per_chip"
    assert result["value"] > 0
    launched = {k: v - n0[k] for k, v in launch.LAUNCHES.items() if v != n0[k]}
    assert launched == {"pair_flow_i8": 30}, launched


def _tc_case(kind: str, bi: int, dev, T: int = 1000, B: int = 2, pair=None):
    """Inputs and a launcher of a tensor-core pair at lj22k block bi's widths
    (or ``pair``'s R): ``i8`` (pair_flow_i8, int8 codes of c with per-row
    scales), ``i8rs`` (pair_flow_i8rs, the same with int8 res/skip),
    ``direct`` (pair_flow), ``hoisted`` / ``hoisted_i8`` (pair_flow_hoisted
    / pair_flow_hoisted_i8: c through the hoist matmul), ``wino``
    (pair_flow_wino, F(2,3)), ``wino4`` (pair_flow_wino4, F(4,3)) or
    ``wino_hoisted`` / ``wino4_hoisted`` (their hoisted twins, c through
    the hoist matmul), all with bf16 storage; returns (kernel(rows),
    plain(rows), passthru(rows), counter name).  The plain version runs at
    the tile of the kernel's last launch (the int8 pairs' per-window scales
    follow it)."""
    r_in, cc = 1 << bi, 80 << bi
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11 + bi)
    u, v = (torch.randn(B, T, r_in, generator=g, device=dev).to(dt)
            for _ in range(2))
    c = [torch.rand(B, T, cc, generator=g, device=dev).to(dt)
         for _ in range(2)]
    pair = _pair(bi, dev) if pair is None else pair
    if kind in ("i8", "i8rs", "direct"):
        int8 = kind != "direct"
        crs = None
        if int8:
            q = [quantize_act(x, per_row=True) for x in c]
            c = [q[0][0], q[1][0]]
            crs = torch.cat([q[0][1].reshape(-1, 1), q[1][1].reshape(-1, 1)],
                            1)
            ops = pf.pair_reverse_operands_int8(pair, dt, rs=kind == "i8rs")
        else:
            ops = pf.pair_reverse_operands(pair, dt)
        tt = pf.kernel_t_tile(dt, r_in)

        def kern(rows, ops=ops):
            return pf.fused_pair_reverse(
                u[rows], v[rows], c[0][rows], c[1][rows], ops, int8=int8,
                c_row_scales=None if crs is None else crs[rows])

        def plain(rows, ops=ops):
            return pf.pair_reverse_ref(
                u[rows], v[rows], c[0][rows], c[1][rows], ops, t_tile=tt,
                int8=int8, c_row_scales=None if crs is None else crs[rows])
        name = {"i8": "pair_flow_i8", "i8rs": "pair_flow_i8rs",
                "direct": "pair_flow"}[kind]
    elif kind in ("hoisted", "hoisted_i8"):
        int8 = kind == "hoisted_i8"
        make = (pf.pair_reverse_operands_hoisted_int8 if int8
                else pf.pair_reverse_operands_hoisted)
        ops, (we, wo) = make(pair, dt)
        c = [pf.hoist_cond(c[0], we), pf.hoist_cond(c[1], wo)]
        name = "pair_flow_" + kind

        def kern(rows, ops=ops):
            return pf.fused_pair_reverse(u[rows], v[rows], c[0][rows],
                                         c[1][rows], ops, int8=int8,
                                         hoisted=True)

        def plain(rows, ops=ops):
            return pf.pair_reverse_ref(
                u[rows], v[rows], c[0][rows], c[1][rows], ops,
                t_tile=launch.LAST_LAUNCH[name]["t_tile"], int8=int8,
                hoisted=True)
        # zw = zb = 0 (operands 10, 11: the hoisted family has no cond_w)
        ops_pass = tuple(torch.zeros_like(o) if i in (10, 11) else o
                         for i, o in enumerate(ops))
        return kern, plain, lambda rows: plain(rows, ops=ops_pass), name
    else:
        P = 12 if kind.startswith("wino4") else 6
        hoisted = kind.endswith("hoisted")
        ops = (pf.pair_reverse_operands_wino(pair, dt) if P == 6
               else pf.pair_reverse_operands_wino4(pair, dt))
        if hoisted:
            ops, (we, wo) = pf.pop_cond_w(ops)
            c = [pf.hoist_cond(c[0], we), pf.hoist_cond(c[1], wo)]

        def kern(rows, ops=ops):
            return pf.fused_pair_reverse_wino(u[rows], v[rows], c[0][rows],
                                              c[1][rows], ops,
                                              hoisted=hoisted)

        def plain(rows, ops=ops):
            return pf.pair_reverse_wino_ref(u[rows], v[rows], c[0][rows],
                                            c[1][rows], ops, t_tile=10 * P,
                                            hoisted=hoisted)
        name = "pair_flow_" + kind
        if hoisted:
            # zw = zb = 0 (operands 10, 11 without cond_w)
            ops_pass = tuple(torch.zeros_like(o) if i in (10, 11) else o
                             for i, o in enumerate(ops))
            return (kern, plain, lambda rows: plain(rows, ops=ops_pass),
                    name)
    ops_pass = tuple(torch.zeros_like(o) if i in (11, 12) else o
                     for i, o in enumerate(ops))          # zw = zb = 0
    return kern, plain, lambda rows: plain(rows, ops=ops_pass), name


TC_CASES = [("i8", 0), ("i8", 3), ("wino", 1), ("direct", 0), ("direct", 3),
            ("wino4", 1), ("i8rs", 0), ("i8rs", 3), ("hoisted", 4),
            ("hoisted", 7), ("hoisted_i8", 5), ("hoisted_i8", 7),
            ("wino_hoisted", 0), ("wino_hoisted", 2), ("wino4_hoisted", 0),
            ("wino4_hoisted", 2)]
TC_OPTIONS = {"i8": dict(int8=True), "i8rs": dict(int8=True, rs=True),
              "direct": {}, "wino": dict(phases=6), "wino4": dict(phases=12),
              "hoisted": dict(hoisted=True),
              "hoisted_i8": dict(int8=True, hoisted=True),
              "wino_hoisted": dict(phases=6, hoisted=True),
              "wino4_hoisted": dict(phases=12, hoisted=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind,bi", TC_CASES)
def test_tc_kernels_match_plain(cuda, kind, bi):
    """The tensor-core pairs vs their plain versions at lj22k widths, two
    rows, T = 1000 (a ragged last tile): rel-to-max <= 1e-2, corr >= 0.9999
    (int8: its sums are exact, as the plain version's float64 products) or
    0.999 (bf16: summation order and one-ulp flips), and the error as a
    share of what the coupling nets add <= 1e-2."""
    assert launch.uses_tensor_cores(torch.bfloat16)
    kern, plain, passthru, name = _tc_case(kind, bi, cuda)
    rows = slice(0, 2)
    n0 = launch.LAUNCHES[name]
    got = kern(rows)
    torch.cuda.synchronize()
    assert launch.LAUNCHES[name] == n0 + 1
    _check(got, plain(rows), passthru(rows), 1e-2,
           0.9999 if "i8" in kind else 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,bi", TC_CASES)
def test_tc_kernels_are_deterministic_and_row_local(cuda, kind, bi):
    """Two launches give the same bits, and a batch row computed alone
    equals the same row computed beside another (one CTA per (row, tile);
    every scale is row-local; at T = 1000 the hoisted pairs' tile rule
    gives one and two rows the same tile)."""
    kern, _, _, name = _tc_case(kind, bi, cuda)
    a = kern(slice(0, 2))
    tile = launch.LAST_LAUNCH[name]["t_tile"]
    b = kern(slice(0, 2))
    alone = kern(slice(1, 2))
    assert launch.LAST_LAUNCH[name]["t_tile"] == tile
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, alone):
        assert torch.equal(x, y)
        assert torch.equal(x[1:2], z)


@pytest.mark.cuda
def test_tc_launchers_refuse_unpadded_widths_and_wrong_flags(cuda):
    """The C launchers are the guard against a wrapper that forgets to pad:
    R = 16 or Cc = 88 on a tensor-core instance (i8rs and the hoisted pairs
    included), R = 48 (not dividing the 512 threads) and Cc = 79 anywhere,
    hoisted c not 4R wide (the hoisted Winograd pairs too), and a tc flag
    that does not name the instance (the bf16 i8rs, hoisted and hoisted
    Winograd pairs off the tensor cores among them; tc = 2, the front and
    zero convs on the tensor cores, anywhere but a direct hoisted pair with
    R_in a multiple of 16), return a cudaError (cudaErrorInvalidValue)
    before anything is launched."""
    import ctypes
    ptrs = (ctypes.c_void_p * 26)()            # never dereferenced

    def dims(R, Cc, TT, Rin=2):
        return (ctypes.c_int * 6)(1, 120, Rin, R, Cc, TT)
    direct = launch.library("pair_flow").pair_reverse_launch
    wino = launch.library("pair_flow_wino").pair_wino_launch
    bad = [direct(1, 0, 1, ptrs, dims(16, 160, 64), None),     # tc, R=16
           direct(1, 1, 1, ptrs, dims(16, 160, 64), None),
           direct(0, 0, 0, ptrs, dims(48, 160, 32), None),     # R=48
           direct(0, 1, 0, ptrs, dims(32, 79, 32), None),      # Cc=79
           direct(1, 0, 1, ptrs, dims(32, 88, 64), None),      # tc, Cc=88
           direct(1, 0, 0, ptrs, dims(256, 160, 64), None),    # flag off
           direct(0, 0, 1, ptrs, dims(256, 160, 32), None),    # fp32 tc
           direct(1, 2, 0, ptrs, dims(256, 160, 64), None),    # i8rs off
           direct(1, 2, 1, ptrs, dims(16, 160, 64), None),     # i8rs R=16
           direct(1, 2, 1, ptrs, dims(32, 88, 64), None),      # i8rs Cc=88
           direct(1, 3, 0, ptrs, dims(256, 1024, 32), None),   # hoisted off
           direct(1, 4, 0, ptrs, dims(256, 1024, 32), None),   # hoisted_i8
           direct(1, 3, 1, ptrs, dims(16, 64, 32), None),      # R=16
           direct(1, 4, 1, ptrs, dims(16, 64, 32), None),
           direct(1, 3, 1, ptrs, dims(256, 1040, 32), None),   # Cc != 4R
           direct(1, 4, 1, ptrs, dims(256, 512, 32), None),
           direct(0, 3, 0, ptrs, dims(256, 1040, 32), None),
           direct(1, 3, 2, ptrs, dims(256, 1024, 32, 8), None),  # tc=2
           direct(1, 0, 2, ptrs, dims(256, 160, 64, 16), None),
           direct(0, 3, 2, ptrs, dims(256, 1024, 32, 16), None),
           wino(1, 6, 0, 1, ptrs, dims(16, 160, 72), None),
           wino(1, 12, 0, 1, ptrs, dims(16, 160, 60), None),
           wino(1, 12, 0, 1, ptrs, dims(64, 79, 60), None),
           wino(1, 12, 0, 0, ptrs, dims(256, 160, 60), None),  # flag off
           wino(1, 6, 1, 0, ptrs, dims(256, 1024, 72), None),  # hoisted off
           wino(1, 12, 1, 0, ptrs, dims(256, 1024, 60), None),
           wino(1, 6, 1, 2, ptrs, dims(256, 1024, 72, 16), None),  # tc=2
           wino(1, 12, 0, 2, ptrs, dims(256, 160, 60, 16), None),
           wino(1, 6, 1, 1, ptrs, dims(256, 1040, 72), None),  # Cc != 4R
           wino(1, 12, 1, 1, ptrs, dims(256, 512, 60), None),
           wino(0, 6, 1, 0, ptrs, dims(256, 1040, 48), None)]
    torch.cuda.synchronize()
    assert all(err != 0 for err in bad), bad


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["i8", "direct", "wino", "wino4", "i8rs",
                                  "hoisted", "hoisted_i8", "wino_hoisted",
                                  "wino4_hoisted"])
def test_tc_padded_narrow_pair_matches_plain(cuda, kind):
    """A filter_size 16 pair (R = 16 divides the threads but is no multiple
    of 32) runs on its tensor-core instance padded to R = 32, and matches
    its unpadded plain version at the bars of test_tc_kernels_match_plain."""
    cfg = dataclasses.replace(lj22k().model, filter_size=16)
    gen = torch.Generator().manual_seed(0)
    block = fwn.init_block(gen, 2, 160, cfg)
    block["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05, generator=gen)
    pair = tree_map(lambda l: l.to(cuda),
                    fwn._index(fwn._pair_params(block), 0))
    kern, plain, passthru, name = _tc_case(kind, 1, cuda, T=300, pair=pair)
    rows = slice(0, 2)
    n0 = launch.LAUNCHES[name]
    got = kern(rows)
    torch.cuda.synchronize()
    assert launch.LAUNCHES[name] == n0 + 1
    _check(got, plain(rows), passthru(rows), 1e-2,
           0.9999 if "i8" in kind else 0.999)


def _odd_width_model(name: str):
    """lj22k cut to 5 blocks (the kernel routes' blocks 0-4) with an odd
    num_mels (79: Cc = 79 * 2^b, the per-level route) or filter_size 48 (R
    padded to 64), params with 0.05-scale zero convs so the coupling nets
    move the audio."""
    kw = dict(num_mels=79) if name == "num_mels79" else dict(filter_size=48)
    cfg = dataclasses.replace(lj22k().model, n_block=5, **kw)
    gen = torch.Generator().manual_seed(5)
    params = fwn.init_flowavenet(gen, cfg)
    for bp in params["blocks"]:
        bp["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05, generator=gen)
    return cfg, params


# route -> (model switches, kernels it launches)
ODD_ROUTES = {"int8": ({}, ("pair_flow_i8",)),
              "FWN_INT8=0": ({"PAIR_KERNEL_INT8": False},
                             ("pair_flow_wino", "pair_flow")),
              "FWN_WINO4=1": ({"PAIR_KERNEL_INT8": False,
                               "PAIR_KERNEL_WINO4": True},
                              ("pair_flow_wino4", "pair_flow"))}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ODD_ROUTES))
@pytest.mark.parametrize("model", ["num_mels79", "filter_size48"])
def test_odd_width_models_reverse_on_the_kernel_routes(cuda, monkeypatch,
                                                       model, route):
    """Widths the kernels take only padded: bf16 reverse of two 40-frame
    mels on the kernel route vs the plain route (use_pallas=False) at the
    JAX package's int8 bar (rel-to-max < 0.08, corr > 0.998), with every
    kernel of the route launched."""
    cfg, params = _odd_width_model(model)
    switches, kernels = ODD_ROUTES[route]
    for k, val in switches.items():
        monkeypatch.setattr(fwn, k, val)
    params = tree_map(lambda l: l.to(cuda), params)
    g = torch.Generator(device=cuda).manual_seed(6)
    T = 40 * cfg.hop_size
    z = torch.randn(2, T, 1, generator=g, device=cuda)
    mel = torch.rand(2, 40, cfg.num_mels, generator=g, device=cuda)
    n0 = dict(launch.LAUNCHES)
    got = fwn.reverse(params, cfg, z, mel, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert all(launch.LAUNCHES[k] > n0[k] for k in kernels), launch.LAUNCHES
    want = fwn.reverse(params, dataclasses.replace(cfg, use_pallas=False),
                       z, mel, compute_dtype=torch.bfloat16)
    a, b = (x.float().cpu().numpy().ravel() for x in (got, want))
    assert np.all(np.isfinite(a))
    assert np.abs(a - b).max() / np.abs(b).max() < 0.08
    assert np.corrcoef(a, b)[0, 1] > 0.998


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["num_mels79", "filter_size48"])
def test_odd_width_models_train_on_the_kernel_route(cuda, monkeypatch,
                                                    model):
    """Widths the tensor-core training pair takes only padded (block 0's
    Cc 79 -> 80, R 48 -> 64): block 0's pair on pair_train_fwd /
    pair_train_bwd in bf16 vs the plain versions at the bf16 bars of
    test_train_tc_kernels_match_plain, T = 300; then the bf16 loss and
    gradient of the whole model on the FWN_TRAIN_KERNEL=1 route (block 0's
    three pairs on the kernels) vs the plain route: first loss within rel
    1e-3 or no farther from the fp32 loss than the plain route's, and the
    gradient's cosine to the fp32 plain gradient no more than 0.01 below
    the plain bf16 route's (chip_smoke.py phase 5's bars)."""
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    from flowavenet_tpu_torch.utils.tree import leaves
    cfg, params = _odd_width_model(model)
    pair = tree_map(lambda l: l.to(cuda), fwn._index(fwn._pair_params(
        params["blocks"][0]), 0))
    ops = pf.pair_forward_operands(pair, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(7)
    u, v, gu, gv = (torch.randn(2, 300, 1, generator=g, device=cuda)
                    .bfloat16() for _ in range(4))
    ca, cb = (torch.rand(2, 300, cfg.num_mels, generator=g, device=cuda)
              .bfloat16() for _ in range(2))
    scal = [torch.tensor(s, device=cuda) for s in (0.7, 0.11, 1.3)]
    mx = pft.pair_train_fwd_ref(u, v, ca, cb, ops)[3]
    monkeypatch.setattr(pft, "HINGE_MARGIN", 0.5 * float(mx))
    want = pft.pair_train_fwd_ref(u, v, ca, cb, ops)
    n0 = dict(launch.LAUNCHES)
    got = pft.fused_pair_train_fwd(u, v, ca, cb, ops)
    d = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal, ops)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["pair_train_fwd"] == n0["pair_train_fwd"] + 1
    assert launch.LAUNCHES["pair_train_bwd"] == n0["pair_train_bwd"] + 1
    for a, b in zip(got[:2], want[:2]):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-2
        assert _cos(a - a.mean(), b - b.mean()) >= 0.999
    for a, b in zip(got[2:], want[2:]):
        assert abs(float(a) - float(b)) <= 1e-2 * abs(float(b)) + 1e-6
    dref = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, *scal, ops)
    for a, b in zip(list(d[0]) + list(d[1:]), list(dref[0]) + list(dref[1:])):
        assert a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all())
        if float(b.float().abs().max()) > 0:
            assert _cos(a, b) >= 0.999

    monkeypatch.setattr(pft, "HINGE_MARGIN", 0.3)
    params = tree_map(lambda l: l.to(cuda), params)
    gx = torch.Generator(device=cuda).manual_seed(8)
    x = 0.3 * torch.randn(2, 40 * cfg.hop_size, 1, generator=gx, device=cuda)
    mel = torch.rand(2, 40, cfg.num_mels, generator=gx, device=cuda)

    def loss_and_grad(on, dt):
        monkeypatch.setattr(fwn, "TRAIN_KERNEL", on)
        p = tree_map(lambda l: l.detach().requires_grad_(), params)
        total, _ = fwn.loss_fn(p, cfg, x, mel, compute_dtype=dt,
                               logs_l2=0.05, logs_hinge=1.0)
        flat = leaves(p)
        gs = torch.autograd.grad(total, flat, allow_unused=True)
        return float(total.detach()), torch.cat([
            (torch.zeros_like(q) if gq is None else gq).flatten()
            for gq, q in zip(gs, flat)])

    n0 = dict(launch.LAUNCHES)
    l_k, g_k = loss_and_grad(True, torch.bfloat16)
    torch.cuda.synchronize()
    n_pair = cfg.n_flow // 2
    for k in ("pair_train_fwd", "pair_train_bwd"):
        assert launch.LAUNCHES[k] == n0[k] + n_pair
    l_p, g_p = loss_and_grad(False, torch.bfloat16)
    l32, g32 = loss_and_grad(False, torch.float32)
    assert np.isfinite(l_k) and bool(torch.isfinite(g_k).all())
    assert (abs(l_k - l_p) <= 1e-3 * abs(l_p)
            or abs(l_k - l32) <= abs(l_p - l32))
    assert _cos(g_k, g32) >= _cos(g_p, g32) - 0.01


def _tiny_train_pair(dev, dt=torch.bfloat16, T: int = 1024, B: int = 2):
    """tiny's block-0 training pair (R 32, R_in 1, Cc 80) with 0.05-scale
    zero conv and ActNorm noise, and seeded inputs of B rows of T_k = T,
    as in tiny's training step (batch 2 x 2048 samples, squeezed once)."""
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    cfg = tiny().model
    gen = torch.Generator().manual_seed(32)
    block = fwn.init_block(gen, 1, cfg.num_mels, cfg)
    fl = block["flows"]
    for leaf in (fl["coupling"]["zero"]["w"], fl["actnorm"]["b"],
                 fl["actnorm"]["logs"]):
        leaf.normal_(0, 0.05, generator=gen)
    pair = tree_map(lambda l: l.to(dev), fwn._index(fwn._pair_params(block),
                                                    0))
    ops = pf.pair_forward_operands(pair, dt)
    g = torch.Generator(device=dev).manual_seed(32)
    x = [torch.randn(B, T, 1, generator=g, device=dev).to(dt)
         for _ in range(4)]
    c = [torch.rand(B, T, cfg.num_mels, generator=g, device=dev).to(dt)
         for _ in range(2)]
    scal = [torch.tensor(s, device=dev) for s in (0.7, 0.11, 1.3)]
    return pft, ops, x, c, scal


# tiles of the tensor-core backward at R = 32: 16 (the last whose 88-column
# conditioning staging fitted in P3 before the repair), 17 (the first that
# overran it), the tile rule's pick at tiny's geometry (72) and between
TINY_BWD_TILES = (16, 17, 24, 32, 48, 64, 72)


@pytest.mark.cuda
def test_train_bwd_at_tiny_block0_matches_plain(cuda, monkeypatch):
    """pair_train_bwd in bf16 at tiny's block-0 widths (R 32, R_in 1, Cc
    80, T_k 1024, B 2), the launch that stopped with cudaError 700 while
    the conditioning staging of the cond weight gradient (80 columns at
    the row stride 88) overran P3 (laid out at R + 8 = 40): on the tile
    rule's tile (72 rows here) and on every tile of ``TINY_BWD_TILES``,
    each launch against pair_train_bwd_ref at phase 4's bf16 bar (cosine
    >= 0.999 per gradient), two launches bit-identical."""
    pft, ops, (u, v, gu, gv), (ca, cb), scal = _tiny_train_pair(cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pft.train_tc_t_tile(2, 1024, 32, 1, True, n_sm) == 72
    dref = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, *scal, ops)
    pick = pft.train_tc_t_tile
    for tt in (None,) + TINY_BWD_TILES:
        if tt is not None:
            monkeypatch.setattr(pft, "train_tc_t_tile", lambda *a, tt=tt: tt)
        n0 = launch.LAUNCHES["pair_train_bwd"]
        d = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal, ops)
        d2 = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal, ops)
        torch.cuda.synchronize()
        monkeypatch.setattr(pft, "train_tc_t_tile", pick)
        assert launch.LAUNCHES["pair_train_bwd"] == n0 + 2
        assert launch.LAST_LAUNCH["pair_train_bwd"]["t_tile"] == (tt or 72)
        for a, a2, b in zip(list(d[0]) + list(d[1:]), list(d2[0]) +
                            list(d2[1:]), list(dref[0]) + list(dref[1:])):
            assert torch.equal(a, a2)
            assert bool(torch.isfinite(a.float()).all())
            if float(b.float().abs().max()) > 0:
                assert _cos(a, b) >= 0.999, (tt, a.shape)


@pytest.mark.cuda
def test_tiny_trains_in_bf16_on_the_kernel_route(cuda, monkeypatch):
    """tiny in bf16 on FWN_TRAIN_KERNEL=1 (block 0's pair on
    pair_train_fwd / pair_train_bwd at R = 32): one make_train_step step
    runs and gives finite metrics and parameters, and the first loss and
    gradient against the plain route meet chip_smoke.py phase 5's bars
    (loss within rel 1e-3 or no farther from the fp32 loss than the
    plain route's; the gradient's cosine to the fp32 plain gradient no
    more than 0.01 below the plain bf16 route's)."""
    from flowavenet_tpu_torch.training import train_state as tts
    from flowavenet_tpu_torch.utils.tree import leaves
    cfg = tiny()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                compute_dtype="bfloat16"))
    g = torch.Generator(device=cuda).manual_seed(4)
    batch = {"audio": 0.1 * torch.randn(2, 2048, 1, generator=g,
                                        device=cuda),
             "mel": torch.rand(2, 8, 80, generator=g, device=cuda)}
    state = tts.ddi_initialize(tts.create_state(
        torch.Generator(device=cuda).manual_seed(0), cfg), cfg, batch)
    params = state.params

    def loss_and_grad(on, dt):
        monkeypatch.setattr(fwn, "TRAIN_KERNEL", on)
        p = tree_map(lambda l: l.detach().requires_grad_(), params)
        total, _ = fwn.loss_fn(p, cfg.model, batch["audio"], batch["mel"],
                               compute_dtype=dt)
        flat = leaves(p)
        gs = torch.autograd.grad(total, flat, allow_unused=True)
        return float(total.detach()), torch.cat([
            (torch.zeros_like(q) if gq is None else gq).flatten()
            for gq, q in zip(gs, flat)])

    n0 = dict(launch.LAUNCHES)
    l_k, g_k = loss_and_grad(True, torch.bfloat16)
    torch.cuda.synchronize()
    for k in ("pair_train_fwd", "pair_train_bwd"):
        assert launch.LAUNCHES[k] == n0[k] + 1
    l_p, g_p = loss_and_grad(False, torch.bfloat16)
    l32, g32 = loss_and_grad(False, torch.float32)
    assert np.isfinite(l_k) and bool(torch.isfinite(g_k).all())
    assert (abs(l_k - l_p) <= 1e-3 * abs(l_p)
            or abs(l_k - l32) <= abs(l_p - l32))
    assert _cos(g_k, g32) >= _cos(g_p, g32) - 0.01
    monkeypatch.setattr(fwn, "TRAIN_KERNEL", True)
    n0 = launch.LAUNCHES["pair_train_bwd"]
    state, m = tts.make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["pair_train_bwd"] == n0 + 1
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(bool(torch.isfinite(l).all()) for l in leaves(state.params))


# The width sweep: every launch site of the pair and ResBlock kernels at
# R 32-512, two conditioning widths and two R_in (the ResBlocks: two
# dilations), in fp32 (CUDA cores) and bf16 (tensor cores), each launch
# against its plain version at chip_smoke.py's bars (phases 2-4), or
# refused with ValueError before any launch where its shared memory does
# not fit.
SWEEP_SITES = ("pair_flow", "pair_flow_i8", "pair_flow_i8rs",
               "pair_flow_hoisted", "pair_flow_hoisted_i8", "pair_flow_wino",
               "pair_flow_wino4", "pair_flow_wino_hoisted",
               "pair_flow_wino4_hoisted", "pair_fwd", "pair_train_fwd",
               "pair_train_bwd", "resblock", "resblock_v2")
SWEEP_R = (32, 64, 128, 256, 512)
SWEEP_T = 310           # a ragged last tile at every tile below
R_SEED = 5              # inputs' seed, plus R_in and Cc
SWEEP_OPTIONS = {"pair_flow": {}, "pair_flow_i8": dict(int8=True),
                 "pair_flow_i8rs": dict(int8=True, rs=True),
                 "pair_flow_hoisted": dict(hoisted=True),
                 "pair_flow_hoisted_i8": dict(int8=True, hoisted=True),
                 "pair_flow_wino": dict(phases=6),
                 "pair_flow_wino4": dict(phases=12),
                 "pair_flow_wino_hoisted": dict(phases=6, hoisted=True),
                 "pair_flow_wino4_hoisted": dict(phases=12, hoisted=True)}


def _sweep_pair(R: int, r_in: int, cc: int, dev):
    """A seeded pair of widths (R_in, Cc, R) with 0.05-scale zero conv and
    ActNorm noise (two layers, as lj22k's)."""
    cfg = dataclasses.replace(lj22k().model, filter_size=R)
    gen = torch.Generator().manual_seed(R + 7 * r_in + cc)
    block = fwn.init_block(gen, r_in, cc, cfg)
    fl = block["flows"]
    for leaf in (fl["coupling"]["zero"]["w"], fl["actnorm"]["b"],
                 fl["actnorm"]["logs"]):
        leaf.normal_(0, 0.05, generator=gen)
    return tree_map(lambda l: l.to(dev), fwn._index(fwn._pair_params(block),
                                                    0))


def _sweep_reverse(name, pair, r_in, cc, dt, dev):
    """(kernel(), plain(tile), passthru(tile), bars) of a reverse pair site:
    the plain version at the tile of the kernel's launch; bars (rel, corr)
    of phase 2 / 2b (fp32 1e-4; bf16 1e-2 and 0.999; int8 1e-2 and
    0.9999)."""
    o = SWEEP_OPTIONS[name]
    int8, rs, hoisted = o.get("int8", False), o.get("rs", False), \
        o.get("hoisted", False)
    P = o.get("phases", 0)
    g = torch.Generator(device=dev).manual_seed(R_SEED + r_in + cc)
    u, v = (torch.randn(2, SWEEP_T, r_in, generator=g, device=dev).to(dt)
            for _ in range(2))
    c = [torch.rand(2, SWEEP_T, cc, generator=g, device=dev).to(dt)
         for _ in range(2)]
    crs = None
    if P:
        ops = (pf.pair_reverse_operands_wino(pair, dt) if P == 6
               else pf.pair_reverse_operands_wino4(pair, dt))
        if hoisted:
            ops, (we, wo) = pf.pop_cond_w(ops)
            c = [pf.hoist_cond(c[0], we), pf.hoist_cond(c[1], wo)]

        def kern():
            return pf.fused_pair_reverse_wino(u, v, *c, ops, hoisted=hoisted)

        def plain(tt, ops=ops):
            return pf.pair_reverse_wino_ref(u, v, *c, ops, t_tile=10 * P,
                                            hoisted=hoisted)
    else:
        if hoisted:
            make = (pf.pair_reverse_operands_hoisted_int8 if int8
                    else pf.pair_reverse_operands_hoisted)
            ops, (we, wo) = make(pair, dt)
            c = [pf.hoist_cond(c[0], we), pf.hoist_cond(c[1], wo)]
        elif int8:
            q = [quantize_act(x, per_row=True) for x in c]
            c = [q[0][0], q[1][0]]
            crs = torch.cat([q[0][1].reshape(-1, 1), q[1][1].reshape(-1, 1)],
                            1)
            ops = pf.pair_reverse_operands_int8(pair, dt, rs=rs)
        else:
            ops = pf.pair_reverse_operands(pair, dt)

        def kern():
            return pf.fused_pair_reverse(u, v, *c, ops, int8=int8,
                                         c_row_scales=crs, hoisted=hoisted)

        def plain(tt, ops=ops):
            return pf.pair_reverse_ref(u, v, *c, ops, t_tile=tt, int8=int8,
                                       c_row_scales=crs, hoisted=hoisted)
    # zw = zb = 0: the pass-through (ActNorm only)
    zero = (10, 11) if hoisted else (11, 12)
    ops_pass = tuple(torch.zeros_like(x) if i in zero else x
                     for i, x in enumerate(ops))
    bars = ((1e-2, 0.9999) if int8 else
            (1e-4, None) if dt == torch.float32 else (1e-2, 0.999))
    return kern, plain, lambda tt: plain(tt, ops=ops_pass), bars



def _sweep_smem(name, dt, R, r_in, cc, tt, dil=1):
    """Dynamic shared memory of site ``name`` at a tile (0: static only),
    from its launcher's own formula."""
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    dcode, tc = int(dt == torch.bfloat16), int(dt == torch.bfloat16)
    if name in SWEEP_OPTIONS:
        o = SWEEP_OPTIONS[name]
        if o.get("phases"):
            return launch.library("pair_flow_wino").pair_wino_smem_bytes(
                dcode, o["phases"], tc, R, r_in, tt)
        return launch.library("pair_flow").pair_reverse_smem_bytes(
            dcode, launch.KERNELS[name][1][0], tc, R, r_in, tt)
    if name in pft.TRAIN_KERNELS:
        return launch.library("pair_flow_train").pair_train_smem_bytes(
            int(name == "pair_train_bwd"), tc, R, r_in, tt)
    return launch.library("resblock").resblock_smem_bytes(
        dcode, int(name == "resblock_v2"), R, cc, tt, dil)


def _sweep_tiles(name, dt, R, r_in, cc, dil):
    """[(tile, patches)] of a sweep point: the tile rule's sites (the
    hoisted and training tensor-core pairs, the tensor-core ResBlocks, the
    fp32 training pairs) at their shortest and longest tile that fits,
    forced through the rule's function; every other site at the one tile
    its wrapper takes (``None``).  ``[(None, [])]`` also where no tile of
    a rule fits (the wrapper must then refuse)."""
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    bf16 = dt == torch.bfloat16
    hoisted_tc = bf16 and name in ("pair_flow_hoisted",
                                   "pair_flow_hoisted_i8")
    if name in pft.TRAIN_KERNELS and not bf16:
        return [(tt, [(pft, "train_t_tile", lambda *a, tt=tt: tt)])
                for tt in (32, 256)]
    if hoisted_tc:
        target = (pf, "_hoisted_tile")
    elif bf16 and name in pft.TRAIN_KERNELS:
        target = (pft, "train_tc_t_tile")
    elif bf16 and name.startswith("resblock"):
        target = (rb, "_tc_tile")
    else:
        return [(None, [])]
    fit = [tt for tt in range(16, 73)
           if 0 < _sweep_smem(name, dt, R, r_in, cc, tt, dil)
           <= launch.SMEM_MAX]
    if not fit:
        return [(None, [])]
    return [(tt, [(*target, lambda *a, tt=tt: tt)])
            for tt in sorted({fit[0], fit[-1]})]


def _sweep_fixed_smem(name, dt, R, r_in, cc, dil):
    """Shared memory of a site at the tile its wrapper takes unforced
    (the fixed tiles; 0 for the fp32 training pairs, static only)."""
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    if name in pft.TRAIN_KERNELS:
        return 0 if dt == torch.float32 else -1
    if name.startswith("resblock"):
        if dt == torch.bfloat16:
            return -1
        tt = rb._plan_tiles(SWEEP_T, rb.KERNEL_T_TILE)[0]
    else:
        o = SWEEP_OPTIONS[name]
        tt = (pf.wino_t_tile(dt, o["phases"]) if o.get("phases")
              else -1 if o.get("hoisted") and dt == torch.bfloat16
              else pf.kernel_t_tile(dt, r_in))
    return _sweep_smem(name, dt, R, r_in, cc, tt, dil)


def _sweep_point(name, R, r_in, cc, dt, dev, monkeypatch):
    """Runs one width-sweep point over its tiles; returns the outcomes
    ("ok <tile>" or "refused")."""
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    dil = r_in if name.startswith("resblock") else 1
    out = []
    for tt, patches in _sweep_tiles(name, dt, R, r_in, cc, dil):
        smem = (_sweep_fixed_smem(name, dt, R, r_in, cc, dil) if tt is None
                else _sweep_smem(name, dt, R, r_in, cc, tt, dil))
        fits = smem == 0 or 0 < smem <= launch.SMEM_MAX
        n0 = dict(launch.LAUNCHES)
        with monkeypatch.context() as mp:
            for obj, attr, val in patches:
                mp.setattr(obj, attr, val)
            try:
                n_launch = _sweep_launch(name, R, r_in, cc, dt, dev, dil, mp)
            except ValueError:
                torch.cuda.synchronize()
                assert dict(launch.LAUNCHES) == n0
                assert not fits, (name, R, r_in, cc, dt, tt, smem)
                out.append("refused")
                continue
            except AssertionError as e:
                # a mismatch is recorded, so that one run lists them all
                out.append(f"FAIL {tt}: {str(e).split(chr(10) + 'assert')[0]}")
                continue
        torch.cuda.synchronize()
        launched = {k: v - n0[k] for k, v in
                    dict(launch.LAUNCHES).items() if v != n0[k]}
        assert launched == {name: n_launch}, launched
        assert fits
        out.append(f"ok {tt}")
    return out


def _sweep_launch(name, R, r_in, cc, dt, dev, dil, mp):
    """One launch of site ``name`` against its plain version (raises
    ValueError where the wrapper refuses the geometry); returns the
    launches made (2 where an fp32 backward was re-run with shifted front
    conv biases)."""
    from flowavenet_tpu_torch.ops import pair_flow_train as pft
    if name in SWEEP_OPTIONS:
        pair = _sweep_pair(R, r_in, cc, dev)
        kern, plain, passthru, (bar, corr) = _sweep_reverse(
            name, pair, r_in, cc, dt, dev)
        got = kern()
        torch.cuda.synchronize()
        tt = launch.LAST_LAUNCH[name]["t_tile"]
        _check(got, plain(tt), passthru(tt), bar, corr)
        return 1
    if name.startswith("resblock"):
        v2 = name == "resblock_v2"
        args = _resblock_args(dev, dt, v2, cc, T=SWEEP_T, R=R)
        fn = rb.fused_gated_resblock_v2 if v2 else rb.fused_gated_resblock
        ref = rb.resblock_v2_ref if v2 else rb.resblock_ref
        got = fn(*args, dilation=dil, causal=False)
        torch.cuda.synchronize()
        want = ref(*args, dilation=dil, causal=False)
        pairs = zip(got, want)
        grads = []
    else:
        pair = _sweep_pair(R, r_in, cc, dev)
        ops = pf.pair_forward_operands(pair, dt)
        g = torch.Generator(device=dev).manual_seed(R_SEED + r_in + cc)
        u, v, gu, gv = (torch.randn(2, SWEEP_T, r_in, generator=g,
                                    device=dev).to(dt) for _ in range(4))
        ca, cb = (torch.rand(2, SWEEP_T, cc, generator=g, device=dev).to(dt)
                  for _ in range(2))
        scal = [torch.tensor(s, device=dev) for s in (0.7, 0.11, 1.3)]
        mx = pft.pair_train_fwd_ref(u, v, ca, cb, ops)[3]
        mp.setattr(pft, "HINGE_MARGIN", 0.5 * float(mx))
        want = pft.pair_train_fwd_ref(u, v, ca, cb, ops)
        grads = []
        if name == "pair_fwd":
            got = pft.fused_pair_forward(u, v, ca, cb, ops)
        elif name == "pair_train_fwd":
            got = pft.fused_pair_train_fwd(u, v, ca, cb, ops)
        else:
            d = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal, ops)
            dref = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, *scal, ops)
            grads = list(zip(list(d[0]) + list(d[1:]),
                             list(dref[0]) + list(dref[1:])))
            got = want
            # the fp64 plain version, to tell a kernel's error from the
            # plain version's own on a failure
            x64 = [t.double() for t in (u, v, ca, cb, gu, gv)]
            d64 = pft.pair_train_bwd_ref(
                *x64, *scal, pf.pair_forward_operands(pair, torch.float64))
            grads = [(a, b, c) for (a, b), c in zip(
                grads, list(d64[0]) + list(d64[1:]))]
        torch.cuda.synchronize()
        pairs = list(zip(got[:2], want[:2]))
        for a, b in zip(got[2:], want[2:]):
            bar = 1e-4 if dt == torch.float32 else 1e-2
            assert abs(float(a) - float(b)) <= bar * abs(float(b)) + 1e-6
    for i, (a, b) in enumerate(pairs):
        a, b = a.detach().float(), b.float()
        assert bool(torch.isfinite(a).all()), ("output", i, "not finite")
        rel = float((a - b).abs().max() / b.abs().max())
        cos = _cos(a - a.mean(), b - b.mean())
        assert rel <= (1e-4 if dt == torch.float32 else 1e-2), \
            ("output", i, "rel", rel)
        assert dt == torch.float32 or cos >= 0.999, ("output", i, "cos", cos)
    def rel_to(a, b):
        return float((a.double() - b.double()).abs().max()) / max(
            1e-30, float(b.double().abs().max()))

    bad = []
    for i, (a, b, b64) in enumerate(grads):
        a, b = a.float(), b.float()
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), \
            f"gradient {i} {tuple(a.shape)}: shape or not finite"
        if dt == torch.float32 and rel_to(a, b) > 1e-4:
            # where the entries past the bar lie: (flow, last-axis index)
            far = ((a - b).abs() > 1e-4 * b.abs().max()).nonzero()
            where = sorted({(int(x[0]), int(x[-1])) for x in far})[:4]
            bad.append(f"gradient {i} {tuple(a.shape)}: rel "
                       f"{rel_to(a, b):.3e} (kernel vs fp64 "
                       f"{rel_to(a, b64):.3e}, plain vs fp64 "
                       f"{rel_to(b, b64):.3e}), {len(far)} entries at "
                       f"{where}")
        elif (dt == torch.bfloat16 and float(b.abs().max()) > 0
              and _cos(a, b) < 0.999):
            # where the bf16 plain version is itself farther than phase 4's
            # bar from the fp64 one (R = 512: bf16 rounding of 2R-deep
            # products), the kernel is held to fp64 as closely as it
            c64, p64 = _cos(a, b64), _cos(b, b64)
            if p64 >= 0.999 or c64 < p64 - 1e-3:
                bad.append(f"gradient {i} {tuple(a.shape)}: cos "
                           f"{_cos(a, b):.6f} (kernel vs fp64 {c64:.6f}, "
                           f"plain vs fp64 {p64:.6f})")
    if bad and dt == torch.float32:
        # a ReLU whose fp32 pre-activation sits within rounding of zero can
        # take the other branch in the kernel than in the plain version,
        # which moves the gradient entries of its channel by a whole term:
        # the same pair with every front conv bias 1e-5 higher (no
        # pre-activation that close to zero then) must meet the bar, which
        # a fault would not
        ops2 = list(ops)
        ops2[1] = ops[1] + 1e-5
        d2 = pft.fused_pair_train_bwd(u, v, ca, cb, gu, gv, *scal, ops2)
        r2 = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, *scal, ops2)
        worst = max(rel_to(a, b) for a, b in zip(
            list(d2[0]) + list(d2[1:]), list(r2[0]) + list(r2[1:])))
        print(f"{name} R={R} R_in={r_in} Cc={cc} fp32: "
              + "; ".join(bad) + f"; front conv biases + 1e-5: worst "
              f"gradient rel {worst:.3e}")
        bad = [] if worst <= 1e-4 else bad + [
            f"front conv biases + 1e-5: worst gradient rel {worst:.3e}"]
        assert not bad, "; ".join(bad)
        return 2
    assert not bad, "; ".join(bad)
    return 1


@pytest.mark.cuda
@pytest.mark.parametrize("R", SWEEP_R)
@pytest.mark.parametrize("site", SWEEP_SITES)
def test_width_sweep_matches_plain_or_refuses(cuda, monkeypatch, site, R):
    """Every launch site at R (32-512), Cc 16 and 80, R_in 1 and 4 (the
    ResBlocks: dilations 1 and 4), fp32 on CUDA cores and bf16 on the
    tensor cores, T = 310 (ragged last tiles), at the tile rule's shortest
    and longest tile where a rule picks it (else the wrapper's one tile):
    each launch matches its plain version at chip_smoke.py's bars (phases
    2-4), or, where its shared memory does not fit, the wrapper raises
    ValueError before any launch.  No geometry faults.  A bf16 gradient
    whose plain version is itself below phase 4's cosine bar against the
    fp64 plain version is held to fp64 instead: no more than 1e-3 below
    the plain version's cosine.  Where fp32 gradients miss the bar, a ReLU
    pre-activation within rounding of zero may have taken the other
    branch (at R 256, R_in 4, Cc 16: one channel of flow 0's front conv);
    the same pair with its front conv biases 1e-5 higher must then meet
    the bar."""
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        for cc in (16, 80):
            for r_in in (1, 4):
                results[f"{str(dt)[6:]} Cc={cc} R_in={r_in}"] = _sweep_point(
                    site, R, r_in, cc, dt, cuda, monkeypatch)
    print(json.dumps({"site": site, "R": R, "points": results}))
    bad = {k: v for k, v in results.items()
           if any(o.startswith("FAIL") for o in v)}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["lj22k_4_blocks", "tiny"])
def test_nccl_world_size_one_step_is_bit_identical(cuda, monkeypatch, model):
    """The production scale-out path at world size 1: NCCL, a (1, 1) mesh,
    the state placed with put_tree, in bf16 on FWN_TRAIN_KERNEL=1 (block
    0) and FWN_FWD_KERNEL=1 (the blocks after it), the guards off, as that
    route needs: lj22k's widths cut to 4 blocks, and tiny (R 32, where
    pair_train_bwd's conditioning staging once overran its shared
    memory).  Two steps give the metrics and every leaf of the state of
    the one-device steps bit for bit, and the pair kernels run."""
    import socket

    import torch.distributed as dist

    from flowavenet_tpu_torch.parallel.mesh import make_mesh
    from flowavenet_tpu_torch.parallel.multihost import (
        initialize_distributed, put_tree, shutdown)
    from flowavenet_tpu_torch.training import train_state as tts
    from flowavenet_tpu_torch.training.train import state_sharding
    from flowavenet_tpu_torch.utils.tree import leaves
    monkeypatch.setattr(fwn, "TRAIN_KERNEL", True)
    monkeypatch.setattr(fwn, "PAIR_KERNEL_FWD", True)
    cfg = lj22k() if model.startswith("lj22k") else tiny()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model,
                                  n_block=min(4, cfg.model.n_block)),
        train=dataclasses.replace(cfg.train, compute_dtype="bfloat16",
                                  logs_hinge=0.0, logs_l2=0.0))
    g = torch.Generator(device=cuda).manual_seed(3)
    batch = {"audio": 0.1 * torch.randn(2, 16 * 256, 1, generator=g,
                                        device=cuda),
             "mel": torch.rand(2, 16, 80, generator=g, device=cuda)}
    state0 = tts.ddi_initialize(tts.create_state(
        torch.Generator(device=cuda).manual_seed(0), cfg), cfg, batch)

    def run(step, state):
        for _ in range(2):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        return state, m

    want, wm = run(tts.make_train_step(cfg), state0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert initialize_distributed(f"localhost:{port}", 1, 0, device="cuda",
                                  backend="nccl") is False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(cfg.mesh, cuda)
        assert mesh.distributed and mesh.shape == {"data": 1, "model": 1}
        specs = state_sharding(state0, mesh, cfg.mesh)
        n0 = dict(launch.LAUNCHES)
        got, gm = run(tts.make_train_step(cfg, mesh, specs.params),
                      put_tree(state0, mesh, specs))
        assert launch.LAUNCHES["pair_train_bwd"] > n0["pair_train_bwd"]
        assert launch.LAUNCHES["pair_fwd"] > n0["pair_fwd"]
    finally:
        shutdown()
    assert set(gm) == set(wm)
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "FWN_INT8=0"])
def test_two_replica_dispatch_rows_are_bit_identical(cuda, monkeypatch,
                                                     int8):
    """dispatch_mels over a data mesh of two replicas on the one card
    (cuda:0 twice): 3 mels pow2-padded to 4 rows, 2 per replica, each row
    bit-identical to the one-device call's (synthesis rows do not follow
    their companions on the card, PERF.md section 2); the kernels run on
    both shards."""
    from flowavenet_tpu_torch.parallel.mesh import make_data_mesh
    from flowavenet_tpu_torch.synthesis import synthesize as tsyn
    monkeypatch.setattr(fwn, "PAIR_KERNEL_INT8", int8)
    cfg = lj22k()
    gen = torch.Generator().manual_seed(11)
    params = tree_map(lambda l: l.to(cuda, torch.bfloat16),
                      fwn.init_flowavenet(gen, cfg.model))
    rs = np.random.RandomState(2)
    mels = [rs.rand(n, 80).astype(np.float32) for n in (60, 45, 52)]
    kw = dict(seed=[1, 2, 3], pad_batch=True, noise="device",
              compute_dtype=torch.bfloat16)
    one = tsyn.synthesize_mels(params, cfg, mels, device=cuda, **kw)
    mesh = make_data_mesh(["cuda:0", "cuda:0"])
    name = "pair_flow_i8" if int8 else "pair_flow_wino"
    n0 = launch.LAUNCHES[name]
    wav, frames = tsyn.dispatch_mels(params, cfg, mels, data_sharding=mesh,
                                     batch_multiple=2, **kw)
    two = tsyn.materialize_wavs(wav, frames, cfg)
    assert launch.LAUNCHES[name] - n0 == 2 * (15 if int8 else 9)
    for a, b in zip(one, two):
        assert np.array_equal(a, b)
