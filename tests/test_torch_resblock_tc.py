"""PyTorch port, the tensor-core ResBlocks ``resblock`` and ``resblock_v2``
(csrc/resblock.cu on pair_flow_common.cuh's ``direct_layer_tc_bf`` and
``tc_rows``; ops/resblock.py): the weights the wrapper packs unpack to the
same matrices; a row-by-row emulation of the kernel's tiling (window, tap
rows, conditioning rows, ragged m-tiles, stores) gives the plain
versions; the tile rule fits shared memory and fills the card at chip_smoke
phase 2c's geometry; widths the kernels take only padded give the
unpadded outputs; and the int8 hoisted pair's tile does not follow the
batch.  No JAX and no card: the kernels themselves are held against their
plain versions by tests/test_torch_card.py (``-k resblock``) and
chip_smoke.py."""

import types

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.ops import pair_flow as pf
from flowavenet_tpu_torch.ops import resblock as rb


def _randn(shape, seed, scale=1.0):
    r = np.random.RandomState(seed)
    return torch.from_numpy(scale * r.randn(*shape).astype(np.float32))


def _unpack(packed: torch.Tensor, k: int, n: int) -> np.ndarray:
    """Invert pack_tc_weights for a bf16 [..., K/16, N/8, 32, 4] operand:
    element i of lane l of (k-step s, n-tile t) is (16s + 2(l % 4) + (i &
    1) + 8(i >> 1), 8t + l // 4)."""
    p = packed.float().numpy()
    out = np.full(p.shape[:-4] + (k, n), np.nan, np.float32)
    for lane in range(32):
        for i in range(4):
            kk = 2 * (lane % 4) + (i & 1) + 8 * (i >> 1)
            out[..., kk::16, lane // 4::8] = p[..., :, :, lane, i]
    return out


@pytest.mark.parametrize("cc", [80, 2560])
def test_packed_weights_unpack_to_the_matrices(cc):
    """pack_resblock_weights packs w_conv [3, R, 2R], w_cond [Cc, 2R],
    w_res and w_skip [R, R] in fragment order (sizes kept; tap k of w_conv
    starts k * R/16 * 2R/8 * 32 fragments on, where direct_layer_tc_bf
    reads layer 0's taps), leaves the biases and cond as they are, and
    every operand unpacks to the matrix it was given."""
    R = 64
    ops = {"cond": _randn((1, 5, cc), 1).bfloat16(),
           "w_conv": _randn((3, R, 2 * R), 2).bfloat16(),
           "w_cond": _randn((cc, 2 * R), 3).bfloat16(),
           "b_all": _randn((2 * R,), 4),
           "w_res": _randn((R, R), 5).bfloat16(),
           "b_res": _randn((R,), 6),
           "w_skip": _randn((R, R), 7).bfloat16(),
           "b_skip": _randn((R,), 8)}
    packed = rb.pack_resblock_weights(ops)
    assert packed["w_conv"].shape == (3, R // 16, 2 * R // 8, 32, 4)
    assert packed["w_cond"].shape == (cc // 16, 2 * R // 8, 32, 4)
    base = packed["w_conv"].data_ptr()
    for k in range(3):
        assert (packed["w_conv"][k].data_ptr() - base) // 8 == (
            k * (R // 16) * (2 * R // 8) * 32)
    for name, (k, n) in {"w_conv": (R, 2 * R), "w_cond": (cc, 2 * R),
                         "w_res": (R, R), "w_skip": (R, R)}.items():
        assert packed[name].numel() == ops[name].numel()
        np.testing.assert_array_equal(_unpack(packed[name], k, n),
                                      ops[name].float().numpy())
    for name in ("cond", "b_all", "b_res", "b_skip"):
        assert packed[name] is ops[name]
    v1 = rb.pack_resblock_weights({**ops, "w_cond": None, "b_all": None})
    assert v1["w_cond"] is None and v1["b_all"] is None


def _emulate(h, cond, w_conv, w_cond, b_all, w_res, b_res, w_skip, b_skip,
             *, dilation, causal, t_tile):
    """The tensor-core kernel's indexing, row by row in fp64: one CTA per
    (batch row, tile of t_tile rows from t0); its window holds rows t0 -
    lead ... t0 + t_tile + 2d - lead (zero outside [0, T)); the layer runs
    over window rows [rb, re) = [d, d + rows) with rows = min(t_tile, T -
    t0), each 16-row m-tile reading row min(m0 + i, re - 1) (a ragged
    m-tile re-reads the last row and stores nothing past re) with taps r -
    d, r, r + d and its conditioning at global row min(max(win0 + r, 0), T
    - 1), win0 = t0 - d; G keeps centre row r at r - d; res/skip run over
    the same rows of G the same way and store output row o = r - d at t0 +
    o with h from window row o + lead.  Returns (h_new, skip, stores), the
    last counting how often each output row was stored."""
    h, cond = h.double().numpy(), cond.double().numpy()
    wc, wr, ws = (x.double().numpy() for x in (w_conv, w_res, w_skip))
    br, bs = b_res.double().numpy(), b_skip.double().numpy()
    v2 = w_cond is not None
    if v2:
        wcd, bias = w_cond.double().numpy(), b_all.double().numpy()
    B, T, R = h.shape
    d = dilation
    lead = 2 * d if causal else d
    h_new, skip = np.full_like(h, np.nan), np.full_like(h, np.nan)
    stores = np.zeros((B, T), int)
    for b in range(B):
        for t0 in range(0, T, t_tile):
            rows = min(t_tile, T - t0)
            pos = np.arange(t0 - lead, t0 + t_tile + 2 * d - lead)
            win = np.where(((pos >= 0) & (pos < T))[:, None],
                           h[b, np.clip(pos, 0, T - 1)], 0.0)
            rb_, re_, win0 = d, d + rows, t0 - d
            G = np.full((t_tile, R), np.nan)
            for m0 in range(rb_, re_, 16):
                r = np.minimum(m0 + np.arange(16), re_ - 1)
                fg = sum(win[r - d + k * d] @ wc[k] for k in range(3))
                crow = np.clip(win0 + r, 0, T - 1)
                fg = fg + (cond[b, crow] @ wcd + bias if v2
                           else cond[b, crow])
                gate = np.tanh(fg[:, :R]) / (1 + np.exp(-fg[:, R:]))
                keep = m0 + np.arange(16) < re_
                G[r[keep] - d] = gate[keep]
            for m0 in range(rb_, re_, 16):
                r = np.minimum(m0 + np.arange(16), re_ - 1)
                res, sk = G[r - d] @ wr, G[r - d] @ ws
                keep = m0 + np.arange(16) < re_
                o = r[keep] - d
                h_new[b, t0 + o] = (win[o + lead] + (res[keep] + br)) \
                    * rb.SQRT_HALF
                skip[b, t0 + o] = sk[keep] + bs
                stores[b, t0 + o] += 1
    return h_new, skip, stores


@pytest.mark.parametrize("v2", [False, True], ids=["resblock", "resblock_v2"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dilation", [1, 3, 16])
def test_tc_tiling_emulation_gives_the_plain_version(v2, causal, dilation):
    """The emulated tiling (T = 86 on 32-row tiles: two full tiles and a
    ragged one of 22 rows, whose second m-tile clamps) against
    resblock_ref / resblock_v2_ref in fp32: rel-to-max <= 1e-5 on every
    row, the first, a mid-tile and the last ones included; every output
    row stored exactly once."""
    R, Cc, B, T, tt = 32, 48, 2, 86, 32
    h = _randn((B, T, R), 10 + dilation)
    w = dict(w_conv=_randn((3, R, 2 * R), 11, 0.1),
             w_res=_randn((R, R), 12, 0.15), b_res=_randn((R,), 13),
             w_skip=_randn((R, R), 14, 0.15), b_skip=_randn((R,), 15))
    if v2:
        c = _randn((B, T, Cc), 16)
        w_cond, b_all = _randn((Cc, 2 * R), 17, 0.1), _randn((2 * R,), 18)
        want = rb.resblock_v2_ref(h, c, w["w_conv"], w_cond, b_all,
                                  w["w_res"], w["b_res"], w["w_skip"],
                                  w["b_skip"], dilation=dilation,
                                  causal=causal)
        got = _emulate(h, c, w["w_conv"], w_cond, b_all, w["w_res"],
                       w["b_res"], w["w_skip"], w["b_skip"],
                       dilation=dilation, causal=causal, t_tile=tt)
    else:
        cond = _randn((B, T, 2 * R), 19)
        want = rb.resblock_ref(h, cond, **w, dilation=dilation,
                               causal=causal)
        got = _emulate(h, cond, w["w_conv"], None, None, w["w_res"],
                       w["b_res"], w["w_skip"], w["b_skip"],
                       dilation=dilation, causal=causal, t_tile=tt)
    assert (got[2] == 1).all()
    for g, r in zip(got[:2], want):
        r = r.double().numpy()
        err = np.abs(g - r)
        assert err.max() <= 1e-5 * np.abs(r).max()
        for t in (0, 47, T - 1):                # first, mid-tile, last row
            assert err[:, t].max() <= 1e-5 * np.abs(r).max()


def _smem_bytes(R: int, tt: int, dil: int) -> int:
    """resblock_smem_bytes of a tensor-core instance (csrc/resblock.cu,
    smem_bytes_tc): the h window [tt + 2d] and the gate rows [tt] at the
    row stride R + 8 in bf16, each rounded up to 16 bytes."""
    ld = R + 8
    a16 = lambda x: (x + 15) & ~15
    return a16(2 * (tt + 2 * dil) * ld) + a16(2 * tt * ld)


def test_resblock_tile_rule_fills_the_card_at_phase_2c(monkeypatch):
    """The tensor-core ResBlocks' tile rule (resblock._tc_tile: the hoisted
    pairs' launch.balanced_t_tile(shortest=True) over resblock_smem_bytes,
    here the formula of :func:`_smem_bytes`) at chip_smoke phase 2c's
    geometry (4 mels padded to
    360 frames: T_k = 92160 >> (b + 1) at lj22k blocks 0-7, R = 256, the
    ResBlock of layer 0 at dilation 1; 132 SMs): a tile whose window fits
    in 232448 bytes of shared memory, needing no more waves than any tile
    of 16-72 rows, and the shortest of those; blocks 6-7 (v1) take 22 and
    16 rows, 132 and 92 CTAs, where the CUDA-core kernel's 64 rows gave 48
    and 24.  The largest window (R = 256, 72 rows, d = 16) fits."""
    n_sm, B, R = 132, 4, 256

    def library(smem):
        return lambda name: types.SimpleNamespace(
            resblock_smem_bytes=lambda dt, v2, r, cc, t, dil: smem(r, t, dil))
    monkeypatch.setattr(rb, "library", library(_smem_bytes))
    rule = rb._tc_tile.__wrapped__             # uncached
    want = {6: (22, 132), 7: (16, 92)}
    for bi in range(8):
        T = 92160 >> (bi + 1)
        tt = rule(B, T, R, 1, n_sm)

        def waves(t, T=T):
            return -(-B * -(-T // t) // n_sm)
        assert 16 <= tt <= 72 and _smem_bytes(R, tt, 1) <= 232448
        assert waves(tt) == min(waves(t) for t in range(16, 73))
        assert all(t >= tt for t in range(16, 73) if waves(t) == waves(tt))
        if bi in want:
            assert (tt, B * -(-T // tt)) == want[bi], (bi, tt)
    assert _smem_bytes(R, 72, 16) <= 232448
    monkeypatch.setattr(rb, "library", library(lambda r, t, dil: 10 ** 6))
    with pytest.raises(ValueError):
        rule(B, 360, R, 1, n_sm)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("cc", [0, 79, 80], ids=["v1", "v2_cc79",
                                                 "v2_cc80"])
def test_padded_resblock_equals_the_unpadded_one(dtype, cc):
    """R = 48 (and v2's Cc = 79 or 80) through resblock_widths and
    pad_resblock_widths: bf16 runs at R = 64 and Cc = 80, fp32 at R = 64
    with Cc unchanged; the plain version at the padded widths, cut back to
    R, gives the unpadded outputs (fp32: rel-to-max <= 1e-6, the padded
    products' summation order; bf16: within one bf16 ulp of the largest
    output, a fp32 difference flipping a rounding), and the padded
    channels' h_new and skip are exactly 0."""
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    R, B, T = 48, 2, 40
    h = _randn((B, T, R), 20).to(dt)
    ops = {"cond": (_randn((B, T, cc), 21) if cc
                    else _randn((B, T, 2 * R), 21)).to(dt),
           "w_conv": _randn((3, R, 2 * R), 22, 0.1).to(dt),
           "w_cond": _randn((cc, 2 * R), 23, 0.1).to(dt) if cc else None,
           "b_all": _randn((2 * R,), 24) if cc else None,
           "w_res": _randn((R, R), 25, 0.15).to(dt), "b_res": _randn((R,), 26),
           "w_skip": _randn((R, R), 27, 0.15).to(dt),
           "b_skip": _randn((R,), 28)}
    rk, cck = rb.resblock_widths(R, cc, dt)
    assert (rk, cck) == ((64, -(-cc // 16) * 16) if dtype == "bf16"
                         else (64, cc))
    hp, opsp = rb.pad_resblock_widths(h, ops, rk, cck)
    assert hp.shape == (B, T, rk) and opsp["w_conv"].shape == (3, rk, 2 * rk)
    if cc:
        assert opsp["cond"].shape == (B, T, cck)

    def run(x, o):
        kw = dict(dilation=3, causal=False)
        if cc:
            return rb.resblock_v2_ref(x, o["cond"], o["w_conv"], o["w_cond"],
                                      o["b_all"], o["w_res"], o["b_res"],
                                      o["w_skip"], o["b_skip"], **kw)
        return rb.resblock_ref(x, o["cond"], o["w_conv"], o["w_res"],
                               o["b_res"], o["w_skip"], o["b_skip"], **kw)
    for a, p in zip(run(h, ops), run(hp, opsp)):
        assert bool((p[..., R:] == 0).all())
        a, p = a.float(), p[..., :R].float()
        top = float(a.abs().max())
        tol = 1e-6 * top if dtype == "fp32" else 2.0 ** -7 * top
        assert float((a - p).abs().max()) <= tol


def test_fp32_widths_divide_the_threads():
    """The CUDA-core (fp32) instances give each thread one column: R runs at
    the next divisor of 512 that is a multiple of 4; wider R raises."""
    f32 = torch.float32
    assert [rb.resblock_widths(r, 0, f32)[0] for r in (2, 4, 48, 100, 256,
                                                        512)] == \
        [4, 4, 64, 128, 256, 512]
    assert rb.resblock_widths(256, 2560, torch.bfloat16) == (256, 2560)
    with pytest.raises(ValueError, match="up to 512"):
        rb.resblock_widths(513, 0, f32)


def _pair_smem(r_in: int, tt: int, int8: bool, R: int = 256) -> int:
    """smem_layout's formula (csrc/pair_flow_common.cuh) for a hoisted
    tensor-core pair (tests/test_torch_pair_tc3.py's _smem_bytes)."""
    L = tt + 20
    rows = L - 10
    sizes = [4 * rows * R, 4 * rows * 2 * r_in, 4 * L * r_in, 4 * 32,
             2 * L * (R + 8), 2 * L * (R + 8)] + [2 * L * (r_in + 8)] * 3
    sizes.append(L * (R + 16) if int8 else 0)
    o = 0
    for s in sizes:
        o = (o + s + 15) & ~15
    return o


def test_hoisted_int8_tile_does_not_follow_the_batch():
    """hoisted_launch_tile: the int8 hoisted pair's tile, so its per-window
    scales, is the same for B = 1 ... 16 rows and any SM count at T_k =
    92160 >> (b + 1), b = 5-7 (1440, 720 and 360 rows), where the bf16
    hoisted pair's wave-balanced tile follows the batch; at the reference
    batch on 132 SMs both equal hoisted_t_tile's."""
    for bi in (5, 6, 7):
        T, r_in = 92160 >> (bi + 1), 1 << bi

        def smem(tt, int8, r_in=r_in):
            return _pair_smem(r_in, tt, int8)
        i8 = {pf.hoisted_launch_tile(B, T, n_sm, lambda t: smem(t, True),
                                     int8=True)
              for B in range(1, 17) for n_sm in (114, 132)}
        bf = {pf.hoisted_launch_tile(B, T, 132, lambda t: smem(t, False),
                                     int8=False) for B in range(1, 17)}
        ref = pf.hoisted_t_tile(pf.HOISTED_I8_REF_BATCH, T,
                                pf.HOISTED_I8_REF_SMS,
                                lambda t: smem(t, True))
        assert i8 == {ref}, (bi, i8)
        assert len(bf) > 1, (bi, bf)
