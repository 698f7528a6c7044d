"""PyTorch port, the hoisted tensor-core pairs ``pair_flow_hoisted`` and
``pair_flow_hoisted_i8`` (csrc/pair_flow_common.cuh, ops/pair_flow.py),
emulated lane by lane as the PTX ISA lays out the m16n8k16 operands: the
bf16x2 words of precomputed pre-activations that each lane adds to its
accumulators, the front conv's three taps through ldmatrix from the
padded u/v window against front_w packed per tap, the packing of front_w
and zw, and the tile rule at the synthesis batch.  No JAX and no card: the
kernels themselves are held against their plain versions by
tests/test_torch_card.py (``-k hoisted``) and chip_smoke.py."""

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.ops import pair_flow as pf

TJ = 2                          # n-tiles per half of a warp item (pf::TJ)


def _bf16(shape, seed):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randn(*shape).astype(np.float32)).bfloat16()


def _frag_row(lane: int, i: int) -> int:
    return (lane >> 2) + 8 * (i >> 1)


def _frag_col(lane: int, t: int, i: int) -> int:
    return 8 * t + 2 * (lane & 3) + (i & 1)


def _ld_g32(raw: np.ndarray, elem: int) -> int:
    """The 4 bytes at bf16 element ``elem`` of a bf16 buffer's bytes, as
    ld_g32 reads them (little-endian: element elem in the low half)."""
    return int(raw[2 * elem:2 * elem + 4].view(np.uint32)[0])


def _hoist_elem(words, i: int, gate: bool) -> np.float32:
    """hoist_elem: the row (lo, hi) is i >> 1, the column (low half n,
    high half n + 1) i & 1; the bf16 bits shifted into an fp32."""
    w = words[2 * gate + (i >> 1)]
    bits = (w & 0xFFFF0000) if i & 1 else ((w << 16) & 0xFFFFFFFF)
    return np.array([bits], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("layer", [0, 1])
def test_hoisted_words_are_the_plain_cond_term(layer):
    """direct_layer_tc_bf / direct_layer_tc with COND_HOIST: each lane of
    warp item (m-tile m0, n-tiles t0 = TJ * group) loads, before its taps'
    products, the bf16x2 words at c + row * Cc + layer * 2R + n (filter)
    and + R + n (gate) of its rows lo = m0 + lane / 4 and hi = lo + 8
    (clamped to the region's last row, global positions clamped into
    [0, T)), n = frag_col of its n-tile.  For every lane and accumulator
    element of a window that sticks out of the sequence at both ends, the
    decoded value is the pre-activation of the (row, column) the element
    holds: the cond() term of _coupling_net(hoisted=True), i.e. the
    window's c rows (pf._windows) sliced to [layer * 2R, (layer + 1) * 2R),
    filter columns then gate columns.  Rows whose position lies outside
    [0, T) read the clamped row instead of the plain window's zeros; the
    kernel masks or never stores those rows."""
    R, T, t_tile, halo = 32, 50, 48, 10
    cc = 4 * R
    c = _bf16((1, T, cc), 7 + layer)
    raw = c.contiguous().view(torch.uint8).numpy().reshape(-1)
    win = pf._windows(c, t_tile, 2, halo)          # [2 windows, L, Cc]
    L = t_tile + 2 * halo
    for w in range(2):
        win0 = w * t_tile - halo
        # layer 0 of the odd net covers [2, L - 2), layer 1 [5, L - 5)
        rb, re = (2, L - 2) if layer == 0 else (5, L - 5)
        term = win[w, :, layer * 2 * R:(layer + 1) * 2 * R].numpy()
        n_mt, ngroups = -(-(re - rb) // 16), R // (8 * TJ)
        seen = np.zeros((L, 2 * R), bool)
        for it in range(n_mt * ngroups):
            m0, t0 = rb + 16 * (it % n_mt), TJ * (it // n_mt)
            for lane in range(32):
                rows = [min(m0 + _frag_row(lane, 0), re - 1),
                        min(m0 + _frag_row(lane, 2), re - 1)]
                pos = [min(max(win0 + r, 0), T - 1) for r in rows]
                for j in range(TJ):
                    n = _frag_col(lane, t0 + j, 0)
                    words = [_ld_g32(raw, p * cc + layer * 2 * R + off + n)
                             for off in (0, R) for p in pos]
                    for i in range(4):
                        row = m0 + _frag_row(lane, i)
                        col = _frag_col(lane, t0 + j, i)
                        if row >= re:
                            continue
                        f = _hoist_elem(words, i, False)
                        g = _hoist_elem(words, i, True)
                        p = win0 + row
                        if 0 <= p < T:
                            assert f == term[row, col], (w, row, col)
                            assert g == term[row, R + col], (w, row, col)
                        else:
                            q = min(max(p, 0), T - 1)
                            assert f == c[0, q, layer * 2 * R + col].item()
                        seen[row, col] = seen[row, R + col] = True
        assert seen[rb:re].all()


def _ldmatrix_x4(buf, row_addr, col_off):
    """ldmatrix.x4 on a [rows, cols] buffer of bf16 values (as float64):
    lane l gives the address (row_addr[l], col_off[l]) of row l % 8 of
    matrix l // 8; lane t receives from matrix j the 2 elements at its row
    t // 4, columns 2 * (t % 4) + {0, 1}.  Returns [32 lanes, 8]."""
    out = np.zeros((32, 8))
    for j in range(4):
        for t in range(32):
            src = 8 * j + t // 4
            c0 = col_off[src] + 2 * (t % 4)
            out[t, 2 * j:2 * j + 2] = buf[row_addr[src], c0:c0 + 2]
    return out


def _a_tile(frag) -> np.ndarray:
    """The [16, 16] A tile of an m16n8k16 product from ldmatrix.x4's
    registers (PTX ISA: element i of lane l is row g + 8 * ((i >> 1) & 1),
    k = 2q + (i & 1) + 8 * (i >> 2))."""
    a = np.zeros((16, 16))
    for lane in range(32):
        g, q = lane >> 2, lane % 4
        for i in range(8):
            a[g + 8 * ((i >> 1) & 1), 2 * q + (i & 1) + 8 * (i >> 2)] = \
                frag[lane, i]
    return a


def _b_tile(packed: np.ndarray, s: int, t: int) -> np.ndarray:
    """The [16, 8] B tile of k-step s, n-tile t from a bf16 operand packed
    by pack_tc_weights ([K/16, N/8, 32, 4], as float64): element i of
    lane l is (k = 2(l % 4) + (i & 1) + 8(i >> 1), n = l // 4)."""
    b = np.zeros((16, 8))
    for lane in range(32):
        for i in range(4):
            b[2 * (lane % 4) + (i & 1) + 8 * (i >> 1), lane >> 2] = \
                packed[s, t, lane, i]
    return b


@pytest.mark.parametrize("r_in", [16, 32])
def test_front_conv_taps_through_ldmatrix_give_the_3tap_conv(r_in):
    """front_tc: the u/v window's rows at the padded stride R_in + 8
    (row_ld_h; the 8 row addresses of every ldmatrix matrix fall in 8
    distinct 16-byte bank groups, for every R_in the hoisted pairs take),
    tap k of m-tile m0 read at row min(m0 + (lane & 15), re - 1) - 1 + k
    and column 8 * (lane >> 4) + 16 * ks, against front_w packed per tap
    (tap k's fragments start k * R_in/16 * R/8 * 32 fragments on), with 4
    n-tiles per warp item: the sums are the plain version's front conv,
    sum over k of x[row - 1 + k] @ front_w[k], on every row of [rb, re),
    the ragged last m-tile included."""
    R, L = 64, 45
    ldx = r_in + 8
    for rin in (16, 32, 64, 128):
        rowb = 2 * (rin + 8)
        for m0 in range(0, 24, 8):
            assert len({((m0 + l) * rowb // 16) % 8 for l in range(8)}) == 8
    X = _bf16((L, ldx), 3).double().numpy()        # pad columns: junk
    W = _bf16((3, r_in, R), 4)
    # [3, Rin/16, R/8, 32, 4]
    packed = launch.pack_tc_weights(W).double().numpy()
    assert packed.shape == (3, r_in // 16, R // 8, 32, 4)
    rb, re = 1, L - 1                              # 43 rows: 3 m-tiles
    ntl, tn = R // 8, 2 * TJ
    acc = np.zeros((L, R))
    n_mt = -(-(re - rb) // 16)
    for it in range(n_mt * (ntl // tn)):
        m0, t0 = rb + 16 * (it % n_mt), tn * (it // n_mt)
        c = np.zeros((tn, 16, 8))
        for k in range(3):
            for ks in range(r_in // 16):
                addr = [min(m0 + (l & 15), re - 1) - 1 + k for l in range(32)]
                coff = [8 * (l >> 4) + 16 * ks for l in range(32)]
                a = _a_tile(_ldmatrix_x4(X, addr, coff))
                for j in range(tn):
                    c[j] += a @ _b_tile(packed[k], ks, t0 + j)
        for j in range(tn):
            rows = slice(m0, min(m0 + 16, re))
            acc[rows, 8 * (t0 + j):8 * (t0 + j + 1)] = c[j][:rows.stop - m0]
    w = W.double().numpy()
    want = sum(X[rb - 1 + k:re - 1 + k, :r_in] @ w[k] for k in range(3))
    np.testing.assert_allclose(acc[rb:re], want, rtol=1e-12, atol=1e-12)


def _unpack(packed: torch.Tensor, k: int, n: int) -> np.ndarray:
    """Invert pack_tc_weights for a bf16 [..., K/16, N/8, 32, 4] operand."""
    p = packed.float().numpy()
    lead = p.shape[:-4]
    out = np.full(lead + (k, n), np.nan, np.float32)
    for s in range(k // 16):
        for t in range(n // 8):
            for lane in range(32):
                for i in range(4):
                    out[..., 16 * s + 2 * (lane % 4) + (i & 1)
                        + 8 * (i >> 1), 8 * t + lane // 4] = \
                        p[..., s, t, lane, i]
    return out


@pytest.mark.parametrize("r_in", [16, 128])
def test_front_and_zero_conv_weights_pack_and_round_trip(r_in):
    """pack_tc_weights of front_w [2 flows, 3, R_in, R] (three K = R_in
    products) and zw [2 flows, R, 2 R_in] keeps every element (packed and
    unpacked sizes equal, so make_params' per-flow offsets 3 R_in R and
    R 2 R_in hold), puts tap k of flow f at fragment (f * 3 + k) * R_in/16
    * R/8 * 32, as front_tc reads it, and unpacks to the original
    weights."""
    R = 64
    front = _bf16((2, 3, r_in, R), 5)
    zw = _bf16((2, R, 2 * r_in), 6)
    pfront, pzw = launch.pack_tc_weights(front), launch.pack_tc_weights(zw)
    assert pfront.shape == (2, 3, r_in // 16, R // 8, 32, 4)
    assert pzw.shape == (2, R // 16, 2 * r_in // 8, 32, 4)
    assert pfront.numel() == front.numel() and pzw.numel() == zw.numel()
    base = pfront.data_ptr()
    for f in range(2):
        for k in range(3):
            assert (pfront[f, k].data_ptr() - base) // 8 == (
                (f * 3 + k) * (r_in // 16) * (R // 8) * 32)
    assert (pzw[1].data_ptr() - pzw.data_ptr()) // 2 == R * 2 * r_in
    np.testing.assert_array_equal(_unpack(pfront, r_in, R),
                                  front.float().numpy())
    np.testing.assert_array_equal(_unpack(pzw, R, 2 * r_in),
                                  zw.float().numpy())


def _smem_bytes(r_in: int, tt: int, int8: bool, R: int = 256) -> int:
    """smem_layout's formula (csrc/pair_flow_common.cuh) for a hoisted
    tensor-core instance (bf16, H/G rows R + 8, Q rows R + 16 bytes, u/v
    windows R_in + 8): S, net, VA, red, H, G, U, V, UM, Q, each rounded up
    to 16 bytes, for a window of tt + 20 rows."""
    L = tt + 20
    rows = L - 10
    sizes = [4 * rows * R, 4 * rows * 2 * r_in, 4 * L * r_in, 4 * 32,
             2 * L * (R + 8), 2 * L * (R + 8)] + [2 * L * (r_in + 8)] * 3
    sizes.append(L * (R + 16) if int8 else 0)
    o = 0
    for s in sizes:
        o = (o + s + 15) & ~15
    return o


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_hoisted_tile_rule_fills_the_card_at_the_synthesis_batch(int8):
    """hoisted_t_tile at phase 3's batch (4 mels padded to 360 frames:
    T_k = 92160 >> (b + 1) at blocks 4-7, R_in = 2^b, 132 SMs): a tile
    whose window fits in 232448 bytes of shared memory by smem_layout's
    formula, needing no more waves than any fitting tile of 16-72 rows,
    and the shortest of those (44, 44, 22, 16 rows: 264, 132, 132, 92
    CTAs)."""
    n_sm, B = 132, 4
    for bi, want in zip(range(4, 8), (44, 44, 22, 16)):
        T, r_in = 92160 >> (bi + 1), 1 << bi

        def smem(tt, r_in=r_in):
            return _smem_bytes(r_in, tt, int8)
        tt = pf.hoisted_t_tile(B, T, n_sm, smem)

        def waves(t, T=T):
            return -(-B * -(-T // t) // n_sm)
        fit = [t for t in range(16, 73) if smem(t) <= 232448]
        assert smem(tt) <= 232448 and tt in fit
        assert waves(tt) == min(waves(t) for t in fit)
        assert all(t >= tt for t in fit if waves(t) == waves(tt))
        assert tt == want, (bi, tt)
    # block 7's largest window still fits, with the int8 codes Q too
    assert _smem_bytes(128, 16, True) <= 232448
    with pytest.raises(ValueError):
        pf.hoisted_t_tile(B, 360, n_sm, lambda tt: 10 ** 6)


def test_front_and_zero_conv_on_tensor_cores_only_where_r_in_allows():
    """front_zero_tc: the hoisted tensor-core pairs run their front and zero
    convs on the tensor cores at R_in a multiple of 16 (every deep block
    of the presets, R_in = 16-128); narrower windows (a padded narrow
    pair's R_in = 2) keep the CUDA-core loops and pass front_w and zw
    unpacked."""
    assert all(pf.front_zero_tc(1 << b) for b in range(4, 8))
    assert not any(pf.front_zero_tc(r) for r in (1, 2, 4, 8, 24))
