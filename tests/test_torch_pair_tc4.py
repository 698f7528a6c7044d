"""PyTorch port, the hoisted Winograd pairs on the tensor cores
(``pair_flow_wino_hoisted``, F(2,3), and ``pair_flow_wino4_hoisted``,
F(4,3); wino_layer_tc with COND_HOIST in csrc/pair_flow_common.cuh),
emulated lane by lane as the PTX ISA lays out the m16n8k16 operands: the
bf16x2 words of precomputed pre-activations that each lane loads for every
output of its groups, and the hoisted F(2,3) pair's plane fragments from
its bf16x2 input transform.  No JAX and no card: the kernels themselves
are held against their plain versions by tests/test_torch_card.py (``-k
wino_hoisted``) and chip_smoke.py."""

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.ops import pair_flow as pf
from test_torch_pair_tc2 import _a_coords, _round_bf16
from test_torch_pair_tc3 import (_bf16, _frag_col, _frag_row, _hoist_elem,
                                 _ld_g32)


@pytest.mark.parametrize("net", ["odd", "even"])
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("P", [6, 12])
def test_wino_hoisted_words_are_the_plain_cond_term(P, layer, net):
    """wino_layer_tc<P, COND_HOIST>: warp item (group m-tile g0, n-tile t0
    = column group; both hoisted layers take one n-tile of the filter and
    one of the gate) of a layer over window rows [rb, re) at dilation 1
    (layer 0) or 3 (layer 1).  Each lane's group rows are lo = g0 + lane /
    4 and hi = lo + 8, clamped to the last group, with bases rb + M*g (d=1)
    or rb + P*(g // 3) + g % 3 (d=3); for output e of its groups it loads
    the bf16x2 words at c + row * Cc + layer * 2R + n (filter) and + R + n
    (gate), row = base + e*dil clamped into [0, T), n = frag_col of its
    n-tile.  For every lane and stored accumulator element of two windows
    that stick out of the sequence at both ends, the decoded value is the
    pre-activation that pair_reverse_wino_ref(hoisted=True) adds at the
    same position and column: the cond() term of _coupling_net_wino, the
    plain windows' c rows (6P-row halo, pf._windows) sliced to [layer * 2R,
    (layer + 1) * 2R), inside the plain net's region of that layer.
    Positions outside [0, T) read the clamped row instead of the plain
    window's zeros; the kernel masks or never stores those rows."""
    M, TW = (2, 1) if P == 6 else (4, 1)    # outputs per group, n-tiles
    R, dil = 32, 1 if layer == 0 else 3
    cc = 4 * R
    tt = pf.wino_t_tile(torch.bfloat16, P)
    T = tt + 10                             # two tiles, the last ragged
    c = _bf16((1, T, cc), 3 * P + 2 * layer + (net == "even"))
    raw = c.contiguous().view(torch.uint8).numpy().reshape(-1)
    halo, halo_ref = 2 * P, 6 * P                   # kernel, plain version
    ref = pf._windows(c, tt, 2, halo_ref).numpy()   # [2 windows, Lp, Cc]
    L, Lp = tt + 2 * halo, tt + 2 * halo_ref
    # the kernel's net output region [o0, L - o0) and the plain version's
    # first row of h0 (a_h0 * P): layer 0 one plane row on, layer 1 two
    o0, a_h0 = (P, 1) if net == "odd" else (2 * P, 4)
    rb, re = (o0 - 4, L - o0 + 4) if layer == 0 else (o0, L - o0)
    s_ref = (a_h0 + 1 + layer) * P
    ng = (re - rb) // M
    n_mt, ngroups = -(-ng // 16), R // (8 * TW)

    def base(g):
        return rb + M * g if dil == 1 else rb + P * (g // 3) + g % 3

    for w in range(2):
        win0, p_ref = w * tt - halo, w * tt - halo_ref
        seen = np.zeros((L, 2 * R), bool)
        for it in range(n_mt * ngroups):
            g0, t0 = 16 * (it % n_mt), TW * (it // n_mt)
            for lane in range(32):
                b = [base(min(g0 + _frag_row(lane, i), ng - 1))
                     for i in (0, 2)]
                for e in range(M):
                    pos = [min(max(win0 + x + e * dil, 0), T - 1) for x in b]
                    for j in range(TW):
                        n = _frag_col(lane, t0 + j, 0)
                        words = [_ld_g32(raw, p * cc + layer * 2 * R + off + n)
                                 for off in (0, R) for p in pos]
                        for i in range(4):
                            g = g0 + _frag_row(lane, i)
                            if g >= ng:
                                continue
                            row = base(g) + e * dil
                            col = _frag_col(lane, t0 + j, i)
                            f = _hoist_elem(words, i, False)
                            gt = _hoist_elem(words, i, True)
                            p = win0 + row
                            if 0 <= p < T:
                                r = p - p_ref           # plain window row
                                assert s_ref <= r < Lp - s_ref, (w, row)
                                term = ref[w, r, layer * 2 * R:]
                                assert f == term[col], (w, row, col)
                                assert gt == term[R + col], (w, row, col)
                            else:
                                q = min(max(p, 0), T - 1)
                                base_c = c[0, q, layer * 2 * R:].float()
                                assert f == base_c[col].item()
                                assert gt == base_c[R + col].item()
                            assert not seen[row, col]
                            seen[row, col] = seen[row, R + col] = True
        # every row of the layer's region, every filter and gate column,
        # exactly once
        assert seen[rb:re].all() and not seen[:rb].any() \
            and not seen[re:].any()


@pytest.mark.parametrize("dil", [1, 3])
def test_wino_hoisted_f23_lane_fragments_are_the_plain_planes(dil):
    """wino_frags<6, BF2 = true> (the hoisted F(2,3) pair): lane l of
    m-tile g0 takes group rows lo = g0 + (l >> 2) and hi = lo + 8 (clamped
    to the last group), group bases rb + 2g (d=1) or rb + 6(g // 3) + g % 3
    (d=3), taps base + (k - 1) * dil for k < 4, and channels 2(l % 4) +
    {0, 1} + 8(r >> 1) + 16 ks for register r; the 4-tap wino_in_bf2 (one
    fma.rn.bf16x2 per plane, each rounding its exact result once) turns
    the taps into the 4 plane fragments.  Decoded as the PTX ISA lays out
    the A fragment, they equal the planes that the plain version's
    _wino_conv multiplies (its _wino_in in fp32, each operation rounded to
    bf16) for every real group, bit for bit, on bf16 values spread over 40
    binades (the fp32-then-bf16 double rounding of the plain version is
    innocuous)."""
    R, L = 32, 110
    r = np.random.RandomState(5 + dil)
    H = (torch.from_numpy(r.randn(L, R + 8) * 2.0 ** r.randint(-20, 20,
                                                               (L, R + 8)))
         .float().bfloat16().double().numpy())
    if dil == 1:
        rb, re = 8, 104                         # 48 groups
    else:
        rb, re = 12, 96                         # 42 groups, a ragged m-tile
    ng = (re - rb) // 2

    def base(g):
        return rb + 2 * g if dil == 1 else rb + 6 * (g // 3) + g % 3

    def sub(a, b):
        return _round_bf16(a - b)

    def add(a, b):
        return _round_bf16(a + b)

    got = np.full((4, ng, R), np.nan)
    for g0 in range(0, ng, 16):
        for ks in range(R // 16):
            for lane in range(32):
                q = lane % 4
                b_lo = base(min(g0 + (lane >> 2), ng - 1))
                b_hi = base(min(g0 + (lane >> 2) + 8, ng - 1))
                for reg in range(4):
                    b = b_hi if reg & 1 else b_lo
                    c = 16 * ks + 2 * q + 8 * (reg >> 1)
                    d = [H[b - dil + k * dil, c:c + 2] for k in range(4)]
                    t = [sub(d[0], d[2]), add(d[1], d[2]), sub(d[2], d[1]),
                         sub(d[1], d[3])]
                    for e in range(2):           # the register's two halves
                        row, kk = _a_coords(lane, 2 * reg + e)
                        assert kk == c + e - 16 * ks
                        if g0 + row < ng:
                            for p in range(4):
                                got[p, g0 + row, 16 * ks + kk] = t[p][e]
    m, starts = pf._WINO_GROUPS[6, dil]
    want_base = [rb + 6 * j + s for j in range((re - rb) // 6)
                 for s in starts]
    assert want_base == [base(g) for g in range(ng)]
    buf = torch.from_numpy(H[:, :R]).float()[None]
    idx = torch.tensor(want_base)
    taps = [buf.index_select(1, idx + (k - 1) * dil) for k in range(m + 2)]
    planes = pf._wino_in(taps, lambda x: x.bfloat16().float())
    for p in range(4):
        np.testing.assert_array_equal(got[p], planes[p][0].double().numpy())
