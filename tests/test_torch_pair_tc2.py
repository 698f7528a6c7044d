"""PyTorch port, the fragment layouts of the tensor-core ``pair_flow``
(bf16 direct pair) and ``pair_flow_wino4`` (F(4,3) Winograd pair) in
csrc/pair_flow_common.cuh, emulated lane by lane as the PTX ISA lays out
the m16n8k16 operands: the ldmatrix row addresses of the 3-tap layer give
the A fragment of the direct conv, and the F(4,3) plane fragments that a
lane builds from its 6 taps in bf16x2 arithmetic (one rounding per
operation) are the plain version's planes, bit for bit.  No JAX and no
card."""

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.ops import pair_flow as pf


def _bf16_grid(shape, seed):
    """Random values exactly representable in bf16, as float64."""
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randn(*shape).astype(np.float32)).bfloat16()
    return x.double().numpy()


def _a_coords(lane: int, i: int):
    """(row, k) of element i of lane ``lane``'s m16n8k16 bf16 A fragment
    (PTX ISA): registers {0, 1, 2, 3} hold rows g, g + 8, g, g + 8 at k
    2q + {0, 1}, 2q + {0, 1}, 2q + 8 + {0, 1}, 2q + 8 + {0, 1}."""
    g, q = lane >> 2, lane % 4
    return g + 8 * ((i >> 1) & 1), 2 * q + (i & 1) + 8 * (i >> 2)


def _ldmatrix_x4(buf, row_addr, col_off):
    """ldmatrix.x4 on a [rows, cols] bf16 buffer: lane l gives the address
    (row_addr[l], col_off[l]) of row l % 8 of matrix l // 8; lane t
    receives from matrix j the 2 elements at its row t // 4, columns
    2 * (t % 4) + {0, 1}.  Returns [32 lanes, 8 elements] (register j
    holds elements 2j, 2j + 1)."""
    out = np.zeros((32, 8))
    for j in range(4):
        for t in range(32):
            src = 8 * j + t // 4
            c0 = col_off[src] + 2 * (t % 4)
            out[t, 2 * j:2 * j + 2] = buf[row_addr[src], c0:c0 + 2]
    return out


@pytest.mark.parametrize("dil", [1, 3])
def test_direct_tap_rows_give_the_conv_a_fragment(dil):
    """direct_layer_tc_bf reads tap k of m-tile m0 through ldmatrix at row
    min(m0 + (lane & 15), re - 1) - dil + k * dil and column 8 * (lane >>
    4) + 16 * ks; those fragments, multiplied by the taps' weights and
    summed over taps and k-steps, are the plain version's 3-tap conv
    (conv3 of ops/pair_flow.py:_coupling_net) on every row of the region,
    the ragged last m-tile included."""
    R, N = 32, 8                                # two k-steps, one n-tile
    rows = 60
    H = _bf16_grid((rows, R + 8), 1)            # the padded row stride
    W = _bf16_grid((3, R, N), 2)
    rb, re = 4, 41                              # 3 m-tiles, the last ragged
    acc = np.zeros((rows, N))
    for m0 in range(rb, re, 16):
        for k in range(3):
            for ks in range(R // 16):
                addr = [min(m0 + (l & 15), re - 1) - dil + k * dil
                        for l in range(32)]
                coff = [8 * (l >> 4) + 16 * ks for l in range(32)]
                frag = _ldmatrix_x4(H, addr, coff)
                for lane in range(32):
                    for i in range(8):
                        row, kk = _a_coords(lane, i)
                        assert frag[lane, i] == H[
                            min(m0 + row, re - 1) - dil + k * dil,
                            16 * ks + kk]
                # the mma of this k-step: the decoded A times B's 16 rows
                a = np.zeros((16, 16))
                for lane in range(32):
                    for i in range(8):
                        row, kk = _a_coords(lane, i)
                        a[row, kk] = frag[lane, i]
                acc[m0:m0 + 16] += a @ W[k, 16 * ks:16 * ks + 16]
    want = sum(H[rb - dil + k * dil:re - dil + k * dil, :R] @ W[k]
               for k in range(3))
    np.testing.assert_allclose(acc[rb:re], want, rtol=1e-12, atol=1e-12)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """Round exact (float64) values once to bf16, to nearest even: what
    fma.rn.bf16x2 does to its exact result."""
    m, e = np.frexp(x)
    return np.ldexp(np.round(m * 256.0), e - 8)


def _wino_in_bf2(d):
    """The kernel's wino_in_bf2 on float64 copies of bf16 values: every
    fma.rn.bf16x2 (a*1 + b, b*(-1) + a, a*k + (-0)) rounds its exact
    result once."""
    def add(a, b):
        return _round_bf16(a + b)

    def sub(a, b):
        return _round_bf16(a - b)

    def mul(a, k):
        return _round_bf16(a * k)
    return [add(sub(mul(d[0], 4.0), mul(d[2], 5.0)), d[4]),
            add(add(mul(add(d[1], d[2]), -4.0), d[3]), d[4]),
            add(sub(mul(sub(d[1], d[2]), 4.0), d[3]), d[4]),
            add(add(sub(mul(d[1], -2.0), d[2]), mul(d[3], 2.0)), d[4]),
            add(sub(sub(mul(d[1], 2.0), d[2]), mul(d[3], 2.0)), d[4]),
            add(sub(mul(d[1], 4.0), mul(d[3], 5.0)), d[5])]


@pytest.mark.parametrize("dil", [1, 3])
def test_wino4_lane_fragments_are_the_plain_planes(dil):
    """wino_layer_tc<12>: lane l of m-tile g0 takes group rows lo = g0 +
    (l >> 2) and hi = lo + 8 (clamped to the last group), group bases rb +
    4g (d=1) or rb + 12(g // 3) + g % 3 (d=3), taps base + (k - 1) * dil
    for k < 6, and channels 2(l % 4) + {0, 1} + 8(r >> 1) + 16 ks for
    register r; wino_in_bf2 turns the taps into the 6 plane fragments.
    Decoded as the PTX ISA lays out the A fragment, they equal the planes
    that the plain version's _wino_conv multiplies (its _wino_in in fp32,
    each operation rounded to bf16) for every real group, bit for bit."""
    R, L = 32, 110
    H = _bf16_grid((L, R + 8), 3 + dil)
    if dil == 1:
        rb, re = 8, 104                         # 24 groups, a ragged m-tile
    else:
        rb, re = 12, 96                         # 21 groups
    ng = (re - rb) // 4

    def base(g):
        return rb + 4 * g if dil == 1 else rb + 12 * (g // 3) + g % 3

    got = np.full((6, ng, R), np.nan)
    for g0 in range(0, ng, 16):
        for ks in range(R // 16):
            for lane in range(32):
                q = lane % 4
                b_lo = base(min(g0 + (lane >> 2), ng - 1))
                b_hi = base(min(g0 + (lane >> 2) + 8, ng - 1))
                for r in range(4):
                    b = b_hi if r & 1 else b_lo
                    c = 16 * ks + 2 * q + 8 * (r >> 1)
                    d = [H[b - dil + k * dil, c:c + 2] for k in range(6)]
                    t = _wino_in_bf2(d)
                    for e in range(2):           # the register's two halves
                        row, kk = _a_coords(lane, 2 * r + e)
                        assert kk == c + e - 16 * ks
                        if g0 + row < ng:
                            for p in range(6):
                                got[p, g0 + row, 16 * ks + kk] = t[p][e]
    # the plain version's planes: the group starts of _WINO_GROUPS, the
    # taps its _wino_conv selects, its _wino_in with bf16 rounding in fp32
    m, starts = pf._WINO_GROUPS[12, dil]
    want_base = [rb + 12 * j + s for j in range((re - rb) // 12)
                 for s in starts]
    assert want_base == [base(g) for g in range(ng)]
    buf = torch.from_numpy(H[:, :R]).float()[None]
    idx = torch.tensor(want_base)
    taps = [buf.index_select(1, idx + (k - 1) * dil) for k in range(m + 2)]
    planes = pf._wino_in(taps, lambda x: x.bfloat16().float())
    for p in range(6):
        np.testing.assert_array_equal(got[p], planes[p][0].double().numpy())
