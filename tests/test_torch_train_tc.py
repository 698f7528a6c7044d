"""PyTorch port, the fragment layouts of the tensor-core training pairs
(``pair_train_fwd`` and ``pair_train_bwd`` in csrc/pair_flow_train.cu),
emulated lane by lane as the PTX ISA lays out the m16n8k16 operands: the
``ldmatrix.trans`` rows of a weight-gradient product (``tc_wgrad``) give
X^T dY over a tile's valid rows; the transposed weights packed for the
input-gradient products round-trip; the shifted rows of the transposed
3-tap convs (``tc_rowprod`` terms) give the conv's input gradient at
dilations 1 and 3; the wave-balanced tile; and the zero-padding of widths
the tensor-core instances do not take.  No JAX and no card."""

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.ops import pair_flow as pf
from flowavenet_tpu_torch.ops import pair_flow_train as pft


def _bf16_grid(shape, seed):
    """Random values exactly representable in bf16, as float64."""
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randn(*shape).astype(np.float32)).bfloat16()
    return x.double().numpy()


def _ldmatrix_x4(read, addr, trans: bool):
    """ldmatrix.x4 (optionally .trans): lane l gives the address of row
    l % 8 of matrix l // 8 as (row, col) of 8 consecutive b16 elements,
    read through ``read(row, col)`` (None: the 16-byte zero row).  Without
    .trans lane t receives row t // 4, columns 2(t % 4) + {0, 1} of each
    matrix; with .trans column t // 4 of rows 2(t % 4) + {0, 1}.  Returns
    [32 lanes, 4 registers, 2 elements]."""
    mats = np.zeros((4, 8, 8))
    for j in range(4):
        for r in range(8):
            a = addr[8 * j + r]
            mats[j, r] = 0.0 if a is None else [read(a[0], a[1] + c)
                                                for c in range(8)]
    out = np.zeros((32, 4, 2))
    for t in range(32):
        for j in range(4):
            for e in range(2):
                out[t, j, e] = (mats[j, 2 * (t % 4) + e, t // 4] if trans
                                else mats[j, t // 4, 2 * (t % 4) + e])
    return out


def _decode_a(frag):
    """The 16 x 16 A tile from the lanes' m16n8k16 A fragments: register j
    of lane t holds rows t // 4 + 8(j & 1), columns 2(t % 4) + {0, 1} +
    8(j >> 1)."""
    a = np.zeros((16, 16))
    for t in range(32):
        for j in range(4):
            for e in range(2):
                a[t // 4 + 8 * (j & 1), 2 * (t % 4) + e + 8 * (j >> 1)] = \
                    frag[t, j, e]
    return a


def _decode_b(regs):
    """The 16 x 8 B tile from the lanes' two B registers: register r of
    lane t holds rows (k) 2(t % 4) + {0, 1} + 8r, column (n) t // 4."""
    b = np.zeros((16, 8))
    for t in range(32):
        for r in range(2):
            for e in range(2):
                b[2 * (t % 4) + e + 8 * r, t // 4] = regs[t, r, e]
    return b


@pytest.mark.parametrize("shift", [-3, 0, 1])
def test_wgrad_trans_rows_give_xt_dy_over_the_valid_rows(shift):
    """tc_wgrad: for k-step ks lane l (q = l >> 3) loads the A = X^T
    fragment at X row s0 + 16ks + 8(q >> 1) + l % 8 + shift, channels m0 +
    8(q & 1), and the B = dY fragments of n-tiles j, j + 1 at dY row s0 +
    16ks + 8(q & 1) + l % 8, columns n0 + 16jj + 8(q >> 1); either reads
    the zero row once its row reaches s1.  Decoded as the PTX ISA lays
    them out and multiplied, they sum to X[r + shift]^T dY[r] over exactly
    the tile's valid rows [s0, s1), here 37 rows, so the last k-step is
    ragged; the rows past s1 hold NaN (a tile of 66 rows reads past its
    cotangent buffer there), which must not reach the sum."""
    M, N = 32, 64
    rows, s0, s1 = 80, 20, 57
    X = _bf16_grid((rows, M), 1)
    Y = _bf16_grid((rows, N), 2)
    X[s1 + shift:], Y[s1:] = np.nan, np.nan
    out = np.zeros((M, N))
    nks = (s1 - s0 + 15) // 16
    for m0 in range(0, M, 16):
        for n0 in range(0, N, 32):
            for ks in range(nks):
                a_addr = []
                for l in range(32):
                    q = l >> 3
                    ka = s0 + 16 * ks + 8 * (q >> 1) + (l & 7)
                    a_addr.append((ka + shift, m0 + 8 * (q & 1))
                                  if ka < s1 else None)
                a = _decode_a(_ldmatrix_x4(lambda r, c: X[r, c], a_addr,
                                           True))
                for jj in range(2):
                    b_addr = []
                    for l in range(32):
                        kb = s0 + 16 * ks + 8 * ((l >> 3) & 1) + (l & 7)
                        b_addr.append((kb, n0 + 16 * jj + 8 * (l >> 4))
                                      if kb < s1 else None)
                    b4 = _ldmatrix_x4(lambda r, c: Y[r, c], b_addr, True)
                    for half in range(2):
                        b = _decode_b(b4[:, 2 * half:2 * half + 2])
                        c0 = n0 + 16 * jj + 8 * half
                        out[m0:m0 + 16, c0:c0 + 8] += a @ b
    want = X[s0 + shift:s1 + shift].T @ Y[s0:s1]
    assert np.isfinite(want).all()
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k,n", [(512, 256), (512, 80), (256, 256)])
def test_transposed_packing_round_trips(k, n):
    """The input-gradient products take W^T ([N_out, K_in] of a [K_in,
    N_out] weight) packed by pack_tc_weights: lane l of (k-step s, n-tile
    t) holds element i at row 16s + 2(l % 4) + i % 2 + 8(i // 2) of W^T,
    column 8t + l // 4.  Reading every lane's 4 elements back gives W^T
    (here kfg^T 2R x R, cond_w^T 2R x Cc, res_w^T R x R at R = 256, Cc =
    80)."""
    w = torch.from_numpy(_bf16_grid((n, k), 3)).bfloat16()   # [K_in, N_out]
    packed = launch.pack_tc_weights(w.transpose(0, 1))
    assert packed.shape == (k // 16, n // 8, 32, 4)
    back = np.zeros((k, n))
    p = packed.double().numpy()
    for s in range(k // 16):
        for t in range(n // 8):
            for lane in range(32):
                for i in range(4):
                    back[16 * s + 2 * (lane % 4) + i % 2 + 8 * (i // 2),
                         8 * t + lane // 4] = p[s, t, lane, i]
    np.testing.assert_array_equal(back, w.double().numpy().T)


@pytest.mark.parametrize("dil", [1, 3])
def test_transposed_conv_rows_give_the_input_gradient(dil):
    """tc_rowprod over rows [rb, re) with the three terms (dY, +d, W[0]^T),
    (dY, 0, W[1]^T), (dY, -d, W[2]^T): lane l of m-tile m0 reads A through
    ldmatrix at dY row min(m0 + (l & 15), re - 1) + shift, column 8(l >>
    4) + 16ks, and B from the packed W[k]^T.  Summed over terms and
    k-steps this is the transposed 3-tap conv dx[r] = sum_k dY[r - (k-1)d]
    W[k]^T on every row of the region, the ragged last m-tile included."""
    K, N = 32, 16                       # dY width (2R), output width (R)
    rows, rb, re = 70, 3 + dil, 44 + dil
    dY = _bf16_grid((rows, K), 4)
    W = _bf16_grid((3, N, K), 5)        # [tap][K_in = N][N_out = K]
    packed = [launch.pack_tc_weights(
        torch.from_numpy(W[k].T.copy()).bfloat16()).double().numpy()
        for k in range(3)]
    out = np.zeros((rows, N))
    for m0 in range(rb, re, 16):
        acc = np.zeros((16, N))
        for k, shift in enumerate((dil, 0, -dil)):
            for ks in range(K // 16):
                addr = [(min(m0 + (l & 15), re - 1) + shift,
                         8 * (l >> 4) + 16 * ks) for l in range(32)]
                a = _decode_a(_ldmatrix_x4(lambda r, c: dY[r, c], addr,
                                           False))
                for t in range(N // 8):
                    regs = packed[k][ks, t].reshape(32, 2, 2)
                    acc[:, 8 * t:8 * t + 8] += a @ _decode_b(regs)
        for i in range(16):
            if m0 + i < re:
                out[m0 + i] = acc[i]
    want = sum(dY[rb - (k - 1) * dil:re - (k - 1) * dil] @ W[k].T
               for k in range(3))
    np.testing.assert_allclose(out[rb:re], want, rtol=1e-12, atol=1e-12)


def test_tc_operands_have_the_launcher_sizes():
    """_tc_operands packs kfg, cond_w, res_w, skip_w and fin_w for the
    shared forward body (element counts unchanged, so the launcher's flow
    offsets hold) and their transposes for the backward, whose per-flow
    sizes are the launcher's FlowT strides (uint2 = 4 bf16): kfg^T 2*3*2R*R,
    cond_w^T 2*2R*Cc, res_w^T R*R, skip_w^T 2*R*R, fin_w^T R*R elements."""
    R, Cc, r_in = 64, 80, 2
    shapes = [(2, 3, r_in, R), (2, R), (2, 2, 3, R, 2 * R), (2, 2, Cc, 2 * R),
              (2, 2, 2 * R), (2, R, R), (2, R), (2, 2, R, R), (2, 2, R),
              (2, R, R), (2, R), (2, R, 2 * r_in), (2, 2 * r_in),
              (2, 2, r_in), (2, 2, r_in)]
    ops = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    fwd, bwd = pft._tc_operands(ops)
    assert [o.numel() for o in fwd] == [o.numel() for o in ops]
    per_flow = [2 * 3 * 2 * R * R, 2 * 2 * R * Cc, R * R, 2 * R * R, R * R]
    assert [o.numel() // 2 for o in bwd] == per_flow
    pf.check_kernel_geometry(256, 80, True)
    for r, cc in ((48, 80), (16, 80), (256, 88)):
        with pytest.raises(ValueError):
            pf.check_kernel_geometry(r, cc, True)


def test_balanced_tile_fills_whole_waves():
    """balanced_t_tile over the tiles a window fits: lj22k block 0 at batch
    8 on 132 SMs takes 66 rows (392 tiles, 3 waves), not 64 (400 tiles, a
    fourth wave of 4); a problem that fits one wave takes the longest
    tile, or with ``shortest`` (the forward's rule) the shortest (lj22k
    blocks 2 and 3 at batch 8: 50 rows, 128 tiles, and 25 rows, 128
    tiles, where the longest would leave 36 and 84 SMs idle); nothing that
    fits raises."""
    def fits(tt):
        return tt <= 68
    assert launch.balanced_t_tile(8, 3200, 132, fits) == 66
    assert launch.balanced_t_tile(2, 300, 132, fits) == 68
    assert launch.balanced_t_tile(8, 1600, 132, fits) == 49
    for T, tt in ((3200, 66), (1600, 49), (800, 50), (400, 25)):
        assert launch.balanced_t_tile(8, T, 132, fits, shortest=True) == tt
    with pytest.raises(ValueError):
        launch.balanced_t_tile(8, 3200, 132, lambda tt: False)


@pytest.mark.parametrize("model", ["num_mels79", "filter_size48"])
def test_padded_widths_give_the_unpadded_gradients(model):
    """The zero-padding of the tensor-core training instances (_pad_tc,
    _unpad_grad; block 0 of lj22k with num_mels 79: Cc 79 -> 80, with
    filter_size 48: R 48 -> 64), through the plain versions in fp64: the
    pair's outputs and statistics at the padded widths equal those at the
    model's widths, every gradient cut back equals the unpadded one, and
    every entry the cut drops is zero."""
    import dataclasses
    from flowavenet_tpu_torch.config import lj22k
    from flowavenet_tpu_torch.models import flowavenet as fwn
    kw = dict(num_mels=79) if model == "num_mels79" else dict(filter_size=48)
    cfg = dataclasses.replace(lj22k().model, **kw)
    gen = torch.Generator().manual_seed(3)
    block = fwn.init_block(gen, 1, cfg.num_mels, cfg)
    fl = block["flows"]
    for leaf in (fl["coupling"]["zero"]["w"], fl["actnorm"]["b"],
                 fl["actnorm"]["logs"]):
        leaf.normal_(0, 0.05, generator=gen)
    ops = [o.double() for o in pf.pair_forward_operands(
        fwn._index(fwn._pair_params(block), 0), torch.float32)]
    R, Cc = ops[5].shape[-1], cfg.num_mels
    r = np.random.RandomState(4)
    u, v, gu, gv = (torch.from_numpy(r.randn(2, 40, 1)) for _ in range(4))
    ca, cb = (torch.from_numpy(r.rand(2, 40, Cc)) for _ in range(2))
    scal = [torch.tensor(s, dtype=torch.float64) for s in (0.7, 0.11, 1.3)]
    ca_p, cb_p, ops_p, Rk, Cck = pft._pad_tc(ca, cb, ops, R, Cc)
    assert (Rk, Cck) == pf.kernel_widths(R, Cc, True) != (R, Cc)
    pf.check_kernel_geometry(Rk, Cck, True)
    want = pft.pair_train_fwd_ref(u, v, ca, cb, ops)
    got = pft.pair_train_fwd_ref(u, v, ca_p, cb_p, ops_p)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)
    d = pft.pair_train_bwd_ref(u, v, ca, cb, gu, gv, *scal, ops)
    dp = pft.pair_train_bwd_ref(u, v, ca_p, cb_p, gu, gv, *scal, ops_p)
    names = pf._OP_NAMES + ("an_s", "an_b")
    for name, o, g, gp in zip(names, ops, d[0], dp[0]):
        cut = pft._unpad_grad(gp, o.shape, name)
        np.testing.assert_allclose(cut.numpy(), g.numpy(), rtol=1e-12,
                                   atol=1e-12)
        idx = pft._unpad_grad(torch.arange(gp.numel()).view(gp.shape),
                              o.shape, name)
        dropped = gp.flatten().clone()
        dropped[idx.flatten()] = 0.0
        assert float(dropped.abs().max()) == 0.0, name
    for g, gp in zip(d[1:3], dp[1:3]):
        np.testing.assert_allclose(gp.numpy(), g.numpy(), rtol=1e-12,
                                   atol=1e-12)
    for g, gp in zip(d[3:], dp[3:]):
        np.testing.assert_allclose(gp[..., :Cc].numpy(), g.numpy(),
                                   rtol=1e-12, atol=1e-12)
        assert not bool(gp[..., Cc:].any())
