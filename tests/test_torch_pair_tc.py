"""PyTorch port, the tensor-core pair kernels' layouts (ops/pair_flow.py,
csrc/pair_flow_common.cuh): the fragment-order weight packing that the
wrapper hands to ``pair_flow``, ``pair_flow_i8``, ``pair_flow_i8rs``,
``pair_flow_hoisted``, ``pair_flow_hoisted_i8``, ``pair_flow_wino`` and
``pair_flow_wino4``, emulated lane by lane as the
PTX ISA lays out the mma.sync operands (with ``pair_flow_i8rs``'s int8
res/skip products on the gate codes), the wrapper's geometry checks, and
``pair_flow_i8``'s activation quantization (``quantize_rows_bf2``) emulated
thread by thread.  No JAX and no card:
the kernels themselves are held against their plain versions by
tests/test_torch_card.py (``-k tc``) and chip_smoke.py."""

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.config import lj22k, tiny
from flowavenet_tpu_torch.models import flowavenet as fwn
from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.ops import pair_flow as pf


def _weight(k: int, n: int, int8: bool, seed: int = 0) -> torch.Tensor:
    r = np.random.RandomState(seed)
    if int8:
        return torch.from_numpy(r.randint(-127, 128, (k, n)).astype(np.int8))
    return torch.from_numpy(r.randn(k, n).astype(np.float32)).bfloat16()


def _b_coords(lane: int, i: int, s: int, t: int, int8: bool):
    """(k, n) of element i of lane ``lane``'s B fragment for k-step s and
    n-tile t: the PTX ISA's m16n8k16 (.bf16) and m16n8k32 (.s8) layouts,
    groupID = lane >> 2, threadID_in_group = lane % 4."""
    g, q = lane >> 2, lane % 4
    if int8:
        k = q * 4 + (i & 3) + 16 * (i >= 4)
        return 32 * s + k, 8 * t + g
    k = q * 2 + (i & 1) + 8 * (i >= 2)
    return 16 * s + k, 8 * t + g


# (K, N): the lj22k width (R = 256: fg convs and res/skip at K = R, N = 2R
# or R), the tiny width (R = 32), and the int8 conditioning at lj22k block 0
# (Cc = 80, padded to 96 rows of zeros)
SHAPES = [(256, 512), (256, 256), (32, 64), (32, 32), (80, 512), (1280, 512)]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_tc_packing_round_trips(k, n, int8):
    """Scatter every packed element back to the (k, n) the PTX layout
    gives it: the original weight, plus zero rows for the int8 K
    padding."""
    if not int8 and k % 16:
        pytest.skip("bf16 K is always a multiple of 16 (checked)")
    w = _weight(k, n, int8)
    p = launch.pack_tc_weights(w)
    ks = 32 if int8 else 16
    kp = -(-k // ks) * ks
    assert p.shape == (kp // ks, n // 8, 32, 8 if int8 else 4)
    assert p.dtype == w.dtype and p.is_contiguous()
    back = np.full((kp, n), 99.0, np.float32)
    s, t, lane, i = np.meshgrid(*(np.arange(d) for d in p.shape),
                                indexing="ij")
    kk, nn = _b_coords(lane, i, s, t, int8)
    back[kk, nn] = p.float().numpy()
    assert np.array_equal(back[:k], w.float().numpy())
    assert np.all(back[k:] == 0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_tc_fragment_bytes_follow_ptx_layout(int8):
    """The kernel reads lane l's fragment of (k-step s, n-tile t) as the 8
    bytes at ((s * ntl + t) * 32 + l) * 8 of the packed operand (tc_b,
    ntl = N / 8); decoding those bytes as the PTX ISA lays out the B
    fragment reproduces W[k, n], at the lj22k fg-conv shape [R, 2R], for
    the filter tile t and its gate tile R/8 + t."""
    R = 256
    w = _weight(R, 2 * R, int8, seed=1)
    raw = launch.pack_tc_weights(w).contiguous().view(torch.uint8).numpy()
    raw = raw.reshape(-1)
    ntl, ks = 2 * R // 8, 32 if int8 else 16
    wf = w.float().numpy()
    for s in (0, 3, R // ks - 1):
        for t in (0, 5, R // 8 - 1, R // 8, R // 8 + 5):
            for lane in range(32):
                off = ((s * ntl + t) * 32 + lane) * 8
                frag = raw[off:off + 8]
                if int8:
                    vals = frag.view(np.int8).astype(np.float32)
                else:
                    vals = torch.from_numpy(frag.copy()).view(
                        torch.bfloat16).float().numpy()
                for i, v in enumerate(vals):
                    kk, nn = _b_coords(lane, i, s, t, int8)
                    assert v == wf[kk, nn], (s, t, lane, i)


def _ldmatrix_x4(buf: np.ndarray, row_addr, col_off) -> np.ndarray:
    """Emulate ldmatrix.x4 on a byte buffer [rows, row_bytes]: lane l gives
    the address (row_addr[l], col_off[l]) of row l % 8 of matrix l // 8;
    lane t receives from matrix j the 4 bytes at (its row t // 4, bytes
    4 * (t % 4)...+3).  Returns [32 lanes, 4 registers, 4 bytes]."""
    out = np.zeros((32, 4, 4), np.uint8)
    for j in range(4):
        for t in range(32):
            src = 8 * j + t // 4
            b0 = col_off[src] + 4 * (t % 4)
            out[t, j] = buf[row_addr[src], b0:b0 + 4]
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_tc_ldmatrix_rows_give_the_mma_a_fragment(int8):
    """The kernel's A addressing (row m0 + (lane & 15), clamped to the last
    row of the region, and byte offset 16 * (lane >> 4) within the k-step)
    through ldmatrix.x4 yields, register by register, the PTX ISA's A
    fragment of the m16n8k16 / m16n8k32 product: element i of lane l is
    A[groupID + 8 * (i-th row half), k(i)].  A ragged m-tile (rows past the
    region's end) repeats the last row, as the kernel's clamp does."""
    r = np.random.RandomState(2)
    rows, kbytes, ld = 40, 64, 80          # 2 k-steps, a padded stride
    buf = r.randint(0, 256, (rows, ld)).astype(np.uint8)
    m0, re = 32, 37                        # a ragged last m-tile
    esize = 1 if int8 else 2
    for kstep in range(kbytes // 32):
        addr = [min(m0 + (l & 15), re - 1) for l in range(32)]
        coff = [kstep * 32 + 16 * (l >> 4) for l in range(32)]
        regs = _ldmatrix_x4(buf, addr, coff)
        for lane in range(32):
            g, q = lane >> 2, lane % 4
            vals = regs[lane].reshape(-1)          # 16 bytes, 4 registers
            for i in range(16 // esize):
                if int8:
                    row = g + (8 if (i // 4) % 2 else 0)
                    k = q * 4 + (i & 3) + (16 if i >= 8 else 0)
                else:
                    row = g + (8 if (i // 2) % 2 else 0)
                    k = q * 2 + (i & 1) + (8 if i >= 4 else 0)
                want = buf[min(m0 + row, re - 1),
                           kstep * 32 + k * esize:kstep * 32 + (k + 1) * esize]
                got = vals[i * esize:(i + 1) * esize]
                assert np.array_equal(got, want), (kstep, lane, i)


def test_tc_geometry_check_rejects_other_widths():
    for r, cc in ((256, 80), (256, 1280), (32, 80), (512, 16)):
        pf.check_tc_geometry(r, cc)
    for r, cc in ((48, 80), (16, 80), (0, 80), (256, 72), (256, 0),
                  (256, 40)):
        with pytest.raises(ValueError, match="multiple of"):
            pf.check_tc_geometry(r, cc)


@pytest.mark.parametrize("rs", [False, True], ids=["main", "rs"])
@pytest.mark.parametrize("preset,bi", [("lj22k", 0), ("lj22k", 4),
                                       ("tiny", 0), ("tiny", 1)])
def test_tc_packed_operands_have_the_kernel_sizes(preset, bi, rs):
    """The packed operands hold the element counts the kernel's
    make_params strides by: every flow's kfg, res_w, skip_w and fin_w
    as many as before packing, an int8 cond_w 2 * ceil(Cc/32)*32 * 2R
    per flow (its K padded with zero rows), a bf16 cond_w 2 * Cc * 2R; for
    the int8, F(2,3), bf16 direct and F(4,3) operands (``main``), or the
    int8 res/skip operands (``rs``: res_w and skip_w int8, packed whole in
    32-deep k-steps, so a flow's skip-1 matrix starts R/32 * R/8 * 32
    fragments after its skip-0, where pair_flow_common.cuh reads it)."""
    cfg = (lj22k() if preset == "lj22k" else tiny()).model
    block = fwn.init_block(torch.Generator().manual_seed(bi), 1 << bi,
                           cfg.num_mels << bi, cfg)
    pair = fwn._index(fwn._pair_params(block), 0)
    R, cc = cfg.filter_size, cfg.num_mels << bi
    pf.check_tc_geometry(R, cc)
    names = ("kfg", "cond_w", "res_w", "skip_w", "fin_w")
    bf = torch.bfloat16
    families = ([(pf.pair_reverse_operands_int8(pair, bf, rs=True), 32)]
                if rs else
                [(pf.pair_reverse_operands_int8(pair, bf), 32),
                 (pf.pair_reverse_operands_wino(pair, bf), 16),
                 (pf.pair_reverse_operands(pair, bf), 16),
                 (pf.pair_reverse_operands_wino4(pair, bf), 16)])
    for ops, ks in families:
        d = dict(zip(pf._operand_names(len(ops), ks == 32, False), ops))
        for name in names:
            packed = launch.pack_tc_weights(d[name])
            want = d[name].numel()
            if name == "cond_w":
                want = 2 * 2 * (-(-cc // ks) * ks) * 2 * R
            assert packed.numel() == want, (name, packed.shape)
            assert packed.dtype == d[name].dtype
        if rs:
            for name in ("res_w", "skip_w"):
                assert d[name].dtype == torch.int8
            skip = launch.pack_tc_weights(d["skip_w"])
            assert skip.shape == (2, 2, R // 32, R // 8, 32, 8)
            # uint2 fragments from flow f's skip-0 to its skip-1
            assert (skip[0, 1].data_ptr() - skip[0, 0].data_ptr()) // 8 == (
                R // 32) * (R // 8) * 32


def _a_s8(regs: np.ndarray) -> np.ndarray:
    """The [16, 32] int8 A tile of an m16n8k32 product from the registers
    that ldmatrix.x4 gave each lane ([32 lanes, 4 registers, 4 bytes]):
    byte i of lane l is A[groupID + 8 * ((i // 4) % 2), 4 * (l % 4) +
    i % 4 + 16 * (i >= 8)] (PTX ISA)."""
    a = np.full((16, 32), 999, np.int64)
    for lane in range(32):
        vals = regs[lane].reshape(-1).view(np.int8)
        for i in range(16):
            row = (lane >> 2) + (8 if (i // 4) % 2 else 0)
            a[row, 4 * (lane % 4) + (i & 3) + (16 if i >= 8 else 0)] = vals[i]
    assert np.all(a != 999)
    return a


def _b_s8(frag: np.ndarray) -> np.ndarray:
    """The [32, 8] int8 B tile of one (k-step, n-tile) from its packed
    fragments [32 lanes, 8 bytes] (pack_tc_weights, the PTX layout)."""
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        for i in range(8):
            k, n = _b_coords(lane, i, 0, 0, True)
            b[k, n] = frag[lane, i]
    return b


def _tc_rows_s8(buf, ld, rb, re, K, B0, B1, ngroups, tstep, tj=2):
    """tc_rows with int8 A (pair_flow_common.cuh), lane by lane: warp items
    of one 16-row m-tile (row addresses clamped to re - 1) and tj n-tiles
    from tstep * g of the packed B0 and the same of B1, A through
    ldmatrix.x4 at byte offset 16 * (lane >> 4) of each 32-byte k-step.
    Returns the int32 sums (v0 by B0's columns, v1 beside them) of the
    rows below re, as the epilogue receives them."""
    n0 = 8 * B0.shape[1]
    v0 = np.zeros((re, n0), np.int64)
    v1 = np.zeros((re, n0), np.int64)
    for m0 in range(rb, re, 16):
        for g in range(ngroups):
            for j in range(tj):
                t = tstep * g + j
                acc0, acc1 = np.zeros((16, 8), np.int64), np.zeros(
                    (16, 8), np.int64)
                for ks in range(K // 32):
                    addr = [min(m0 + (l & 15), re - 1) for l in range(32)]
                    coff = [32 * ks + 16 * (l >> 4) for l in range(32)]
                    a = _a_s8(_ldmatrix_x4(buf, addr, coff))
                    acc0 += a @ _b_s8(B0[ks, t])
                    acc1 += a @ _b_s8(B1[ks, t])
                rows = slice(m0, min(m0 + 16, re))
                v0[rows, 8 * t:8 * t + 8] = acc0[:rows.stop - m0]
                v1[rows, 8 * t:8 * t + 8] = acc1[:rows.stop - m0]
    return v0[rb:], v1[rb:]


@pytest.mark.parametrize("R", [32, 64])
def test_i8rs_gate_codes_through_ldmatrix_give_the_int_dot(R):
    """pair_flow_i8rs on the tensor cores: the int8 gate codes (``_gate_q8``)
    stored at G's row stride ldq = R + 16 bytes (row_ld_q: the 8 row
    addresses of an ldmatrix matrix fall in 8 distinct 16-byte bank
    groups), read through ldmatrix into the m16n8k32 A fragment against
    the packed int8 res_w | skip-0 (tiles t, t+1 of each) and skip-1
    (tiles t..t+3, as B0 and B1 16 columns on), give exactly the plain
    version's _int_dot over rows [rb, re) with a ragged last m-tile, and
    the epilogue's scaling res_s * (1/127) in fp32 gives its bits."""
    r = np.random.RandomState(R)
    L, rb, re, ldq = 48, 3, 40, R + 16
    fg = torch.from_numpy(r.randn(L, 2 * R).astype(np.float32) * 2)
    codes = pf._gate_q8(fg)
    buf = r.randint(0, 256, (L, ldq)).astype(np.uint8)      # pad bytes: junk
    buf[:, :R] = codes.numpy().astype(np.int8).view(np.uint8)
    for m0 in range(0, L - 16, 16):
        for j in range(4):
            addr = [(m0 + l) * ldq + 16 * j for l in range(8)]
            assert len({(x // 16) % 8 for x in addr}) == 8
    w = [torch.from_numpy(r.randint(-127, 128, (R, R)).astype(np.int8))
         for _ in range(3)]                         # res, skip-0, skip-1
    res_s, skip_s = (torch.from_numpy(r.rand(R).astype(np.float32) * 1e-2)
                     for _ in range(2))
    packed = [launch.pack_tc_weights(x).numpy() for x in w]
    tj = 2
    ri, si = _tc_rows_s8(buf, ldq, rb, re, R, packed[0], packed[1],
                         R // (8 * tj), tj)
    q = codes[rb:re]
    want = pf._int_dot(q, torch.cat([w[0], w[1]], -1))
    np.testing.assert_array_equal(ri, want[:, :R].numpy())
    np.testing.assert_array_equal(si, want[:, R:].numpy())
    rs_s = torch.cat([res_s, skip_s]) * (1.0 / 127.0)
    got = np.concatenate([ri.astype(np.float32) * (res_s.numpy()
                                                   * np.float32(1 / 127)),
                          si.astype(np.float32) * (skip_s.numpy()
                                                   * np.float32(1 / 127))],
                         -1)
    np.testing.assert_array_equal(got, (want * rs_s).numpy())
    # skip-1: 4 n-tiles per item, the second pair as "B1" 16 columns on
    p1 = packed[2]
    v0, v1 = _tc_rows_s8(buf, ldq, rb, re, R, p1, p1[:, tj:],
                         R // (16 * tj), 2 * tj)
    sk1 = np.zeros_like(v0)
    for t0 in range(0, R // 8, 2 * tj):
        c = slice(8 * t0, 8 * t0 + 8 * tj)
        sk1[:, c] = v0[:, c]
        sk1[:, 8 * t0 + 8 * tj:8 * t0 + 16 * tj] = v1[:, c]
    np.testing.assert_array_equal(sk1, pf._int_dot(q, w[2]).numpy())



def _quantize_rows_bf2(h: np.ndarray, r0: int, r1: int, nt: int = 512):
    """pair_flow_common.cuh:quantize_rows_bf2 emulated for all threads at
    once: thread t takes columns 2*(t % (R/2)) + {0, 1} of rows r0 + t //
    (R/2) + k*(nt // (R/2)) below r1 (R/2 divides nt).  Returns how often
    each element was touched, the scale and the codes (fp32 division,
    round half to even, as rintf(x / scale))."""
    R = h.shape[1]
    words = R // 2
    assert nt % words == 0
    step = nt // words
    t = np.arange(nt)
    rows = ((r0 + t // words)[:, None]
            + step * np.arange(-(-(r1 - r0) // step))[None])
    rows = np.repeat(rows[:, :, None], 2, axis=2)
    cols = np.broadcast_to((2 * (t % words))[:, None, None]
                           + np.arange(2)[None, None], rows.shape)
    keep = rows < r1
    J, C = rows[keep], cols[keep]
    count = np.zeros(h.shape, dtype=np.int64)
    np.add.at(count, (J, C), 1)
    m = np.abs(h[J, C]).max()
    scale = np.float32(max(m, np.float32(1e-30))) * np.float32(1 / 127)
    q = np.zeros(h.shape, dtype=np.int8)
    q[J, C] = np.clip(np.rint(h[J, C] / scale), -127, 127)
    return count, scale, q


@pytest.mark.parametrize("R", [32, 128, 256, 512])
def test_quantize_rows_bf2_covers_each_element_once_with_the_plain_codes(R):
    """pair_flow_i8's quantize_rows_bf2: every element of rows [r0, r1) is
    quantized by exactly one thread, and the scale and codes are the plain
    version's (_quant_act over the same rows), at the lj22k width and the
    narrowest and widest R a tensor-core instance takes, over the row
    ranges of h0 (window rows 1-83 and 6-78) and h1 (2-82, 7-77)."""
    rng = np.random.RandomState(R)
    h = torch.from_numpy(rng.randn(84, R).astype(np.float32)).bfloat16()
    hf = h.float().numpy()
    for r0, r1 in ((1, 83), (2, 82), (6, 78), (7, 77)):
        count, scale, q = _quantize_rows_bf2(hf, r0, r1)
        assert (count[r0:r1] == 1).all()
        assert count.sum() == (r1 - r0) * R
        want, want_scale = pf._quant_act(h[None, r0:r1].float())
        assert np.float32(want_scale.item()) == scale
        assert np.array_equal(q[r0:r1], want[0].numpy().astype(np.int8))
