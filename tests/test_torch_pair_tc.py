"""PyTorch port, the tensor-core pair kernels' layouts (ops/pair_flow.py,
csrc/pair_flow_common.cuh): the fragment-order weight packing that the
wrapper hands to ``pair_flow``, ``pair_flow_i8``, ``pair_flow_wino`` and
``pair_flow_wino4``, emulated lane by lane as the PTX ISA lays out the
mma.sync operands, and the wrapper's geometry checks.  No JAX and no card:
the kernels themselves are held against their plain versions by
tests/test_torch_card.py (``-k tc``) and chip_smoke.py."""

import numpy as np
import pytest
import torch

from flowavenet_tpu_torch.config import lj22k, tiny
from flowavenet_tpu_torch.models import flowavenet as fwn
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
    p = pf.pack_tc_weights(w)
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
    raw = pf.pack_tc_weights(w).contiguous().view(torch.uint8).numpy()
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


def test_uses_tensor_cores_only_on_the_four_redesigned_instances():
    """pair_flow, pair_flow_i8, pair_flow_wino and pair_flow_wino4 in bf16
    only; fp32, i8rs and the hoisted pairs stay on CUDA cores."""
    bf, f32 = torch.bfloat16, torch.float32
    on = [dict(dtype=bf), dict(dtype=bf, int8=True), dict(dtype=bf, phases=6),
          dict(dtype=bf, phases=12)]
    off = [dict(dtype=f32), dict(dtype=f32, int8=True),
           dict(dtype=f32, phases=6), dict(dtype=f32, phases=12),
           dict(dtype=bf, int8=True, rs=True),
           dict(dtype=bf, hoisted=True), dict(dtype=bf, int8=True,
                                              hoisted=True),
           dict(dtype=bf, phases=6, hoisted=True),
           dict(dtype=bf, phases=12, hoisted=True)]
    assert all(pf.uses_tensor_cores(**kw) for kw in on)
    assert not any(pf.uses_tensor_cores(**kw) for kw in off)


@pytest.mark.parametrize("preset,bi", [("lj22k", 0), ("lj22k", 4),
                                       ("tiny", 0), ("tiny", 1)])
def test_tc_packed_operands_have_the_kernel_sizes(preset, bi):
    """The packed main-path operands hold the element counts the kernel's
    make_params strides by: every flow's kfg, res_w, skip_w and fin_w
    as many as before packing, an int8 cond_w 2 * ceil(Cc/32)*32 * 2R
    per flow (its K padded with zero rows), a bf16 cond_w 2 * Cc * 2R; for
    the int8, F(2,3), bf16 direct and F(4,3) operands."""
    cfg = (lj22k() if preset == "lj22k" else tiny()).model
    block = fwn.init_block(torch.Generator().manual_seed(bi), 1 << bi,
                           cfg.num_mels << bi, cfg)
    pair = fwn._index(fwn._pair_params(block), 0)
    R, cc = cfg.filter_size, cfg.num_mels << bi
    pf.check_tc_geometry(R, cc)
    names = ("kfg", "cond_w", "res_w", "skip_w", "fin_w")
    bf = torch.bfloat16
    for ops, ks in ((pf.pair_reverse_operands_int8(pair, bf), 32),
                    (pf.pair_reverse_operands_wino(pair, bf), 16),
                    (pf.pair_reverse_operands(pair, bf), 16),
                    (pf.pair_reverse_operands_wino4(pair, bf), 16)):
        d = dict(zip(pf._operand_names(len(ops), ks == 32, False), ops))
        for name in names:
            packed = pf.pack_tc_weights(d[name])
            want = d[name].numel()
            if name == "cond_w":
                want = 2 * 2 * (-(-cc // ks) * ks) * 2 * R
            assert packed.numel() == want, (name, packed.shape)
            assert packed.dtype == d[name].dtype
