"""Fused reverse flow pair: operand folding, the plain tiled versions, and
the wrappers around the CUDA kernels ``csrc/pair_flow.cu`` and
``csrc/pair_flow_wino.cu``.

Twin of ``flowavenet_tpu/ops/pallas_flow.py``: ``_pair_kernel``,
``_pair_kernel_i8``, ``_pair_kernel_i8rs``, ``_pair_kernel_hoisted`` and
``_pair_kernel_hoisted_i8`` through :func:`fused_pair_reverse`, and
``_pair_kernel_wino`` and ``_pair_kernel_wino_hoisted`` (F(2,3) and
F(4,3)) through :func:`fused_pair_reverse_wino`.  One pair applies

    u <- u * exp(log_s(v; odd)) + t(v; odd)       coupling (odd flow)
    v <- v * sA - bA ; u <- u * sB - bB           ActNorm reverse (odd)
    v <- v * exp(log_s(u; even)) + t(u; even)     coupling (even flow)
    u <- u * sC - bC ; v <- v * sD - bD           ActNorm reverse (even)

over time tiles plus a halo, where each (log_s, t) is a WaveNet coupling
net.  :func:`pair_reverse_ref` and :func:`pair_reverse_wino_ref` are the
plain PyTorch versions of exactly that tiled math (tile, halo, edge masks,
per-window int8 scales, Winograd groups, cast points); the wrappers run
them for CPU tensors and launch the kernels for CUDA tensors.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..utils.profiling import span, spanned
from ..utils.tree import tree_map
from .conv import wn_kernel
from .launch import (KERNELS, SMEM_MAX, balanced_t_tile, call, library,
                     pack_tc_weights, pad_dim, pad_halves, uses_tensor_cores)

# Rows of halo per side in the CUDA kernel: the receptive field of one
# pair (5 per coupling net).  The JAX kernel uses 16 (sublane alignment).
KERNEL_HALO = 10
SQRT_HALF = 0.7071067811865476


def kernel_t_tile(dtype: torch.dtype, r_in: int = 1) -> int:
    """Output rows per CTA of the direct pair: 64 in bf16, 32 in fp32
    (twice as wide shared-memory buffers); halved for R_in > 32 (the deep
    blocks' u/v windows).  The hoisted tensor-core pairs take
    :func:`hoisted_launch_tile` on the card instead; on the CPU every pair's
    plain version runs at this tile."""
    tt = 32 if dtype == torch.float32 else 64
    return tt if r_in <= 32 else tt // 2


def wino_t_tile(dtype: torch.dtype, phases: int) -> int:
    """Output rows per CTA of the Winograd pair, a multiple of the phase
    count: the window is the tile plus 2 * phases rows per side."""
    if dtype == torch.float32:
        return 48 if phases == 6 else 24
    return 72 if phases == 6 else 60


# ---------------------------------------------------------------------------
# Operand folding (outside the kernel, as in the JAX package)
# ---------------------------------------------------------------------------

def _flow_operands(fp: dict, dtype) -> tuple:
    """Fold one flow's coupling params into kernel operands (effective
    weights in ``dtype``; biases fp32)."""
    cp = fp["coupling"]
    f32 = torch.float32
    front_w = wn_kernel(cp["front"]).to(dtype)             # [3, R_in, R]
    front_b = cp["front"]["b"].to(f32)
    kfg, cond_w, cond_b, skip_w, skip_b = [], [], [], [], []
    for layer in cp["layers"]:
        kfg.append(torch.cat([wn_kernel(layer["filter"]),
                              wn_kernel(layer["gate"])], -1).to(dtype))
        cond_w.append(torch.cat([wn_kernel(layer["filter_c"]),
                                 wn_kernel(layer["gate_c"])], -1)[0]
                      .to(dtype))
        cond_b.append(torch.cat(
            [layer["filter"]["b"] + layer["filter_c"]["b"],
             layer["gate"]["b"] + layer["gate_c"]["b"]], -1).to(f32))
        skip_w.append(wn_kernel(layer["skip"])[0].to(dtype))
        skip_b.append(layer["skip"]["b"].to(f32))
    res_w = wn_kernel(cp["layers"][0]["res"])[0].to(dtype)
    res_b = cp["layers"][0]["res"]["b"].to(f32)
    fin_w = wn_kernel(cp["final"])[0].to(dtype)
    fin_b = cp["final"]["b"].to(f32)
    ez = torch.exp(cp["zero"]["scale"].to(f32) * 3.0)
    zw = (cp["zero"]["w"][0].to(f32) * ez).to(dtype)
    zb = cp["zero"]["b"].to(f32) * ez
    return (front_w, front_b, torch.stack(kfg), torch.stack(cond_w),
            torch.stack(cond_b), res_w, res_b, torch.stack(skip_w),
            torch.stack(skip_b), fin_w, fin_b, zw, zb)


def _pair_operands(pair: dict, dtype, an_sign: float) -> tuple:
    even = tree_map(lambda l: l[0], pair)
    odd = tree_map(lambda l: l[1], pair)
    per_flow = [_flow_operands(even, dtype), _flow_operands(odd, dtype)]
    stacked = [torch.stack([a, b]) for a, b in zip(*per_flow)]

    def an_halves(fp):
        logs3 = fp["actnorm"]["logs"].float()[0, 0] * 3.0
        b = fp["actnorm"]["b"].float()[0, 0]
        c2 = logs3.shape[0] // 2
        s = torch.exp(an_sign * logs3)
        return torch.stack([s[:c2], s[c2:]]), torch.stack([b[:c2], b[c2:]])

    an_e, an_o = an_halves(even), an_halves(odd)
    return tuple(stacked) + (torch.stack([an_e[0], an_o[0]]),
                             torch.stack([an_e[1], an_o[1]]))


@spanned("fwn.fold.pair", kind="plain")
def pair_reverse_operands(pair: dict, dtype=torch.bfloat16) -> tuple:
    """Operands for one flow pair (leaves lead with axis [2]: even=0,
    odd=1).  Returns 15 tensors, each stacking the two flows:
    front_w, front_b, kfg, cond_w, cond_b, res_w, res_b, skip_w, skip_b,
    fin_w, fin_b, zw, zb, an_s, an_b (an_* are [flow, half, R_in] fp32,
    an_s = exp(-3*logs))."""
    return _pair_operands(pair, dtype, -1.0)


def pair_forward_operands(pair: dict, dtype=torch.bfloat16) -> tuple:
    """Operands for one FORWARD flow pair (twin of the JAX
    ``pair_forward_operands``): the folding of :func:`pair_reverse_operands`
    with the ActNorm halves in forward form, an_s = exp(+3*logs) applied as
    (x + b) * s.  Differentiable: autograd carries the operand gradients
    back through the folding to the params."""
    return _pair_operands(pair, dtype, 1.0)


def _quant_w(w: torch.Tensor, reduce_dims: tuple):
    """Per-out-channel int8 weight quantization: (wq, fp32 scales)."""
    wf = w.float()
    amax = torch.amax(wf.abs(), dim=reduce_dims)
    scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    sc = scale
    for d in sorted(reduce_dims):
        sc = sc.unsqueeze(d)
    wq = torch.clamp(torch.round(wf / sc), -127.0, 127.0).to(torch.int8)
    return wq, scale


@spanned("fwn.fold.pair", kind="int8")
def pair_reverse_operands_int8(pair: dict, dtype=torch.bfloat16,
                               rs: bool = False) -> tuple:
    """Operands for the int8 kernel: the 15 of :func:`pair_reverse_operands`
    with kfg [2, nl, 3, R, 2R] and cond_w [2, nl, Cc, 2R] quantized to int8
    (after the cast to ``dtype``), plus their per-(flow, layer, out-channel)
    scales kfg_scale and cond_scale appended.  ``rs`` (the FWN_INT8_RS
    route, ``_pair_kernel_i8rs``) also quantizes res_w [2, R, R] and skip_w
    [2, nl, R, R] and appends res_scale [2, R] and skip_scale [2, nl, R]:
    19 operands."""
    ops = list(pair_reverse_operands(pair, dtype))
    ops[2], s_fg = _quant_w(ops[2], (2, 3))
    ops[3], s_c = _quant_w(ops[3], (2,))
    scales = [s_fg, s_c]
    if rs:
        ops[5], s_r = _quant_w(ops[5], (1,))
        ops[7], s_s = _quant_w(ops[7], (2,))
        scales += [s_r, s_s]
    return tuple(ops) + tuple(scales)


def pop_cond_w(operands) -> tuple:
    """Hoisted form of a pair's 15 operands: (the 14 without cond_w,
    (w_even, w_odd)), where w_flow is the [Cc, n_layer*2R] hoist weight
    (layer 0 || layer 1 on the output axis), applied as ``c_half @ w_flow``
    outside the kernel."""
    ops = list(operands)
    cond_w = ops.pop(3)                        # [2(flow), n_layer, Cc, 2R]
    hoist = torch.cat([cond_w[:, l] for l in range(cond_w.shape[1])], -1)
    return tuple(ops), (hoist[0], hoist[1])


@spanned("fwn.fold.pair", kind="hoisted")
def pair_reverse_operands_hoisted(pair: dict, dtype=torch.bfloat16):
    """Operands for the hoisted-conditioning pair (``_pair_kernel_hoisted``):
    :func:`pop_cond_w` of :func:`pair_reverse_operands`."""
    return pop_cond_w(pair_reverse_operands(pair, dtype))


@spanned("fwn.fold.pair", kind="hoisted_int8")
def pair_reverse_operands_hoisted_int8(pair: dict, dtype=torch.bfloat16):
    """Hoisted operands with int8 fg convs only (``_pair_kernel_hoisted_i8``):
    kfg quantized per (flow, layer, out-channel) and kfg_scale appended
    (15 operands); res/skip/final and the hoist weights stay in
    ``dtype``."""
    ops, hoist = pair_reverse_operands_hoisted(pair, dtype)
    ops = list(ops)
    ops[2], s = _quant_w(ops[2], (2, 3))
    return tuple(ops) + (s,), hoist


def hoist_cond(c: torch.Tensor, w_flow: torch.Tensor) -> torch.Tensor:
    """The hoisted cond pre-activations ``c @ w_flow``: fp32 products and
    sums, rounded once to ``c``'s dtype, as the JAX package computes them
    (``preferred_element_type=float32``, then the cast).  On the card a
    16-bit product runs on the tensor cores into an fp32 result; the CPU
    has no such matmul, so it multiplies the fp32 copies.  One product per
    batch row: cuBLAS picks this long-K product's kernel, and with it the
    order of its sums, by the number of rows, so a row's bits would follow
    its batch companions (PERF.md §6)."""
    if c.is_cuda and c.dtype in (torch.bfloat16, torch.float16):
        w = w_flow.to(c.dtype)
        out = torch.cat([torch.mm(r, w, out_dtype=torch.float32).to(c.dtype)
                         for r in c.reshape(c.shape[0], -1, c.shape[-1])])
        return out.reshape(*c.shape[:-1], -1)
    return torch.matmul(c.float(), w_flow.float()).to(c.dtype)


def _wino_weights(w: torch.Tensor) -> torch.Tensor:
    """F(2,3) G-transform of 3-tap kernels: [..., 3, Cin, Cout] ->
    [..., 4, Cin, Cout] with U = (W0, (W0+W1+W2)/2, (W0-W1+W2)/2, W2)."""
    w0, w1, w2 = w[..., 0, :, :], w[..., 1, :, :], w[..., 2, :, :]
    return torch.stack([w0, (w0 + w1 + w2) * 0.5, (w0 - w1 + w2) * 0.5, w2],
                       dim=-3)


def _wino4_weights(w: torch.Tensor) -> torch.Tensor:
    """F(4,3) G-transform (Lavin & Gray): [..., 3, Cin, Cout] ->
    [..., 6, Cin, Cout]."""
    w0, w1, w2 = w[..., 0, :, :], w[..., 1, :, :], w[..., 2, :, :]
    return torch.stack([
        w0 * 0.25,
        (-w0 - w1 - w2) * (1.0 / 6.0),
        (-w0 + w1 - w2) * (1.0 / 6.0),
        w0 * (1.0 / 24.0) + w1 * (1.0 / 12.0) + w2 * (1.0 / 6.0),
        w0 * (1.0 / 24.0) - w1 * (1.0 / 12.0) + w2 * (1.0 / 6.0),
        w2,
    ], dim=-3)


# operand indices of the weights cast to the storage dtype (the rest are
# fp32 biases, ActNorm halves and scales)
_WEIGHT_OPERANDS = (0, 2, 3, 5, 7, 9, 11)


@spanned("fwn.fold.pair", kind="wino")
def pair_reverse_operands_wino(pair: dict, dtype=torch.bfloat16) -> tuple:
    """Like :func:`pair_reverse_operands` with the fg conv kernels
    G-transformed for F(2,3): kfg becomes [2, n_layer, 4, R, 2R].  The
    transform runs in fp32 (the 0.5 factors are exact); weights are cast to
    ``dtype`` after, biases stay fp32."""
    ops = list(pair_reverse_operands(pair, dtype=torch.float32))
    ops[2] = _wino_weights(ops[2])
    return tuple(o.to(dtype) if i in _WEIGHT_OPERANDS else o
                 for i, o in enumerate(ops))


@spanned("fwn.fold.pair", kind="wino4")
def pair_reverse_operands_wino4(pair: dict, dtype=torch.bfloat16,
                                hoisted: bool = False):
    """F(4,3) operands: kfg becomes [2, n_layer, 6, R, 2R] (G-transform in
    fp32; the 1/6, 1/12, 1/24 factors round once into ``dtype``).
    ``hoisted=True`` returns (operands, (w_even, w_odd)) as
    :func:`pop_cond_w` does (``_pair_kernel_wino_hoisted``)."""
    ops = list(pair_reverse_operands(pair, dtype=torch.float32))
    ops[2] = _wino4_weights(ops[2])
    ops = tuple(o.to(dtype) if i in _WEIGHT_OPERANDS else o
                for i, o in enumerate(ops))
    return pop_cond_w(ops) if hoisted else ops


# ---------------------------------------------------------------------------
# Plain version: the kernel's tiled math in eager PyTorch
# ---------------------------------------------------------------------------

def _windows(x: torch.Tensor, t_tile: int, n_t: int, halo: int
             ) -> torch.Tensor:
    """[B, T, C] -> [B*n_t, t_tile + 2*halo, C]; rows outside [0, T) are
    zeros."""
    B, T, C = x.shape
    x = x if x.dtype == torch.float64 else x.float()
    xp = F.pad(x, (0, 0, halo, n_t * t_tile - T + halo))
    w = xp.unfold(1, t_tile + 2 * halo, t_tile)         # [B, n_t, C, L]
    return w.permute(0, 1, 3, 2).reshape(B * n_t, t_tile + 2 * halo, C)


def _mask(x: torch.Tensor, p0: torch.Tensor, T: int) -> torch.Tensor:
    """Zero rows whose global position (p0[w] + row) is outside [0, T)."""
    pos = p0[:, None] + torch.arange(x.shape[1], device=x.device)[None]
    ok = ((pos >= 0) & (pos < T))[..., None]
    return torch.where(ok, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _quant_act(x: torch.Tensor):
    """Per-window max-abs int8 codes (as float) and the [N, 1, 1] scale."""
    amax = torch.amax(x.abs(), dim=(1, 2), keepdim=True)
    scale = torch.clamp(amax, min=1e-30) * (1.0 / 127.0)
    return torch.clamp(torch.round(x / scale), -127.0, 127.0), scale


def _int_dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product sum (float64 holds every int32 sum
    exactly), returned as fp32 like an int32 accumulator's astype."""
    return torch.matmul(a.double(), w.double()).float()


def _gate_q8(fg: torch.Tensor) -> torch.Tensor:
    """tanh(f)*sigmoid(g) as int8 codes (held in float) at the fixed scale
    1/127 (the JAX ``_gated_q8``: |tanh*sigmoid| < 1, no max-abs pass)."""
    r = fg.shape[-1] // 2
    return torch.round(torch.tanh(fg[..., :r]) * torch.sigmoid(fg[..., r:])
                       * 127.0)


def _gate(fg, rnd):
    """tanh(filter) * sigmoid(gate) of a [.., filter R | gate R]
    pre-activation, rounded once by ``rnd``."""
    r = fg.shape[-1] // 2
    return rnd(torch.tanh(fg[..., :r]) * torch.sigmoid(fg[..., r:]))


def _coupling_net(x_buf, c_buf, *, x_off: int, c_off: int, out_len: int,
                  p0, T: int, w: dict, rnd, int8: bool, c_scale=None,
                  hoisted: bool = False, rs: bool = False, rg=None):
    """One coupling net over windows, mirroring the JAX ``_coupling_net``:
    x_buf[:, j] holds position j - x_off relative to output row 0, whose
    global position is p0 [N]; likewise c_buf with c_off.  ``hoisted``:
    c_buf holds the precomputed conditioning pre-activations (layer 0 ||
    layer 1).  ``rs``: res/skip on int8 gate codes (``_gated_q8``).
    ``rg``: an identity whose gradient is rounded (the training pair's
    backward cast points, ops/pair_flow_train.py), applied to the zero
    conv's product, each layer's filter|gate sum before its bias and the
    residual sum of h1; None for the reverse pairs."""
    wt = x_buf.dtype            # fp32 (fp64 for an fp64 reference run)
    if rg is None:
        def rg(x):
            return x
    def conv3(buf, wk, off, length, dil):
        acc = None
        for k in range(3):
            s = off - dil + k * dil
            o = torch.matmul(buf[:, s:s + length], wk[k].to(wt))
            acc = o if acc is None else acc + o
        return acc

    def conv_fg(buf, layer, off, length, dil):
        if not int8:
            return conv3(buf, w["kfg"][layer], off, length, dil)
        q, a_scale = _quant_act(buf)
        acc = None
        for k in range(3):
            s = off - dil + k * dil
            o = torch.matmul(q[:, s:s + length].double(),
                             w["kfg"][layer][k].double())
            acc = o if acc is None else acc + o
        return acc.float() * (a_scale * w["kfg_s"][layer])

    def cond(layer, off, length):
        tap = c_buf[:, off:off + length]
        if hoisted:
            w2r = tap.shape[-1] // 2
            return tap[..., layer * w2r:(layer + 1) * w2r]
        if int8:
            return _int_dot(tap, w["cond_w"][layer]) * (
                c_scale * w["cond_s"][layer])
        return torch.matmul(tap, w["cond_w"][layer].to(wt))

    l_h0 = out_len + 8
    h0 = conv3(x_buf, w["front_w"], x_off - 4, l_h0, 1)
    h0 = _mask(rnd(torch.relu(h0 + w["front_b"])), p0 - 4, T)
    l_g0 = out_len + 6
    fg0 = conv_fg(h0, 0, 1, l_g0, 1)
    fg0 = rg(fg0 + cond(0, c_off - 3, l_g0))
    fg0 = fg0 + w["cond_b"][0]
    r = fg0.shape[-1] // 2
    if rs:
        rs_s = torch.cat([w["res_s"], w["skip_s"][0]], -1) * (1.0 / 127.0)
        rsk = _int_dot(_gate_q8(fg0), torch.cat(
            [w["res_w"], w["skip_w"][0]], -1)) * rs_s
    else:
        rs_w = torch.cat([w["res_w"], w["skip_w"][0]], -1).to(wt)
        rsk = torch.matmul(_gate(fg0, rnd), rs_w)
    res0 = rsk[..., :r] + w["res_b"]
    h1 = rnd(rg(h0[:, 1:1 + l_g0] + res0) * SQRT_HALF)
    h1 = _mask(h1, p0 - 3, T)
    fg1 = conv_fg(h1, 1, 3, out_len, 3)
    fg1 = rg(fg1 + cond(1, c_off, out_len))
    fg1 = fg1 + w["cond_b"][1]
    sk0 = rsk[:, 3:3 + out_len, r:] + w["skip_b"][0]
    if rs:
        sk1 = _int_dot(_gate_q8(fg1), w["skip_w"][1]) * (
            w["skip_s"][1] * (1.0 / 127.0))
    else:
        sk1 = torch.matmul(_gate(fg1, rnd), w["skip_w"][1].to(wt))
    sk1 = sk1 + w["skip_b"][1]
    out = rnd(torch.relu(sk0 + sk1))
    out = rnd(torch.relu(torch.matmul(out, w["fin_w"].to(wt))
                         + w["fin_b"]))
    return rg(torch.matmul(out, w["zw"].to(wt))) + w["zb"]


_OP_NAMES = ("front_w", "front_b", "kfg", "cond_w", "cond_b", "res_w",
             "res_b", "skip_w", "skip_b", "fin_w", "fin_b", "zw", "zb")


def _operand_names(n_ops: int, int8: bool, hoisted: bool) -> tuple:
    """Names of a pair's operands, in order, for each operand family:
    direct (15), int8 (17), int8 with int8 res/skip (19), hoisted (14),
    hoisted int8 (15)."""
    names = [n for n in _OP_NAMES if not (hoisted and n == "cond_w")]
    names += ["an_s", "an_b"]
    if int8:
        names += ["kfg_s"] if hoisted else ["kfg_s", "cond_s"]
        if n_ops == 19 and not hoisted:
            names += ["res_s", "skip_s"]
    if len(names) != n_ops:
        raise ValueError(f"expected {len(names)} operands for int8={int8}, "
                         f"hoisted={hoisted}; got {n_ops}")
    return tuple(names)


def _flow_weights(operands, names, fi: int, wt) -> dict:
    """One flow's operands by name; int8 weights stay int8 (their products
    are taken exactly), the rest in the working type ``wt``."""
    return {n: o[fi] if o.dtype == torch.int8 else o[fi].to(wt)
            for n, o in zip(names, operands)}


def pair_reverse_ref(u, v, c_a, c_b, operands, *, t_tile: int,
                     halo: int = KERNEL_HALO, int8: bool = False,
                     c_row_scales=None, hoisted: bool = False):
    """Plain version of the fused pair: the same tiles (``t_tile`` output
    rows plus ``halo`` rows per side), edge masks, per-window int8 scales
    and cast points as the kernel.  On the card, run it with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``).

    With ``int8`` the activation scales of the fg convs are max-abs over
    each window's h0 / h1 buffer, so they depend on ``t_tile`` and
    ``halo``: (t_tile, 10) reproduces the CUDA kernel, (JAX tile, 16) the
    JAX kernel.  c_a/c_b are then int8 with per-row scales
    ``c_row_scales`` [B, 2]; 19 operands (``pair_reverse_operands_int8``
    with ``rs``) also run res/skip on int8 gate codes.  With ``hoisted``
    c_a/c_b are the precomputed conditioning pre-activations [B, T,
    n_layer*2R] of the even / odd flow and ``operands`` come from
    ``pair_reverse_operands_hoisted[_int8]``."""
    B, T, r_in = u.shape
    dt = u.dtype
    n_t = -(-T // t_tile)
    L = t_tile + 2 * halo
    if halo < 10 or t_tile < 1:
        raise ValueError(f"need halo >= 10 and t_tile >= 1, got {halo}, "
                         f"{t_tile}")
    names = _operand_names(len(operands), int8, hoisted)
    rs = "res_s" in names
    wt = torch.float64 if u.dtype == torch.float64 else torch.float32

    def rnd(x):
        return x.to(dt).to(wt)

    def win(x):
        return _windows(x, t_tile, n_t, halo).to(wt)

    uw, vw, caw, cbw = win(u), win(v), win(c_a), win(c_b)
    p_win = ((torch.arange(n_t, device=u.device) * t_tile - halo)
             .repeat(B))                                 # [B*n_t]
    c_sc = [None, None]
    if int8 and not hoisted:
        crs = c_row_scales.to(wt).repeat_interleave(n_t, dim=0)  # [N, 2]
        c_sc = [crs[:, 0, None, None], crs[:, 1, None, None]]
    an_s, an_b = operands[names.index("an_s")], operands[names.index("an_b")]
    an_s, an_b = an_s.to(wt), an_b.to(wt)
    kw = dict(T=T, rnd=rnd, int8=int8, hoisted=hoisted, rs=rs)

    # odd flow over window rows [5, L-5)
    l_mid = L - 10
    net = _coupling_net(vw, cbw, x_off=5, c_off=5, out_len=l_mid,
                        p0=p_win + 5, w=_flow_weights(operands, names, 1, wt),
                        c_scale=c_sc[1], **kw)
    log_s, t = net[..., :r_in], net[..., r_in:]
    u_mid = uw[:, 5:5 + l_mid] * torch.exp(log_s) + t
    v_an = vw[:, 5:5 + l_mid] * an_s[1, 0] - an_b[1, 0]
    u_mid = _mask(rnd(u_mid * an_s[1, 1] - an_b[1, 1]), p_win + 5, T)

    # even flow over window rows [10, L-10)
    l_out = L - 20
    net2 = _coupling_net(u_mid, caw, x_off=5, c_off=10, out_len=l_out,
                         p0=p_win + 10,
                         w=_flow_weights(operands, names, 0, wt),
                         c_scale=c_sc[0], **kw)
    log_s2, t2 = net2[..., :r_in], net2[..., r_in:]
    v_new = v_an[:, 5:5 + l_out] * torch.exp(log_s2) + t2
    u_fin = u_mid[:, 5:5 + l_out] * an_s[0, 0] - an_b[0, 0]
    v_fin = v_new * an_s[0, 1] - an_b[0, 1]

    extra = halo - 10
    def untile(x):
        x = x[:, extra:extra + t_tile].reshape(B, n_t * t_tile, r_in)
        return x[:, :T].to(dt)
    return untile(u_fin), untile(v_fin)


# ---------------------------------------------------------------------------
# Plain version of the Winograd pair (_pair_kernel_wino)
# ---------------------------------------------------------------------------

# (phases, dilation) -> (outputs per group, group starts within a period)
_WINO_GROUPS = {(6, 1): (2, (0, 2, 4)), (6, 3): (2, (0, 1, 2)),
                (12, 1): (4, (0, 4, 8)), (12, 3): (4, (0, 1, 2))}


def _wino_in(d: list, rnd) -> list:
    """Input transform B^T d in the storage type: each operation rounds, as
    on the Pallas kernel's storage-type planes (pallas_flow.py:1105-1108,
    :1129-1134)."""
    if len(d) == 4:
        return [rnd(d[0] - d[2]), rnd(d[1] + d[2]), rnd(d[2] - d[1]),
                rnd(d[1] - d[3])]
    return [
        rnd(rnd(rnd(4.0 * d[0]) - rnd(5.0 * d[2])) + d[4]),
        rnd(rnd(rnd(-4.0 * rnd(d[1] + d[2])) + d[3]) + d[4]),
        rnd(rnd(rnd(4.0 * rnd(d[1] - d[2])) - d[3]) + d[4]),
        rnd(rnd(rnd(rnd(-2.0 * d[1]) - d[2]) + rnd(2.0 * d[3])) + d[4]),
        rnd(rnd(rnd(rnd(2.0 * d[1]) - d[2]) - rnd(2.0 * d[3])) + d[4]),
        rnd(rnd(rnd(4.0 * d[1]) - rnd(5.0 * d[3])) + d[5]),
    ]


def _wino_out(m: list) -> list:
    """Output transform A^T m in fp32."""
    if len(m) == 4:
        return [m[0] + m[1] + m[2], m[1] - m[2] - m[3]]
    return [m[0] + m[1] + m[2] + m[3] + m[4],
            m[1] - m[2] + 2.0 * (m[3] - m[4]),
            m[1] + m[2] + 4.0 * (m[3] + m[4]),
            m[1] - m[2] + 8.0 * (m[3] - m[4]) + m[5]]


def _wino_conv(buf, buf0: int, U, out0: int, out_len: int, step: int,
               P: int, rnd) -> torch.Tensor:
    """Winograd 3-tap conv at dilation ``step`` over window rows [out0,
    out0 + out_len) (both multiples of P; window row 0 has phase 0).
    buf[:, i] holds window row buf0 + i; U: [K, Cin, Cout] G-transformed.
    A group's outputs share its transformed taps, so groups follow absolute
    position: F(2,3) d=1 (2j, 2j+1), d=3 (6j+r, 6j+r+3); F(4,3) d=1
    4j..4j+3, d=3 (12j+r, +3, +6, +9)."""
    m, starts = _WINO_GROUPS[P, step]
    base = torch.tensor([out0 + P * j + r for j in range(out_len // P)
                         for r in starts], device=buf.device)
    d = [buf.index_select(1, base + (k - 1) * step - buf0)
         for k in range(m + 2)]
    mm = [torch.matmul(t, U[k].to(buf.dtype))
          for k, t in enumerate(_wino_in(d, rnd))]
    out = buf.new_empty(buf.shape[0], out_len, U.shape[-1])
    for e, y in enumerate(_wino_out(mm)):
        out[:, base + e * step - out0] = y
    return out


def _coupling_net_wino(x_buf, x_a: int, c_buf, *, a_h0: int, p_win, T: int,
                       w: dict, rnd, P: int, hoisted: bool = False):
    """Plain mirror of the JAX ``_coupling_net_wino`` in window rows (a
    plane row a of the Pallas kernel is window row a*P): x_buf covers
    window rows [x_a*P, L - x_a*P), c_buf the whole window, p_win [N] the
    global position of window row 0.  h0 runs over region a_h0, layer 0
    over a_h0 + 1, layer 1 and the output over a_h0 + 2.  ``hoisted``:
    c_buf holds the conditioning pre-activations (layer 0 || layer 1),
    read instead of ``c @ cond_w``."""
    wt = x_buf.dtype
    L = c_buf.shape[1]
    s0, s1, s2 = a_h0 * P, (a_h0 + 1) * P, (a_h0 + 2) * P
    L0, L1, L2 = L - 2 * s0, L - 2 * s1, L - 2 * s2

    def gate(fg):
        r = fg.shape[-1] // 2
        return rnd(torch.tanh(fg[..., :r]) * torch.sigmoid(fg[..., r:]))

    def cond(layer, s, length):
        tap = c_buf[:, s:s + length]
        if hoisted:
            w2r = tap.shape[-1] // 2
            return tap[..., layer * w2r:(layer + 1) * w2r]
        return torch.matmul(tap, w["cond_w"][layer])

    h0 = None
    for k in range(3):
        st = s0 - 1 + k - x_a * P
        o = torch.matmul(x_buf[:, st:st + L0], w["front_w"][k])
        h0 = o if h0 is None else h0 + o
    h0 = _mask(rnd(torch.relu(h0 + w["front_b"])), p_win + s0, T)

    fg0 = _wino_conv(h0, s0, w["kfg"][0], s1, L1, 1, P, rnd)
    fg0 = fg0 + cond(0, s1, L1)
    fg0 = fg0 + w["cond_b"][0]
    r = fg0.shape[-1] // 2
    rsk = torch.matmul(gate(fg0),
                       torch.cat([w["res_w"], w["skip_w"][0]], -1))
    h1 = rnd((h0[:, P:P + L1] + rsk[..., :r] + w["res_b"]) * SQRT_HALF)
    h1 = _mask(h1, p_win + s1, T)

    fg1 = _wino_conv(h1, s1, w["kfg"][1], s2, L2, 3, P, rnd)
    fg1 = fg1 + cond(1, s2, L2)
    fg1 = fg1 + w["cond_b"][1]
    sk = (rsk[:, P:P + L2, r:] + w["skip_b"][0]
          + torch.matmul(gate(fg1), w["skip_w"][1]) + w["skip_b"][1])
    out = rnd(torch.relu(sk))
    out = rnd(torch.relu(torch.matmul(out, w["fin_w"]) + w["fin_b"]))
    return torch.matmul(out, w["zw"]) + w["zb"]


def pair_reverse_wino_ref(u, v, c_a, c_b, operands, *, t_tile: int,
                          hoisted: bool = False):
    """Plain version of the Winograd pair (the JAX ``_pair_kernel_wino``
    with ``n_pair = 1``, ``nb = 1``): ``operands`` from
    :func:`pair_reverse_operands_wino` (F(2,3), P = 6) or
    :func:`pair_reverse_operands_wino4` (F(4,3), P = 12).  ``hoisted``
    (``_pair_kernel_wino_hoisted``): c_a/c_b are the precomputed
    conditioning pre-activations [B, T, n_layer*2R] of the even / odd flow
    and ``operands`` the 14 of :func:`pop_cond_w`.  Windows of
    ``t_tile`` rows (a multiple of P) plus the JAX kernel's 6P-row halo;
    every stage runs over the JAX kernel's plane-row regions, with its edge
    masks and cast points.  The output does not depend on ``t_tile``: the
    Winograd groups follow absolute position.  On the card, run it with
    TF32 off."""
    P = 6 if operands[2].shape[2] == 4 else 12
    if t_tile % P or t_tile < P:
        raise ValueError(f"t_tile={t_tile} must be a positive multiple of "
                         f"{P}")
    B, T, r_in = u.shape
    dt = u.dtype
    halo = 6 * P
    n_t = -(-T // t_tile)
    wt = torch.float64 if dt == torch.float64 else torch.float32

    def rnd(x):
        return x.to(dt).to(wt)

    def win(x):
        return _windows(x, t_tile, n_t, halo).to(wt)

    uw, vw, caw, cbw = win(u), win(v), win(c_a), win(c_b)
    L = uw.shape[1]
    p_win = ((torch.arange(n_t, device=u.device) * t_tile - halo)
             .repeat(B))
    names = _operand_names(len(operands), False, hoisted)
    an_s = operands[names.index("an_s")].to(wt)
    an_b = operands[names.index("an_b")].to(wt)

    # odd flow: u' at region 3 (window rows [3P, L-3P))
    net = _coupling_net_wino(vw, 0, cbw, a_h0=1, p_win=p_win, T=T,
                             w=_flow_weights(operands, names, 1, wt),
                             rnd=rnd, P=P, hoisted=hoisted)
    s3 = 3 * P
    u_mid = uw[:, s3:L - s3] * torch.exp(net[..., :r_in]) + net[..., r_in:]
    u_mid = _mask(rnd(u_mid * an_s[1, 1] - an_b[1, 1]), p_win + s3, T)
    # even flow: v' at region 6, the tile
    net2 = _coupling_net_wino(u_mid, 3, caw, a_h0=4, p_win=p_win, T=T,
                              w=_flow_weights(operands, names, 0, wt),
                              rnd=rnd, P=P, hoisted=hoisted)
    s6 = 6 * P
    v_an = vw[:, s6:L - s6] * an_s[1, 0] - an_b[1, 0]
    v_new = v_an * torch.exp(net2[..., :r_in]) + net2[..., r_in:]
    v_fin = v_new * an_s[0, 1] - an_b[0, 1]
    u_fin = u_mid[:, s3:s3 + t_tile] * an_s[0, 0] - an_b[0, 0]

    def untile(x):
        return x.reshape(B, n_t * t_tile, r_in)[:, :T].to(dt)
    return untile(u_fin), untile(v_fin)


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

def _pack_int8(wq: torch.Tensor) -> torch.Tensor:
    """[..., Cin, N] int8 -> [..., Cin/4, N] int32 words holding 4
    consecutive input channels (the kernel's __dp4a operand layout)."""
    *lead, cin, n = wq.shape
    w = wq.reshape(*lead, cin // 4, 4, n).transpose(-1, -2).contiguous()
    return w.view(torch.int32).reshape(*lead, cin // 4, n)


def front_zero_tc(r_in: int) -> bool:
    """Whether a hoisted tensor-core pair also runs its front conv (three
    taps of K = R_in into N = R) and its zero conv (K = R into N = 2R_in)
    on the tensor cores: R_in a multiple of 16 (a bf16 k-step, and 2R_in
    then fills the 4 n-tiles of a warp item).  Otherwise they stay on CUDA
    cores; the wrapper then passes front_w and zw unpacked."""
    return r_in % 16 == 0


def hoisted_t_tile(B: int, T: int, n_sm: int, smem) -> int:
    """Rows per CTA of the hoisted tensor-core pairs (one CTA per tile):
    ``launch.balanced_t_tile(shortest=True)`` over the tiles of 16-72 rows
    whose window needs at most ``SMEM_MAX`` bytes of shared memory
    (``smem(tile)``, the launcher's ``pair_reverse_smem_bytes``): the
    fewest waves of B * ceil(T / tile) CTAs over ``n_sm`` SMs, then the
    shortest tile, since a CTA's time follows its window's rows and a
    part-filled wave leaves SMs idle.  Shorter tiles pay for their 20 halo
    rows only where they fill a wave that 16 rows leave part-empty (lj22k
    block 7 at 4 x 360 frames: 11-12 rows, 120-132 CTAs, 4-9 % less kernel
    time than 16 rows, 92 CTAs; H100 80GB HBM3, 700 W, chip_smoke.py
    phase 2d); the floor stays at 16.  The int8 pair takes this rule at a
    fixed batch instead (:func:`hoisted_launch_tile`)."""
    return balanced_t_tile(B, T, n_sm, lambda tt: 0 < smem(tt) <= SMEM_MAX,
                           shortest=True)


# The int8 hoisted pair's per-window activation scales follow its tile, so
# its tile is a function of (T, R, R_in) alone: hoisted_t_tile's rule at
# this batch on this many SMs (chip_smoke.py's 4-mel synthesis batch on an
# H100 SXM) whatever batch and card it runs on, as the JAX package fits
# its hoisted tile to T alone (pallas_flow.py's PAIR_KERNEL_HOISTED_T_TILE
# through _fit_tile).  A row's int8 codes, so its audio, then do not
# depend on the rows beside it, which serving's batch-composition
# invariance needs.
HOISTED_I8_REF_BATCH = 4
HOISTED_I8_REF_SMS = 132


def hoisted_launch_tile(B: int, T: int, n_sm: int, smem, *,
                        int8: bool) -> int:
    """The tile a hoisted tensor-core launch of B rows of T runs at on
    ``n_sm`` SMs: :func:`hoisted_t_tile` for the bf16 pair (no per-window
    scales); for the int8 pair the same rule at ``HOISTED_I8_REF_BATCH``
    rows on ``HOISTED_I8_REF_SMS`` SMs, whatever B and n_sm are."""
    if int8:
        B, n_sm = HOISTED_I8_REF_BATCH, HOISTED_I8_REF_SMS
    return hoisted_t_tile(B, T, n_sm, smem)


@functools.lru_cache(maxsize=None)
def _hoisted_tile(B: int, T: int, r: int, r_in: int, variant: int,
                  n_sm: int) -> int:
    lib = library("pair_flow")
    # variant 4 is the int8 pair (pair_flow_hoisted_i8)
    return hoisted_launch_tile(
        B, T, n_sm, lambda tt: lib.pair_reverse_smem_bytes(
            1, variant, 1, r, r_in, tt), int8=variant == 4)


def check_tc_geometry(r: int, cc: int) -> None:
    """Raise ValueError unless the tensor-core pair takes these widths: R
    a multiple of 32 (a warp item spans 16 filter columns with their 16
    gate columns, or 32 columns of one 1x1, and an int8 k-step is 32 deep)
    and the conditioning width Cc a multiple of 16 (a bf16 k-step; the int8
    product pads a last half step with zero rows)."""
    if r % 32 or r <= 0:
        raise ValueError(f"the tensor-core pair takes R a multiple of 32, "
                         f"got R={r}")
    if cc % 16 or cc <= 0:
        raise ValueError(f"the tensor-core pair takes Cc a multiple of 16, "
                         f"got Cc={cc}")


def check_kernel_geometry(r: int, cc: int, tc: bool,
                          threads: int = 512) -> None:
    """Raise ValueError unless the launchers take these widths, as
    ``pair_reverse_launch`` / ``pair_wino_launch`` check them: R divides
    the CTA's threads (each thread owns one column of a CUDA-core product)
    and R, Cc are multiples of 4 (the int8 words); on a tensor-core
    instance also :func:`check_tc_geometry`."""
    if r <= 0 or threads % r or r % 4 or cc % 4 or cc <= 0:
        raise ValueError(f"the pair kernel takes R dividing {threads} and "
                         f"R, Cc multiples of 4; got R={r}, Cc={cc}")
    if tc:
        check_tc_geometry(r, cc)


def kernel_widths(r: int, cc: int, tc: bool, hoisted: bool = False,
                  threads: int = 512) -> tuple[int, int]:
    """The (R, Cc) a pair of a model's widths (r, cc) runs at on the
    kernel: R rounded up to the next width that divides ``threads`` and is
    a multiple of 32 on a tensor-core instance (of 4 otherwise), Cc up to a
    multiple of 16 (of 4); hoisted, Cc is n_layer * 2R of the padded R.
    Equal to (r, cc) on the lj22k geometry (R = 256, Cc = 80 * 2^b)."""
    step = 32 if tc else 4
    fits = [w for w in range(step, threads + 1, step)
            if threads % w == 0 and w >= r]
    if not fits:
        raise ValueError(f"the pair kernel takes R up to {threads}, got {r}")
    if hoisted:
        return fits[0], 4 * fits[0]
    cstep = 16 if tc else 4
    return fits[0], -(-cc // cstep) * cstep


def pad_pair_widths(c_a, c_b, operands, r: int, cc: int, *,
                    int8: bool = False, hoisted: bool = False):
    """A pair's conditioning and operands (any family of
    :func:`_operand_names`, before packing) padded to R = ``r`` channels
    and Cc = ``cc`` conditioning columns (:func:`kernel_widths`): zero c
    columns and cond-weight rows, and zero channels through every weight
    and bias (the filter and gate halves each), so a padded channel's h0,
    gate, h1, skip and final outputs are relu(0) = tanh(0) * sigmoid(0) =
    0 and the real channels' sums are unchanged.  Weight scales of padded
    int8 columns are 1e-30 (their codes are 0), as :func:`_quant_w` gives
    an all-zero column.  Hoisted c holds [layer, filter|gate] pre-
    activations and is re-laid out at the padded R."""
    names = _operand_names(len(operands), int8, hoisted)
    out = []
    for name, o in zip(names, operands):
        if name in ("front_w", "front_b", "res_b", "skip_b", "fin_b"):
            o = pad_dim(o, -1, r)
        elif name in ("res_w", "skip_w", "fin_w"):
            o = pad_dim(pad_dim(o, -2, r), -1, r)
        elif name == "zw":
            o = pad_dim(o, -2, r)
        elif name in ("kfg", "cond_w"):
            o = pad_halves(pad_dim(o, -2, r if name == "kfg" else cc), r)
        elif name == "cond_b":
            o = pad_halves(o, r)
        elif name in ("kfg_s", "cond_s"):
            o = pad_halves(o, r, 1e-30)
        elif name in ("res_s", "skip_s"):
            o = pad_dim(o, -1, r, 1e-30)
        out.append(o)
    if hoisted:
        B, T, w = c_a.shape
        c_a, c_b = (pad_halves(c.reshape(B, T, 2, w // 2), r)
                    .reshape(B, T, 4 * r) for c in (c_a, c_b))
    else:
        c_a, c_b = (pad_dim(c, -1, cc) for c in (c_a, c_b))
    return c_a.contiguous(), c_b.contiguous(), tuple(out)


# the operands the tensor-core pairs take packed by pack_tc_weights
_TC_WEIGHTS = ("kfg", "cond_w", "res_w", "skip_w", "fin_w")


# the kernels' 19 operand slots, in order (absent ones are null pointers)
_SLOTS = _OP_NAMES + ("an_s", "an_b", "kfg_s", "cond_s", "res_s", "skip_s")
# the direct pair's kernel by (int8, rs, hoisted)
_DIRECT = {(False, False, False): "pair_flow",
           (True, False, False): "pair_flow_i8",
           (True, True, False): "pair_flow_i8rs",
           (False, False, True): "pair_flow_hoisted",
           (True, False, True): "pair_flow_hoisted_i8"}


def _launch(u, v, c_a, c_b, operands, *, int8: bool, hoisted: bool,
            c_row_scales, phases: int = 0):
    """Check the inputs and launch one pair kernel on the current stream:
    the direct variants of csrc/pair_flow.cu (``phases`` 0) or the
    Winograd pair of csrc/pair_flow_wino.cu (``phases`` 6 or 12).  Widths
    the instance does not take are zero-padded first (:func:`kernel_widths`,
    :func:`pad_pair_widths`); the lj22k widths never are."""
    B, T, r_in = u.shape
    dt = u.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pair kernel takes fp32 or bf16, got {dt}")
    names = _operand_names(len(operands), int8, hoisted)
    rs = "res_s" in names
    ops = dict(zip(names, operands))
    R = ops["res_w"].shape[-1]
    R2, Cc = 2 * R, c_a.shape[-1]
    c_dt = torch.int8 if int8 and not hoisted else dt
    for name, x in (("u", u), ("v", v), ("c_a", c_a), ("c_b", c_b)):
        if not (x.is_cuda and x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if v.shape != u.shape or c_a.shape != (B, T, Cc) or c_b.shape != c_a.shape:
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)}, c {tuple(c_a.shape)}, "
                         f"{tuple(c_b.shape)}")
    if c_a.dtype != c_dt or c_b.dtype != c_dt or v.dtype != dt:
        raise TypeError(f"u/v must be {dt} and c {c_dt}")
    if phases:
        kernel = ("pair_flow_wino" if phases == 6 else "pair_flow_wino4") + (
            "_hoisted" if hoisted else "")
    else:
        kernel = _DIRECT[int8, rs, hoisted]
    lib_name, pick = KERNELS[kernel]
    lib = library(lib_name)
    pre = "pair_wino" if phases else "pair_reverse"
    threads = getattr(lib, f"{pre}_threads")()
    tc = uses_tensor_cores(dt)
    if hoisted and Cc != 2 * R2:
        raise ValueError(f"hoisted c must be n_layer*2R = {2 * R2} wide, got "
                         f"{Cc}")
    K = {0: 3, 6: 4, 12: 6}[phases]
    want = {"front_w": (2, 3, r_in, R), "front_b": (2, R),
            "kfg": (2, 2, K, R, R2), "cond_w": (2, 2, Cc, R2),
            "cond_b": (2, 2, R2), "res_w": (2, R, R), "res_b": (2, R),
            "skip_w": (2, 2, R, R), "skip_b": (2, 2, R), "fin_w": (2, R, R),
            "fin_b": (2, R), "zw": (2, R, 2 * r_in), "zb": (2, 2 * r_in),
            "an_s": (2, 2, r_in), "an_b": (2, 2, r_in),
            "kfg_s": (2, 2, R2), "cond_s": (2, 2, R2), "res_s": (2, R),
            "skip_s": (2, 2, R)}
    weights = ("front_w", "kfg", "cond_w", "res_w", "skip_w", "fin_w", "zw")
    int8_w = (("kfg", "cond_w") if int8 else ()) + (
        ("res_w", "skip_w") if rs else ())
    for name, o in ops.items():
        if tuple(o.shape) != want[name]:
            raise ValueError(f"operand {name} has shape {tuple(o.shape)}, "
                             f"expected {want[name]}")
        if o.device != u.device:
            raise ValueError(f"operand {name} is on {o.device}, not "
                             f"{u.device}")
        w_dt = (torch.int8 if name in int8_w else
                dt if name in weights else torch.float32)
        if o.dtype != w_dt:
            raise TypeError(f"operand {name} is {o.dtype}, expected {w_dt}")
    # widths the instance does not take run zero-padded (exact); the
    # launcher refuses them unpadded
    Rk, Cck = kernel_widths(R, Cc, tc, hoisted, threads)
    if (Rk, Cck) != (R, Cc):
        c_a, c_b, padded = pad_pair_widths(c_a, c_b, tuple(ops.values()), Rk,
                                           Cck, int8=int8, hoisted=hoisted)
        ops = dict(zip(names, padded))
        R, Cc = Rk, Cck
    check_kernel_geometry(R, Cc, tc, threads)
    # the hoisted tensor-core pairs run their front and zero convs on the
    # tensor cores too where R_in allows (front_zero_tc)
    ftc = tc and hoisted and not phases and front_zero_tc(r_in)
    packed = _TC_WEIGHTS + (("front_w", "zw") if ftc else ())
    with span("fwn.fold.pack"):
        ops = {k: (pack_tc_weights(o) if tc and k in packed else
                   _pack_int8(o) if k in int8_w else o).contiguous()
               for k, o in ops.items()}
    crs = None
    if int8 and not hoisted:
        if c_row_scales is None:
            raise ValueError("the int8 pair takes per-row c scales [B, 2]")
        crs = c_row_scales.to(device=u.device, dtype=torch.float32
                              ).reshape(B, 2).contiguous()
    dcode = 0 if dt == torch.float32 else 1
    if phases:
        t_tile = wino_t_tile(dt, phases)
    elif tc and hoisted:
        n_sm = torch.cuda.get_device_properties(u.device).multi_processor_count
        t_tile = _hoisted_tile(B, T, R, r_in, pick[0], n_sm)
    else:
        t_tile = kernel_t_tile(dt, r_in)
    smem = getattr(lib, f"{pre}_smem_bytes")(dcode, pick[0], int(tc), R,
                                             r_in, t_tile)
    if not 0 < smem <= SMEM_MAX:
        raise ValueError(f"t_tile={t_tile} needs {smem} bytes of shared "
                         f"memory per CTA (at most {SMEM_MAX})")
    u_out, v_out = torch.empty_like(u), torch.empty_like(v)
    call(getattr(lib, f"{pre}_launch"), kernel,
         (dcode, *pick, 2 if ftc else int(tc)),
         [u, v, c_a, c_b, u_out, v_out, *[ops.get(n) for n in _SLOTS], crs],
         (B, T, r_in, R, Cc, t_tile), u.device,
         {"t_tile": t_tile, "ctas": B * -(-T // t_tile)})
    return u_out, v_out


def fused_pair_reverse(u, v, c_a, c_b, operands, *, int8: bool = False,
                       c_row_scales=None, hoisted: bool = False):
    """Apply one reverse flow pair.  u, v: [B, T, R_in]; c_*: [B, T, Cc]
    (int8 with ``c_row_scales`` [B, 2] when ``int8``); ``operands`` from
    :func:`pair_reverse_operands` or :func:`pair_reverse_operands_int8`
    (17, or 19 with int8 res/skip).  With ``hoisted``, c_* are the
    precomputed conditioning pre-activations [B, T, n_layer*2R] of the even
    / odd flow and ``operands`` come from
    :func:`pair_reverse_operands_hoisted` (or its ``_int8`` twin, with
    ``int8``).  Returns (u', v').

    A CPU tensor runs the plain version at the tile of
    :func:`kernel_t_tile`; a CUDA tensor launches the kernel (or raises),
    the hoisted bf16 pairs on the tile of :func:`hoisted_launch_tile`
    (recorded in ``launch.LAST_LAUNCH``; the int8 pair's output depends on
    it, and that tile on T and the widths alone)."""
    if int8 and not hoisted and c_row_scales is None:
        raise ValueError("the int8 pair takes per-row c scales [B, 2]")
    if u.device.type == "cpu":
        return pair_reverse_ref(u, v, c_a, c_b, operands,
                                t_tile=kernel_t_tile(u.dtype, u.shape[-1]),
                                int8=int8, c_row_scales=c_row_scales,
                                hoisted=hoisted)
    return _launch(u, v, c_a, c_b, operands, int8=int8, hoisted=hoisted,
                   c_row_scales=c_row_scales)


def fused_pair_reverse_wino(u, v, c_a, c_b, operands, *,
                            hoisted: bool = False):
    """Apply one reverse flow pair with Winograd filter|gate convs (port of
    ``_pair_kernel_wino``); ``operands`` from
    :func:`pair_reverse_operands_wino` (F(2,3)) or
    :func:`pair_reverse_operands_wino4` (F(4,3)).  ``hoisted`` (port of
    ``_pair_kernel_wino_hoisted``): c_a/c_b are the precomputed
    conditioning pre-activations [B, T, n_layer*2R] of the even / odd flow
    (:func:`hoist_cond`) and ``operands`` come through :func:`pop_cond_w`.
    A CPU tensor runs :func:`pair_reverse_wino_ref` at the kernel's tile; a
    CUDA tensor launches ``pair_flow_wino[4]`` or
    ``pair_flow_wino[4]_hoisted`` (or raises)."""
    P = 6 if operands[2].shape[2] == 4 else 12
    if u.device.type == "cpu":
        return pair_reverse_wino_ref(u, v, c_a, c_b, operands,
                                     t_tile=wino_t_tile(u.dtype, P),
                                     hoisted=hoisted)
    return _launch(u, v, c_a, c_b, operands, int8=False, hoisted=hoisted,
                   c_row_scales=None, phases=P)


def pair_cost(B: int, T: int, r_in: int, cc: int, r: int = 256,
              int8: bool = False, fg_mults: float = 1.0,
              hoisted: bool = False) -> dict:
    """Work of one pair over [B, T] output rows: operations by type and the
    bytes that must move (each input read once, each output written once),
    from the shapes.  Per net per row: 2*(2*3*R*2R + 2*Cc*2R + R*2R + R*R
    + R*R + 3*R_in*R + R*2R_in) operations (the count behind
    pallas_flow.py:944-946, plus the final 1x1).  ``fg_mults`` scales the
    fg convs to a Winograd's own multiplies (4/6 for F(2,3), 6/12 for
    F(4,3), JAX's count at pallas_flow.py:1484-1488); ``hoisted`` drops the
    cond 1x1s (they run outside the kernel) and reads ``cc`` = n_layer*2R
    wide pre-activations instead of c."""
    rows = 2 * B * T                      # two nets per pair
    fg = rows * 2 * 2 * 3 * r * 2 * r * fg_mults
    cond = 0 if hoisted else rows * 2 * 2 * cc * 2 * r
    rest = rows * 2 * (r * 2 * r + 2 * r * r + 3 * r_in * r + r * 2 * r_in)
    es = 2                                # bf16 storage
    c_bytes = 2 * B * T * cc * (1 if int8 and not hoisted else es)
    uv_bytes = 4 * B * T * r_in * es
    w_fg = 2 * 2 * 3 * r * 2 * r * fg_mults * (1 if int8 else es)
    w_cond = 0 if hoisted else 2 * 2 * cc * 2 * r * (1 if int8 else es)
    w_bytes = w_fg + w_cond + 2 * es * (3 * r_in * r + 3 * r * r
                                        + r * 2 * r_in)
    return {"fg_ops": fg, "cond_ops": cond, "fg_cond_ops": fg + cond,
            "other_ops": rest, "bytes": c_bytes + uv_bytes + w_bytes}


def pair_bound_ms(B: int, T: int, r_in: int, cc: int, r: int = 256,
                  int8: bool = False, fg_mults: float = 1.0,
                  hoisted: bool = False, rs: bool = False
                  ) -> tuple[float, str]:
    """Least time an H100 SXM could take for one bf16 pair: the larger of
    bytes over 3.35 TB/s and operations over the dense peaks (989 TFLOP/s
    bf16; 1979 TOP/s int8 for the fg convs and, on the int8 route, the
    cond 1x1s; with ``rs`` also the res/skip 1x1s).  Returns (ms, "bytes"
    or "operations")."""
    c = pair_cost(B, T, r_in, cc, r, int8, fg_mults, hoisted)
    i8, bf = 1979e12, 989e12
    rs_ops = 2 * B * T * 2 * (r * 2 * r + r * r) if rs else 0
    ops_s = (c["fg_ops"] / (i8 if int8 else bf)
             + c["cond_ops"] / (i8 if int8 and not hoisted else bf)
             + rs_ops / i8 + (c["other_ops"] - rs_ops) / bf)
    mem_s = c["bytes"] / 3.35e12
    return (max(ops_s, mem_s) * 1e3,
            "operations" if ops_s >= mem_s else "bytes")
