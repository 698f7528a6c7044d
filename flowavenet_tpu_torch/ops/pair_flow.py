"""Fused reverse flow pair: operand folding, the plain tiled version, and
the wrapper around the CUDA kernel ``csrc/pair_flow.cu``.

Twin of ``flowavenet_tpu/ops/pallas_flow.py`` (``_pair_kernel`` and
``_pair_kernel_i8`` through ``fused_pair_reverse``).  One pair applies

    u <- u * exp(log_s(v; odd)) + t(v; odd)       coupling (odd flow)
    v <- v * sA - bA ; u <- u * sB - bB           ActNorm reverse (odd)
    v <- v * exp(log_s(u; even)) + t(u; even)     coupling (even flow)
    u <- u * sC - bC ; v <- v * sD - bD           ActNorm reverse (even)

over time tiles plus a halo, where each (log_s, t) is a WaveNet coupling
net.  :func:`pair_reverse_ref` is the plain PyTorch version of exactly
that tiled math (tile, halo, edge masks, per-window int8 scales, cast
points); :func:`fused_pair_reverse` runs it for CPU tensors and launches
the kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..utils.tree import tree_map
from .conv import wn_kernel

# Rows of halo per side in the CUDA kernel: the receptive field of one
# pair (5 per coupling net).  The JAX kernel uses 16 (sublane alignment).
KERNEL_HALO = 10
SQRT_HALF = 0.7071067811865476

# Launches of the CUDA kernels, by name; each wrapper adds one per launch.
# pair_flow* are the reverse pair (csrc/pair_flow.cu); pair_fwd,
# pair_train_fwd and pair_train_bwd the forward and training pairs
# (csrc/pair_flow_train.cu, ops/pair_flow_train.py).
LAUNCHES = {"pair_flow": 0, "pair_flow_i8": 0, "pair_fwd": 0,
            "pair_train_fwd": 0, "pair_train_bwd": 0}


def kernel_t_tile(dtype: torch.dtype) -> int:
    """Output rows per CTA: 64 in bf16; 32 in fp32, whose shared-memory
    buffers are twice as wide."""
    return 32 if dtype == torch.float32 else 64


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


def pair_reverse_operands_int8(pair: dict, dtype=torch.bfloat16) -> tuple:
    """Operands for the int8 kernel: the 15 of :func:`pair_reverse_operands`
    with kfg [2, nl, 3, R, 2R] and cond_w [2, nl, Cc, 2R] quantized to int8
    (after the cast to ``dtype``), plus their per-(flow, layer, out-channel)
    scales kfg_scale and cond_scale appended."""
    ops = list(pair_reverse_operands(pair, dtype))
    ops[2], s_fg = _quant_w(ops[2], (2, 3))
    ops[3], s_c = _quant_w(ops[3], (2,))
    return tuple(ops) + (s_fg, s_c)


# ---------------------------------------------------------------------------
# Plain version: the kernel's tiled math in eager PyTorch
# ---------------------------------------------------------------------------

def _windows(x: torch.Tensor, t_tile: int, n_t: int, halo: int
             ) -> torch.Tensor:
    """[B, T, C] -> [B*n_t, t_tile + 2*halo, C]; rows outside [0, T) are
    zeros."""
    B, T, C = x.shape
    xp = F.pad(x.float(), (0, 0, halo, n_t * t_tile - T + halo))
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


def _coupling_net(x_buf, c_buf, *, x_off: int, c_off: int, out_len: int,
                  p0, T: int, w: dict, rnd, int8: bool, c_scale=None):
    """One coupling net over windows, mirroring the JAX ``_coupling_net``:
    x_buf[:, j] holds position j - x_off relative to output row 0, whose
    global position is p0 [N]; likewise c_buf with c_off."""
    wt = x_buf.dtype            # fp32 (fp64 for an fp64 reference run)
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
        if int8:
            return _int_dot(tap, w["cond_w"][layer]) * (
                c_scale * w["cond_s"][layer])
        return torch.matmul(tap, w["cond_w"][layer].to(wt))

    def gate(fg):
        r = fg.shape[-1] // 2
        return rnd(torch.tanh(fg[..., :r]) * torch.sigmoid(fg[..., r:]))

    l_h0 = out_len + 8
    h0 = conv3(x_buf, w["front_w"], x_off - 4, l_h0, 1)
    h0 = _mask(rnd(torch.relu(h0 + w["front_b"])), p0 - 4, T)
    l_g0 = out_len + 6
    fg0 = conv_fg(h0, 0, 1, l_g0, 1)
    fg0 = fg0 + cond(0, c_off - 3, l_g0)
    fg0 = fg0 + w["cond_b"][0]
    r = fg0.shape[-1] // 2
    rs_w = torch.cat([w["res_w"], w["skip_w"][0]], -1).to(wt)
    rs = torch.matmul(gate(fg0), rs_w)
    res0 = rs[..., :r] + w["res_b"]
    h1 = rnd((h0[:, 1:1 + l_g0] + res0) * SQRT_HALF)
    h1 = _mask(h1, p0 - 3, T)
    fg1 = conv_fg(h1, 1, 3, out_len, 3)
    fg1 = fg1 + cond(1, c_off, out_len)
    fg1 = fg1 + w["cond_b"][1]
    sk0 = rs[:, 3:3 + out_len, r:] + w["skip_b"][0]
    sk1 = torch.matmul(gate(fg1), w["skip_w"][1].to(wt)) + w["skip_b"][1]
    out = rnd(torch.relu(sk0 + sk1))
    out = rnd(torch.relu(torch.matmul(out, w["fin_w"].to(wt))
                         + w["fin_b"]))
    return torch.matmul(out, w["zw"].to(wt)) + w["zb"]


_OP_NAMES = ("front_w", "front_b", "kfg", "cond_w", "cond_b", "res_w",
             "res_b", "skip_w", "skip_b", "fin_w", "fin_b", "zw", "zb")


def pair_reverse_ref(u, v, c_a, c_b, operands, *, t_tile: int,
                     halo: int = KERNEL_HALO, int8: bool = False,
                     c_row_scales=None):
    """Plain version of the fused pair: the same tiles (``t_tile`` output
    rows plus ``halo`` rows per side), edge masks, per-window int8 scales
    and cast points as the kernel.  On the card, run it with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``).

    With ``int8`` the activation scales of the fg convs are max-abs over
    each window's h0 / h1 buffer, so they depend on ``t_tile`` and
    ``halo``: (t_tile, 10) reproduces the CUDA kernel, (JAX tile, 16) the
    JAX kernel.  c_a/c_b are then int8 with per-row scales
    ``c_row_scales`` [B, 2]."""
    B, T, r_in = u.shape
    dt = u.dtype
    n_t = -(-T // t_tile)
    L = t_tile + 2 * halo
    if halo < 10 or t_tile < 1:
        raise ValueError(f"need halo >= 10 and t_tile >= 1, got {halo}, "
                         f"{t_tile}")

    def rnd(x):
        return x.to(dt).float()

    uw, vw = _windows(u, t_tile, n_t, halo), _windows(v, t_tile, n_t, halo)
    caw = _windows(c_a, t_tile, n_t, halo)
    cbw = _windows(c_b, t_tile, n_t, halo)
    p_win = ((torch.arange(n_t, device=u.device) * t_tile - halo)
             .repeat(B))                                 # [B*n_t]
    crs = None
    if int8:
        crs = c_row_scales.float().repeat_interleave(n_t, dim=0)  # [N, 2]

    def flow_w(fi):
        # int8 weights stay int8 (their products are taken exactly)
        w = {name: operands[i][fi] for i, name in enumerate(_OP_NAMES)}
        w = {k: t if t.dtype == torch.int8 else t.float()
             for k, t in w.items()}
        if int8:
            w["kfg_s"], w["cond_s"] = operands[15][fi], operands[16][fi]
        return w

    an_s, an_b = operands[13].float(), operands[14].float()

    # odd flow over window rows [5, L-5)
    l_mid = L - 10
    net = _coupling_net(
        vw, cbw, x_off=5, c_off=5, out_len=l_mid, p0=p_win + 5, T=T,
        w=flow_w(1), rnd=rnd, int8=int8,
        c_scale=None if crs is None else crs[:, 1, None, None])
    log_s, t = net[..., :r_in], net[..., r_in:]
    u_mid = uw[:, 5:5 + l_mid] * torch.exp(log_s) + t
    v_an = vw[:, 5:5 + l_mid] * an_s[1, 0] - an_b[1, 0]
    u_mid = _mask(rnd(u_mid * an_s[1, 1] - an_b[1, 1]), p_win + 5, T)

    # even flow over window rows [10, L-10)
    l_out = L - 20
    net2 = _coupling_net(
        u_mid, caw, x_off=5, c_off=10, out_len=l_out, p0=p_win + 10, T=T,
        w=flow_w(0), rnd=rnd, int8=int8,
        c_scale=None if crs is None else crs[:, 0, None, None])
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
# The kernel wrapper
# ---------------------------------------------------------------------------

def _pack_int8(wq: torch.Tensor) -> torch.Tensor:
    """[..., Cin, N] int8 -> [..., Cin/4, N] int32 words holding 4
    consecutive input channels (the kernel's __dp4a operand layout)."""
    *lead, cin, n = wq.shape
    w = wq.reshape(*lead, cin // 4, 4, n).transpose(-1, -2).contiguous()
    return w.view(torch.int32).reshape(*lead, cin // 4, n)


@functools.lru_cache(maxsize=None)
def _library():
    """The built kernel library, with every C signature declared."""
    from . import _build

    lib = _build.load("pair_flow")
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.pair_reverse_threads.argtypes = []
    lib.pair_reverse_threads.restype = c_int
    lib.pair_reverse_smem_bytes.argtypes = [c_int] * 5
    lib.pair_reverse_smem_bytes.restype = c_int
    lib.pair_reverse_launch.argtypes = [c_int, c_int, c_ptr, c_ptr, c_ptr]
    lib.pair_reverse_launch.restype = c_int
    return lib


def _launch(u, v, c_a, c_b, operands, *, int8: bool, c_row_scales):
    lib = _library()
    B, T, r_in = u.shape
    dt = u.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pair kernel takes fp32 or bf16, got {dt}")
    R = operands[5].shape[-1]
    Cc = c_a.shape[-1]
    n_ops = 17 if int8 else 15
    if len(operands) != n_ops:
        raise ValueError(f"expected {n_ops} operands, got {len(operands)}")
    c_dt = torch.int8 if int8 else dt
    for name, x in (("u", u), ("v", v), ("c_a", c_a), ("c_b", c_b)):
        if not (x.is_cuda and x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous CUDA tensor")
    if v.shape != u.shape or c_a.shape != (B, T, Cc) or c_b.shape != c_a.shape:
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, v "
                         f"{tuple(v.shape)}, c {tuple(c_a.shape)}, "
                         f"{tuple(c_b.shape)}")
    if c_a.dtype != c_dt or c_b.dtype != c_dt or v.dtype != dt:
        raise TypeError(f"u/v must be {dt} and c {c_dt}")
    threads = lib.pair_reverse_threads()
    if threads % R or Cc % 4 or R % 4:
        raise ValueError(f"kernel takes R dividing {threads} and Cc, R "
                         f"multiples of 4; got R={R}, Cc={Cc}")
    R2 = 2 * R
    want = [(2, 3, r_in, R), (2, R), (2, 2, 3, R, R2), (2, 2, Cc, R2),
            (2, 2, R2), (2, R, R), (2, R), (2, 2, R, R), (2, 2, R),
            (2, R, R), (2, R), (2, R, 2 * r_in), (2, 2 * r_in),
            (2, 2, r_in), (2, 2, r_in), (2, 2, R2), (2, 2, R2)]
    for i, shp in enumerate(want[:n_ops]):
        if tuple(operands[i].shape) != shp:
            raise ValueError(f"operand {i} has shape "
                             f"{tuple(operands[i].shape)}, expected {shp}")
    ops = [o.contiguous() for o in operands]
    for i, o in enumerate(ops):
        if o.device != u.device:
            raise ValueError(f"operand {i} is on {o.device}, not {u.device}")
        w_dt = (torch.int8 if int8 and i in (2, 3) else
                dt if i in (0, 2, 3, 5, 7, 9, 11) else torch.float32)
        if o.dtype != w_dt:
            raise TypeError(f"operand {i} is {o.dtype}, expected {w_dt}")
    crs = None
    if int8:
        ops[2], ops[3] = _pack_int8(ops[2]), _pack_int8(ops[3])
        crs = c_row_scales.to(device=u.device, dtype=torch.float32
                              ).reshape(B, 2).contiguous()
    t_tile = kernel_t_tile(dt)
    smem = lib.pair_reverse_smem_bytes(0 if dt == torch.float32 else 1,
                                       int(int8), R, r_in, t_tile)
    if smem > 232448:
        raise ValueError(f"t_tile={t_tile} needs {smem} bytes of shared "
                         "memory per CTA (at most 232448)")
    u_out, v_out = torch.empty_like(u), torch.empty_like(v)
    # the kernel runs on the current stream, so the caching allocator may
    # reuse these temporaries only for work queued after it
    ptrs = [u, v, c_a, c_b, u_out, v_out, *ops]
    ptr_arr = (ctypes.c_void_p * 24)(
        *[x.data_ptr() for x in ptrs],
        *([0] * (17 - len(ops))),
        crs.data_ptr() if crs is not None else 0)
    dims = (ctypes.c_int * 6)(B, T, r_in, R, Cc, t_tile)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.pair_reverse_launch(
            0 if dt == torch.float32 else 1, int(int8),
            ctypes.cast(ptr_arr, ctypes.c_void_p),
            ctypes.cast(dims, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"pair_flow kernel launch failed: cudaError {err}")
    LAUNCHES["pair_flow_i8" if int8 else "pair_flow"] += 1
    return u_out, v_out


def fused_pair_reverse(u, v, c_a, c_b, operands, *, int8: bool = False,
                       c_row_scales=None):
    """Apply one reverse flow pair.  u, v: [B, T, R_in]; c_*: [B, T, Cc]
    (int8 with ``c_row_scales`` [B, 2] when ``int8``); ``operands`` from
    :func:`pair_reverse_operands` or :func:`pair_reverse_operands_int8`.
    Returns (u', v').

    A CPU tensor runs the plain version at the kernel's tile
    (:func:`kernel_t_tile`); a CUDA tensor launches the kernel (or
    raises)."""
    if int8 and c_row_scales is None:
        raise ValueError("the int8 pair takes per-row c scales [B, 2]")
    if u.device.type == "cpu":
        return pair_reverse_ref(u, v, c_a, c_b, operands,
                                t_tile=kernel_t_tile(u.dtype), int8=int8,
                                c_row_scales=c_row_scales)
    return _launch(u, v, c_a, c_b, operands, int8=int8,
                   c_row_scales=c_row_scales)


def fused_pair_forward(u, v, c_a, c_b, operands):
    """Apply one FORWARD flow pair (twin of the JAX ``fused_pair_forward``,
    the port of ``_pair_kernel_fw``).  u, v: [B, T, R_in]; c_*: [B, T, Cc];
    ``operands`` from :func:`pair_forward_operands`.  Returns
    (u', v', raw) where raw is the fp32 sum of -log_s over both couplings.

    A CPU tensor runs the plain version (``pair_flow_train.
    pair_train_fwd_ref`` without the extra statistics); a CUDA tensor
    launches ``pair_fwd`` (or raises).  No gradient: the model's
    autograd.Function recomputes the plain pair for that."""
    from . import pair_flow_train as pft
    if u.device.type == "cpu":
        return pft.pair_train_fwd_ref(u, v, c_a, c_b, operands, stats=False)
    return pft.launch_forward(u, v, c_a, c_b, operands, stats=False)


def pair_cost(B: int, T: int, r_in: int, cc: int, r: int = 256,
              int8: bool = False) -> dict:
    """Work of one pair over [B, T] output rows: operations by type and the
    bytes that must move (each input read once, each output written once),
    from the shapes.  Per net per row: 2*(2*3*R*2R + 2*Cc*2R + R*2R + R*R
    + R*R + 3*R_in*R + R*2R_in) operations (the count behind
    pallas_flow.py:944-946, plus the final 1x1)."""
    rows = 2 * B * T                      # two nets per pair
    fg_cond = rows * 2 * (2 * 3 * r * 2 * r + 2 * cc * 2 * r)
    rest = rows * 2 * (r * 2 * r + 2 * r * r + 3 * r_in * r + r * 2 * r_in)
    es = 2                                # bf16 storage
    c_bytes = 2 * B * T * cc * (1 if int8 else es)
    uv_bytes = 4 * B * T * r_in * es
    w_el = 2 * (2 * 3 * r * 2 * r + 2 * cc * 2 * r)
    w_bytes = w_el * (1 if int8 else es) + 2 * es * (
        3 * r_in * r + 3 * r * r + r * 2 * r_in)
    return {"fg_cond_ops": fg_cond, "other_ops": rest,
            "bytes": c_bytes + uv_bytes + w_bytes}


def pair_bound_ms(B: int, T: int, r_in: int, cc: int, r: int = 256,
                  int8: bool = False) -> tuple[float, str]:
    """Least time an H100 SXM could take for one bf16 pair: the larger of
    bytes over 3.35 TB/s and operations over the dense peaks (989 TFLOP/s
    bf16; 1979 TOP/s int8 for the fg convs and cond 1x1s of the int8
    route).  Returns (ms, "bytes" or "operations")."""
    c = pair_cost(B, T, r_in, cc, r, int8)
    ops_s = (c["fg_cond_ops"] / (1979e12 if int8 else 989e12)
             + c["other_ops"] / 989e12)
    mem_s = c["bytes"] / 3.35e12
    return (max(ops_s, mem_s) * 1e3,
            "operations" if ops_s >= mem_s else "bytes")
