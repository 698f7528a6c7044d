"""Plain FloWaveNet (arXiv 1811.02155, the ryhorv/tf-flowavenet model) in
float32 PyTorch: synthesis (``reverse``), the likelihood (``loss``) with
the training guards, data-dependent ActNorm init (``ddi``) and the
clip -> Adam step.  It imports nothing of the measured package; the
parameters come in that package's tree layout
(``fwbench/families/flowavenet.py``), and everything derived from them
(weight norms, folded operands, noise, crops) is worked out here again.

Tensors are channels-last ``[B, T, C]``; a 1-D kernel is ``[K, Cin, Cout]``
and a ``K``-tap conv with dilation ``d`` reads ``x[t + (j - (K-1)/2) d]``.
Squeeze maps ``(t = 2 t' + p, c)`` to channel ``2 c + p``.  A flow is
ActNorm, an affine coupling whose WaveNet reads the first half of the
channels (and of the conditioning), then a swap of the halves.

Every product reads its operands through :class:`Prec`: ``Prec("fp32")``
is the reference (fp32 products and sums, TF32 off on the card);
``Prec("lower")`` is the lower-precision control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)
WN_EPS = 1e-12
HINGE_MARGIN = 5.0


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = top / amax
    return (x * s).to(dtype).to(torch.float32) / s


def _int4(x: torch.Tensor, dims) -> torch.Tensor:
    """Symmetric int4 codes (-7..7) with max-abs scales over ``dims``."""
    s = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / 7.0
    return torch.clamp(torch.round(x / s), -7.0, 7.0) * s


class _Q(torch.autograd.Function):
    """Forward: round to e4m3; backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class _QGrad(torch.autograd.Function):
    """Forward: identity; backward: round the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Prec:
    """The precision of every product and of every tensor kept between
    operations.  ``"fp32"``: the reference.  ``"lower"``: the control, one
    step below what the configuration states: product operands in int4
    (per-row activation and per-output weight scales) where it states int8
    (``int8`` maps "fg" and "cond" to the blocks whose filter|gate convs or
    conditioning 1x1s run on int8 codes), in float8 e4m3 (one scale per
    tensor) where it states bfloat16, and the activations and the flow's
    state, which the program keeps in bfloat16, kept in e4m3; in a
    backward pass the gradient entering each product is rounded to e5m2."""

    def __init__(self, mode: str = "fp32", int8: dict | None = None):
        if mode not in ("fp32", "lower"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.int8 = {k: set(v) for k, v in (int8 or {}).items()}

    def operands(self, x, w, kind: str = "", block: int = -1):
        """x [B, T, Cin] and kernel w [K, Cin, Cout] as the product reads
        them; ``kind`` ("fg" or "cond") and ``block`` place the product."""
        if self.mode == "fp32":
            return x, w
        if block in self.int8.get(kind, ()):
            return _int4(x, (1, 2)), _int4(w, (0, 1))
        return _Q.apply(x), _Q.apply(w)

    def out(self, y):
        """A product's result: in the control, the gradient entering it
        is rounded to e5m2 in a backward pass."""
        return y if self.mode == "fp32" else _QGrad.apply(y)

    def act(self, x):
        """A tensor the program keeps in its compute dtype between
        operations: in the control, rounded to e4m3."""
        return x if self.mode == "fp32" else _Q.apply(x)


def no_tf32() -> None:
    """fp32 products in fp32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def wn(p: dict) -> torch.Tensor:
    """Weight norm: each output column of ``v`` scaled to norm ``g``."""
    v = p["v"].float()
    norm = torch.sqrt(torch.clamp((v * v).sum(dim=(0, 1), keepdim=True),
                                  min=WN_EPS))
    return v / norm * p["g"].float()


def conv(pr: Prec, x, kernel, bias, dilation: int = 1, kind: str = "",
         block: int = -1):
    """Non-causal 'same' conv of x [B, T, Cin] with kernel [K, Cin, Cout]."""
    x, kernel = pr.operands(x, kernel, kind, block)
    K = kernel.shape[0]
    half = (K - 1) // 2 * dilation
    T = x.shape[1]
    xp = F.pad(x, (0, 0, half, half)) if half else x
    out = None
    for j in range(K):
        y = torch.matmul(xp[:, j * dilation: j * dilation + T], kernel[j])
        out = y if out is None else out + y
    out = pr.out(out)
    return out + bias.float() if bias is not None else out


def wavenet(pr: Prec, p: dict, x, c, g_row=None, block: int = -1):
    """Coupling net of block ``block``: x [B, T, in], c [B, T, Cc], g_row
    [B, 1, Cg] (global conditioning, constant in time) -> [B, T, out]."""
    h = pr.act(torch.relu(conv(pr, x, wn(p["front"]), p["front"]["b"])))
    R = p["front"]["v"].shape[-1]
    skip = None
    n = len(p["layers"])
    for i, L in enumerate(p["layers"]):
        kfg = torch.cat([wn(L["filter"]), wn(L["gate"])], -1)
        bfg = torch.cat([L["filter"]["b"], L["gate"]["b"]], -1).float()
        kc = torch.cat([wn(L["filter_c"]), wn(L["gate_c"])], -1)
        bc = torch.cat([L["filter_c"]["b"], L["gate_c"]["b"]], -1).float()
        fg = (conv(pr, h, kfg, bfg, 3 ** i, "fg", block)
              + conv(pr, c, kc, bc, 1, "cond", block))
        if g_row is not None and "filter_g" in L:
            kg = torch.cat([wn(L["filter_g"]), wn(L["gate_g"])], -1)
            bg = torch.cat([L["filter_g"]["b"], L["gate_g"]["b"]], -1)
            fg = fg + conv(pr, g_row, kg, bg.float())
        fg = pr.act(fg)
        out = pr.act(torch.tanh(fg[..., :R]) * torch.sigmoid(fg[..., R:]))
        s = pr.act(conv(pr, out, wn(L["skip"]), L["skip"]["b"]))
        skip = s if skip is None else pr.act(skip + s)
        if i + 1 < n:
            h = pr.act((h + conv(pr, out, wn(L["res"]), L["res"]["b"]))
                       * math.sqrt(0.5))
    out = pr.act(torch.relu(conv(pr, torch.relu(skip), wn(p["final"]),
                                 p["final"]["b"])))
    z = p["zero"]
    return pr.act(conv(pr, out, z["w"].float(), z["b"])
                  * torch.exp(3.0 * z["scale"].float()))


def squeeze(x):
    B, T, C = x.shape
    return x.reshape(B, T // 2, 2, C).transpose(2, 3).reshape(B, T // 2,
                                                               2 * C)


def unsqueeze(x):
    B, T, C = x.shape
    return x.reshape(B, T, C // 2, 2).transpose(2, 3).reshape(B, 2 * T,
                                                              C // 2)


def swap(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([b, a], -1)


def flow(params: dict, bi: int, i: int) -> dict:
    """Flow ``i`` of block ``bi`` (its slice of the stacked leaves)."""
    def pick(t):
        if isinstance(t, dict):
            return {k: pick(v) for k, v in t.items()}
        if isinstance(t, list):
            return [pick(v) for v in t]
        return t[i]
    return pick(params["blocks"][bi]["flows"])


def upsample(pr: Prec, params: dict, scales, mel):
    """TF ``Conv2DTranspose(1, (2s, 3), strides=(s, 1), 'same')`` per scale
    over the mel as an image [T_mel, mels], weight-normalized over (kernel
    rows, output), then leaky_relu(0.4)."""
    h = mel.float()
    for p, s in zip(params["upsample"], scales):
        v = p["v"].float()                                   # [kh, 3, 1, 1]
        w = v / torch.sqrt(torch.clamp((v * v).sum(dim=(0, 2), keepdim=True),
                                       min=WN_EPS)) * p["g"].float()
        if pr.mode != "fp32":
            h, w = _Q.apply(h), _Q.apply(w)
        kh = w.shape[0]
        B, H, W = h.shape
        # the transposed conv as a product: every (frame, tap row) pair
        # scatters into output row frame * s + row - pad_top
        top = (kh - s) // 2
        cols = F.pad(h, (1, 1))                              # [B, H, W+2]
        out = h.new_zeros(B, (H - 1) * s + kh, W)
        for r in range(kh):
            for u in range(3):
                # output column j reads input column j + 1 - u
                contrib = cols[:, :, 2 - u: 2 - u + W] * w[r, u, 0, 0]
                out[:, r: r + (H - 1) * s + 1: s] += contrib
        h = out[:, top: top + H * s] + p["b"].float()
        h = pr.act(F.leaky_relu(h, 0.4))
    return h


def _levels(pr, params, model, mel, speakers):
    """(upsampled c [B, T, mels], speaker rows [B, 1, gin] or None)."""
    c = upsample(pr, params, model["upsample_scales"], mel)
    g = None
    if model["gin_channels"] > 0:
        g = params["speaker_emb"].float()[speakers.long()][:, None, :]
    return c, g


def _g_level(g, k: int):
    """Speaker rows at block level k: squeezing a constant-in-time signal
    repeats each channel 2**k times (channel 2**k c + j <- c)."""
    return None if g is None else g.repeat_interleave(2 ** k, dim=-1)


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

@torch.no_grad()
def reverse(params: dict, model: dict, z, mel, speakers=None,
            pr: Prec | None = None):
    """Audio [B, T] from noise z [B, T] and mel [B, T / hop, mels]."""
    pr = pr or Prec()
    nb, nf = model["n_block"], model["n_flow"]
    if nf % 2:
        raise ValueError("the reference takes an even n_flow")
    c, g = _levels(pr, params, model, mel, speakers)
    x = z.float()[..., None]
    for _ in range(nb):
        x = squeeze(x)
    for bi in reversed(range(nb)):
        k = bi + 1
        ck = c
        for _ in range(k):
            ck = squeeze(ck)
        gk = _g_level(g, k)
        for i in reversed(range(nf)):
            fp = flow(params, bi, i)
            x = swap(x)
            xa, xb = x.chunk(2, -1)
            ca = ck.chunk(2, -1)[i % 2]
            ga = None if gk is None else gk.chunk(2, -1)[i % 2]
            log_s, t = wavenet(pr, fp["coupling"], xa, ca, ga,
                               bi).chunk(2, -1)
            x = pr.act(torch.cat([xa, xb * torch.exp(log_s) + t], -1))
            an = fp["actnorm"]
            x = pr.act(x * torch.exp(-3.0 * an["logs"].float())
                       - an["b"].float())
        x = unsqueeze(x)
    return x[..., 0]


# ---------------------------------------------------------------------------
# Likelihood, DDI and the training step
# ---------------------------------------------------------------------------

def loss(params: dict, model: dict, audio, mel, speakers=None,
         pr: Prec | None = None, logs_hinge: float = 1.0,
         actnorm_hinge: float = 1.0):
    """(total, nll) in nats per sample: the negative log-likelihood plus
    the dead-zone hinges on |log_s| and on the ActNorm scales."""
    pr = pr or Prec()
    c, g = _levels(pr, params, model, mel, speakers)
    x = audio.float()[..., None]
    nel = x.numel()
    logdet = x.new_zeros(())
    hinge = x.new_zeros(())
    for bi in range(model["n_block"]):
        x, c = squeeze(x), squeeze(c)
        gk = _g_level(g, bi + 1)
        for i in range(model["n_flow"]):
            fp = flow(params, bi, i)
            an = fp["actnorm"]
            logs3 = 3.0 * an["logs"].float()
            x = pr.act((x + an["b"].float()) * torch.exp(logs3))
            logdet = logdet + logs3.mean()
            xa, xb = x.chunk(2, -1)
            ca = c.chunk(2, -1)[0]
            ga = None if gk is None else gk.chunk(2, -1)[0]
            log_s, t = wavenet(pr, fp["coupling"], xa, ca, ga).chunk(2, -1)
            x = pr.act(torch.cat([xa, (xb - t) * torch.exp(-log_s)], -1))
            logdet = logdet - log_s.mean() / 2.0
            hinge = hinge + (torch.relu(log_s.abs() - HINGE_MARGIN) ** 2).sum()
            x, c = swap(x), swap(c)
            if gk is not None:
                gk = swap(gk)
    log_p = (-0.5 * (LOG_2PI + x * x)).mean()
    nll = -(log_p + logdet)
    total = nll + logs_hinge * hinge / nel
    if actnorm_hinge > 0:
        total = total + actnorm_hinge * actnorm_penalty(params)
    return total, nll


@torch.no_grad()
def ddi(params: dict, model: dict, audio, mel, speakers=None) -> dict:
    """Every ActNorm set from its own input over one batch: b = -mean,
    logs = log(1 / (std + 1e-7)) / 3, over (batch, time)."""
    pr = Prec()
    c, g = _levels(pr, params, model, mel, speakers)
    x = audio.float()[..., None]
    blocks = []
    for bi in range(model["n_block"]):
        x, c = squeeze(x), squeeze(c)
        gk = _g_level(g, bi + 1)
        bs, ls = [], []
        for i in range(model["n_flow"]):
            fp = flow(params, bi, i)
            mean = x.mean(dim=(0, 1), keepdim=True)
            std = torch.sqrt(((x - mean) ** 2).mean(dim=(0, 1), keepdim=True))
            b, logs = -mean, torch.log(1.0 / (std + 1e-7)) / 3.0
            bs.append(b)
            ls.append(logs)
            x = (x + b) * torch.exp(3.0 * logs)
            xa, xb = x.chunk(2, -1)
            ga = None if gk is None else gk.chunk(2, -1)[0]
            log_s, t = wavenet(pr, fp["coupling"], xa, c.chunk(2, -1)[0],
                               ga).chunk(2, -1)
            x = torch.cat([xa, (xb - t) * torch.exp(-log_s)], -1)
            x, c = swap(x), swap(c)
            if gk is not None:
                gk = swap(gk)
        fl = params["blocks"][bi]["flows"]
        blocks.append({"flows": {**fl, "actnorm": {
            "b": torch.stack(bs), "logs": torch.stack(ls)}}})
    return {**params, "blocks": blocks}


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rebuild(v, it) for v in tree]
    return next(it)


class Adam:
    """Global-norm clip, then Adam with bias correction (eps outside the
    square root), then the learning rate."""

    def __init__(self, lr: float, clip: float, b1: float, b2: float,
                 eps: float):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.count = 0
        self.mu = self.nu = None

    def step(self, params: list, grads: list) -> tuple[list, list]:
        """(new params, the clipped gradients)."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if float(norm) >= self.clip:
            grads = [g / norm * self.clip for g in grads]
        if self.mu is None:
            self.mu = [torch.zeros_like(g) for g in grads]
            self.nu = [torch.zeros_like(g) for g in grads]
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * g * g + self.b2 * self.nu[i]
            upd = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2)
                                        + self.eps)
            out.append(p - self.lr * upd)
        return out, grads


def actnorm_penalty(params: dict):
    """The dead-zone hinge on the ActNorm scales, normalized per level."""
    pen = 0.0
    for bp in params["blocks"]:
        l3 = 3.0 * bp["flows"]["actnorm"]["logs"].float()
        pen = pen + (torch.relu(l3.abs() - HINGE_MARGIN) ** 2).sum() \
            / l3.shape[-1]
    return pen


def train_step(params: dict, opt: Adam, model: dict, batch: dict,
               pr: Prec | None = None, rows: int | None = None,
               logs_hinge: float = 1.0, actnorm_hinge: float = 1.0):
    """One step: (new params, loss total, nll, clipped gradient leaves).
    The batch's loss is a mean over its samples, so it runs ``rows`` rows
    at a time, each block's gradient weighted by its share of the rows."""
    flat = [p.detach().float().requires_grad_() for p in leaves(params)]
    tree = rebuild(params, iter(flat))
    B = batch["audio"].shape[0]
    rows = rows or B
    grads = [torch.zeros_like(p) for p in flat]
    total_v, nll_v = 0.0, 0.0

    def add(value):
        for acc, g in zip(grads, torch.autograd.grad(value, flat,
                                                     allow_unused=True)):
            if g is not None:
                acc += g

    for s in range(0, B, rows):
        sl = slice(s, s + rows)
        w = batch["audio"][sl].shape[0] / B
        spk = batch.get("speaker")
        tot, nll = loss(tree, model, batch["audio"][sl], batch["mel"][sl],
                        None if spk is None else spk[sl], pr=pr,
                        logs_hinge=logs_hinge, actnorm_hinge=0.0)
        add(tot * w)
        total_v += w * float(tot.detach())
        nll_v += w * float(nll.detach())
    if actnorm_hinge > 0:
        pen = actnorm_hinge * actnorm_penalty(tree)
        add(pen)
        total_v += float(pen.detach())
    with torch.no_grad():
        new, clipped = opt.step([p.detach() for p in flat], grads)
    return rebuild(params, iter(new)), total_v, nll_v, clipped
