"""Seeded random weights in the measured package's parameter layout.

The tree is the one ``init_flowavenet`` builds (nested dicts and lists,
the flow axis of each block stacked first), laid out here from the
configuration's sizes alone.  Every leaf is a view into one of two flat
buffers drawn on the device in two calls (uniform and normal) from a
``torch.Generator`` seeded by the run's seed, so the same seed gives the
same weights on either side of a comparison.

Unlike a fresh init, the zero convolutions and the ActNorms are drawn
non-zero (a trained model's are): with zero convs every coupling would be
the identity and synthesis a reshuffle of the noise.  The ActNorm scales
are centred so that 48 flows shrink the noise about tenfold, as a trained
vocoder's do, which keeps the audio inside 16-bit range.
"""

from __future__ import annotations

import math

import torch

# (kind, parameters) of each leaf's distribution:
#   ("uniform", a): U(-a, a); ("normal", (mean, sd)); ("const", value)
ZERO_W_SD = 0.01
ZERO_B_SD = 0.01
ACTNORM_B_SD = 0.01
ACTNORM_LOGS = (0.016, 0.01)


def _he(fan_in: int) -> tuple:
    return ("uniform", math.sqrt(6.0 / fan_in))


def _wn_conv(nf: int, k: int, cin: int, cout: int) -> dict:
    """Weight-normalized conv leaves, stacked over ``nf`` flows."""
    return {"v": ((nf, k, cin, cout), _he(k * cin)),
            "g": ((nf, cout), ("const", 1.0)),
            "b": ((nf, cout), _he(cout))}


def layout(model: dict) -> dict:
    """The parameter tree of ``model`` (the config file's ``model``
    section) as {leaf: (shape, distribution)}."""
    nf, R, nl = model["n_flow"], model["filter_size"], model["n_layer"]
    gin = max(model["gin_channels"], 0)
    tree: dict = {"upsample": [
        {"v": ((2 * s, 3, 1, 1), _he(2 * s * 3)),
         "g": ((1,), ("const", 1.0)), "b": ((1,), ("const", 0.0))}
        for s in model["upsample_scales"]]}
    if gin:
        n_sp = model["n_speakers"]
        tree["speaker_emb"] = ((n_sp, gin),
                               ("uniform", math.sqrt(6.0 / (n_sp + gin))))
    blocks = []
    in_ch, cin_ch, g_ch = 1, model["num_mels"], gin
    out_ch = 2 * in_ch
    for _ in range(model["n_block"]):
        sq = 2 * in_ch
        out_ch = sq if model["affine"] else sq // 2
        layers = []
        for _ in range(nl):
            layer = {"filter": _wn_conv(nf, 3, R, R),
                     "gate": _wn_conv(nf, 3, R, R),
                     "filter_c": _wn_conv(nf, 1, cin_ch, R),
                     "gate_c": _wn_conv(nf, 1, cin_ch, R),
                     "res": _wn_conv(nf, 1, R, R),
                     "skip": _wn_conv(nf, 1, R, R)}
            if g_ch:
                layer["filter_g"] = _wn_conv(nf, 1, g_ch, R)
                layer["gate_g"] = _wn_conv(nf, 1, g_ch, R)
            layers.append(layer)
        coupling = {
            "front": _wn_conv(nf, 3, in_ch, R),
            "layers": layers,
            "final": _wn_conv(nf, 1, R, R),
            "zero": {"w": ((nf, 1, R, out_ch), ("normal", (0.0, ZERO_W_SD))),
                     "b": ((nf, out_ch), ("normal", (0.0, ZERO_B_SD))),
                     "scale": ((nf, out_ch), ("const", 0.0))}}
        actnorm = {"b": ((nf, 1, 1, sq), ("normal", (0.0, ACTNORM_B_SD))),
                   "logs": ((nf, 1, 1, sq), ("normal", ACTNORM_LOGS))}
        blocks.append({"flows": {"actnorm": actnorm, "coupling": coupling}})
        in_ch, cin_ch, g_ch = 2 * in_ch, 2 * cin_ch, 2 * g_ch
    tree["blocks"] = blocks
    return tree


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn) for v in tree]
    return fn(tree)


def _leaf_specs(tree) -> list:
    out: list = []
    _walk(tree, out.append)
    return out


def make(model: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The weights of ``model`` for ``seed`` on ``device``, cast to
    ``dtype`` (bf16 as synthesis serves them, fp32 for training)."""
    tree = layout(model)
    specs = _leaf_specs(tree)
    n_u = sum(math.prod(s) for s, d in specs if d[0] == "uniform")
    n_n = sum(math.prod(s) for s, d in specs if d[0] == "normal")
    gen = torch.Generator(device).manual_seed(int(seed))
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nrm = torch.randn(n_n, generator=gen, device=device)
    pos = {"uniform": 0, "normal": 0}

    def leaf(spec):
        shape, (kind, arg) = spec
        n = math.prod(shape)
        if kind == "const":
            t = torch.full(shape, float(arg), device=device)
        else:
            src = uni if kind == "uniform" else nrm
            t = src[pos[kind]: pos[kind] + n].view(shape)
            pos[kind] += n
            t = t * arg if kind == "uniform" else t * arg[1] + arg[0]
        return t.to(dtype)

    return _walk(tree, leaf)


def n_params(model: dict) -> int:
    return sum(math.prod(s) for s, _ in _leaf_specs(layout(model)))


def map_leaves(fn, tree):
    return _walk(tree, fn)


def leaf_paths(model: dict) -> list:
    """Each leaf's path in the tree, in leaf order."""
    out: list = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            out.append(path[1:])
    walk(layout(model), "")
    return out
