"""Seeded random weights in the measured package's parameter layout.

A configuration's model family (``fwbench/families/``, named by its
``reference`` key) lays the tree out from the ``model`` section's sizes.
Every leaf is a view into one of two flat buffers drawn on the device in
two calls (uniform and normal) from a ``torch.Generator`` seeded by the
run's seed, so the same seed gives the same weights on either side of a
comparison.
"""

from __future__ import annotations

import math

import torch

from . import families


def layout(config: dict) -> dict:
    """The parameter tree of a configuration file's model as {leaf:
    (shape, distribution)}, laid out by its family."""
    return families.of(config).layout(config["model"])


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


def make(config: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The weights of a configuration file's model for ``seed`` on
    ``device``, cast to ``dtype`` (bf16 as synthesis serves them, fp32 for
    training)."""
    tree = layout(config)
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


def n_params(config: dict) -> int:
    return sum(math.prod(s) for s, _ in _leaf_specs(layout(config)))


def map_leaves(fn, tree):
    return _walk(tree, fn)


def leaf_paths(config: dict) -> list:
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
    walk(layout(config), "")
    return out
