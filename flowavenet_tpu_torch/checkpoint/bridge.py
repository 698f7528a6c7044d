"""Weights across the two packages.

The JAX package's params are a tree of nested dicts and lists with arrays
at the leaves (each block's flow axis stacked first); the port uses the
same tree with torch tensors.  Its checkpoints are npz files whose keys are
``jax.tree_util.keystr`` paths (``['blocks'][0]['flows']['actnorm']['b']``),
prefixed with ``.params`` when the saved tree was a ``TrainState``, plus a
``__meta__`` JSON entry.  This module converts trees both ways and reads and
writes that npz layout without JAX.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from ..utils.tree import tree_map

_META_KEY = "__meta__"
_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def to_torch(tree: Any, device="cpu", dtype: Optional[torch.dtype] = None
             ) -> Any:
    """numpy (or array-like) leaves -> torch tensors on ``device``
    (cast to ``dtype`` when given; values are copied bit for bit
    otherwise)."""
    def conv(a):
        t = torch.from_numpy(np.array(a, copy=True)).to(device)
        return t.to(dtype) if dtype is not None else t
    return tree_map(conv, tree)


def to_numpy(tree: Any) -> Any:
    """torch tensor leaves -> numpy arrays (bf16 leaves become fp32)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(conv, tree)


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """keystr path -> leaf, in the JAX package's key format."""
    out: dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}['{k}']")
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, f"{path}[{i}]")
        else:
            out[path] = node
    walk(tree, prefix)
    return out


def unflatten(flat: dict[str, Any]) -> Any:
    """Rebuild the nested dict/list tree from keystr paths."""
    root: dict = {}
    for key, leaf in flat.items():
        toks = [(m.group(1), m.group(2)) for m in _TOKEN.finditer(key)]
        if "".join(m.group(0) for m in _TOKEN.finditer(key)) != key:
            raise ValueError(f"not a dict/list keystr path: {key!r}")
        node = root
        for (name, idx), nxt in zip(toks, toks[1:] + [None]):
            k = name if name is not None else int(idx)
            child = leaf if nxt is None else node.get(k, {})
            node[k] = child
            node = child
    return _lists(root)


def _lists(node):
    """Turn dicts keyed 0..n-1 (from list indices) back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def save_params(path: str, params: Any, step: int = 0) -> str:
    """Atomically write a params tree as a JAX-layout npz (keys as
    ``flowavenet_tpu.checkpoint.save_checkpoint`` writes them for a bare
    params tree; bf16 leaves are stored as fp32)."""
    flat = flatten(to_numpy(params))
    meta = {"step": int(step), "keys": list(flat)}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat, **{_META_KEY: json.dumps(meta)})
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_params_npz(path: str) -> tuple[Any, int]:
    """Read the model params (numpy tree) and step from a JAX-layout npz:
    a bare params tree, or a ``TrainState`` whose ``.params`` subtree is
    taken and whose optimizer state is ignored."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META_KEY]))
        keys = [k for k in data.files if k != _META_KEY]
        if any(k.startswith(".params") for k in keys):
            flat = {k[len(".params"):]: data[k] for k in keys
                    if k.startswith(".params[")}
        else:
            flat = {k: data[k] for k in keys}
    return unflatten(flat), int(meta["step"])


_CKPT = re.compile(r"^ckpt-(\d+)\.npz$")


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest ``ckpt-<step>.npz`` in ``directory`` (the JAX trainer's
    naming), or None."""
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), os.path.join(directory, n))
             for n in os.listdir(directory) if (m := _CKPT.match(n))]
    return max(found)[1] if found else None
