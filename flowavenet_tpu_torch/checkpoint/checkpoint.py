"""Whole-train-state checkpoints in the JAX package's npz layout (twin of
``flowavenet_tpu/checkpoint/checkpoint.py``, without JAX).

A checkpoint is ``<dir>/<prefix>-<step>.npz``: every leaf under its
``jax.tree_util.keystr`` path plus a ``__meta__`` JSON entry.  For a
``TrainState`` the keys are ``.step``, ``.params[...]``,
``.opt_state[1].count``, ``.opt_state[1].mu[...]``, ``.opt_state[1].nu[...]``
and ``.opt_state[2].count``, the same as the JAX trainer writes, so either
package resumes the other's run.  Writes are atomic (temp file, then
rename) and old checkpoints are pruned.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

_META_KEY = "__meta__"


def _paths(tree: Any, prefix: str = ""):
    """(keystr path, leaf) pairs in the JAX package's flattening order:
    dict keys sorted, list/tuple items by index, NamedTuple fields by name
    (``.field``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}['{k}']")
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _paths(x, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    prefix: str = "ckpt", keep: int = 5,
                    extra_meta: Optional[dict] = None) -> str:
    """Atomically write ``<dir>/<prefix>-<step>.npz``; prune old ones."""
    os.makedirs(directory, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _paths(tree)}
    meta = {"step": int(step), "keys": list(flat.keys())}
    if extra_meta:
        meta.update(extra_meta)
    path = os.path.join(directory, f"{prefix}-{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat, **{_META_KEY: json.dumps(meta)})
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    for _, old in sorted(_list(directory, prefix))[:-keep]:
        os.unlink(old)
    return path


def _list(directory: str, prefix: str) -> list[tuple[int, str]]:
    pat = re.compile(rf"^{re.escape(prefix)}-(\d+)\.npz$")
    if not os.path.isdir(directory):
        return []
    return [(int(m.group(1)), os.path.join(directory, name))
            for name in os.listdir(directory) if (m := pat.match(name))]


def latest_checkpoint(directory: str, prefix: str = "ckpt") -> Optional[str]:
    ckpts = _list(directory, prefix)
    return max(ckpts)[1] if ckpts else None


def read_meta(path: str) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data[_META_KEY]))


def restore_checkpoint(path: str, target: Any) -> tuple[Any, int]:
    """Restore into the structure of ``target`` (each leaf keeps the
    target's dtype and device); returns (tree, step)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META_KEY]))
        vals = {}
        for key, leaf in _paths(target):
            if key not in data:
                raise KeyError(f"checkpoint {path} missing leaf {key!r} "
                               f"(saved keys: {len(meta['keys'])})")
            val = data[key]
            if tuple(val.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key!r}: checkpoint "
                                 f"{val.shape} vs target {tuple(leaf.shape)}")
            vals[key] = torch.from_numpy(np.array(val)).to(
                device=leaf.device, dtype=leaf.dtype)
    return _rebuild(target, vals), meta["step"]


def _rebuild(tree: Any, vals: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], vals, f"{prefix}['{k}']") for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(getattr(tree, n), vals, f"{prefix}.{n}")
                            for n in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, vals, f"{prefix}[{i}]")
                          for i, x in enumerate(tree))
    return vals[prefix]
