"""Minimal pytree helpers for the nested dict/list parameter trees."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping dict/list/tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)

