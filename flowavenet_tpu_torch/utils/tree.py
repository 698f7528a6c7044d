"""Minimal pytree helpers for the nested dict/list parameter trees."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping dict/list/tuple/NamedTuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):          # NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``tree_map`` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def rebuild(template: Any, new_leaves) -> Any:
    """``template``'s structure with ``new_leaves`` (in ``leaves`` order)."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), template)



def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``tree_map`` of ``fn(path, leaf)``, with each leaf's path in
    ``jax.tree_util.keystr`` form (``['key']``, ``[i]``, ``.field``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}['{k}']")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):              # NamedTuple
        return type(tree)(*[tree_map_with_path(fn, getattr(tree, n),
                                               f"{prefix}.{n}")
                            for n in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, f"{prefix}[{i}]")
                          for i, t in enumerate(tree))
    return fn(prefix, tree)
