"""Nested containers of tensors ("trees"): dicts, lists, tuples and
NamedTuples of leaves, walked in the JAX package's order (dict keys sorted,
sequences in order), so sums over leaves follow the same sequence."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, sep: str = "::") -> List[Tuple[str, Any]]:
    """[(path, leaf)] with paths like ``params::layers::0::attn::wq::w``."""
    if _is_leaf(tree):
        return [("", tree)]
    out = []
    for key, child in _children(tree):
        for path, leaf in leaves_with_paths(child, sep):
            out.append((key + (sep + path if path else ""), leaf))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if _is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}           # keep the key order
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        return type(t)(build(v) for v in t)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest) -> Any:            # noqa: A001
    """``fn`` over corresponding leaves of trees of one structure."""
    cols = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
