"""Parameter trees of the port: nested dicts and NamedTuples of tensors,
walked in ``jax.tree_util``'s order (dict keys sorted, NamedTuple fields in
declaration order) with its path strings (``"q_in/.act/.log2"``: a dict key
as itself, a NamedTuple field as ``.name``). ``None`` is a leaf."""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf), ...] in jax.tree_util's flattening order."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_path(tree[k], join(k))]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields
                for pl in flatten_with_path(getattr(tree, f), join("." + f))]
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(new_leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(rebuild(getattr(node, f))
                                for f in node._fields))
        return next(it)
    out = rebuild(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree) -> Any:
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
