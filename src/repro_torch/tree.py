"""Parameter trees of the port: nested dicts, lists and NamedTuples of
tensors, walked in ``jax.tree_util``'s order (dict keys sorted, list items
and NamedTuple fields in order) with its path strings
(``"q_in/.act/.log2"``: a dict key as itself, a NamedTuple field as
``.name``, a list item as its index). ``None`` and plain tuples are leaves.

Lists and the reference's stacked leaves. The zoo LM keeps one dict per
layer in ``params["layers"]``, where the reference stacks each per-layer
leaf on axis 0. So the port's flat order is, per layer in index order,
the reference's order inside ``layers``: reference leaf ``k`` of the
``n`` stacked ones (path ``layers/sub_0/...``) is the port's leaves
``layers/0/sub_0/...``, ``layers/1/sub_0/...``, ... at flat positions
``base + l * n + k``. The reference's stacked leaf is then the port's
group of one ``stack_key`` in layer order, concatenated on a new axis 0
(``stacked_groups``); leaves outside lists map one to one.
"""
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
    if isinstance(tree, list):
        return [pl for i, item in enumerate(tree)
                for pl in flatten_with_path(item, join(i))]
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
        if isinstance(node, list):
            return [rebuild(item) for item in node]
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


def stack_key(path: str) -> str:
    """The reference's path of a port leaf: list indices dropped
    (``"layers/3/sub_0/ffn/up/core_0"`` -> ``"layers/sub_0/ffn/up/core_0"``)."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


def stacked_groups(paths: list[str]) -> list[list[int]]:
    """Flat positions of the port's leaves grouped by ``stack_key``, one
    group per reference leaf in the reference's flattening order, each in
    layer order."""
    groups: dict[str, list[int]] = {}
    for i, p in enumerate(paths):
        groups.setdefault(stack_key(p), []).append(i)
    return list(groups.values())
