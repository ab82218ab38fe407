"""``repro_torch.tree``: lists flatten item by item in index order with
``"layers/0/..."`` paths, round-trip through ``unflatten``, and the port's
per-layer leaves group back into the reference's stacked leaves in its
(``jax.tree_util``'s) order."""
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.tree import (flatten_with_path, leaves,  # noqa: E402
                              stack_key, stacked_groups, tree_map, unflatten)


class Pair(NamedTuple):
    a: object
    b: object


def _tree():
    t = torch.arange
    return {"head": {"w": t(2)},
            "layers": [{"sub_0": {"n": t(3), "m": Pair(t(1), None)}},
                       {"sub_0": {"n": t(3) + 10, "m": Pair(t(1) + 10,
                                                            None)}}],
            "embed": {"w": t(4)},
            "step": (1, 2)}


def test_lists_flatten_in_index_order_with_their_paths():
    paths = [p for p, _ in flatten_with_path(_tree())]
    assert paths == ["embed/w", "head/w",
                     "layers/0/sub_0/m/.a", "layers/0/sub_0/m/.b",
                     "layers/0/sub_0/n",
                     "layers/1/sub_0/m/.a", "layers/1/sub_0/m/.b",
                     "layers/1/sub_0/n", "step"]
    assert leaves(_tree())[-1] == (1, 2)        # a plain tuple is a leaf


def test_unflatten_and_tree_map_round_trip_lists():
    tree = _tree()
    back = unflatten(tree, leaves(tree))
    assert isinstance(back["layers"], list) and len(back["layers"]) == 2
    assert isinstance(back["layers"][1]["sub_0"]["m"], Pair)
    for (p, a), (q, b) in zip(flatten_with_path(tree),
                              flatten_with_path(back)):
        assert p == q and (a is b)
    doubled = tree_map(lambda x: x * 2 if isinstance(x, torch.Tensor)
                       else x, tree)
    assert torch.equal(doubled["layers"][1]["sub_0"]["n"],
                       torch.tensor([20, 22, 24]))
    with pytest.raises(ValueError):
        unflatten(tree, leaves(tree) + [0])


def test_stacked_groups_are_the_reference_leaves_in_its_order():
    """The port's per-layer leaves group into the stacked leaves of the
    reference's tree, in jax.tree_util's order, each in layer order."""
    jax = pytest.importorskip("jax")
    tree = _tree()
    paths = [p for p, _ in flatten_with_path(tree)]
    assert stack_key("layers/3/sub_0/ffn/up/core_0") == \
        "layers/sub_0/ffn/up/core_0"
    groups = stacked_groups(paths)
    stacked = {"head": {"w": np.zeros(2)}, "embed": {"w": np.zeros(4)},
               "layers": {"sub_0": {"n": np.zeros((2, 3)),
                                    "m": {"a": np.zeros((2, 1)),
                                          "b": np.zeros((2, 1))}}},
               "step": np.zeros(2)}
    jpaths = ["/".join(str(getattr(k, "key", k)) for k in kp)
              for kp, _ in jax.tree_util.tree_flatten_with_path(stacked)[0]]
    assert [stack_key(paths[g[0]]).replace(".", "") for g in groups] == \
        jpaths
    assert groups[2] == [2, 5] and groups[4] == [4, 7]
    assert all(len(g) == 1 for i, g in enumerate(groups) if i not in (2, 3, 4))
