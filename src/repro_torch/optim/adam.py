"""AdamW with f32 first/second moments — the port of ``repro/optim/
adam.py``. The block-wise int8 moments (``opt_state_dtype="int8"``) come
with the blockwise codec kernels (ROADMAP queue 2 items 3-4) and raise
here.

Leaf rule (``repro``'s ``_is_adam_leaf``, kept exactly): every floating
leaf except ``lambda_*`` (closed-form Eq. 4 update) and ``wscale*`` gets
moments. On the TT MLP that includes the ``ActQuant`` leaves
``q_*/.act/.mean_abs``, ``q_*/.grad/.mean_abs`` and ``q_*/.probe``: the
probes move (their gradient is the scale manager's statistic), the
``mean_abs`` leaves take no gradient and stay put.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.base import TrainConfig
from ..tree import flatten_with_path, leaves, unflatten


def _is_adam_leaf(path: str, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
        return False
    name = path.split("/")[-1]
    return not name.startswith(("lambda_", "wscale"))


def _check(cfg: TrainConfig) -> None:
    if cfg.opt_state_dtype != "float32":
        raise NotImplementedError(
            f"opt_state_dtype={cfg.opt_state_dtype!r}: block-wise int8 "
            "moments come with the blockwise codec slice (ROADMAP queue 1)")


class AdamState(NamedTuple):
    """Moments as tuples aligned with the flattened params tree (element
    = None | f32 tensor)."""
    step: torch.Tensor
    m: tuple
    v: tuple


def adam_leaf_paths(params) -> list[str]:
    """Paths of the leaves that get moments (and so a gradient)."""
    return [p for p, leaf in flatten_with_path(params)
            if _is_adam_leaf(p, leaf)]


def init_adam(params, cfg: TrainConfig) -> AdamState:
    _check(cfg)
    flat = flatten_with_path(params)
    m = tuple(torch.zeros(leaf.shape, dtype=torch.float32, device=leaf.device)
              if _is_adam_leaf(p, leaf) else None for p, leaf in flat)
    v = tuple(None if t is None else t.clone() for t in m)
    device = next(t.device for t in m if t is not None)
    return AdamState(torch.zeros((), dtype=torch.int32, device=device), m, v)


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr, cfg: TrainConfig):
    """Returns (new_params, new_state). ``grads`` mirrors ``params``; a
    ``None`` gradient leaves its parameter and moments unchanged (the
    zero-gradient update of a ``mean_abs`` leaf is the identity)."""
    _check(cfg)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    step = state.step + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(flatten_with_path(params), leaves(grads),
                                  state.m, state.v):
        if m is None or g is None:
            new_p.append(p)
            new_m.append(m)
            new_v.append(v)
            continue
        g32 = g.float()
        m32 = b1 * m + (1 - b1) * g32
        v32 = b2 * v + (1 - b2) * torch.square(g32)
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        name = path.split("/")[-1]
        decay = 0.0 if name in ("scale", "b", "bias") or p.dim() < 2 else wd
        p32 = p.float()
        p32 = p32 - lr * (update + decay * p32)
        new_p.append(p32.to(p.dtype))
        new_m.append(m32)
        new_v.append(v32)
    return (unflatten(params, new_p),
            AdamState(step, tuple(new_m), tuple(new_v)))
