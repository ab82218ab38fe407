"""Parameter counts of a config without weights — the arithmetic of
``repro/launch/dryrun.py``'s ``count_params`` and ``active_params``, over
the shapes of ``init_lm(None, lm, device="meta")`` (no memory, no device).
The reference's mesh, HLO lowering and ``dryrun_cell`` are not carried
over: they describe a TPU pod compile.
"""
from __future__ import annotations

import math

from ..models.lm import LMDef, build_lm, init_lm
from ..tree import leaves


def count_params(tree) -> float:
    """Elements over every tensor of a params tree (a meta tree works)."""
    return float(sum(math.prod(t.shape) if t.shape else 1
                     for t in leaves(tree)))


def active_params(cfg, n_total: float, lm: LMDef | None = None) -> float:
    """Parameters a token touches: an MoE layer's full expert stack
    replaced by its ``top_k`` experts (the shared ones stay in the total),
    at 3 x d_model x d_ff an expert, as the reference counts it."""
    if cfg.moe.num_experts == 0:
        return n_total
    lmdef = lm or build_lm(cfg)
    moe_layers = sum(sub.ffn_kind == "moe" for sub in lmdef.period) \
        * lmdef.n_periods
    per_expert = 3 * cfg.d_model * cfg.d_ff
    return n_total - moe_layers * per_expert * (cfg.moe.num_experts
                                                - cfg.moe.top_k)


def meta_params(cfg) -> dict:
    """The params tree of ``cfg`` on the meta device: shapes, no memory."""
    return init_lm(None, build_lm(cfg), device="meta")

