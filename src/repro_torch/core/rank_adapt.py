"""Rank-adaptive tensorized training (paper §3.1, Eqs. 1-2 and 4) — the
port of ``repro/core/rank_adapt.py``.

The loss adds g(θ, λ) = Σ_{n=1}^{d-1} Σ_{r}  ‖G_n(:,:,:,r)‖_F² / λ_n(r)
                                         + (1 + R_{n-1} I_n J_n)/2 · log λ_n(r)

(negative log-posterior of the Hawkins-Liu-Zhang Bayesian model). λ is
updated in closed form each step (Eq. 4):

    λ_n(r) = 2 / (1 + R_{n-1} I_n J_n) · ‖G_n(:,:,:,r)‖_F²

which is exactly the stationary point of g in λ. Slices whose λ collapses
toward 0 are pruned (masked during training; physically sliced at export).
Everything here is device tensor ops except ``effective_ranks``, which
returns Python ints.

Stacked cores (a leading group axis: an MoE layer's E experts, cores ``(E,
R, J, I, R)``, λ ``(E, R)``) are E sites side by side, as the reference's
vmap computes them: every max, mask, floor and norm is per group row.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .ttm import TTMSpec


def slice_sqnorms(core: torch.Tensor) -> torch.Tensor:
    """‖G_n(:,:,:,r)‖_F² for every r along the last (rank) axis -> (R_n,);
    stacked (E, ...) -> (E, R_n)."""
    return torch.sum(torch.square(core.float()), dim=(-4, -3, -2))


def group_size(spec: TTMSpec, n: int) -> int:
    """1 + R_{n-1} I_n J_n for core n (0-based)."""
    return 1 + spec.ranks[n] * spec.i_dims[n] * spec.j_dims[n]


# λ is floored to keep the prior gradient 2·G/λ bounded once a slice has
# collapsed (otherwise 1/λ → ∞ and SGD diverges; the floor turns the pull
# on dead slices into a stable exponential decay).
LAMBDA_FLOOR = 1e-8

# The absolute floor alone cannot deliver that stability: λ tracks the
# slice's squared norm (Eq. 4), so by the time λ reaches any fixed absolute
# floor the pull 2·G/λ has long exceeded the SGD stability limit — the
# slice overshoots zero, flips sign and *revives*. The prior therefore also
# floors λ RELATIVE to the core's largest λ: slices below
# PRIOR_REL_FLOOR · max λ are "dead" (the same relative scale
# ``rank_masks`` prunes at), and their pull saturates at a bounded,
# monotone exponential decay instead of growing without bound.
PRIOR_REL_FLOOR = 1e-2


def _prior_floor(lam: torch.Tensor) -> torch.Tensor:
    """λ as seen by the prior: floored at max(PRIOR_REL_FLOOR·max λ,
    LAMBDA_FLOOR) so the dead-slice pull is bounded and scale-free; the max
    of each group row where λ is stacked."""
    top = torch.amax(lam, dim=-1, keepdim=True)
    return torch.maximum(lam, torch.clamp(PRIOR_REL_FLOOR * top,
                                          min=LAMBDA_FLOOR))


def init_lambdas(spec: TTMSpec, device=None) -> list[torch.Tensor]:
    """λ_n for n = 0..d-2 (no λ for the last core: R_d == 1)."""
    return [torch.ones((spec.ranks[n + 1],), dtype=torch.float32,
                       device=device) for n in range(spec.d - 1)]


def update_lambdas(cores: Sequence[torch.Tensor], spec: TTMSpec,
                   eps: float = LAMBDA_FLOOR) -> list[torch.Tensor]:
    """Closed-form λ update (Eq. 4), floored for numerical stability."""
    return [torch.clamp(2.0 / group_size(spec, n)
                        * slice_sqnorms(cores[n].detach()), min=eps)
            for n in range(spec.d - 1)]


def prior_loss(cores: Sequence[torch.Tensor], lambdas: Sequence[torch.Tensor],
               spec: TTMSpec) -> torch.Tensor:
    """g(θ, λ) (Eq. 2). λ is a constant within the SGD step (detached),
    matching the paper's alternating update: SGD on θ, closed-form on λ."""
    total = torch.zeros((), dtype=torch.float32, device=cores[0].device)
    for n in range(spec.d - 1):
        lam = _prior_floor(lambdas[n].detach())
        sq = slice_sqnorms(cores[n])
        c = 0.5 * group_size(spec, n)
        total = total + torch.sum(sq / lam + c * torch.log(lam))
    return total


def rank_masks(lambdas: Sequence[torch.Tensor],
               threshold: float) -> list[torch.Tensor]:
    """Binary keep-masks per adapted rank: keep r if λ(r) > threshold·max λ
    (the max of each group row where λ is stacked)."""
    return [(lam > threshold * torch.amax(lam, dim=-1, keepdim=True)).float()
            for lam in lambdas]


def apply_masks(cores: Sequence[torch.Tensor],
                masks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Zero out pruned rank slices: mask n applies to core n's last axis
    (one multiply suffices for the matvec product); a stacked mask (E, R)
    to each group's core."""
    out = list(cores)
    for n, m in enumerate(masks):
        out[n] = out[n] * m[..., None, None, None, :].to(out[n].dtype)
    return out


def effective_ranks(lambdas: Sequence[torch.Tensor],
                    threshold: float) -> list[int]:
    return [int(torch.sum(lam > threshold * torch.max(lam)))
            for lam in lambdas]


def compress_cores(cores: Sequence[torch.Tensor],
                   lambdas: Sequence[torch.Tensor], spec: TTMSpec,
                   threshold: float) -> tuple[list[torch.Tensor], TTMSpec]:
    """Physically slice away pruned ranks (export / checkpoint path)."""
    d = spec.d
    keep = [torch.nonzero(lam > threshold * torch.max(lam))[:, 0]
            for lam in lambdas]
    new_cores = []
    new_ranks = [1]
    for n in range(d):
        c = cores[n]
        if n > 0:
            c = torch.index_select(c, 0, keep[n - 1])
        if n < d - 1:
            c = torch.index_select(c, 3, keep[n])
        new_cores.append(c)
        new_ranks.append(c.shape[3])
    return new_cores, TTMSpec(spec.j_dims, spec.i_dims, tuple(new_ranks))


def tt_memory_bits(spec: TTMSpec, weight_bits: int,
                   eff_ranks: list[int] | None = None) -> int:
    """Model-parameter memory in bits (paper Table 1 accounting)."""
    ranks = list(spec.ranks)
    if eff_ranks is not None:
        ranks = [1] + [int(r) for r in eff_ranks] + [1]
    total = 0
    for n in range(spec.d):
        total += ranks[n] * spec.j_dims[n] * spec.i_dims[n] * ranks[n + 1]
    return total * weight_bits
