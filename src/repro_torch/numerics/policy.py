"""The §3.3 scale manager — the part of ``repro/numerics/policy.py`` the
training slice runs. Every managed pow-2 scale is a ``ScaleState``; the
manager nudges its exponent to keep the tracked mean |x / 2^k| inside a
target band. ``NumericsPolicy`` (the site -> QuantSpec map) comes with the
wire slice (ROADMAP queue 1).

All updates are device tensor ops (no host sync), so a training step that
runs them stays asynchronous.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ScaleState(NamedTuple):
    """Per-site dynamic pow-2 scale: k (log2 scale) and the tracked mean
    |x / 2^k| the manager drives into the target band."""
    log2: torch.Tensor       # int32 scalar
    mean_abs: torch.Tensor   # f32 scalar, EMA of mean |x| / 2^k


def init_scale(log2: int = 0, device=None) -> ScaleState:
    return ScaleState(torch.tensor(log2, dtype=torch.int32, device=device),
                      torch.tensor(0.2, dtype=torch.float32, device=device))


def _bump(log2: torch.Tensor, m: torch.Tensor, lo: float,
          hi: float) -> ScaleState:
    """k+1 when m is above the band, k-1 when below; m follows the bump."""
    up = (m > hi).to(torch.int32)        # too large -> coarser scale (k+1)
    dn = (m < lo).to(torch.int32)        # too small -> finer scale (k-1)
    # after a bump the tracked statistic halves/doubles accordingly
    return ScaleState(log2 + up - dn,
                      m * torch.exp2(-(up - dn).to(torch.float32)))


def update_scale(state: ScaleState, x: torch.Tensor, *, lo: float = 0.1,
                 hi: float = 0.3, ema: float = 0.9) -> ScaleState:
    """Track mean|x/2^k| and adjust k to hold it in [lo, hi] (paper
    §3.3). Reads ``x`` without gradient."""
    x = x.detach().float()
    m = torch.mean(torch.abs(x)) / torch.exp2(state.log2.float())
    m = ema * state.mean_abs + (1.0 - ema) * m
    return _bump(state.log2, m, lo, hi)


def update_from_stat(state: ScaleState, stat: torch.Tensor, *, lo: float,
                     hi: float, ema: float) -> ScaleState:
    """The same update from an already-normalised statistic (the probe
    cotangent mean|g|/2^k of a gradient edge)."""
    m = ema * state.mean_abs + (1.0 - ema) * stat
    return _bump(state.log2, m, lo, hi)


def step_log2(state: ScaleState, bits: int) -> torch.Tensor:
    """Grid step exponent of a managed scale: the representable range
    [-2^{b-1}, 2^{b-1}-1] * 2^{k-(b-1)} then covers ~2^k."""
    return state.log2.float() - (bits - 1)
