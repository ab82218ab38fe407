"""Shared model building blocks — the port of ``repro/models/common.py``.

Every matmul is a *weight site*: ``SiteDef`` + ``init_site`` +
``apply_site``. Dense sites store ``w`` as ``(in, out)`` and compute
``y = x @ w`` as the reference does. TT-factorized sites (the paper's
technique) come with the training slice and raise here; biased sites
(only the SSM's ``dt_proj`` in the reference) come with the SSM slice.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclass(frozen=True)
class SiteDef:
    """Static description of one weight site."""
    family: str
    out_dim: int
    in_dim: int
    use_tt: bool


def make_site(cfg: ModelConfig, family: str, out_dim: int,
              in_dim: int) -> SiteDef:
    tt = cfg.tt
    use = (tt.enable and family in tt.apply_to
           and out_dim * in_dim >= tt.min_elements)
    return SiteDef(family, out_dim, in_dim, use)


def _no_tt(site: SiteDef) -> None:
    if site.use_tt:
        raise NotImplementedError(
            f"TT-factorized {site.family!r} site: the TT layer is ported "
            "with the training slice (ROADMAP queue 1)")


def init_site(gen: torch.Generator, site: SiteDef, cfg: ModelConfig,
              device: torch.device) -> dict:
    """Dense site: ``w ~ N(0, 2/(in+out))`` drawn in f32, stored (in, out)
    in the model dtype (the reference's distribution, not its numbers)."""
    _no_tt(site)
    sigma = (2.0 / (site.in_dim + site.out_dim)) ** 0.5
    w = torch.randn((site.in_dim, site.out_dim), generator=gen,
                    device=device, dtype=torch.float32) * sigma
    return {"w": w.to(torch_dtype(cfg.dtype))}


def apply_site(params: dict, x: torch.Tensor, site: SiteDef,
               cfg: ModelConfig) -> torch.Tensor:
    _no_tt(site)
    return x @ params["w"].to(x.dtype)


# ---------------------------------------------------------------------------
# Norms / rotary / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


@functools.lru_cache(maxsize=None)
def _log_f32(theta: float) -> float:
    """log(theta) evaluated in float32 (as the reference's ``jnp.log``),
    on the host: a device tensor here would cost a host-device round trip
    per call."""
    return torch.log(torch.tensor(theta, dtype=torch.float32)).item()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half * _log_f32(theta))
    ang = positions.float()[..., None] * freqs                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
