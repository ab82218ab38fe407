"""Shared model building blocks — the port of ``repro/models/common.py``.

Every matmul is a *weight site*: ``SiteDef`` + ``init_site`` +
``apply_site``, a dense matrix or the paper's TT-factorized,
rank-adaptive, optionally quantized layer, chosen by config
(``TTConfig.apply_to`` and ``min_elements``). Dense sites store ``w`` as
``(in, out)`` and compute ``y = x @ w`` as the reference does; TT sites
run ``core/tt_layer.py`` (the PE kernels and the cores' group fake-quant
on the card) and add the rank-shrinkage prior and the Eq. 4 λ update.

The reference's helpers take stacked (vmapped-over-layer) params; the
port keeps one dict per layer, so ``site_prior_loss`` and
``site_lambda_update`` take one layer's site, and the LM sums over layers.
An MoE layer's TT expert site is stacked over its E experts (cores ``(E,
R, J, I, R)``, λ ``(E, R)``): both take it whole, floor, mask and update
per expert, as the reference folds its stacked axes.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from ..core import quant as Q
from ..core import tt_layer as TL
from ..core.ttm import TTMSpec, make_spec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclass(frozen=True)
class SiteDef:
    """Static description of one weight site."""
    family: str              # one of configs.base.TT_SITES
    out_dim: int
    in_dim: int
    use_tt: bool
    spec: TTMSpec | None     # set when use_tt
    use_bias: bool = False


def make_site(cfg: ModelConfig, family: str, out_dim: int, in_dim: int,
              use_bias: bool = False) -> SiteDef:
    tt = cfg.tt
    use = (tt.enable and family in tt.apply_to
           and out_dim * in_dim >= tt.min_elements)
    spec = make_spec(out_dim, in_dim, tt.d, tt.max_rank) if use else None
    return SiteDef(family, out_dim, in_dim, use, spec, use_bias)


def init_site(gen: torch.Generator, site: SiteDef, cfg: ModelConfig,
              device: torch.device) -> dict:
    """TT site: ``tt_linear_init`` on the site's spec (cores, λ,
    ``wscale_log2``). Dense site: ``w ~ N(0, 2/(in+out))`` drawn in f32,
    stored (in, out) in the model dtype, zero bias ``b`` when the site has
    one. The reference's distributions, not its numbers."""
    dtype = torch_dtype(cfg.dtype)
    if site.use_tt:
        spec = site.spec
        params, _ = TL.tt_linear_init(
            gen, site.out_dim, site.in_dim, cfg.tt, dtype=dtype,
            use_bias=site.use_bias, j_dims=spec.j_dims, i_dims=spec.i_dims,
            ranks=spec.ranks, device=device)
        return params
    sigma = (2.0 / (site.in_dim + site.out_dim)) ** 0.5
    w = torch.randn((site.in_dim, site.out_dim), generator=gen,
                    device=device, dtype=torch.float32) * sigma
    p = {"w": w.to(dtype)}
    if site.use_bias:
        p["b"] = torch.zeros((site.out_dim,), dtype=dtype, device=device)
    return p


def apply_site(params: dict, x: torch.Tensor, site: SiteDef,
               cfg: ModelConfig) -> torch.Tensor:
    if site.use_tt:
        return TL.tt_linear_apply(params, x, site.spec, cfg.tt, cfg.quant)
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def site_prior_loss(params: dict, site: SiteDef,
                    cfg: ModelConfig) -> torch.Tensor:
    """Rank-shrinkage prior g(θ,λ) of one layer's site (0 for dense
    sites): ``gamma`` times Eq. 2 with λ detached and floored at
    max(PRIOR_REL_FLOOR · max λ, LAMBDA_FLOOR) per core, as the
    reference's per-stack-entry floor."""
    if not site.use_tt:
        return torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
    return TL.tt_prior_loss(params, site.spec, cfg.tt)


def site_lambda_update(params: dict, site: SiteDef, cfg: ModelConfig) -> dict:
    """Closed-form Eq. 4 λ update of one layer's site (dense: unchanged)."""
    if not site.use_tt:
        return params
    return TL.tt_lambda_update(params, site.spec, cfg.tt)


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


def quant_edge_maybe(x: torch.Tensor, qparams: dict | None, name: str,
                     cfg: ModelConfig) -> torch.Tensor:
    """Insert an (act_bits fwd, grad_bits bwd) quant point if QAT is on:
    ``qparams[name]`` is an ``ActQuant`` or a dict of its fields."""
    if not cfg.quant.enable or qparams is None or name not in qparams:
        return x
    site = qparams[name]
    if isinstance(site, dict):
        site = Q.ActQuant(*(site[k] for k in ("act", "grad", "probe")))
    return Q.quant_edge(x, site, cfg.quant.act_bits, cfg.quant.grad_bits)
