"""Unified LM, dense family — the port of ``repro/models/lm.py``.

Structure: embed -> per-layer sublayers (rms_norm -> GQA attention ->
residual -> rms_norm -> SwiGLU FFN -> residual) -> final norm -> head.
Where the reference stacks layer params on a leading axis for ``lax.scan``,
the port keeps a Python list of per-layer dicts (``params["layers"][l]``)
and loops; ``convert.params_from_jax`` unstacks a JAX tree into it.

Parameters are plain nested dicts of tensors with the reference's names,
so the two packages' trees correspond key for key. MoE, MLA and the
recurrent families are later slices and raise at ``build_lm``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as A
from . import ffn as F
from .common import SiteDef, apply_site, init_site, make_site, rms_norm, \
    torch_dtype


@dataclass(frozen=True)
class SubDef:
    mixer_kind: str          # "attn_gqa" (this slice)
    mixer: Any
    ffn_kind: str | None     # "ffn"
    ffn: Any


@dataclass(frozen=True)
class LMDef:
    cfg: ModelConfig
    embed: SiteDef
    head: SiteDef
    period: tuple[SubDef, ...]
    n_periods: int


def build_lm(cfg: ModelConfig) -> LMDef:
    """Dense/GQA stacks only; other families name the slice they wait for."""
    if cfg.family in ("ssm_rwkv6", "hybrid_jamba"):
        raise NotImplementedError(
            f"{cfg.family} sublayers (recurrent state) are a later slice "
            "(ROADMAP queue 1: models/ssm.py + serve/state_cache.py)")
    if cfg.moe.num_experts > 0:
        raise NotImplementedError("MoE FFNs are a later slice (ROADMAP "
                                  "queue 1: models/moe.py)")
    if cfg.attn_kind == "mla":
        raise NotImplementedError("MLA attention is a later slice (ROADMAP "
                                  "queue 1: attention.py MLA)")
    if cfg.frontend != "none":
        raise NotImplementedError("frontends are a later slice (ROADMAP "
                                  "queue 1: models/frontend.py)")
    sub = SubDef("attn_gqa", A.make_gqa(cfg), "ffn", F.make_ffn(cfg))
    embed = make_site(cfg, "embed", cfg.vocab_size, cfg.d_model)
    head = make_site(cfg, "head", cfg.vocab_size, cfg.d_model)
    return LMDef(cfg, embed, head, (sub,), cfg.num_layers)


def _init_sub(gen: torch.Generator, sub: SubDef, cfg: ModelConfig,
              device: torch.device) -> dict:
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
    return {"norm1": {"scale": ones.clone()},
            "mixer": A.init_gqa(gen, sub.mixer, cfg, device),
            "norm2": {"scale": ones.clone()},
            "ffn": F.init_ffn(gen, sub.ffn, cfg, device)}


def init_lm(gen: torch.Generator, lm: LMDef, device=None) -> dict:
    """Random weights with the reference's distributions (``lm.py:119``):
    embedding ``N(0, 1/d_model)``, dense sites ``N(0, 2/(in+out))``, norm
    scales 1. ``gen`` must live on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``). The numbers differ from a JAX
    init of the same seed — parity tests transfer weights instead."""
    device = resolve_device(device)
    cfg = lm.cfg
    if lm.embed.use_tt:
        raise NotImplementedError("TT embeddings are a later slice")
    sigma = 1.0 / math.sqrt(cfg.d_model)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=device, dtype=torch.float32) * sigma
    return {
        "embed": {"w": embed.to(torch_dtype(cfg.dtype))},
        "layers": [{f"sub_{i}": _init_sub(gen, sub, cfg, device)
                    for i, sub in enumerate(lm.period)}
                   for _ in range(lm.n_periods)],
        "final_norm": {"scale": torch.ones((cfg.d_model,), device=device)},
        "head": init_site(gen, lm.head, cfg, device),
    }


def embed_tokens(params: dict, tokens: torch.Tensor, lm: LMDef) -> torch.Tensor:
    return params["embed"]["w"][tokens.long()].to(torch_dtype(lm.cfg.dtype))


def _sub_forward(pp: dict, x: torch.Tensor, sub: SubDef, cfg: ModelConfig,
                 positions: torch.Tensor, return_cache: bool):
    """One sublayer (attention + FFN). Returns (x, cache_entry)."""
    h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
    q, k, v = A.gqa_qkv(pp["mixer"], h, sub.mixer, cfg, positions)
    out = A.chunked_attention(q, k, v, causal=not cfg.is_encoder)
    b, s = h.shape[:2]
    if sub.mixer.real_heads != sub.mixer.num_heads:
        out = out[:, :, :sub.mixer.real_heads]
    x = x + apply_site(pp["mixer"]["o"], out.reshape(b, s, -1), sub.mixer.o,
                       cfg)
    return sub_ffn_decode(pp, x, sub, cfg), ({"k": k, "v": v}
                                             if return_cache else {})


def lm_forward(params: dict, lm: LMDef, *, tokens: torch.Tensor,
               return_cache: bool = False):
    """Prefill forward. tokens: (B, S) int. Returns (logits, aux, cache):
    aux is 0 (no MoE in this slice); cache (when asked) is
    ``{"sub_i": {"k", "v"}}`` with leaves stacked over layers,
    (L, B, S, Hkv, Dh), the reference's layout."""
    cfg = lm.cfg
    x = embed_tokens(params, tokens, lm)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    caches: list[dict] = []
    for pp in params["layers"]:
        layer_cache = {}
        for i, sub in enumerate(lm.period):
            x, c = _sub_forward(pp[f"sub_{i}"], x, sub, cfg, positions,
                                return_cache)
            layer_cache[f"sub_{i}"] = c
        caches.append(layer_cache)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = apply_site(params["head"], x, lm.head, cfg)
    if cfg.logits_softcap > 0:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    cache = None
    if return_cache:
        cache = {key: {name: torch.stack([c[key][name] for c in caches])
                       for name in caches[0][key]}
                 for key in caches[0]}
    return logits, torch.zeros((), device=x.device), cache


def sub_ffn_decode(pp: dict, x: torch.Tensor, sub: SubDef,
                   cfg: ModelConfig) -> torch.Tensor:
    """Post-mixer FFN half of a sublayer (shared by prefill and decode)."""
    if sub.ffn_kind is None:
        return x
    h = rms_norm(x, pp["norm2"]["scale"], cfg.norm_eps)
    return x + F.ffn_forward(pp["ffn"], h, sub.ffn, cfg)
