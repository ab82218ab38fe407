"""Dense SwiGLU FFN — the port of ``repro/models/ffn.py``:
``down(silu(gate(x)) * up(x))``, each matmul a weight site."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from .common import SiteDef, apply_site, init_site, make_site, silu


@dataclass(frozen=True)
class FFNDef:
    gate: SiteDef
    up: SiteDef
    down: SiteDef


def make_ffn(cfg: ModelConfig, d_ff: int | None = None) -> FFNDef:
    f = d_ff or cfg.d_ff
    return FFNDef(
        gate=make_site(cfg, "ffn", f, cfg.d_model),
        up=make_site(cfg, "ffn", f, cfg.d_model),
        down=make_site(cfg, "ffn", cfg.d_model, f),
    )


def init_ffn(gen: torch.Generator, d: FFNDef, cfg: ModelConfig,
             device: torch.device) -> dict:
    return {"gate": init_site(gen, d.gate, cfg, device),
            "up": init_site(gen, d.up, cfg, device),
            "down": init_site(gen, d.down, cfg, device)}


def ffn_forward(params: dict, x: torch.Tensor, d: FFNDef,
                cfg: ModelConfig) -> torch.Tensor:
    g = apply_site(params["gate"], x, d.gate, cfg)
    u = apply_site(params["up"], x, d.up, cfg)
    return apply_site(params["down"], silu(g) * u, d.down, cfg)
