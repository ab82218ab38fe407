"""Modality frontends — the port of ``repro/models/frontend.py``, which is
a stub: the model takes precomputed frame (audio) or patch (vision)
embeddings. These helpers state their shapes and draw synthetic ones for
smoke runs; ``lm_forward(embeds=...)`` consumes them.

Where the reference returns ``jax.ShapeDtypeStruct`` specs, the port
returns (shape, dtype) pairs; the synthetic draws take a
``torch.Generator`` (standard normal in f32, cast), so their numbers
differ from a JAX key's.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig


def audio_frames_spec(cfg: ModelConfig, batch: int, seq: int, dtype):
    """HuBERT-style CNN feature extractor output: (B, S, d_model)."""
    return (batch, seq, cfg.d_model), dtype


def vision_patches_spec(cfg: ModelConfig, batch: int, n_patches: int, dtype):
    """LLaVA-NeXT anyres tiling output after the projector: (B, P,
    d_model)."""
    return (batch, n_patches, cfg.d_model), dtype


def synth_audio_frames(gen: torch.Generator, cfg: ModelConfig, batch: int,
                       seq: int, dtype) -> torch.Tensor:
    return torch.randn((batch, seq, cfg.d_model), generator=gen,
                       device=gen.device, dtype=torch.float32).to(dtype)


def synth_vision_patches(gen: torch.Generator, cfg: ModelConfig, batch: int,
                         n: int, dtype) -> torch.Tensor:
    return torch.randn((batch, n, cfg.d_model), generator=gen,
                       device=gen.device, dtype=torch.float32).to(dtype)
