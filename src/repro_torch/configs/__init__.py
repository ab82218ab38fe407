"""Config registry: ``get_config(arch)`` -> (ModelConfig, strategy),
``get_reduced(arch)`` for smoke tests; ``--tt`` variants via ``with_tt``."""
from __future__ import annotations

import importlib

from .base import (MLAConfig, MeshConfig, ModelConfig, MoEConfig, QuantConfig,
                   SHAPES, SSMConfig, ShapeConfig, TTConfig, TrainConfig)

ARCHS = {
    "hubert-xlarge": "hubert_xlarge",
    "yi-34b": "yi_34b",
    "granite-34b": "granite_34b",
    "internlm2-1.8b": "internlm2_1_8b",
    "stablelm-3b": "stablelm_3b",
    "jamba-1.5-large": "jamba_1_5_large",
    "llava-next-34b": "llava_next_34b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "moonshot-v1-16b": "moonshot_v1_16b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f".{ARCHS[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_strategy(arch: str) -> str:
    return getattr(_module(arch), "STRATEGY", "tp")


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def with_tt(cfg: ModelConfig, d: int = 3, max_rank: int = 16,
            apply_to=("ffn", "attn_qkv", "attn_o", "expert"),
            quantize: bool = False) -> ModelConfig:
    """The paper's technique switched on for any zoo config.

    Default sites: FFN/attention/expert projections. Embedding/head are NOT
    tensorized by default: vocab sizes with large prime factors (92544 =
    2^7·3·241) make the TTM chain cost explode (measured 26× the dense
    FLOPs at rank 64 — EXPERIMENTS.md §Perf, refuted-hypothesis entry);
    pass apply_to with "embed"/"head" explicitly for power-of-two-ish
    vocabs where it pays off. Default rank 16 (the paper's):
    TTM middle-core cost scales with R^2 — rank 32 measured 5x the
    dense-baseline FLOPs, rank 16 is near parity while cutting the
    projection parameter bytes ~40x (EXPERIMENTS.md §Perf)."""
    return cfg.replace(
        tt=TTConfig(enable=True, d=d, max_rank=max_rank, apply_to=apply_to),
        quant=QuantConfig(enable=quantize))


def valid_cells(arch: str) -> list[str]:
    """Assigned shape cells minus documented skips (DESIGN.md §4)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder:
        cells.append("decode_32k")
        if cfg.family in ("ssm_rwkv6", "hybrid_jamba"):
            cells.append("long_500k")
    return cells


ALL_CELLS = [(a, s) for a in ARCHS for s in valid_cells(a)]
