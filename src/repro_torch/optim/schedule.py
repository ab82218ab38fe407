"""LR schedules (pure functions of the step) — the port of
``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch

from ..configs.base import TrainConfig


def lr_at(step, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in f32 on ``step``'s device
    (a tensor step stays on the device: no host read)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    total = max(cfg.total_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(total - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)
