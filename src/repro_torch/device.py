"""Device policy of the port's entry points: the card unless the caller
explicitly asks for the CPU. There is no silent fallback — a program that
was meant for the GPU and finds none fails instead of running slowly."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a usable card
    raises ``RuntimeError``; ``"cpu"`` must be asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
