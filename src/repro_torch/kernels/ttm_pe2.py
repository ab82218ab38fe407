"""PE2 — single-index contraction over a middle dim (paper Eq. 6):

    Z'(a, d, c) = sum_b  Z(a, b, c) * G(b, d)

The port of ``repro/kernels/ttm_pe2.py``. ``pe2_cuda`` launches the
hand-written kernel (``csrc/ttm_pe2.cu``: slabs Z[a] streamed through
shared memory with G, launch plan from ``tt_contract.plan``);
``pe2_torch`` is its plain version. Both accumulate in f32 and return
Z's dtype.
"""
from __future__ import annotations

import torch

from . import pe_gemm, tt_contract

NAME = "pe2"


def _shapes(z: torch.Tensor, g: torch.Tensor) -> tuple[int, int, int, int]:
    if z.dim() != 3 or g.dim() != 2 or z.shape[1] != g.shape[0]:
        raise ValueError(f"{NAME}: want Z (a,b,c) and G (b,d), got "
                         f"{tuple(z.shape)} and {tuple(g.shape)}")
    a, b, c = z.shape
    return a, b, c, g.shape[1]


def pe2_torch(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _shapes(z, g)
    acc_t = torch.promote_types(z.dtype, torch.float32)
    return torch.einsum("abc,bd->adc", z.to(acc_t), g.to(acc_t)).to(z.dtype)


def pe2_cuda(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    a, b, c, d = _shapes(z, g)
    pe_gemm.check_operands(NAME, z, g)
    z, g = z.contiguous(), g.contiguous()
    out = torch.empty((a, d, c), dtype=z.dtype, device=z.device)
    tt_contract.check_sizes(NAME, z, g, out)
    tt_contract.launch(NAME, "ttm_pe2", z, g, out)
    return out
