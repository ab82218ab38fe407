"""PE2 — single-index contraction over a middle dim (paper Eq. 6):

    Z'(a, d, c) = sum_b  Z(a, b, c) * G(b, d)

The port of ``repro/kernels/ttm_pe2.py``. ``pe2_cuda`` launches one of
the hand-written kernels of ``csrc/ttm_pe2.cu``, by the first route whose
plan takes the dtype, shapes and alignment: bf16 with even rows on the
tensor cores (``pe2_mma_kernel``, ``tt_mma.plan``); f32 with at least
``tt_tile.MIN_FLOPS`` products as register-tiled GEMM tiles over (slab,
column) rows on the CUDA cores (``pe2_tile_kernel``, ``tt_tile.plan``);
everything else on the CUDA cores as slabs Z[a] streamed through shared
memory with G (``pe2_kernel``, ``tt_contract.plan``). All count as ``pe2``
launches. A leading group axis (the experts of an MoE layer: Z (E, a,
b, c), G (E, b, d) -> (E, a, d, c)) runs in one launch of the tensor-core
or the streamed route (the tile route takes no group). ``pe2_torch`` is
the plain version. All accumulate in f32 and return Z's dtype.
"""
from __future__ import annotations

import torch

from . import tt_contract, tt_mma, tt_tile

NAME = "pe2"


def _shapes(z: torch.Tensor, g: torch.Tensor) -> tuple[int, int, int, int]:
    lead = z.dim() - 3
    if lead not in (0, 1) or g.dim() != 2 + lead \
            or z.shape[:lead] != g.shape[:lead] or z.shape[-2] != g.shape[-2]:
        raise ValueError(f"{NAME}: want Z ([E,] a,b,c) and G ([E,] b,d), "
                         f"got {tuple(z.shape)} and {tuple(g.shape)}")
    a, b, c = z.shape[-3:]
    return a, b, c, g.shape[-1]


def pe2_torch(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _shapes(z, g)
    acc_t = torch.promote_types(z.dtype, torch.float32)
    return torch.einsum("...abc,...bd->...adc", z.to(acc_t),
                        g.to(acc_t)).to(z.dtype)


def pe2_cuda(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    a, b, c, d = _shapes(z, g)
    tt_contract.check_operands(NAME, z, g)
    z, g = z.contiguous(), g.contiguous()
    out = torch.empty(z.shape[:-3] + (a, d, c), dtype=z.dtype,
                      device=z.device)
    tt_contract.check_sizes(NAME, z, g, out)
    p = tt_mma.plan_for(z, g)
    if p is not None:
        tt_mma.launch(NAME, "ttm_pe2", p, z, g, out)
    elif (t := tt_tile.plan_for(z, g)) is not None:
        tt_tile.launch(NAME, "ttm_pe2", t, z, g, out)
    else:
        tt_contract.launch(NAME, "ttm_pe2", z, g, out)
    return out
