"""PE3 — the batched outer product that accumulates the full-weight
gradient (paper Appendix A.2):

    What(j, i) = sum_b  Ybar(b, j) * X(b, i)

The port of ``repro/kernels/ttm_pe3.py``. ``pe3_cuda`` launches one of
the hand-written kernels of ``csrc/ttm_pe3.cu``: PE2's contraction at
a = 1, Z = X and G = Ybar, by the same routes in the same order: bf16 with
even rows on the tensor cores (``pe3_mma_kernel``, ``tt_mma.plan``), f32
with at least ``tt_tile.MIN_FLOPS`` products on the CUDA cores as GEMM
tiles, split over a cluster's CTAs where the tiles are few
(``pe3_tile_kernel``, ``tt_tile.plan``), the rest on the CUDA cores
(``pe3_kernel``, ``tt_contract.plan``); all count as ``pe3`` launches.
A leading group axis (the experts of an MoE layer: Ybar (E, b, j), X (E,
b, i) -> (E, j, i)) runs in one launch of the tensor-core or the streamed
route. ``pe3_torch`` is the plain version. All accumulate in f32 and
return Ybar's dtype.
"""
from __future__ import annotations

import torch

from . import tt_contract, tt_mma, tt_tile

NAME = "pe3"


def _shapes(ybar: torch.Tensor, x: torch.Tensor) -> tuple[int, int, int]:
    lead = ybar.dim() - 2
    if lead not in (0, 1) or x.dim() != ybar.dim() \
            or ybar.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"{NAME}: want Ybar ([E,] b,j) and X ([E,] b,i), "
                         f"got {tuple(ybar.shape)} and {tuple(x.shape)}")
    return ybar.shape[-2], ybar.shape[-1], x.shape[-1]


def pe3_torch(ybar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _shapes(ybar, x)
    acc_t = torch.promote_types(ybar.dtype, torch.float32)
    return torch.einsum("...bj,...bi->...ji", ybar.to(acc_t), x.to(acc_t)
                        ).to(ybar.dtype)


def pe3_cuda(ybar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    b, j, i = _shapes(ybar, x)
    tt_contract.check_operands(NAME, ybar, x)
    ybar, x = ybar.contiguous(), x.contiguous()
    lead = tuple(ybar.shape[:-2])
    out = torch.empty(lead + (j, i), dtype=ybar.dtype, device=ybar.device)
    tt_contract.check_sizes(NAME, ybar, x, out)
    # PE2 at a = 1 for each group: Z = X (1, b, i), G = Ybar, O (1, j, i)
    z, o = x.view(lead + (1, b, i)), out.view(lead + (1, j, i))
    p = tt_mma.plan_for(z, ybar)
    if p is not None:
        tt_mma.launch(NAME, "ttm_pe3", p, z, ybar, o)
    elif (t := tt_tile.plan_for(z, ybar)) is not None:
        tt_tile.launch(NAME, "ttm_pe3", t, z, ybar, o)
    else:
        tt_contract.launch(NAME, "ttm_pe3", z, ybar, o)
    return out
