"""PE3 — the batched outer product that accumulates the full-weight
gradient (paper Appendix A.2):

    What(j, i) = sum_b  Ybar(b, j) * X(b, i)

The port of ``repro/kernels/ttm_pe3.py``. ``pe3_cuda`` launches the
hand-written kernel (``csrc/ttm_pe3.cu``: PE2's streamed contraction at
a = 1, Z = X and G = Ybar, launch plan from ``tt_contract.plan``);
``pe3_torch`` is its plain version. Both accumulate in f32 and return
Ybar's dtype.
"""
from __future__ import annotations

import torch

from . import tt_contract

NAME = "pe3"


def _shapes(ybar: torch.Tensor, x: torch.Tensor) -> tuple[int, int, int]:
    if ybar.dim() != 2 or x.dim() != 2 or ybar.shape[0] != x.shape[0]:
        raise ValueError(f"{NAME}: want Ybar (b,j) and X (b,i), got "
                         f"{tuple(ybar.shape)} and {tuple(x.shape)}")
    return ybar.shape[0], ybar.shape[1], x.shape[1]


def pe3_torch(ybar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    _shapes(ybar, x)
    acc_t = torch.promote_types(ybar.dtype, torch.float32)
    return torch.einsum("bj,bi->ji", ybar.to(acc_t), x.to(acc_t)
                        ).to(ybar.dtype)


def pe3_cuda(ybar: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    b, j, i = _shapes(ybar, x)
    tt_contract.check_operands(NAME, ybar, x)
    ybar, x = ybar.contiguous(), x.contiguous()
    out = torch.empty((j, i), dtype=ybar.dtype, device=ybar.device)
    tt_contract.check_sizes(NAME, ybar, x, out)
    tt_contract.launch(NAME, "ttm_pe3", x.view(1, b, i), ybar,
                       out.view(1, j, i))
    return out
