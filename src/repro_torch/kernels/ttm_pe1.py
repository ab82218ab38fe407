"""PE1 — two-index contraction over the last dims of both operands (paper
Eq. 5), with the FPGA PE's optional requantize-on-writeback epilogue:

    Z'(a, d) = sum_{b, c}  Z(a, b, c) * G(b, d, c)

The port of ``repro/kernels/ttm_pe1.py``. ``pe1_cuda`` launches the
hand-written kernel (``csrc/ttm_pe.cu``: the (b, c) pair is a split
contraction index, so G needs no re-layout); ``pe1_torch`` is its plain
version (einsum + the codec's ``epilogue``), the CPU path and the
kernel's oracle on the card. Both accumulate in f32 (f64 inputs stay f64
in the plain version) and return Z's dtype.
"""
from __future__ import annotations

import torch

from ..numerics.codecs import Pow2Reference
from ..numerics.spec import QuantSpec
from . import pe_gemm

NAME = "pe1"


def _shapes(z: torch.Tensor, g: torch.Tensor) -> tuple[int, int, int, int]:
    if z.dim() != 3 or g.dim() != 3 or z.shape[1] != g.shape[0] \
            or z.shape[2] != g.shape[2]:
        raise ValueError(f"{NAME}: want Z (a,b,c) and G (b,d,c), got "
                         f"{tuple(z.shape)} and {tuple(g.shape)}")
    a, b, c = z.shape
    return a, b, c, g.shape[1]


def pe1_torch(z: torch.Tensor, g: torch.Tensor, step_log2=None,
              bits: int | None = None) -> torch.Tensor:
    _shapes(z, g)
    acc_t = torch.promote_types(z.dtype, torch.float32)
    acc = torch.einsum("abc,bdc->ad", z.to(acc_t), g.to(acc_t))
    if bits is not None:
        acc = Pow2Reference().epilogue(acc, QuantSpec("pow2", bits),
                                       step_log2)
    return acc.to(z.dtype)


def pe1_cuda(z: torch.Tensor, g: torch.Tensor, step_log2=None,
             bits: int | None = None) -> torch.Tensor:
    a, b, c, d = _shapes(z, g)
    pe_gemm.check_operands(NAME, z, g)
    z, g = z.contiguous(), g.contiguous()
    out = torch.empty((a, d), dtype=z.dtype, device=z.device)
    pe_gemm.launch(NAME, z, g, out, dict(
        batch=1, M=a, N=d, K1=b, K2=c,
        a_z=0, a_m=b * c, a_k1=c, a_k2=1,          # Z(a, b, c)
        b_z=0, b_n=c, b_k1=d * c, b_k2=1,          # G(b, d, c)
        c_z=0, c_m=d, c_n=1), step_log2, bits)
    return out
