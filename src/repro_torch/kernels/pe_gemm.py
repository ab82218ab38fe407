"""ctypes binding of ``csrc/ttm_pe.cu``: the strided, batched fp32-FMA
product ``C[z][m][n] = sum_k A[z][m][k] B[z][k][n]`` that served PE1, PE2
and PE3 before. It is on no path now: each PE has a kernel of its
own (``ttm_pe1.py``, ``ttm_pe2.py``, ``ttm_pe3.py``), and ``chip_smoke.py``
launches this one only to time the design they replaced (``previous_ms``);
no other module imports it. The library is built at the first launch, never
at import."""
from __future__ import annotations

import ctypes

import torch

from . import build as B
from .tt_contract import DTYPE_CODE

SOURCE = "ttm_pe"
GEOM_FIELDS = ("batch", "M", "N", "K1", "K2", "a_z", "a_m", "a_k1", "a_k2",
               "b_z", "b_n", "b_k1", "b_k2", "c_z", "c_m", "c_n")


def _lib() -> ctypes.CDLL:
    lib = B.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pe_gemm.argtypes = [p, p, p, i, ctypes.POINTER(ctypes.c_longlong),
                                i, p, i, p]
        lib.pe_gemm.restype = i
        lib._repro_typed = True
    return lib


def launch(name: str, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           geom: dict, step_log2=None, bits: int | None = None) -> None:
    """Launch the product on ``c``'s stream with element strides ``geom``
    (every key of ``GEOM_FIELDS``); ``bits`` turns on the pow-2 requant
    epilogue at ``step_log2``. Counts one launch of ``name``."""
    if bits is not None and not 2 <= bits <= 16:
        raise ValueError(f"{name}: epilogue bits must be 2..16, got {bits}")
    step = None if bits is None else torch.as_tensor(
        step_log2, dtype=torch.float32, device=c.device).reshape(1)
    lib = _lib()
    g = (ctypes.c_longlong * len(GEOM_FIELDS))(
        *(int(geom[k]) for k in GEOM_FIELDS))
    B.check(lib, lib.pe_gemm(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), DTYPE_CODE[c.dtype], g,
        int(bits is not None), None if step is None else step.data_ptr(),
        bits or 0, torch.cuda.current_stream(c.device).cuda_stream), name)
    B.note_launch(name)
