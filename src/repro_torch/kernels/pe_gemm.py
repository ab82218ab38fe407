"""ctypes binding of ``csrc/ttm_pe.cu``: the strided, batched fp32-FMA
product ``C[z][m][n] = sum_k A[z][m][k] B[z][k][n]`` that the PE1 wrapper
(``ttm_pe1.py``) launches with its strides and optional requant epilogue.
PE2 and PE3 have kernels of their own (``ttm_pe2.py``, ``ttm_pe3.py``);
``launch`` stays generic so a caller can time this design at their shapes.
The library is built at the first launch, never at import."""
from __future__ import annotations

import ctypes

import torch

from . import build as B

SOURCE = "ttm_pe"
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
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


def check_operands(name: str, *ts: torch.Tensor) -> None:
    """Raise on what the kernel does not take: operands off the card, on
    two devices, of two dtypes, or of a dtype other than f32/bf16."""
    dev, dt = ts[0].device, ts[0].dtype
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name}: all operands must be on one CUDA device")
    if any(t.dtype != dt for t in ts) or dt not in DTYPE_CODE:
        raise TypeError(f"{name}: operands must share one dtype of "
                        f"{sorted(map(str, DTYPE_CODE))}, got "
                        f"{[str(t.dtype) for t in ts]}")


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
