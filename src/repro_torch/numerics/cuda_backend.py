"""CUDA codec backend: the row-scale pow-2 encode/decode kernels of
``kernels/csrc/pow2_rows.cu`` and the scalar-scale fake-quant kernel of
``kernels/csrc/pow2_fq.cu`` behind the ``encode / decode / fake_quant``
API of the reference codec — the port of
``repro/numerics/pallas_backend.py``'s multi-scale (row-scale) codec and
its scalar fake-quant.

A scale that follows the ``codecs._bcast`` convention (one scale per
leading index, e.g. the KV pool's per-(layer, slot) arrays) collapses the
data to a contiguous ``(rows, cols)`` view with one f32 ``scale_log2`` per
row (``_rowwise``), and one kernel launch encodes or decodes it.

Routing is by the tensor's device, never by a fallback: a CPU tensor runs
the kernel's plain version (``encode_rows_plain`` / ``decode_rows_plain``);
a CUDA tensor launches the kernel, and anything the kernel does not take (a
scale that is not one value per leading index, storage wider than int8, an
unsupported dtype) raises. A one-element scale is one row: the value the
reference's scalar-scale kernels compute, through the row kernel.

``fake_quant`` takes a one-element scale only (the TT cores' fixed
per-core steps and the managed activation/gradient edges): that launches
``p2_fake_quant``, with the clipped STE's mask computed outside the
kernel, as in the Pallas backend. A scale per leading index is the
row-scale fake-quant of ROADMAP queue 2 item 2 and raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import build as B
from .codecs import Pow2Reference, pow2_fake_quant, pow2_qdq, register_codec
from .spec import QTensor, QuantSpec, qrange

ENC = "p2_enc_rows"
DEC = "p2_dec_rows"
SOURCE = "pow2_rows"
FQ = "p2_fake_quant"
FQ_SOURCE = "pow2_fq"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FQ_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _rowwise(x: torch.Tensor, scale) -> tuple[torch.Tensor, torch.Tensor] | None:
    """View (x, scale) as (rows, cols) with one scale per row.

    After stripping trailing length-1 dims, ``scale.shape`` must broadcast
    against the same number of *leading* dims of ``x`` (each dim equal or
    1). A one-element scale (a scalar, or a pool with one layer or one slot)
    makes the whole tensor one row. Returns (x2d, scale_row) or None when
    the convention doesn't hold."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if scale.numel() == 1:
        return x.reshape(1, -1), scale.reshape(1)
    sh = list(scale.shape)
    while sh and sh[-1] == 1:
        sh.pop()
    if not sh or len(sh) > x.dim():
        return None
    lead = tuple(x.shape[:len(sh)])
    if any(s not in (1, d) for s, d in zip(sh, lead)):
        return None
    rows = 1
    for d in lead:
        rows *= d
    srow = torch.broadcast_to(scale.reshape(sh), lead).reshape(rows)
    return x.reshape(rows, -1), srow


# ---- plain versions (the CPU path, and the kernels' oracle on the card) ----

def encode_rows_plain(x2d: torch.Tensor, srow: torch.Tensor,
                      bits: int) -> torch.Tensor:
    lo, hi = qrange(bits)
    step = torch.exp2(srow.float())[:, None]
    return torch.clamp(torch.round(x2d.float() / step), lo, hi).to(torch.int8)


def decode_rows_plain(q2d: torch.Tensor, srow: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    return (q2d.float() * torch.exp2(srow.float())[:, None]).to(dtype)


# ---- kernel wrappers ------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = B.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.p2_enc_rows.argtypes = [p, i, p, p, ll, ll, i, p]
        lib.p2_enc_rows.restype = i
        lib.p2_dec_rows.argtypes = [p, p, p, i, ll, ll, p]
        lib.p2_dec_rows.restype = i
        lib._repro_typed = True
    return lib


def _check_operands(x2d: torch.Tensor, srow: torch.Tensor) -> torch.Tensor:
    if x2d.dim() != 2 or srow.shape != (x2d.shape[0],):
        raise ValueError(f"want (rows, cols) data and (rows,) scales, got "
                         f"{tuple(x2d.shape)} and {tuple(srow.shape)}")
    if srow.device != x2d.device:
        raise ValueError("data and scales must be on one device")
    return srow.to(torch.float32).contiguous()


def encode_rows(x2d: torch.Tensor, srow: torch.Tensor,
                bits: int) -> torch.Tensor:
    """int8 codes of a (rows, cols) tensor with one scale_log2 per row."""
    srow = _check_operands(x2d, srow)
    if not x2d.is_cuda:
        return encode_rows_plain(x2d, srow, bits)
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"{ENC}: unsupported input dtype {x2d.dtype}")
    if not 2 <= bits <= 8:
        raise ValueError(f"{ENC}: int8 storage holds 2..8 bits, got {bits}")
    x2d = x2d.contiguous()
    q = torch.empty(x2d.shape, dtype=torch.int8, device=x2d.device)
    lib = _lib()
    B.check(lib, lib.p2_enc_rows(
        x2d.data_ptr(), _DTYPE_CODE[x2d.dtype], srow.data_ptr(), q.data_ptr(),
        x2d.shape[0], x2d.shape[1], bits,
        torch.cuda.current_stream(x2d.device).cuda_stream), ENC)
    B.note_launch(ENC)
    return q


def decode_rows(q2d: torch.Tensor, srow: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``dtype`` values of (rows, cols) int8 codes with one scale per row."""
    srow = _check_operands(q2d, srow)
    if not q2d.is_cuda:
        return decode_rows_plain(q2d, srow, dtype)
    if q2d.dtype != torch.int8:
        raise TypeError(f"{DEC}: codes must be int8, got {q2d.dtype}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{DEC}: unsupported output dtype {dtype}")
    q2d = q2d.contiguous()
    y = torch.empty(q2d.shape, dtype=dtype, device=q2d.device)
    lib = _lib()
    B.check(lib, lib.p2_dec_rows(
        q2d.data_ptr(), srow.data_ptr(), y.data_ptr(), _DTYPE_CODE[dtype],
        q2d.shape[0], q2d.shape[1],
        torch.cuda.current_stream(q2d.device).cuda_stream), DEC)
    B.note_launch(DEC)
    return y


def _fq_lib() -> ctypes.CDLL:
    lib = B.load(FQ_SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.p2_fake_quant.argtypes = [p, i, p, p, ll, i, p]
        lib.p2_fake_quant.restype = i
        lib._repro_typed = True
    return lib


def fake_quant_plain(x: torch.Tensor, step_log2, bits: int) -> torch.Tensor:
    """The kernel's plain version: ``pow2_qdq`` with one scale."""
    return pow2_qdq(x, torch.as_tensor(step_log2, dtype=torch.float32,
                                       device=x.device).reshape(()), bits)


def fake_quant_scalar(x: torch.Tensor, step_log2, bits: int) -> torch.Tensor:
    """Quantize-dequantize ``x`` on the ``bits``-bit pow-2 grid of one
    ``step_log2`` (a number or a one-element tensor, read on the device by
    the kernel), in ``x.dtype``. No gradient rule: ``Pow2Cuda.fake_quant``
    wraps it in the clipped STE."""
    s = torch.as_tensor(step_log2, dtype=torch.float32, device=x.device)
    if s.numel() != 1:
        raise ValueError(f"{FQ}: one scale_log2 for the tensor, got shape "
                         f"{tuple(s.shape)}")
    if not x.is_cuda:
        return fake_quant_plain(x, s, bits)
    if x.dtype not in _FQ_DTYPE_CODE:
        raise TypeError(f"{FQ}: unsupported dtype {x.dtype}")
    if not 2 <= bits <= 16:
        raise ValueError(f"{FQ}: bits must be 2..16, got {bits}")
    x = x.contiguous()
    s = s.reshape(1).contiguous()
    y = torch.empty_like(x)
    lib = _fq_lib()
    B.check(lib, lib.p2_fake_quant(
        x.data_ptr(), _FQ_DTYPE_CODE[x.dtype], s.data_ptr(), y.data_ptr(),
        x.numel(), bits, torch.cuda.current_stream(x.device).cuda_stream), FQ)
    B.note_launch(FQ)
    return y


class Pow2Cuda(Pow2Reference):
    backend = "cuda"

    def encode(self, x, spec: QuantSpec, scale) -> QTensor:
        if spec.packed or spec.torch_storage != torch.int8:
            raise NotImplementedError(
                f"{ENC}: the kernel stores int8 codes; {spec.storage_dtype} "
                "is a later slice")
        rw = _rowwise(x, scale)
        if rw is None:
            raise NotImplementedError(
                f"{ENC}: scale of shape {tuple(torch.as_tensor(scale).shape)}"
                " is not one scale per leading index; the row kernel "
                "takes no other layout")
        x2d, srow = rw
        codes = encode_rows(x2d, srow, spec.bits)
        return QTensor(codes.reshape(x.shape), scale, spec, tuple(x.shape))

    def decode(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        if qt.spec.packed:
            raise NotImplementedError(
                f"{DEC}: int4x2 packed codes are a later slice")
        rw = _rowwise(qt.codes, qt.scale)
        if rw is None:
            raise NotImplementedError(
                f"{DEC}: scale is not one scale per leading index; the "
                "row kernel takes no other layout")
        q2d, srow = rw
        return decode_rows(q2d, srow, dtype).reshape(qt.codes.shape)

    def fake_quant(self, x: torch.Tensor, spec: QuantSpec,
                   scale) -> torch.Tensor:
        s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        if s.numel() != 1:
            raise NotImplementedError(
                f"{FQ}: a scale of shape {tuple(s.shape)} (one per leading "
                "index) is the row-scale fake-quant, ROADMAP queue 2 item 2; "
                "the scalar kernel takes one scale")
        return pow2_fake_quant(x, s.reshape(()), spec.bits,
                               qdq=fake_quant_scalar)


register_codec("pow2", "cuda", Pow2Cuda())
