"""CUDA codec backend: the pow-2 encode/decode kernels with one scale
(``kernels/csrc/pow2_scalar.cu``) or one scale per row
(``kernels/csrc/pow2_rows.cu``), the pow-2 fake-quant kernels of
``kernels/csrc/pow2_fq.cu``, the int4x2 packed encode/decode kernels of
``kernels/csrc/pow2_packed.cu`` and the blockwise encode/decode kernels of
``kernels/csrc/blockwise.cu`` behind the ``encode / decode / fake_quant``
API of the reference codecs — the port of
``repro/numerics/pallas_backend.py``.

Dispatch mirrors ``Pow2Pallas``: a one-element scale (``_scalar``: a 0-d
tensor or one of size 1, e.g. a one-slot read or a one-layer pool) goes to
the scalar-scale kernels ``p2_enc`` / ``p2_dec`` / ``p2_fake_quant``, the
step read on the device. A scale that follows the ``codecs._bcast``
convention (one scale per leading index, e.g. the KV pool's per-(layer,
slot) arrays) collapses the data to a contiguous ``(rows, cols)`` view with
one f32 ``scale_log2`` per row (``_rowwise``) for ``p2_enc_rows`` /
``p2_dec_rows`` / ``p2_fq_rows``. ``fake_quant`` wraps either kernel in the
clipped STE, its mask computed outside the kernel on the ``_bcast``-shaped
scale, as in the Pallas backend.

Codes are stored in the spec's storage type (``int8``, ``int16``,
``int32`` or ``float32``; the kernels are templated over it), saturated to
an integer type's range as JAX converts (``codecs.to_storage``); a grid
takes at most as many bits as its storage holds (32 for float32).

Routing is by the tensor's device, never by a fallback: a CPU tensor runs
the kernel's plain version (``encode_scalar_plain``, ``encode_rows_plain``,
...); a CUDA tensor launches the kernel, and anything the kernel does not
take (a scale that is not one value per leading index, more bits than the
storage holds, an unsupported dtype) raises — where ``Pow2Pallas`` falls
back to the reference codec, the port does not.

Packed int4x2 storage views the data as ``(rows, last)`` keeping the
logical trailing dim (``_rowwise_lastdim``), so a byte's two nibbles never
straddle rows; a one-element scale is every row's (stride 0 in the kernel).

The blockwise codec (``BlockwiseCuda``) views the data as ``(rows, last)``
and encodes each row's ``blockwise_geometry`` blocks with one launch of
``bw_enc``; ``bw_dec`` decodes and drops the pad.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import build as B
from .codecs import (BlockwiseReference, Pow2Reference, _bcast,
                     blockwise_geometry, pow2_fake_quant, pow2_qdq,
                     register_codec, to_storage)
from .spec import QTensor, QuantSpec, packed_trailing, qrange

ENC = "p2_enc_rows"
DEC = "p2_dec_rows"
SOURCE = "pow2_rows"
SENC = "p2_enc"
SDEC = "p2_dec"
SCALAR_SOURCE = "pow2_scalar"
FQ = "p2_fake_quant"
FQR = "p2_fq_rows"
FQ_SOURCE = "pow2_fq"
PENC = "p2_enc_packed"
PDEC = "p2_dec_packed"
PACKED_SOURCE = "pow2_packed"
BENC = "bw_enc"
BDEC = "bw_dec"
BW_SOURCE = "blockwise"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FQ_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# code storage types of the codec kernels (csrc/pow2_codes.cuh Code) and
# the widest grid each holds
_CODE = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.float32: 3}
_CODE_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32,
              torch.float32: 32}


def _check_storage(what: str, bits: int, storage: torch.dtype) -> int:
    """The kernel's code for ``storage``; raises on a storage type the
    kernels do not write or a grid wider than it holds."""
    if storage not in _CODE:
        raise TypeError(f"{what}: unsupported code storage {storage}")
    if not 2 <= bits <= _CODE_BITS[storage]:
        raise ValueError(f"{what}: {storage} storage holds 2.."
                         f"{_CODE_BITS[storage]} bits, got {bits}")
    return _CODE[storage]


def _code_of(what: str, q: torch.Tensor) -> int:
    if q.dtype not in _CODE:
        raise TypeError(f"{what}: codes must be one of "
                        f"{sorted(map(str, _CODE))}, got {q.dtype}")
    return _CODE[q.dtype]


def _rowwise(x: torch.Tensor, scale) -> tuple[torch.Tensor, torch.Tensor] | None:
    """View (x, scale) as (rows, cols) with one scale per row.

    After stripping trailing length-1 dims, ``scale.shape`` must broadcast
    against the same number of *leading* dims of ``x`` (each dim equal or
    1). Returns (x2d, scale_row), or None when the convention doesn't hold
    — a one-element scale included, as in the reference: the scalar
    kernels take that one (``_scalar``)."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
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


def _rowwise_lastdim(x: torch.Tensor, scale
                     ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """View ``x`` as (rows, last) with one scale per row, KEEPING the
    logical trailing dim intact (the packed codec pairs nibbles along it;
    ``_rowwise``'s full collapse would let pairs straddle rows when the
    trailing dim is odd). A one-element scale comes back as shape (1,):
    every row's. None when the scale extends into the trailing dim."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    x2d = x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)
    if scale.numel() == 1:
        return x2d, scale.reshape(1)
    sh = list(scale.shape)
    while sh and sh[-1] == 1:
        sh.pop()
    if len(sh) > x.dim() - 1:
        return None
    lead = tuple(x.shape[:-1])
    if any(s not in (1, d) for s, d in zip(sh, lead)):
        return None
    srow = torch.broadcast_to(
        scale.reshape(tuple(sh) + (1,) * (len(lead) - len(sh))), lead)
    return x2d, srow.reshape(-1)


# ---- plain versions (the CPU path, and the kernels' oracle on the card) ----

def encode_rows_plain(x2d: torch.Tensor, srow: torch.Tensor, bits: int,
                      storage: torch.dtype = torch.int8) -> torch.Tensor:
    lo, hi = qrange(bits)
    step = torch.exp2(srow.float())[:, None]
    return to_storage(torch.clamp(torch.round(x2d.float() / step), lo, hi),
                      storage)


def decode_rows_plain(q2d: torch.Tensor, srow: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    return (q2d.float() * torch.exp2(srow.float())[:, None]).to(dtype)


def encode_scalar_plain(x: torch.Tensor, s: torch.Tensor, bits: int,
                        storage: torch.dtype = torch.int8) -> torch.Tensor:
    return encode_rows_plain(x.reshape(1, -1), s.reshape(1), bits,
                             storage).reshape(x.shape)


def decode_scalar_plain(q: torch.Tensor, s: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    return decode_rows_plain(q.reshape(1, -1), s.reshape(1),
                             dtype).reshape(q.shape)


def fake_quant_rows_plain(x2d: torch.Tensor, srow: torch.Tensor,
                          bits: int) -> torch.Tensor:
    """The row fake-quant kernel's plain version: ``pow2_qdq`` per row."""
    return pow2_qdq(x2d, srow.float()[:, None], bits)


# ---- kernel wrappers ------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = B.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.p2_enc_rows.argtypes = [p, i, p, p, i, ll, ll, i, p]
        lib.p2_enc_rows.restype = i
        lib.p2_dec_rows.argtypes = [p, i, p, p, i, ll, ll, p]
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


def encode_rows(x2d: torch.Tensor, srow: torch.Tensor, bits: int,
                storage: torch.dtype = torch.int8) -> torch.Tensor:
    """``storage`` codes of a (rows, cols) tensor with one scale_log2 per
    row."""
    srow = _check_operands(x2d, srow)
    if not x2d.is_cuda:
        return encode_rows_plain(x2d, srow, bits, storage)
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"{ENC}: unsupported input dtype {x2d.dtype}")
    code = _check_storage(ENC, bits, storage)
    x2d = x2d.contiguous()
    q = torch.empty(x2d.shape, dtype=storage, device=x2d.device)
    lib = _lib()
    B.check(lib, lib.p2_enc_rows(
        x2d.data_ptr(), _DTYPE_CODE[x2d.dtype], srow.data_ptr(), q.data_ptr(),
        code, x2d.shape[0], x2d.shape[1], bits,
        torch.cuda.current_stream(x2d.device).cuda_stream), ENC)
    B.note_launch(ENC)
    return q


def decode_rows(q2d: torch.Tensor, srow: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``dtype`` values of (rows, cols) codes (int8, int16, int32 or f32)
    with one scale per row."""
    srow = _check_operands(q2d, srow)
    if not q2d.is_cuda:
        return decode_rows_plain(q2d, srow, dtype)
    code = _code_of(DEC, q2d)
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{DEC}: unsupported output dtype {dtype}")
    q2d = q2d.contiguous()
    y = torch.empty(q2d.shape, dtype=dtype, device=q2d.device)
    lib = _lib()
    B.check(lib, lib.p2_dec_rows(
        q2d.data_ptr(), code, srow.data_ptr(), y.data_ptr(),
        _DTYPE_CODE[dtype], q2d.shape[0], q2d.shape[1],
        torch.cuda.current_stream(q2d.device).cuda_stream), DEC)
    B.note_launch(DEC)
    return y


def _scalar_lib() -> ctypes.CDLL:
    lib = B.load(SCALAR_SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.p2_enc.argtypes = [p, i, p, p, i, ll, i, p]
        lib.p2_enc.restype = i
        lib.p2_dec.argtypes = [p, i, p, p, i, ll, p]
        lib.p2_dec.restype = i
        lib._repro_typed = True
    return lib


def _one_scale(s, dev, what: str) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    if s.numel() != 1:
        raise ValueError(f"{what}: one scale_log2 for the tensor, got shape "
                         f"{tuple(s.shape)}")
    return s.reshape(1).contiguous()


def encode_scalar(x: torch.Tensor, s, bits: int,
                  storage: torch.dtype = torch.int8) -> torch.Tensor:
    """``storage`` codes of ``x`` (any shape) under one scale_log2 (a
    number or a one-element tensor, read on the device by the kernel)."""
    s = _one_scale(s, x.device, SENC)
    if not x.is_cuda:
        return encode_scalar_plain(x, s, bits, storage)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{SENC}: unsupported input dtype {x.dtype}")
    code = _check_storage(SENC, bits, storage)
    x = x.contiguous()
    q = torch.empty(x.shape, dtype=storage, device=x.device)
    lib = _scalar_lib()
    B.check(lib, lib.p2_enc(
        x.data_ptr(), _DTYPE_CODE[x.dtype], s.data_ptr(), q.data_ptr(), code,
        x.numel(), bits, torch.cuda.current_stream(x.device).cuda_stream),
        SENC)
    B.note_launch(SENC)
    return q


def decode_scalar(q: torch.Tensor, s, dtype: torch.dtype) -> torch.Tensor:
    """``dtype`` values of codes (any shape; int8, int16, int32 or f32)
    under one scale_log2."""
    s = _one_scale(s, q.device, SDEC)
    if not q.is_cuda:
        return decode_scalar_plain(q, s, dtype)
    code = _code_of(SDEC, q)
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{SDEC}: unsupported output dtype {dtype}")
    q = q.contiguous()
    y = torch.empty(q.shape, dtype=dtype, device=q.device)
    lib = _scalar_lib()
    B.check(lib, lib.p2_dec(
        q.data_ptr(), code, s.data_ptr(), y.data_ptr(), _DTYPE_CODE[dtype],
        q.numel(), torch.cuda.current_stream(q.device).cuda_stream), SDEC)
    B.note_launch(SDEC)
    return y


def _fq_lib() -> ctypes.CDLL:
    lib = B.load(FQ_SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.p2_fake_quant.argtypes = [p, i, p, p, ll, i, p]
        lib.p2_fake_quant.restype = i
        lib.p2_fq_rows.argtypes = [p, i, p, p, ll, ll, i, p]
        lib.p2_fq_rows.restype = i
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
    s = _one_scale(step_log2, x.device, FQ)
    if not x.is_cuda:
        return fake_quant_plain(x, s, bits)
    if x.dtype not in _FQ_DTYPE_CODE:
        raise TypeError(f"{FQ}: unsupported dtype {x.dtype}")
    if not 2 <= bits <= 16:
        raise ValueError(f"{FQ}: bits must be 2..16, got {bits}")
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _fq_lib()
    B.check(lib, lib.p2_fake_quant(
        x.data_ptr(), _FQ_DTYPE_CODE[x.dtype], s.data_ptr(), y.data_ptr(),
        x.numel(), bits, torch.cuda.current_stream(x.device).cuda_stream), FQ)
    B.note_launch(FQ)
    return y


def fake_quant_rows(x: torch.Tensor, scale, bits: int) -> torch.Tensor:
    """Quantize-dequantize ``x`` on the pow-2 grid of one scale per leading
    index (the ``_bcast`` convention, any of its shapes), in ``x.dtype``.
    No gradient rule: ``Pow2Cuda.fake_quant`` wraps it in the clipped
    STE."""
    rw = _rowwise(x, scale)
    if rw is None:
        raise NotImplementedError(
            f"{FQR}: scale of shape {tuple(torch.as_tensor(scale).shape)} is "
            "not one scale per leading index; the row kernel takes no other "
            "layout")
    x2d, srow = rw
    srow = srow.contiguous()
    if not x.is_cuda:
        return fake_quant_rows_plain(x2d, srow, bits).reshape(x.shape)
    if x.dtype not in _FQ_DTYPE_CODE:
        raise TypeError(f"{FQR}: unsupported dtype {x.dtype}")
    if not 2 <= bits <= 16:
        raise ValueError(f"{FQR}: bits must be 2..16, got {bits}")
    x2d = x2d.contiguous()
    y = torch.empty_like(x2d)
    lib = _fq_lib()
    B.check(lib, lib.p2_fq_rows(
        x2d.data_ptr(), _FQ_DTYPE_CODE[x.dtype], srow.data_ptr(), y.data_ptr(),
        x2d.shape[0], x2d.shape[1], bits,
        torch.cuda.current_stream(x.device).cuda_stream), FQR)
    B.note_launch(FQR)
    return y.reshape(x.shape)


# ---- int4x2 packed encode / decode ----------------------------------------

def encode_packed_plain(x2d: torch.Tensor, srow: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """The packed encode kernel's plain version: the reference codec on the
    (rows, last) view, one scale per row (or one for all)."""
    spec = QuantSpec("pow2", bits, 0, "int4x2")
    return Pow2Reference().encode(x2d, spec, srow).codes


def decode_packed_plain(p2d: torch.Tensor, srow: torch.Tensor,
                        last: int) -> torch.Tensor:
    """The packed decode kernel's plain version: f32 (rows, last)."""
    qt = QTensor(p2d, srow, QuantSpec("pow2", 4, 0, "int4x2"),
                 (p2d.shape[0], last))
    return Pow2Reference().decode(qt, torch.float32)


def _packed_lib() -> ctypes.CDLL:
    lib = B.load(PACKED_SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.p2_enc_packed.argtypes = [p, p, ll, p, ll, ll, i, p]
        lib.p2_enc_packed.restype = i
        lib.p2_dec_packed.argtypes = [p, p, ll, p, ll, ll, p]
        lib.p2_dec_packed.restype = i
        lib._repro_typed = True
    return lib


def _check_row_scales(rows: int, srow: torch.Tensor, dev) -> torch.Tensor:
    if srow.dim() != 1 or srow.shape[0] not in (1, rows):
        raise ValueError(f"want (rows,) or (1,) scales for {rows} rows, got "
                         f"{tuple(srow.shape)}")
    if srow.device != dev:
        raise ValueError("data and scales must be on one device")
    return srow.to(torch.float32).contiguous()


def encode_packed(x2d: torch.Tensor, srow: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """int8 bytes (rows, ceil(last/2)) of a (rows, last) tensor, two 4-bit
    codes a byte, with one scale_log2 per row or one (shape (1,)) for all."""
    if x2d.dim() != 2:
        raise ValueError(f"{PENC}: want (rows, last) data, got "
                         f"{tuple(x2d.shape)}")
    srow = _check_row_scales(x2d.shape[0], srow, x2d.device)
    if not x2d.is_cuda:
        return encode_packed_plain(x2d, srow, bits)
    if not 2 <= bits <= 4:
        raise ValueError(f"{PENC}: a nibble holds 2..4 bits, got {bits}")
    x2d = x2d.float().contiguous()
    rows, last = x2d.shape
    out = torch.empty((rows, packed_trailing(last)), dtype=torch.int8,
                      device=x2d.device)
    lib = _packed_lib()
    B.check(lib, lib.p2_enc_packed(
        x2d.data_ptr(), srow.data_ptr(), int(srow.shape[0] > 1),
        out.data_ptr(), rows, last, bits,
        torch.cuda.current_stream(x2d.device).cuda_stream), PENC)
    B.note_launch(PENC)
    return out


def decode_packed(p2d: torch.Tensor, srow: torch.Tensor,
                  last: int) -> torch.Tensor:
    """f32 (rows, last) values of (rows, ceil(last/2)) packed bytes."""
    if p2d.dim() != 2 or p2d.shape[1] != packed_trailing(last):
        raise ValueError(f"{PDEC}: want (rows, {packed_trailing(last)}) "
                         f"bytes for last={last}, got {tuple(p2d.shape)}")
    srow = _check_row_scales(p2d.shape[0], srow, p2d.device)
    if not p2d.is_cuda:
        return decode_packed_plain(p2d, srow, last)
    if p2d.dtype != torch.int8:
        raise TypeError(f"{PDEC}: packed codes must be int8, got {p2d.dtype}")
    p2d = p2d.contiguous()
    rows = p2d.shape[0]
    y = torch.empty((rows, last), dtype=torch.float32, device=p2d.device)
    lib = _packed_lib()
    B.check(lib, lib.p2_dec_packed(
        p2d.data_ptr(), srow.data_ptr(), int(srow.shape[0] > 1), y.data_ptr(),
        rows, last, torch.cuda.current_stream(p2d.device).cuda_stream), PDEC)
    B.note_launch(PDEC)
    return y


# ---- blockwise encode / decode --------------------------------------------

_STORAGE_NAME = {torch.int8: "int8", torch.int16: "int16",
                 torch.int32: "int32", torch.float32: "float32"}


def _bw_spec(b: int, bits: int, storage: torch.dtype = torch.int8
             ) -> QuantSpec:
    return QuantSpec("blockwise", bits, b, _STORAGE_NAME[storage],
                     "per_tensor_max")


def bw_encode_plain(x2d: torch.Tensor, block: int, bits: int = 8,
                    storage: torch.dtype = torch.int8
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blockwise encode kernel's plain version: (codes (rows, nb*b) of
    ``storage``, scales (rows, nb) f32) of a (rows, last) tensor, by the
    reference."""
    qt = BlockwiseReference().encode(x2d, _bw_spec(block, bits, storage))
    return qt.codes, qt.scale


def bw_decode_plain(codes: torch.Tensor, scales: torch.Tensor,
                    last: int) -> torch.Tensor:
    """The blockwise decode kernel's plain version: f32 (rows, last)."""
    b = codes.shape[-1] // scales.shape[-1]
    qt = QTensor(codes, scales, _bw_spec(b, 8), (codes.shape[0], last))
    return BlockwiseReference().decode(qt, torch.float32)


def _bw_lib() -> ctypes.CDLL:
    lib = B.load(BW_SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bw_enc.argtypes = [p, p, i, p, ll, ll, ll, ll, i, p]
        lib.bw_enc.restype = i
        lib.bw_dec.argtypes = [p, i, p, p, ll, ll, ll, ll, p]
        lib.bw_dec.restype = i
        lib._repro_typed = True
    return lib


def bw_encode(x2d: torch.Tensor, block: int, bits: int = 8,
              storage: torch.dtype = torch.int8
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax codes (of ``storage``) and scales of a (rows, last)
    tensor in blocks of ``blockwise_geometry``'s width (``block`` clamped
    to ``last``)."""
    if x2d.dim() != 2:
        raise ValueError(f"{BENC}: want (rows, last) data, got "
                         f"{tuple(x2d.shape)}")
    if not x2d.is_cuda:
        return bw_encode_plain(x2d, block, bits, storage)
    code = _check_storage(BENC, bits, storage)
    x2d = x2d.float().contiguous()
    rows, last = x2d.shape
    b, nb, _ = blockwise_geometry(_bw_spec(block, bits), last)
    codes = torch.empty((rows, nb * b), dtype=storage, device=x2d.device)
    scales = torch.empty((rows, nb), dtype=torch.float32, device=x2d.device)
    lib = _bw_lib()
    B.check(lib, lib.bw_enc(
        x2d.data_ptr(), codes.data_ptr(), code, scales.data_ptr(), rows, last,
        b, nb, bits,
        torch.cuda.current_stream(x2d.device).cuda_stream), BENC)
    B.note_launch(BENC)
    return codes, scales


def bw_decode(codes: torch.Tensor, scales: torch.Tensor,
              last: int) -> torch.Tensor:
    """f32 (rows, last) values of blockwise (rows, nb*b) codes (int8, int16,
    int32 or f32) and (rows, nb) scales; the pad past ``last`` is
    dropped."""
    if codes.dim() != 2 or scales.dim() != 2 \
            or scales.shape[0] != codes.shape[0] \
            or codes.shape[1] % scales.shape[1]:
        raise ValueError(f"{BDEC}: want (rows, nb*b) codes and (rows, nb) "
                         f"scales, got {tuple(codes.shape)} and "
                         f"{tuple(scales.shape)}")
    if scales.device != codes.device:
        raise ValueError("codes and scales must be on one device")
    if not codes.is_cuda:
        return bw_decode_plain(codes, scales, last)
    code = _code_of(BDEC, codes)
    if scales.dtype != torch.float32:
        raise TypeError(f"{BDEC}: want f32 scales, got {scales.dtype}")
    rows, nb = scales.shape
    b = codes.shape[1] // nb
    codes, scales = codes.contiguous(), scales.contiguous()
    y = torch.empty((rows, last), dtype=torch.float32, device=codes.device)
    lib = _bw_lib()
    B.check(lib, lib.bw_dec(
        codes.data_ptr(), code, scales.data_ptr(), y.data_ptr(), rows, last,
        b, nb,
        torch.cuda.current_stream(codes.device).cuda_stream), BDEC)
    B.note_launch(BDEC)
    return y


class Pow2Cuda(Pow2Reference):
    backend = "cuda"

    @staticmethod
    def _scalar(scale) -> bool:
        """``Pow2Pallas._scalar``: a 0-d scale or one of size 1."""
        s = torch.as_tensor(scale)
        return s.dim() == 0 or s.numel() == 1

    def encode(self, x, spec: QuantSpec, scale) -> QTensor:
        if spec.packed:
            rw = _rowwise_lastdim(x, scale)
            if rw is None:
                raise NotImplementedError(
                    f"{PENC}: scale of shape "
                    f"{tuple(torch.as_tensor(scale).shape)} is not one scale "
                    "per leading index; the packed kernel takes no other "
                    "layout")
            x2d, srow = rw
            codes = encode_packed(x2d, srow, spec.bits)
            return QTensor(codes.reshape(tuple(x.shape[:-1])
                                         + (codes.shape[-1],)),
                           scale, spec, tuple(x.shape))
        storage = spec.torch_storage
        if self._scalar(scale):
            return QTensor(encode_scalar(x, scale, spec.bits, storage), scale,
                           spec, tuple(x.shape))
        rw = _rowwise(x, scale)
        if rw is None:
            raise NotImplementedError(
                f"{ENC}: scale of shape {tuple(torch.as_tensor(scale).shape)}"
                " is not one scale per leading index; the row kernel "
                "takes no other layout")
        x2d, srow = rw
        codes = encode_rows(x2d, srow, spec.bits, storage)
        return QTensor(codes.reshape(x.shape), scale, spec, tuple(x.shape))

    def decode(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        if qt.spec.packed:
            rw = _rowwise_lastdim(qt.codes, qt.scale)
            if rw is None:
                raise NotImplementedError(
                    f"{PDEC}: scale is not one scale per leading index; the "
                    "packed kernel takes no other layout")
            p2d, srow = rw
            last = qt.shape[-1] if qt.shape else 1
            return decode_packed(p2d, srow, last).reshape(qt.shape).to(dtype)
        if self._scalar(qt.scale):
            return decode_scalar(qt.codes, qt.scale, dtype)
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
        if self._scalar(s):
            return pow2_fake_quant(x, s.reshape(()), spec.bits,
                                   qdq=fake_quant_scalar)
        # the STE mask and the kernel both see the _bcast-shaped scale
        s = _bcast(s, x.dim(), x.device)
        if _rowwise(x, s) is None:
            raise NotImplementedError(
                f"{FQR}: a scale of shape {tuple(s.shape)} is not one scale "
                "per leading index; the row kernel takes no other layout "
                "(the Pallas backend falls back to the reference, the port "
                "does not)")
        return pow2_fake_quant(x, s, spec.bits, qdq=fake_quant_rows)


class BlockwiseCuda(BlockwiseReference):
    """The blockwise codec on ``bw_enc`` / ``bw_dec``: the data as a
    (rows, last) view, one launch each way."""
    backend = "cuda"

    def encode(self, x: torch.Tensor, spec: QuantSpec, scale=None) -> QTensor:
        shape = tuple(x.shape) if x.dim() else (1,)
        lead = shape[:-1]
        codes, sc = bw_encode(x.reshape(-1, shape[-1]), spec.block, spec.bits,
                              spec.torch_storage)
        return QTensor(codes.reshape(lead + (codes.shape[-1],)),
                       sc.reshape(lead + (sc.shape[-1],)), spec, shape)

    def decode(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        last = qt.shape[-1] if qt.shape else 1
        y = bw_decode(qt.codes.reshape(-1, qt.codes.shape[-1]),
                      qt.scale.reshape(-1, qt.scale.shape[-1]), last)
        return y.reshape(qt.shape).to(dtype)


register_codec("pow2", "cuda", Pow2Cuda())
register_codec("blockwise", "cuda", BlockwiseCuda())
