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
and encodes each row's ``blockwise_geometry`` blocks with ``bw_enc``;
``bw_dec`` decodes and drops the pad.

Grouped launches: the fake-quant, the blockwise encode and decode and
the packed encode and decode kernels take a table of tensors
(``kernels/grouped.py`` plans it), so a list costs one launch.
``fake_quant_scalar_many`` quantizes a layer's TT cores, each under its
own step; ``bw_encode_many`` (``encode_many`` of the codec) encodes the
optimizer's moments or the wire's gradient leaves, their codes and
scales views into one buffer each a launch, and ``bw_decode_many``
(``decode_many``) decodes them, their values views into one f32 buffer a
launch; ``encode_packed_many`` and ``decode_packed_many`` write and read
the deploy export's packed cores, their bytes or values views into one
buffer a launch. A single tensor (``fake_quant_scalar``, ``bw_encode``,
``bw_decode``, ``encode_packed``, ``decode_packed``) is a group of one.
``state_decode_many`` and ``state_encode_many`` read and write the
recurrent-state pool of a whole decode step (``serve/state_cache.py``
``read_step`` / ``write_step``): every layer's state tensors in one launch
each way (``kernels/csrc/state_codec.cu``), the encode choosing each
(layer, slot)'s scale on the device and skipping inactive slots.
``state_decode_slot`` and ``state_encode_slot`` do the same for ONE slot,
every layer (a chunk step's read and write, a whole-prompt prefill's
write; ``read_slot`` / ``write_slot_step`` / ``write_prefill``): the
slot's index an int32 on the device, no ``active`` mask.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import build as B
from ..kernels import grouped as G
from .codecs import (BlockwiseReference, Pow2Reference, _bcast,
                     per_tensor_max_scale_log2, pow2_fake_quant,
                     pow2_fake_quant_many, pow2_qdq, register_codec,
                     to_storage)
from .spec import QTensor, QuantSpec, packed_trailing, qrange

ENC = "p2_enc_rows"
DEC = "p2_dec_rows"
SOURCE = "pow2_rows"
SENC = "p2_enc"
SDEC = "p2_dec"
SCALAR_SOURCE = "pow2_scalar"
FQ = "p2_fake_quant"
RT = "p2_rt_group"
FQR = "p2_fq_rows"
FQ_SOURCE = "pow2_fq"
PENC = "p2_enc_packed"
PDEC = "p2_dec_packed"
PACKED_SOURCE = "pow2_packed"
BENC = "bw_enc"
BDEC = "bw_dec"
BW_SOURCE = "blockwise"
STDEC = "st_dec_group"
STENC = "st_enc_group"
STDEC_SLOT = "st_dec_slot"
STENC_SLOT = "st_enc_slot"
STATE_SOURCE = "state_codec"
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


def fq_typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/pow2_fq.cu``) with its C signatures."""
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.p2_fq_group.argtypes = [ctypes.POINTER(ll), i, i, i, i, p, p]
        lib.p2_fq_group.restype = i
        lib.p2_fq_rows.argtypes = [p, i, p, p, ll, ll, i, p]
        lib.p2_fq_rows.restype = i
        lib._repro_typed = True
    return lib


def _fq_lib() -> ctypes.CDLL:
    return fq_typed(B.load(FQ_SOURCE))


def fake_quant_plain(x: torch.Tensor, step_log2, bits: int) -> torch.Tensor:
    """The kernel's plain version: ``pow2_qdq`` with one scale."""
    return pow2_qdq(x, torch.as_tensor(step_log2, dtype=torch.float32,
                                       device=x.device).reshape(()), bits)


def sat_counts_plain(xs: list[torch.Tensor], steps_log2: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """(saturated, total) int64 of the codes ``encode`` gives each x under
    its own step (``obs.saturation_counts`` of each): the fake-quant
    group's saturation counter's plain version."""
    from ..obs.counters import saturation_counts
    spec = QuantSpec("pow2", bits, 0, "int32", "per_tensor_max")
    out = torch.zeros(2, dtype=torch.int64, device=xs[0].device)
    for n, x in enumerate(xs):
        codes = encode_scalar_plain(x, steps_log2[n].reshape(1), bits,
                                    torch.int32)
        out += torch.stack(saturation_counts(QTensor(codes, 0.0, spec)))
    return out


def fake_quant_many_plain(xs: list[torch.Tensor], steps_log2: torch.Tensor,
                          bits: int, sat: torch.Tensor | None = None
                          ) -> list[torch.Tensor]:
    """The group kernel's plain version: ``fake_quant_plain`` of each x
    with its own step; ``sat`` gets ``sat_counts_plain`` added."""
    if sat is not None and xs:
        sat += sat_counts_plain(xs, steps_log2, bits)
    return [fake_quant_plain(x, steps_log2[n], bits) for n, x in enumerate(xs)]


def _fq_group(xs: list[torch.Tensor], steps: list[int], bits: int,
              storage: torch.dtype | None = None, *,
              lib: ctypes.CDLL | None = None,
              stream: bool = True, sat: torch.Tensor | None = None
              ) -> list[torch.Tensor]:
    """Launch ``p2_fq_group`` over CUDA tensors ``xs`` of one dtype, the f32
    step of ``xs[n]`` at device address ``steps[n]`` (read on the device):
    one launch per ``grouped.FQ_CAP`` tensors, units as ``grouped.fq_plan``
    gives them. ``storage`` None: the fake-quant; a code type: the codec's
    round trip through it. ``lib``: another build of the source;
    ``stream=False``: narrow units throughout (both yardsticks only).
    ``sat`` (the fake-quant only): a (2,) int64 tensor on the device that
    each launch adds (saturated, total) to."""
    what = FQ if storage is None else RT
    dtype = xs[0].dtype
    if dtype not in _FQ_DTYPE_CODE or any(x.dtype != dtype for x in xs):
        raise TypeError(f"{what}: want one dtype of "
                        f"{sorted(map(str, _FQ_DTYPE_CODE))}, got "
                        f"{sorted({str(x.dtype) for x in xs})}")
    if not 2 <= bits <= 16:
        raise ValueError(f"{what}: bits must be 2..16, got {bits}")
    code = -1 if storage is None else _check_storage(what, bits, storage)
    xs = [x.contiguous() for x in xs]
    ys = [torch.empty_like(x) for x in xs]
    lib = _fq_lib() if lib is None else lib
    cuda_stream = torch.cuda.current_stream(xs[0].device).cuda_stream
    for launch in G.fq_plan([x.numel() for x in xs], xs[0].element_size(),
                            stream=stream):
        if not launch.tiles:
            continue
        rows = []
        for i, end, wide in zip(launch.index, launch.tile_end, launch.wide):
            rows += [xs[i].data_ptr(), ys[i].data_ptr(), steps[i],
                     xs[i].numel(), end, int(wide)]
        table = (ctypes.c_longlong * len(rows))(*rows)
        B.check(lib, lib.p2_fq_group(table, len(launch.index),
                                     _FQ_DTYPE_CODE[dtype], bits, code,
                                     None if sat is None else sat.data_ptr(),
                                     cuda_stream), what)
        B.note_launch(what)
    return ys


def _one_device(xs: list[torch.Tensor], steps: list[torch.Tensor],
                what: str) -> None:
    dev = xs[0].device
    if any(t.device != dev for t in xs + steps):
        raise ValueError(f"{what}: tensors and steps must be on one device")


def fake_quant_scalar(x: torch.Tensor, step_log2, bits: int) -> torch.Tensor:
    """Quantize-dequantize ``x`` on the ``bits``-bit pow-2 grid of one
    ``step_log2`` (a number or a one-element tensor, read on the device by
    the kernel), in ``x.dtype``: a group of one. No gradient rule:
    ``Pow2Cuda.fake_quant`` wraps it in the clipped STE."""
    s = _one_scale(step_log2, x.device, FQ)
    if not x.is_cuda:
        return fake_quant_plain(x, s, bits)
    return _fq_group([x], [s.data_ptr()], bits)[0]


def fake_quant_scalar_many(xs: list[torch.Tensor], steps_log2,
                           bits: int, sat: torch.Tensor | None = None
                           ) -> list[torch.Tensor]:
    """``fake_quant_scalar`` of each tensor of ``xs`` (one dtype, one
    device) under its own step, ``steps_log2[n]`` for ``xs[n]`` (a tensor of
    ``len(xs)`` steps, read on the device, never on the host): on the card
    one launch for the lot. No gradient rule: ``Pow2Cuda.fake_quant_many``
    wraps it in the clipped STE. ``sat``, a (2,) int64 tensor on the
    device or None, gets (saturated, total) of the codes ``encode`` gives
    each tensor under its step added (counted inside the launch on the
    card; ``sat_counts_plain`` on the CPU)."""
    if not xs:
        return []
    steps = torch.as_tensor(steps_log2, dtype=torch.float32,
                            device=xs[0].device).reshape(-1)
    if steps.numel() != len(xs):
        raise ValueError(f"{FQ}: one step per tensor, got {steps.numel()} "
                         f"steps for {len(xs)} tensors")
    if sat is not None and (sat.dtype != torch.int64
                            or tuple(sat.shape) != (2,)
                            or not sat.is_contiguous()):
        raise ValueError(f"{FQ}: the saturation counter is a contiguous (2,) "
                         f"int64 tensor, got {tuple(sat.shape)} {sat.dtype}")
    if not xs[0].is_cuda:
        if any(x.is_cuda for x in xs):
            raise ValueError(f"{FQ}: tensors must be on one device")
        return fake_quant_many_plain(xs, steps, bits, sat)
    _one_device(xs, [steps] + ([] if sat is None else [sat]), FQ)
    steps = steps.contiguous()
    return _fq_group(xs, [steps.data_ptr() + 4 * n for n in range(len(xs))],
                     bits, sat=sat)


def roundtrip_many_plain(xs: list[torch.Tensor], steps: list[torch.Tensor],
                         bits: int, storage: torch.dtype = torch.int8
                         ) -> list[torch.Tensor]:
    """The round-trip group's plain version: the scalar encode's and
    decode's plain versions of each x under its own step, back in x's
    dtype."""
    return [decode_scalar_plain(encode_scalar_plain(x, s, bits, storage), s,
                                x.dtype) for x, s in zip(xs, steps)]


def roundtrip_many(xs: list[torch.Tensor], steps, bits: int,
                   storage: torch.dtype = torch.int8) -> list[torch.Tensor]:
    """decode(encode(x)) of each tensor of ``xs`` (one dtype, one device)
    under its own scalar step, ``steps[n]`` (a one-element tensor or a
    number) for ``xs[n]``, through ``storage`` codes, in x's dtype: the
    codec's ``roundtrip`` leaf by leaf, bit for bit (a zero code is +0.0).
    On the card one ``p2_fq_group`` launch in its round-trip mode, the
    steps read on the device."""
    if not xs:
        return []
    if len(steps) != len(xs):
        raise ValueError(f"{RT}: one step per tensor, got {len(steps)} steps "
                         f"for {len(xs)} tensors")
    steps = [_one_scale(s, xs[0].device, RT) for s in steps]
    if not xs[0].is_cuda:
        if any(x.is_cuda for x in xs):
            raise ValueError(f"{RT}: tensors must be on one device")
        return roundtrip_many_plain(xs, steps, bits, storage)
    _one_device(xs, steps, RT)
    return _fq_group(xs, [s.data_ptr() for s in steps], bits, storage)


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


def _pk_flat(shapes: list[tuple[int, int]], dev, fill, values: bool
             ) -> list[torch.Tensor]:
    """The packed groups' layout filled by ``fill(i)``, the (rows, pk)
    bytes (``values`` False) or (rows, last) f32 values of entry i: one
    zeroed buffer a ``grouped.pk_plan`` launch, per-entry views of it."""
    out = []
    for launch in G.pk_plan(shapes):
        buf = torch.zeros(launch.out if values else launch.codes,
                          dtype=torch.float32 if values else torch.int8,
                          device=dev)
        for i, leaf in zip(launch.index, launch.leaves):
            if values:
                v = buf[leaf.out_off:leaf.out_off + leaf.numel].view(
                    leaf.rows, leaf.last)
            else:
                v = buf[leaf.code_off:leaf.code_off + leaf.nbytes].view(
                    leaf.rows, leaf.pk)
            v.copy_(fill(i))
            out.append(v)
    return out


def encode_packed_many_plain(x2ds: list[torch.Tensor],
                             srows: list[torch.Tensor],
                             bits: int) -> list[torch.Tensor]:
    """The group encode's plain version: ``encode_packed_plain`` of each
    (rows, last) tensor, into the group's layout (one int8 buffer a launch,
    each entry's bytes on 16 bytes, zero pad bytes)."""
    if not x2ds:
        return []
    return _pk_flat([tuple(x.shape) for x in x2ds], x2ds[0].device,
                    lambda i: encode_packed_plain(x2ds[i], srows[i], bits),
                    False)


def decode_packed_many_plain(p2ds: list[torch.Tensor],
                             srows: list[torch.Tensor],
                             lasts: list[int]) -> list[torch.Tensor]:
    """The group decode's plain version: ``decode_packed_plain`` of each
    entry, into the group's layout (one f32 buffer a launch, each entry's
    values on 16 bytes, zero pads)."""
    if not p2ds:
        return []
    return _pk_flat([(p.shape[0], last) for p, last in zip(p2ds, lasts)],
                    p2ds[0].device,
                    lambda i: decode_packed_plain(p2ds[i], srows[i],
                                                  lasts[i]), True)


def _packed_lib() -> ctypes.CDLL:
    lib = B.load(PACKED_SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        table = ctypes.POINTER(ctypes.c_longlong)
        lib.p2_enc_packed.argtypes = [table, i, p, i, p]
        lib.p2_enc_packed.restype = i
        lib.p2_dec_packed.argtypes = [table, i, p, p]
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


def _pk_group(ins: list[torch.Tensor], srows: list[torch.Tensor],
              lasts: list[int], bits: int | None) -> list[torch.Tensor]:
    """Launch the packed encode group (``bits``: f32 (rows, last) ``ins``)
    or decode group (``bits`` None: int8 (rows, pk) ``ins``) over CUDA
    entries: one launch per ``grouped.PK_CAP`` of them, each writing one
    buffer, returned as per-entry views."""
    enc = bits is not None
    what = PENC if enc else PDEC
    dev = ins[0].device
    lib = _packed_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = []
    for launch in G.pk_plan([(x.shape[0], last)
                             for x, last in zip(ins, lasts)]):
        buf = torch.empty(launch.codes if enc else launch.out,
                          dtype=torch.int8 if enc else torch.float32,
                          device=dev)
        rows = []
        for i, leaf, end in zip(launch.index, launch.leaves, launch.tile_end):
            s = srows[i]
            off = leaf.code_off if enc else leaf.out_off
            rows += [ins[i].data_ptr(), s.data_ptr(), int(s.shape[0] > 1),
                     leaf.rows, leaf.last, off, end]
            out.append(buf[off:off + leaf.nbytes].view(leaf.rows, leaf.pk)
                       if enc else
                       buf[off:off + leaf.numel].view(leaf.rows, leaf.last))
        if not launch.tiles:
            continue
        table = (ctypes.c_longlong * len(rows))(*rows)
        code = (lib.p2_enc_packed(table, len(launch.index), buf.data_ptr(),
                                  bits, stream) if enc else
                lib.p2_dec_packed(table, len(launch.index), buf.data_ptr(),
                                  stream))
        B.check(lib, code, what)
        B.note_launch(what)
    return out


def encode_packed_many(x2ds: list[torch.Tensor], srows: list[torch.Tensor],
                       bits: int) -> list[torch.Tensor]:
    """int8 bytes (rows, ceil(last/2)) of each (rows, last) tensor of
    ``x2ds`` (one device), two 4-bit codes a byte, under its own scales
    ``srows[n]`` (one scale_log2 per row, or one of shape (1,) for all):
    on the card one launch for up to ``grouped.PK_CAP`` of them, their
    bytes views into one int8 buffer a launch."""
    if len(x2ds) != len(srows):
        raise ValueError(f"{PENC}: {len(x2ds)} tensors and {len(srows)} "
                         "scales")
    for x in x2ds:
        if x.dim() != 2:
            raise ValueError(f"{PENC}: want (rows, last) data, got "
                             f"{tuple(x.shape)}")
    srows = [_check_row_scales(x.shape[0], s, x.device)
             for x, s in zip(x2ds, srows)]
    if not x2ds:
        return []
    _one_device(x2ds, [], PENC)
    if not x2ds[0].is_cuda:
        return encode_packed_many_plain(x2ds, srows, bits)
    if not 2 <= bits <= 4:
        raise ValueError(f"{PENC}: a nibble holds 2..4 bits, got {bits}")
    x2ds = [x.float().contiguous() for x in x2ds]
    return _pk_group(x2ds, srows, [x.shape[1] for x in x2ds], bits)


def decode_packed_many(p2ds: list[torch.Tensor], srows: list[torch.Tensor],
                       lasts: list[int]) -> list[torch.Tensor]:
    """f32 (rows, last) values of each entry's (rows, ceil(last/2)) packed
    bytes ``p2ds[n]`` under ``srows[n]``, ``lasts[n]`` (one device): on the
    card one launch for up to ``grouped.PK_CAP`` of them, their values
    views into one f32 buffer a launch."""
    if not len(p2ds) == len(srows) == len(lasts):
        raise ValueError(f"{PDEC}: {len(p2ds)} codes, {len(srows)} scales "
                         f"and {len(lasts)} lengths")
    for p, last in zip(p2ds, lasts):
        if p.dim() != 2 or p.shape[1] != packed_trailing(last):
            raise ValueError(f"{PDEC}: want (rows, {packed_trailing(last)}) "
                             f"bytes for last={last}, got {tuple(p.shape)}")
    srows = [_check_row_scales(p.shape[0], s, p.device)
             for p, s in zip(p2ds, srows)]
    if not p2ds:
        return []
    _one_device(p2ds, [], PDEC)
    if not p2ds[0].is_cuda:
        return decode_packed_many_plain(p2ds, srows, lasts)
    if any(p.dtype != torch.int8 for p in p2ds):
        raise TypeError(f"{PDEC}: packed codes must be int8, got "
                        f"{sorted({str(p.dtype) for p in p2ds})}")
    return _pk_group([p.contiguous() for p in p2ds], srows, lasts, None)


def encode_packed(x2d: torch.Tensor, srow: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """int8 bytes (rows, ceil(last/2)) of a (rows, last) tensor, two 4-bit
    codes a byte, with one scale_log2 per row or one (shape (1,)) for all:
    a group of one."""
    return encode_packed_many([x2d], [srow], bits)[0]


def decode_packed(p2d: torch.Tensor, srow: torch.Tensor,
                  last: int) -> torch.Tensor:
    """f32 (rows, last) values of (rows, ceil(last/2)) packed bytes: a
    group of one."""
    return decode_packed_many([p2d], [srow], [last])[0]


# ---- blockwise encode / decode --------------------------------------------

# ---- the recurrent-state pool of a decode step ----------------------------

def _state_spec(bits: int) -> QuantSpec:
    """The state pool's ``ssm_state`` spec (``serve/state_cache.py``)."""
    return QuantSpec("pow2", bits, 0, "int8", "per_tensor_max")


def state_decode_many_plain(codes: list[torch.Tensor],
                            scales: list[torch.Tensor],
                            dtypes: list[torch.dtype]) -> list[torch.Tensor]:
    """The state decode group's plain version: each (L, B, *feat) pool
    tensor decoded layer by layer as ``state_cache.read_layer`` decodes it
    (``decode_rows_plain`` of the (B, F) view under its (B,) scales)."""
    out = []
    for q, s, dt in zip(codes, scales, dtypes):
        y = torch.empty(q.shape, dtype=dt, device=q.device)
        if q.numel():
            for lay in range(q.shape[0]):
                y[lay] = decode_rows_plain(q[lay].reshape(q.shape[1], -1),
                                           s[lay], dt).reshape(q.shape[1:])
        out.append(y)
    return out


def state_write_health(scale_l: torch.Tensor, new: torch.Tensor,
                       step: torch.Tensor, active: torch.Tensor, bits: int
                       ) -> tuple[torch.Tensor, ...]:
    """(clipped, total, drift_sum, drift_n) of one (layer, tensor) write
    of the state pool: ``obs.pow2_clip_stats`` of the (B, *feat) new state
    under its fresh per-slot scales ``step`` over the active slots, and
    ``obs.scale_drift_stats`` of the stored scales ``scale_l`` against
    them — the reference's ``state_cache.write_health``."""
    from ..obs.counters import pow2_clip_stats, scale_drift_stats
    amask = active.reshape((-1,) + (1,) * (new.dim() - 1))
    clipped, total = pow2_clip_stats(new, step, bits, valid=amask)
    dsum, dn = scale_drift_stats(scale_l, step, valid=active)
    return clipped, total, dsum, dn


def state_encode_many_plain(codes: list[torch.Tensor],
                            scales: list[torch.Tensor],
                            news: list[list[torch.Tensor]],
                            active: torch.Tensor, bits: int,
                            health: torch.Tensor | None = None) -> None:
    """The state encode group's plain version: each (layer, tensor)'s new
    state written into the pool as ``state_cache.write_layer`` writes it,
    in place: a ``per_tensor_max`` scale per slot, ``encode_rows_plain``,
    the active slots' codes and scales kept, the inactive slots' left.
    ``health`` ((4,) int64): each write's ``state_write_health`` added,
    the stored scales read before they are overwritten."""
    spec = _state_spec(bits)
    for q, s, layers in zip(codes, scales, news):
        for lay, new in enumerate(layers):
            amask = active.reshape((-1,) + (1,) * (new.dim() - 1))
            step = per_tensor_max_scale_log2(
                new, spec, reduce_axes=tuple(range(1, new.dim())))
            if health is not None:
                health += torch.stack([
                    v.to(torch.int64) for v in state_write_health(
                        s[lay], new, step, active, bits)])
            c = encode_rows_plain(new.reshape(new.shape[0], -1), step, bits,
                                  q.dtype).reshape(new.shape)
            q[lay].copy_(torch.where(amask, c, q[lay]))
            s[lay].copy_(torch.where(active, step, s[lay]))


def _slot_of(slot: torch.Tensor) -> int:
    """The slot index a twin reads (a host read of the (1,) tensor)."""
    return int(slot.reshape(-1)[0])


def state_decode_slot_plain(codes: list[torch.Tensor],
                            scales: list[torch.Tensor],
                            dtypes: list[torch.dtype],
                            slot: torch.Tensor) -> list[torch.Tensor]:
    """The one-slot decode's plain version: slot ``slot`` of each (L, B,
    *feat) pool tensor decoded layer by layer as the chunk step's
    ``state_cache.read_layer`` of ``data[l][slot][None]`` decodes it, into
    an (L, 1, *feat) tensor."""
    b = _slot_of(slot)
    out = []
    for q, s, dt in zip(codes, scales, dtypes):
        y = torch.empty((q.shape[0], 1) + tuple(q.shape[2:]), dtype=dt,
                        device=q.device)
        for lay in range(q.shape[0] if q.numel() else 0):
            y[lay] = decode_rows_plain(q[lay, b].reshape(1, -1),
                                       s[lay, b:b + 1], dt).reshape(y.shape[1:])
        out.append(y)
    return out


def state_encode_slot_plain(codes: list[torch.Tensor],
                            scales: list[torch.Tensor],
                            news: list[list[torch.Tensor]],
                            slot: torch.Tensor, bits: int) -> None:
    """The one-slot encode's plain version: each layer's (1, *feat) new
    state written into slot ``slot`` of the pool as
    ``state_cache.write_slot`` writes it, in place: a ``per_tensor_max``
    scale a layer, ``encode_rows_plain``; no other slot touched."""
    spec = _state_spec(bits)
    b = _slot_of(slot)
    for q, s, layers in zip(codes, scales, news):
        for lay, new in enumerate(layers):
            step = per_tensor_max_scale_log2(
                new, spec, reduce_axes=tuple(range(1, new.dim())))
            c = encode_rows_plain(new.reshape(1, -1), step, bits, q.dtype)
            q[lay, b].copy_(c.reshape(q.shape[2:]))
            s[lay, b].copy_(step[0])


def _state_lib() -> ctypes.CDLL:
    lib = B.load(STATE_SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        table = ctypes.POINTER(ctypes.c_longlong)
        lib.st_dec_group.argtypes = [table, i, p]
        lib.st_dec_group.restype = i
        lib.st_enc_group.argtypes = [table, i, table, i, p, i, i, i, i, p, p]
        lib.st_enc_group.restype = i
        lib.st_dec_slot.argtypes = [table, i, p, i, p]
        lib.st_dec_slot.restype = i
        lib.st_enc_slot.argtypes = [table, i, table, i, p, i, i, i, i, p]
        lib.st_enc_slot.restype = i
        lib._repro_typed = True
    return lib


def _state_feat(q: torch.Tensor) -> int:
    n = 1
    for d in q.shape[2:]:
        n *= d
    return n


def _check_state_pool(what: str, codes: list[torch.Tensor],
                      scales: list[torch.Tensor]) -> None:
    if len(codes) != len(scales):
        raise ValueError(f"{what}: {len(codes)} pool tensors and "
                         f"{len(scales)} scales")
    for q, s in zip(codes, scales):
        if q.dim() < 2 or tuple(s.shape) != tuple(q.shape[:2]):
            raise ValueError(f"{what}: want (L, B, *feat) codes and (L, B) "
                             f"scales, got {tuple(q.shape)} and "
                             f"{tuple(s.shape)}")
    if codes:
        _one_device(codes, scales, what)


def _check_state_card(what: str, codes: list[torch.Tensor],
                      scales: list[torch.Tensor]) -> None:
    for q, s in zip(codes, scales):
        if q.dtype != torch.int8:
            raise TypeError(f"{what}: the state pool stores int8 codes, got "
                            f"{q.dtype}")
        if s.dtype != torch.float32:
            raise TypeError(f"{what}: scales must be float32, got {s.dtype}")
        if not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError(f"{what}: the pool's codes and scales must be "
                             "contiguous")


def state_decode_many(codes: list[torch.Tensor], scales: list[torch.Tensor],
                      dtypes: list[torch.dtype]) -> list[torch.Tensor]:
    """Every (L, B, *feat) int8 pool tensor ``codes[n]`` decoded under its
    (L, B) ``scales[n]`` into a new (L, B, *feat) tensor of ``dtypes[n]``
    (one device): on the card one ``st_dec_group`` launch for up to
    ``grouped.ST_CAP`` of them, on the CPU the plain version."""
    if len(dtypes) != len(codes):
        raise ValueError(f"{STDEC}: {len(codes)} pool tensors and "
                         f"{len(dtypes)} dtypes")
    _check_state_pool(STDEC, codes, scales)
    if not codes:
        return []
    if not codes[0].is_cuda:
        return state_decode_many_plain(codes, scales, dtypes)
    _check_state_card(STDEC, codes, scales)
    for dt in dtypes:
        if dt not in _DTYPE_CODE:
            raise TypeError(f"{STDEC}: unsupported output dtype {dt}")
    outs = [torch.empty(q.shape, dtype=dt, device=q.device)
            for q, dt in zip(codes, dtypes)]
    lib = _state_lib()
    stream = torch.cuda.current_stream(codes[0].device).cuda_stream
    for table, n in _st_dec_tables(codes, scales, outs, dtypes, False):
        B.check(lib, lib.st_dec_group(table, n, stream), STDEC)
        B.note_launch(STDEC)
    return outs


def _st_dec_tables(codes, scales, outs, dtypes, one_slot: bool):
    """(table, entries) of each decode launch: rows = layers x slots of
    each pool tensor, or its layers (``one_slot``: the rows of one slot)."""
    feats = [_state_feat(q) for q in codes]
    for launch in G.st_dec_plan([(q.shape[0] * (1 if one_slot else
                                                q.shape[1]), f)
                                 for q, f in zip(codes, feats)]):
        if not launch.tiles:
            continue
        rows = []
        for i, units, end in zip(launch.index, launch.units,
                                 launch.tile_end):
            rows += [codes[i].data_ptr(), scales[i].data_ptr(),
                     outs[i].data_ptr(), units, end, max(feats[i], 1),
                     _DTYPE_CODE[dtypes[i]]]
        yield (ctypes.c_longlong * len(rows))(*rows), len(launch.index)


def _check_slot(what: str, codes: list[torch.Tensor],
                slot: torch.Tensor) -> int:
    """The pool's slots (one for every tensor); ``slot`` a (1,) int32 on
    the pool's device."""
    pool_slots = codes[0].shape[1]
    if any(q.shape[1] != pool_slots for q in codes):
        raise ValueError(f"{what}: want {pool_slots} slots in every pool "
                         "tensor")
    if tuple(slot.shape) != (1,) or slot.dtype != torch.int32:
        raise TypeError(f"{what}: the slot must be a (1,) int32 tensor, got "
                        f"{tuple(slot.shape)} {slot.dtype}")
    if slot.device != codes[0].device:
        raise ValueError(f"{what}: the slot must be on the pool's device")
    return pool_slots


def state_decode_slot(codes: list[torch.Tensor], scales: list[torch.Tensor],
                      dtypes: list[torch.dtype],
                      slot: torch.Tensor) -> list[torch.Tensor]:
    """Slot ``slot`` ((1,) int32, on the pool's device) of every (L, B,
    *feat) int8 pool tensor ``codes[n]``, every layer, decoded under its
    (L, B) ``scales[n]`` into a new (L, 1, *feat) tensor of ``dtypes[n]``:
    on the card one ``st_dec_slot`` launch for up to ``grouped.ST_CAP`` of
    them, the slot read on the device; on the CPU the plain version."""
    if len(dtypes) != len(codes):
        raise ValueError(f"{STDEC_SLOT}: {len(codes)} pool tensors and "
                         f"{len(dtypes)} dtypes")
    _check_state_pool(STDEC_SLOT, codes, scales)
    if not codes:
        return []
    pool_slots = _check_slot(STDEC_SLOT, codes, slot)
    if not codes[0].is_cuda:
        return state_decode_slot_plain(codes, scales, dtypes, slot)
    _check_state_card(STDEC_SLOT, codes, scales)
    for dt in dtypes:
        if dt not in _DTYPE_CODE:
            raise TypeError(f"{STDEC_SLOT}: unsupported output dtype {dt}")
    outs = [torch.empty((q.shape[0], 1) + tuple(q.shape[2:]), dtype=dt,
                        device=q.device) for q, dt in zip(codes, dtypes)]
    lib = _state_lib()
    stream = torch.cuda.current_stream(codes[0].device).cuda_stream
    for table, n in _st_dec_tables(codes, scales, outs, dtypes, True):
        B.check(lib, lib.st_dec_slot(table, n, slot.data_ptr(), pool_slots,
                                     stream), STDEC_SLOT)
        B.note_launch(STDEC_SLOT)
    return outs


def _slot_stride(x: torch.Tensor) -> int | None:
    """Elements between two slots' rows of a (B, *feat) tensor whose rows
    are each contiguous (a strided view of whole rows included); None
    where a row is not."""
    expect = 1
    for size, st in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        if size != 1 and st != expect:
            return None
        expect *= size
    return x.stride(0)


def state_encode_many(codes: list[torch.Tensor], scales: list[torch.Tensor],
                      news: list[list[torch.Tensor]], active: torch.Tensor,
                      bits: int, health: torch.Tensor | None = None) -> None:
    """Write every layer's new state into the pool, in place: ``news[n][l]``
    (B, *feat) into layer l of the (L, B, *feat) int8 pool tensor
    ``codes[n]`` and its (L, B) ``scales[n]``, a ``per_tensor_max`` scale
    per slot, only where the (B,) bool ``active`` is set (one device). On
    the card one ``st_enc_group`` launch for up to ``grouped.ST_CAP``
    pieces and ``grouped.ST_PTR_CAP`` new states (``grouped.st_enc_plan``),
    ``active`` read on the device; on the CPU the plain version.
    ``health``, a (4,) int64 tensor on the pool's device or None, gets
    (clipped, total, drift_sum, drift_n) of the step's writes added (the
    reference's ``write_health`` summed over layers and tensors; counted
    inside the kernel on the card)."""
    _st_encode(codes, scales, news, active, bits, health=health)


def _st_encode(codes, scales, news, active, bits,
               reread: bool = False, health=None) -> None:
    """``state_encode_many``. ``reread`` has every launch re-read its
    values from global memory in the second pass where the plan would
    stage them in shared memory: a yardstick ``chip_smoke.py`` times, on
    no path."""
    _check_new_states(STENC, codes, scales, news, None)
    if not codes:
        return
    slots = codes[0].shape[1]
    if tuple(active.shape) != (slots,) or any(q.shape[1] != slots
                                              for q in codes):
        raise ValueError(f"{STENC}: want {slots} slots in every pool tensor "
                         f"and (B,) active, got {tuple(active.shape)}")
    _one_device(codes, [n for layers in news for n in layers] + [active]
                + ([] if health is None else [health]), STENC)
    if health is not None and (health.dtype != torch.int64
                               or tuple(health.shape) != (4,)
                               or not health.is_contiguous()):
        raise ValueError(f"{STENC}: the health counter is a contiguous (4,) "
                         f"int64 tensor, got {tuple(health.shape)} "
                         f"{health.dtype}")
    if not codes[0].is_cuda:
        return state_encode_many_plain(codes, scales, news, active, bits,
                                       health)
    if active.dtype != torch.bool or not active.is_contiguous():
        raise TypeError(f"{STENC}: active must be a contiguous bool tensor")
    lib = _state_lib()
    hptr = None if health is None else health.data_ptr()
    for args in _st_enc_tables(STENC, codes, scales, news, bits, slots,
                               slots, reread, True):
        B.check(lib, lib.st_enc_group(*args[:4], active.data_ptr(), slots,
                                      *args[4:-1], hptr, args[-1]), STENC)
        B.note_launch(STENC)


def _check_new_states(what, codes, scales, news, slots) -> None:
    """Each pool tensor's list of new states: one a layer, each (B, *feat)
    (``slots`` None) or (slots, *feat)."""
    if len(news) != len(codes):
        raise ValueError(f"{what}: {len(codes)} pool tensors and "
                         f"{len(news)} lists of new states")
    _check_state_pool(what, codes, scales)
    for q, layers in zip(codes, news):
        if len(layers) != q.shape[0]:
            raise ValueError(f"{what}: {len(layers)} new states for "
                             f"{q.shape[0]} layers")
        want = tuple(q.shape[1:]) if slots is None \
            else (slots,) + tuple(q.shape[2:])
        for n in layers:
            if tuple(n.shape) != want:
                raise ValueError(f"{what}: a new state of shape "
                                 f"{tuple(n.shape)} for a pool of "
                                 f"{tuple(q.shape)}")


def _st_enc_tables(what, codes, scales, news, bits, rows_slots: int,
                   pool_slots: int, reread: bool, cluster: bool):
    """(pieces, count, ptrs, nptr, bits, stage, smem, stream) of each
    encode launch over ``rows_slots`` rows a layer (the pool's slots for
    the step form, 1 for the one-slot form, whose pieces start at slot 0
    of their first layer of a pool of ``pool_slots``)."""
    _check_state_card(what, codes, scales)
    if not 2 <= bits <= 8:
        raise ValueError(f"{what}: int8 storage holds 2..8 bits, got {bits}")
    dts, strides = [], []
    for layers in news:
        kinds = {n.dtype for n in layers}
        if len(kinds) > 1 or not kinds <= set(_DTYPE_CODE):
            raise TypeError(f"{what}: a pool tensor's new states must share "
                            f"one of {sorted(map(str, _DTYPE_CODE))}, got "
                            f"{sorted(map(str, kinds))}")
        dts.append(next(iter(kinds), torch.float32))
        st = [_slot_stride(n) for n in layers]
        if None in st:
            raise ValueError(f"{what}: a new state's slot rows must each be "
                             "contiguous")
        strides.append(st)
    feats = [_state_feat(q) for q in codes]
    stream = torch.cuda.current_stream(codes[0].device).cuda_stream
    for launch in G.st_enc_plan([(q.shape[0], rows_slots, f, dt.itemsize)
                                 for q, f, dt in zip(codes, feats, dts)],
                                cluster=cluster):
        stage = launch.stage and not reread
        pieces, ptrs = [], []
        for pc, end in zip(launch.pieces, launch.task_end):
            i, off = pc.entry, pc.layer0 * pool_slots
            pieces += [codes[i].data_ptr() + off * pc.feat,
                       scales[i].data_ptr() + 4 * off, pc.feat,
                       _DTYPE_CODE[dts[i]], pc.rows, pc.ptr0, int(pc.big),
                       end]
            for lay in range(pc.layer0, pc.layer0 + pc.layers):
                ptrs += [news[i][lay].data_ptr(), strides[i][lay]]
        yield ((ctypes.c_longlong * len(pieces))(*pieces), len(launch.pieces),
               (ctypes.c_longlong * max(len(ptrs), 1))(*ptrs), launch.ptrs,
               bits, int(stage), launch.stage_bytes if stage else 0, stream)


def state_encode_slot(codes: list[torch.Tensor], scales: list[torch.Tensor],
                      news: list[list[torch.Tensor]], slot: torch.Tensor,
                      bits: int) -> None:
    """Write every layer's new state into ONE slot of the pool, in place:
    ``news[n][l]`` (1, *feat) into slot ``slot`` ((1,) int32, on the
    pool's device) of layer l of the (L, B, *feat) int8 pool tensor
    ``codes[n]`` and its (L, B) ``scales[n]``, a ``per_tensor_max`` scale
    a layer; no other slot written. On the card one ``st_enc_slot``
    launch for up to ``grouped.ST_CAP`` pieces and ``grouped.ST_PTR_CAP``
    new states, the slot read and each scale chosen on the device; on the
    CPU the plain version."""
    _st_encode_slot(codes, scales, news, slot, bits)


def _st_encode_slot(codes, scales, news, slot, bits, reread: bool = False,
                    cluster: bool = True) -> None:
    """``state_encode_slot``. ``reread`` (re-read the values in the second
    pass) and ``cluster=False`` (a CTA a row, the large rows too) are
    yardsticks ``chip_smoke.py`` times, on no path."""
    _check_new_states(STENC_SLOT, codes, scales, news, 1)
    if not codes:
        return
    pool_slots = _check_slot(STENC_SLOT, codes, slot)
    _one_device(codes, [n for layers in news for n in layers], STENC_SLOT)
    if not codes[0].is_cuda:
        return state_encode_slot_plain(codes, scales, news, slot, bits)
    lib = _state_lib()
    for args in _st_enc_tables(STENC_SLOT, codes, scales, news, bits, 1,
                               pool_slots, reread, cluster):
        B.check(lib, lib.st_enc_slot(*args[:4], slot.data_ptr(), pool_slots,
                                     *args[4:]), STENC_SLOT)
        B.note_launch(STENC_SLOT)


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
    if not scales.shape[1]:                 # no blocks: last == 0
        return torch.zeros((codes.shape[0], last), dtype=torch.float32,
                           device=codes.device)
    b = codes.shape[-1] // scales.shape[-1]
    qt = QTensor(codes, scales, _bw_spec(b, 8), (codes.shape[0], last))
    return BlockwiseReference().decode(qt, torch.float32)


def bw_decode_many_plain(codes: list[torch.Tensor],
                         scales: list[torch.Tensor],
                         lasts: list[int]) -> list[torch.Tensor]:
    """The group decode's plain version: ``bw_decode_plain`` of each
    leaf."""
    return [bw_decode_plain(c, s, last)
            for c, s, last in zip(codes, scales, lasts)]


def bw_typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/blockwise.cu``) with its C signatures."""
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bw_enc_group.argtypes = [ctypes.POINTER(ll), i, i, i, p]
        lib.bw_enc_group.restype = i
        lib.bw_dec_group.argtypes = [ctypes.POINTER(ll), i, p, p]
        lib.bw_dec_group.restype = i
        lib._repro_typed = True
    return lib


def _bw_lib() -> ctypes.CDLL:
    return bw_typed(B.load(BW_SOURCE))


def bw_encode_many_plain(xs: list[torch.Tensor], block: int, bits: int = 8,
                         storage: torch.dtype = torch.int8
                         ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The group encode's plain version: ``bw_encode_plain`` of each
    (rows, last) tensor."""
    return [bw_encode_plain(x, block, bits, storage) for x in xs]


def _bw_group(xs: list[torch.Tensor], block: int, bits: int,
              storage: torch.dtype, *, lib: ctypes.CDLL | None = None,
              stream: bool = True
              ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Launch ``bw_enc_group`` over (rows, last) CUDA tensors: one launch
    per ``grouped.BW_CAP`` leaves, each writing one codes and one scales
    buffer, returned as per-leaf views; tasks as ``grouped.bw_plan`` gives
    them. ``lib``: another build of the source; ``stream=False``: no
    stream tasks (both yardsticks only)."""
    code = _check_storage(BENC, bits, storage)
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"{BENC}: tensors must be on one device")
    xs = [x.float().contiguous() for x in xs]
    lib = _bw_lib() if lib is None else lib
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    out = []
    for launch in G.bw_plan([tuple(x.shape) for x in xs], block, storage,
                            stream=stream):
        codes = torch.empty(launch.codes, dtype=storage, device=dev)
        scales = torch.empty(launch.scales, dtype=torch.float32, device=dev)
        c0, s0 = codes.data_ptr(), scales.data_ptr()
        csz = codes.element_size()
        rows = []
        for i, leaf, end in zip(launch.index, launch.leaves, launch.task_end):
            rows += [xs[i].data_ptr(), c0 + leaf.code_off * csz,
                     s0 + 4 * leaf.scale_off, leaf.rows, leaf.last, leaf.b,
                     leaf.nb, end, int(leaf.stream)]
            out.append((
                codes[leaf.code_off:leaf.code_off + leaf.codes].view(
                    leaf.rows, leaf.nb * leaf.b),
                scales[leaf.scale_off:leaf.scale_off + leaf.scales].view(
                    leaf.rows, leaf.nb)))
        if not launch.tasks:
            continue
        table = (ctypes.c_longlong * len(rows))(*rows)
        B.check(lib, lib.bw_enc_group(table, len(launch.index), code, bits,
                                      cuda_stream), BENC)
        B.note_launch(BENC)
    return out


def _check_2d(what: str, x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what}: want (rows, last) data, got "
                         f"{tuple(x.shape)}")


def bw_encode(x2d: torch.Tensor, block: int, bits: int = 8,
              storage: torch.dtype = torch.int8
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax codes (of ``storage``) and scales of a (rows, last)
    tensor in blocks of ``blockwise_geometry``'s width (``block`` clamped
    to ``last``): a group of one."""
    _check_2d(BENC, x2d)
    if not x2d.is_cuda:
        return bw_encode_plain(x2d, block, bits, storage)
    return _bw_group([x2d], block, bits, storage)[0]


def bw_encode_many(xs: list[torch.Tensor], block: int, bits: int = 8,
                   storage: torch.dtype = torch.int8
                   ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``bw_encode`` of each (rows, last) tensor of ``xs`` (one device): on
    the card one launch for up to ``grouped.BW_CAP`` of them, their codes
    and scales views into one codes and one scales buffer a launch."""
    for x in xs:
        _check_2d(BENC, x)
    if not xs:
        return []
    if not xs[0].is_cuda:
        if any(x.is_cuda for x in xs):
            raise ValueError(f"{BENC}: tensors must be on one device")
        return bw_encode_many_plain(xs, block, bits, storage)
    return _bw_group(xs, block, bits, storage)


def _check_bw_codes(codes: torch.Tensor, scales: torch.Tensor,
                    last: int) -> None:
    nb = scales.shape[1] if scales.dim() == 2 else 0
    if codes.dim() != 2 or scales.dim() != 2 \
            or scales.shape[0] != codes.shape[0] \
            or (codes.shape[1] % nb if nb else last):
        raise ValueError(f"{BDEC}: want (rows, nb*b) codes and (rows, nb) "
                         f"scales, got {tuple(codes.shape)} and "
                         f"{tuple(scales.shape)}")
    if scales.device != codes.device:
        raise ValueError("codes and scales must be on one device")


def _bwd_group(codes: list[torch.Tensor], scales: list[torch.Tensor],
               lasts: list[int]) -> list[torch.Tensor]:
    """Launch ``bw_dec_group`` over CUDA leaves (each its own code type):
    one launch per ``grouped.BW_CAP`` leaves, each writing one f32 buffer,
    returned as per-leaf (rows, last) views."""
    dev = codes[0].device
    if any(c.device != dev for c in codes):
        raise ValueError(f"{BDEC}: tensors must be on one device")
    kinds = [_code_of(BDEC, c) for c in codes]
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError(f"{BDEC}: want f32 scales, got "
                        f"{sorted({str(s.dtype) for s in scales})}")
    codes = [c.contiguous() for c in codes]
    scales = [s.contiguous() for s in scales]
    lib = _bw_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    shapes = [(c.shape[0], last, c.shape[1] // s.shape[1] if s.shape[1]
               else 1, s.shape[1])
              for c, s, last in zip(codes, scales, lasts)]
    out = []
    for launch in G.bwd_plan(shapes):
        y = torch.empty(launch.out, dtype=torch.float32, device=dev)
        rows = []
        for i, leaf, end in zip(launch.index, launch.leaves, launch.tile_end):
            rows += [codes[i].data_ptr(), kinds[i], scales[i].data_ptr(),
                     leaf.out_off, leaf.rows, leaf.last, leaf.b, leaf.nb,
                     end]
            out.append(y[leaf.out_off:leaf.out_off + leaf.numel].view(
                leaf.rows, leaf.last))
        if not launch.tiles:
            continue
        table = (ctypes.c_longlong * len(rows))(*rows)
        B.check(lib, lib.bw_dec_group(table, len(launch.index), y.data_ptr(),
                                      stream), BDEC)
        B.note_launch(BDEC)
    return out


def bw_decode(codes: torch.Tensor, scales: torch.Tensor,
              last: int) -> torch.Tensor:
    """f32 (rows, last) values of blockwise (rows, nb*b) codes (int8, int16,
    int32 or f32) and (rows, nb) scales; the pad past ``last`` is dropped:
    a group of one."""
    _check_bw_codes(codes, scales, last)
    if not codes.is_cuda:
        return bw_decode_plain(codes, scales, last)
    return _bwd_group([codes], [scales], [last])[0]


def bw_decode_many(codes: list[torch.Tensor], scales: list[torch.Tensor],
                   lasts: list[int]) -> list[torch.Tensor]:
    """``bw_decode`` of each leaf (``codes[n]``, ``scales[n]``,
    ``lasts[n]``; one device, any mix of code types): on the card one
    launch for up to ``grouped.BW_CAP`` of them, their values views into one
    f32 buffer a launch."""
    if not len(codes) == len(scales) == len(lasts):
        raise ValueError(f"{BDEC}: {len(codes)} codes, {len(scales)} scales "
                         f"and {len(lasts)} lengths")
    for c, s, last in zip(codes, scales, lasts):
        _check_bw_codes(c, s, last)
    if not codes:
        return []
    if not codes[0].is_cuda:
        if any(c.is_cuda for c in codes):
            raise ValueError(f"{BDEC}: tensors must be on one device")
        return bw_decode_many_plain(codes, scales, lasts)
    return _bwd_group(codes, scales, lasts)


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

    def fake_quant_many(self, xs: list[torch.Tensor], spec: QuantSpec,
                        scales) -> list[torch.Tensor]:
        """``fake_quant`` of each tensor under its own scalar scale
        (``scales[n]`` for ``xs[n]``): one group launch on the card."""
        return pow2_fake_quant_many(xs, scales, spec.bits,
                                    qdq_many=fake_quant_scalar_many)


def _bw_view(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """(the (rows, last) view of ``x``, the shape its QTensor records: a
    0-d ``x`` is one element of shape (1,))."""
    shape = tuple(x.shape) if x.dim() else (1,)
    return x.reshape(-1, shape[-1]), shape


def _bw_qtensor(codes: torch.Tensor, sc: torch.Tensor, spec: QuantSpec,
                shape: tuple[int, ...]) -> QTensor:
    lead = shape[:-1]
    return QTensor(codes.reshape(lead + (codes.shape[-1],)),
                   sc.reshape(lead + (sc.shape[-1],)), spec, shape)


class BlockwiseCuda(BlockwiseReference):
    """The blockwise codec on ``bw_enc`` / ``bw_dec``: the data as a
    (rows, last) view, one launch each way; ``encode_many`` and
    ``decode_many`` take a list of tensors in one group launch."""
    backend = "cuda"

    def encode(self, x: torch.Tensor, spec: QuantSpec, scale=None) -> QTensor:
        x2d, shape = _bw_view(x)
        codes, sc = bw_encode(x2d, spec.block, spec.bits, spec.torch_storage)
        return _bw_qtensor(codes, sc, spec, shape)

    def encode_many(self, xs: list[torch.Tensor],
                    spec: QuantSpec) -> list[QTensor]:
        views = [_bw_view(x) for x in xs]
        pairs = bw_encode_many([v for v, _ in views], spec.block, spec.bits,
                               spec.torch_storage)
        return [_bw_qtensor(codes, sc, spec, shape)
                for (codes, sc), (_, shape) in zip(pairs, views)]

    def decode(self, qt: QTensor, dtype=torch.float32) -> torch.Tensor:
        return self.decode_many([qt], dtype)[0]

    def decode_many(self, qts: list[QTensor],
                    dtype=torch.float32) -> list[torch.Tensor]:
        ys = bw_decode_many(
            [qt.codes.reshape(-1, qt.codes.shape[-1]) for qt in qts],
            [qt.scale.reshape(-1, qt.scale.shape[-1]) for qt in qts],
            [qt.shape[-1] if qt.shape else 1 for qt in qts])
        return [y.reshape(qt.shape).to(dtype) for y, qt in zip(ys, qts)]


register_codec("pow2", "cuda", Pow2Cuda())
register_codec("blockwise", "cuda", BlockwiseCuda())
