"""The paged KV read as one launch per layer: every slot's cache view of K
and V, decoded from the pool's pow-2 codes under the slot's scale straight
off the pages (``csrc/kv_read.cu::p2_read_paged``) — what
``repro/serve/kv_cache.py::gather_slots`` does twice a layer with a page
gather and a scalar- or row-scale decode kernel over the copy.

- ``read_paged_cuda``: the kernel. Each page number and each slot's step
  are read on the device; no gathered copy of the codes is made.
- ``read_paged_torch``: its plain PyTorch twin, the page gather and
  ``decode_rows_plain``. The CPU path, and the oracle the kernel is held
  to on the card.

Layouts: pages ``(P + 1, page_size, *feat)`` codes (int8, int16, int32 or
f32), row P the trash page, the two pools' ``*feat`` their own (MLA's
``c_kv`` and ``k_rope`` differ; one launch all the same); scales ``(B,)``
f32 ``scale_log2``; table ``(B, pages_per_slot)``. Returns the ``(B,
pages_per_slot * page_size, *feat)`` views of K and V, each at its own
``*feat``, in ``dtype`` (f32, bf16 or f16), every position written, masked
or not. A page number outside ``[0, P]`` reads the trash page (the
reference's gather clamps a too-large one there too).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..numerics import cuda_backend as CB
from . import build as B

NAME = "p2_read_paged"
SOURCE = "kv_read"


def _check(kdata, vdata, kscale, vscale, table, dtype) -> int:
    """Raise on what the read does not take; the kernel's code for the
    pools' storage."""
    if kdata.shape[:2] != vdata.shape[:2] or kdata.dtype != vdata.dtype \
            or min(kdata.dim(), vdata.dim()) < 3 \
            or not (kdata.is_contiguous() and vdata.is_contiguous()):
        raise ValueError(f"{NAME}: want two contiguous (P+1, page, *feat) "
                         f"pools of one dtype and page count, got "
                         f"{tuple(kdata.shape)} {kdata.dtype} and "
                         f"{tuple(vdata.shape)} {vdata.dtype}")
    code = CB._code_of(NAME, kdata)
    if dtype not in CB._DTYPE_CODE:
        raise TypeError(f"{NAME}: want values of one of "
                        f"{sorted(map(str, CB._DTYPE_CODE))}, got {dtype}")
    if table.dim() != 2 or table.shape[1] < 1 or table.dtype.is_floating_point:
        raise ValueError(f"{NAME}: want an integer (B, pages) table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    b = table.shape[0]
    if kscale.numel() != b or vscale.numel() != b:
        raise ValueError(f"{NAME}: want (B,) scales for B = {b}, got "
                         f"{tuple(kscale.shape)} and {tuple(vscale.shape)}")
    return code


def _view_shape(data: torch.Tensor, table: torch.Tensor) -> tuple:
    return (table.shape[0], table.shape[1] * data.shape[1]) \
        + tuple(data.shape[2:])


def read_paged_torch(kdata: torch.Tensor, vdata: torch.Tensor,
                     kscale: torch.Tensor, vscale: torch.Tensor,
                     table: torch.Tensor, *, dtype: torch.dtype
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: per tensor, the gathered pages decoded
    as (B, pages_per_slot * page_size * F) rows under the slot scales."""
    _check(kdata, vdata, kscale, vscale, table, dtype)
    trash = kdata.shape[0] - 1
    t = table.long()
    t = torch.where((t >= 0) & (t <= trash), t, trash)
    b = t.shape[0]
    out = []
    for data, scale in ((kdata, kscale), (vdata, vscale)):
        shape = _view_shape(data, t)
        rows = data[t].reshape(b, math.prod(shape[1:]))
        out.append(CB.decode_rows_plain(rows, scale.reshape(b), dtype
                                        ).reshape(shape))
    return out[0], out[1]


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C signature of p2_read_paged, the stream last
ARGTYPES = (_P, _P, _I, _P, _P, _I, _P, _P, _P, _LL, _I, _I, _LL, _LL, _I, _P)


def _lib() -> ctypes.CDLL:
    lib = B.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        lib.p2_read_paged.argtypes = list(ARGTYPES)
        lib.p2_read_paged.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def c_args(kdata: torch.Tensor, vdata: torch.Tensor, kscale: torch.Tensor,
           vscale: torch.Tensor, table: torch.Tensor, *,
           dtype: torch.dtype) -> tuple[list, list]:
    """The kernel's C arguments but the stream (pointers as ints), after
    ``_check``, and the tensors they point into (the two outputs first),
    which the caller keeps alive until the launch. K and V pass their own
    page sizes in elements (one value twice for GQA)."""
    code = _check(kdata, vdata, kscale, vscale, table, dtype)
    dev = kdata.device
    b, pps = table.shape
    kscale = kscale.reshape(b).to(torch.float32).contiguous()
    vscale = vscale.reshape(b).to(torch.float32).contiguous()
    table = table.to(torch.int32)
    if table.stride(1) != 1:
        table = table.contiguous()
    kout = torch.empty(_view_shape(kdata, table), dtype=dtype, device=dev)
    vout = torch.empty(_view_shape(vdata, table), dtype=dtype, device=dev)
    args = [kdata.data_ptr(), vdata.data_ptr(), code, kout.data_ptr(),
            vout.data_ptr(), CB._DTYPE_CODE[dtype], kscale.data_ptr(),
            vscale.data_ptr(), table.data_ptr(), table.stride(0), b, pps,
            math.prod(kdata.shape[1:]), math.prod(vdata.shape[1:]),
            kdata.shape[0] - 1]
    return args, [kout, vout, kscale, vscale, table]


def read_paged_cuda(kdata: torch.Tensor, vdata: torch.Tensor,
                    kscale: torch.Tensor, vscale: torch.Tensor,
                    table: torch.Tensor, *, dtype: torch.dtype
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``p2_read_paged`` once for K and V of every slot; raises on
    anything the kernel does not take."""
    dev = kdata.device
    if any(t.device != dev for t in (vdata, kscale, vscale, table)) \
            or not kdata.is_cuda:
        raise ValueError(f"{NAME}: every tensor on one CUDA device")
    args, keep = c_args(kdata, vdata, kscale, vscale, table, dtype=dtype)
    lib = _lib()
    B.check(lib, lib.p2_read_paged(
        *args, torch.cuda.current_stream(dev).cuda_stream), NAME)
    B.note_launch(NAME)
    return keep[0], keep[1]
