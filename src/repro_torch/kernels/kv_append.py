"""The decode step's KV append as one launch per layer: K and V of every
slot encoded under the slot's pow-2 scale and written into the layer's
pool pages in place (``csrc/kv_append.cu::p2_append_paged``) — what
``repro/serve/kv_cache.py::append_token`` does twice a layer through the
row-scale encode kernel and a scatter.

- ``append_paged_cuda``: the kernel. The page, offset and step of each
  slot are read on the device (``table``, ``lens``, ``active`` and the
  scales never come back to the host); each input is taken at its own slot
  stride, so V, a strided view of the fused kv projection, is read where it
  lies.
- ``append_paged_torch``: its plain PyTorch twin, the page arithmetic of
  ``append_slots`` with ``encode_rows_plain`` and an ``index_put_`` per
  tensor. The CPU path, and the oracle the kernel is held to on the card.
- ``append_slots``: the page and offset each slot writes. An inactive slot,
  or a position past the slot's last page, goes to the trash page (the
  reference's ``take_along_axis`` fills such an index and its scatter drops
  the write, so no real page changes either way).

Layouts: pages ``(P + 1, page_size, *feat)`` codes (int8, int16, int32 or
f32), row P the trash page; new tokens ``(B, 1, *feat)`` f32, bf16 or f16;
scales ``(B,)`` f32 ``scale_log2``; table ``(B, pages_per_slot)``; lens and
active ``(B,)``. Both versions update the pages in place and return them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..numerics import cuda_backend as CB
from . import build as B

NAME = "p2_append_paged"
SOURCE = "kv_append"


def append_slots(table: torch.Tensor, lens: torch.Tensor,
                 active: torch.Tensor, page_size: int, trash: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) of each slot's new token, int64 (B,) each: the page
    of ``table`` holding position ``lens``, or ``trash`` for an inactive
    slot or a position outside the slot's pages."""
    lens = lens.long()
    idx = torch.div(lens, page_size, rounding_mode="floor")
    pps = table.shape[1]
    inside = active.bool() & (idx >= 0) & (idx < pps)
    pages = table.long().gather(1, idx.clamp(0, pps - 1)[:, None])[:, 0]
    return torch.where(inside, pages, trash), lens % page_size


def append_paged_torch(kdata: torch.Tensor, vdata: torch.Tensor,
                       kscale: torch.Tensor, vscale: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                       lens: torch.Tensor, active: torch.Tensor, *,
                       page_size: int, bits: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: per tensor, the row-scale encode of the
    (B, F) token under the slot scales, scattered to its page and
    offset."""
    b = k.shape[0]
    pages, offs = append_slots(table, lens, active, page_size,
                               kdata.shape[0] - 1)
    for data, scale, new in ((kdata, kscale, k), (vdata, vscale, v)):
        codes = CB.encode_rows_plain(new.reshape(b, -1),
                                     scale.reshape(b).float(), bits,
                                     data.dtype)
        data.index_put_((pages, offs),
                        codes.reshape((b,) + tuple(data.shape[2:])))
    return kdata, vdata


def _lib() -> ctypes.CDLL:
    lib = B.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.p2_append_paged.argtypes = [p, p, i, ll, ll, p, p, i, p, p, p, ll,
                                        i, p, p, i, ll, i, i, i, p]
        lib.p2_append_paged.restype = i
        lib._repro_typed = True
    return lib


def _slot_rows(x: torch.Tensor, b: int, feat: int) -> torch.Tensor:
    """(B, F) view of a (B, 1, *feat) token with each slot's F elements
    contiguous: a view where the layout allows one (V's strided slice of
    the fused projection does), else a copy."""
    x2 = x.reshape(b, feat)
    return x2 if feat <= 1 or x2.stride(1) == 1 else x2.contiguous()


def append_paged_cuda(kdata: torch.Tensor, vdata: torch.Tensor,
                      kscale: torch.Tensor, vscale: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                      lens: torch.Tensor, active: torch.Tensor, *,
                      page_size: int, bits: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``p2_append_paged`` once for K and V of every slot; raises on
    anything the kernel does not take."""
    dev = kdata.device
    args = (kdata, vdata, kscale, vscale, k, v, table, lens, active)
    if any(t.device != dev for t in args) or not kdata.is_cuda:
        raise ValueError(f"{NAME}: every tensor on one CUDA device")
    if kdata.shape != vdata.shape or kdata.dtype != vdata.dtype \
            or kdata.dim() < 3 or not (kdata.is_contiguous()
                                       and vdata.is_contiguous()):
        raise ValueError(f"{NAME}: want two contiguous (P+1, page, *feat) "
                         f"pools of one dtype, got {tuple(kdata.shape)} "
                         f"{kdata.dtype} and {tuple(vdata.shape)} "
                         f"{vdata.dtype}")
    if kdata.shape[1] != page_size:
        raise ValueError(f"{NAME}: pages of {kdata.shape[1]} rows, "
                         f"page_size {page_size}")
    code = CB._check_storage(NAME, bits, kdata.dtype)
    b = k.shape[0]
    want = (b, 1) + tuple(kdata.shape[2:])
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"{NAME}: want tokens of shape {want}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != v.dtype or k.dtype not in CB._DTYPE_CODE:
        raise TypeError(f"{NAME}: want K and V of one dtype of "
                        f"{sorted(map(str, CB._DTYPE_CODE))}, got {k.dtype} "
                        f"and {v.dtype}")
    if kscale.numel() != b or vscale.numel() != b or table.dim() != 2 \
            or table.shape[0] != b or lens.shape != (b,) \
            or active.shape != (b,):
        raise ValueError(f"{NAME}: want (B,) scales, lens and active and a "
                         f"(B, pages) table for B = {b}")
    feat = math.prod(kdata.shape[2:])
    xk, xv = _slot_rows(k, b, feat), _slot_rows(v, b, feat)
    kscale = kscale.reshape(b).to(torch.float32).contiguous()
    vscale = vscale.reshape(b).to(torch.float32).contiguous()
    table = table.to(torch.int32)
    if table.stride(1) != 1:
        table = table.contiguous()
    lens = lens.to(torch.int32).contiguous()
    active = active.to(torch.bool).contiguous()
    lib = _lib()
    B.check(lib, lib.p2_append_paged(
        xk.data_ptr(), xv.data_ptr(), CB._DTYPE_CODE[k.dtype], xk.stride(0),
        xv.stride(0), kdata.data_ptr(), vdata.data_ptr(), code,
        kscale.data_ptr(), vscale.data_ptr(), table.data_ptr(),
        table.stride(0), table.shape[1], lens.data_ptr(), active.data_ptr(),
        b, feat, page_size, kdata.shape[0] - 1, bits,
        torch.cuda.current_stream(dev).cuda_stream), NAME)
    B.note_launch(NAME)
    return kdata, vdata
