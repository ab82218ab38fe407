"""The whole-prompt prefill's paged KV write as one launch: K and V of every
layer of one prompt, each (tensor, layer) scale chosen on the device from
the valid rows' max, encoded under it and written into the slot's pool
pages in place (``csrc/kv_prefill.cu::p2_prefill_paged``) — what
``repro/serve/kv_cache.py::write_prefill`` does for a quantized pool
through ``choose_scale_log2``, the row-scale encode kernel and a scatter,
once per tensor.

- ``prefill_paged_cuda``: the kernel. ``length`` is a device int and the
  scales are written on the device: nothing comes back to the host. K and V
  are each taken at their own layer and token strides.
- ``prefill_paged_torch``: its plain PyTorch twin, the reference's scale
  choice (``per_tensor_max_scale_log2`` over the valid rows), the row-scale
  encode's plain version and an ``index_put_`` per tensor, with the page of
  each row from ``kv_append.token_pages`` under the clamp rule. The CPU
  path, and the oracle the kernel is held to on the card.

Layouts: tokens ``(L, S, *feat)`` f32, bf16 or f16 (the prefill cache's
``(L, 1, S, *feat)`` leaves at index 0 of their second axis); pools ``(L, P
+ 1, page_size, *feat)`` codes (int8, int16, int32 or f32), row P of each
layer the trash page, which is write-only scratch; the two tensors'
``*feat`` may differ (MLA's ``c_kv`` and ``k_rope``), each pool matching its
tokens, in one launch; scales ``(L,
num_slots)`` f32 ``scale_log2``, column ``slot`` written; ``table_row``
``(pages_per_slot,)``, the slot's row of the page table; ``length`` a
``(1,)`` int tensor (or an int), the prompt's valid rows. Row j goes to
``(table_row[min(j // page_size, pages_per_slot - 1)], j % page_size)``;
rows at or past ``length`` go to the trash page, and of two valid rows that
meet in one cell past the slot's last page the later is kept, the earlier
sent to the trash page (``kv_pages.cuh``, shared with ``p2_append_paged``).
Both versions update the pools and scales in place and return the pools.

Scale numerics: ``ceil(log2(max(m, 1e-8) / qmax))`` as PyTorch computes it
on the tensors' device. On the card that division is a multiply by the f32
reciprocal of ``qmax`` (PyTorch's rule for a Python scalar divisor), and
the kernel computes it so; the CPU twin divides. Either can pick a
different step from JAX at a max a few f32 ulps above ``qmax * 2^k``
(``ROADMAP.md`` queue 3).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..numerics import cuda_backend as CB
from ..numerics.codecs import per_tensor_max_scale_log2
from ..numerics.spec import QuantSpec
from . import build as B
from .kv_append import token_pages

NAME = "p2_prefill_paged"
SOURCE = "kv_prefill"


def _check(kdata, vdata, kscale, vscale, k, v, table_row, slot: int,
           page_size: int, bits: int) -> int:
    """Raise on what the write does not take; the kernel's code for the
    pools' storage."""
    if kdata.shape[:3] != vdata.shape[:3] or kdata.dtype != vdata.dtype \
            or min(kdata.dim(), vdata.dim()) < 4 \
            or not (kdata.is_contiguous() and vdata.is_contiguous()):
        raise ValueError(f"{NAME}: want two contiguous (L, P+1, page, *feat) "
                         f"pools of one dtype, layers and pages, got "
                         f"{tuple(kdata.shape)} {kdata.dtype} and "
                         f"{tuple(vdata.shape)} {vdata.dtype}")
    if kdata.shape[2] != page_size:
        raise ValueError(f"{NAME}: pages of {kdata.shape[2]} rows, "
                         f"page_size {page_size}")
    code = CB._check_storage(NAME, bits, kdata.dtype)
    layers = kdata.shape[0]
    if k.dim() < 2 or v.dim() < 2 or k.shape[:2] != v.shape[:2] \
            or k.shape[0] != layers \
            or tuple(k.shape[2:]) != tuple(kdata.shape[3:]) \
            or tuple(v.shape[2:]) != tuple(vdata.shape[3:]):
        raise ValueError(f"{NAME}: want ({layers}, S) + "
                         f"{tuple(kdata.shape[3:])} and ({layers}, S) + "
                         f"{tuple(vdata.shape[3:])} tokens, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != v.dtype or k.dtype not in CB._DTYPE_CODE:
        raise TypeError(f"{NAME}: want K and V of one dtype of "
                        f"{sorted(map(str, CB._DTYPE_CODE))}, got {k.dtype} "
                        f"and {v.dtype}")
    for s in (kscale, vscale):
        if s.dim() != 2 or s.shape[0] != layers or s.dtype != torch.float32 \
                or s.stride() != kscale.stride() or s.stride(1) != 1 \
                or not 0 <= slot < s.shape[1]:
            raise ValueError(f"{NAME}: want two ({layers}, slots) f32 "
                             "scales of one layout, unit column stride and "
                             f"slot {slot} in range, got {tuple(s.shape)} "
                             f"{s.dtype}")
    if table_row.dim() != 1:
        raise ValueError(f"{NAME}: want the slot's (pages_per_slot,) table "
                         f"row, got {tuple(table_row.shape)}")
    return code


def _length(length, device) -> torch.Tensor:
    return torch.as_tensor(length, dtype=torch.int32,
                           device=device).reshape(1)


def prefill_paged_torch(kdata: torch.Tensor, vdata: torch.Tensor,
                        kscale: torch.Tensor, vscale: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor,
                        table_row: torch.Tensor, slot: int, length, *,
                        page_size: int, bits: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: per tensor, the per-layer scale over the
    valid rows into column ``slot``, the row-scale encode of the (L, S * F)
    tokens under it, scattered to the rows' pages and offsets."""
    _check(kdata, vdata, kscale, vscale, k, v, table_row, slot, page_size,
           bits)
    s = k.shape[1]
    n = _length(length, k.device)
    pages, offs = token_pages(table_row[None], torch.zeros_like(n), None, s,
                              page_size, kdata.shape[1] - 1, n_valid=n,
                              clamp_last=True)
    rows = torch.arange(s, device=k.device) < n
    spec = QuantSpec("pow2", bits, 0, "int8", "per_tensor_max")
    for data, scale, x in ((kdata, kscale, k), (vdata, vscale, v)):
        valid = rows.reshape((1, s) + (1,) * (x.dim() - 2))
        step = per_tensor_max_scale_log2(x, spec, valid=valid,
                                         reduce_axes=tuple(range(1, x.dim())))
        scale[:, slot] = step
        codes = CB.encode_rows_plain(x.reshape(x.shape[0], -1), step, bits,
                                     data.dtype)
        data[:, pages[0], offs[0]] = codes.reshape(x.shape)
    return kdata, vdata


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C signature of p2_prefill_paged, the stream last
ARGTYPES = (_P, _P, _I, _LL, _LL, _LL, _LL, _I, _I, _P, _P, _I, _LL, _LL, _P,
            _P, _LL, _I, _P, _I, _P, _LL, _LL, _I, _I, _I, _P)


def _lib() -> ctypes.CDLL:
    lib = B.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        lib.p2_prefill_paged.argtypes = list(ARGTYPES)
        lib.p2_prefill_paged.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _layer_rows(x: torch.Tensor, feat: int) -> torch.Tensor:
    """(L, S, F) view of (L, S, *feat) tokens with each row's F elements
    contiguous: a view where the layout allows one, else a copy."""
    x3 = x.reshape(x.shape[0], x.shape[1], feat)
    return x3 if feat <= 1 or x3.stride(2) == 1 else x3.contiguous()


def c_args(kdata: torch.Tensor, vdata: torch.Tensor, kscale: torch.Tensor,
           vscale: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           table_row: torch.Tensor, slot: int, length, *, page_size: int,
           bits: int) -> tuple[list, list]:
    """The kernel's C arguments but the stream (pointers as ints), after
    ``_check``, and the tensors they point into, which the caller keeps
    alive until the launch. K and V pass their own widths and layer
    strides (one value twice for GQA)."""
    code = _check(kdata, vdata, kscale, vscale, k, v, table_row, slot,
                  page_size, bits)
    n = _length(length, kdata.device)
    layers, s = k.shape[:2]
    kfeat, vfeat = math.prod(kdata.shape[3:]), math.prod(vdata.shape[3:])
    xk, xv = _layer_rows(k, kfeat), _layer_rows(v, vfeat)
    table_row = table_row.to(torch.int32).contiguous()
    args = [xk.data_ptr(), xv.data_ptr(), CB._DTYPE_CODE[k.dtype],
            xk.stride(0), xv.stride(0), xk.stride(1), xv.stride(1), s,
            layers, kdata.data_ptr(), vdata.data_ptr(), code,
            kdata.stride(0), vdata.stride(0), kscale.data_ptr(),
            vscale.data_ptr(), kscale.stride(0), slot, table_row.data_ptr(),
            table_row.shape[0], n.data_ptr(), kfeat, vfeat, page_size,
            kdata.shape[1] - 1, bits]
    return args, [xk, xv, table_row, n]


def prefill_paged_cuda(kdata: torch.Tensor, vdata: torch.Tensor,
                       kscale: torch.Tensor, vscale: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor,
                       table_row: torch.Tensor, slot: int, length, *,
                       page_size: int, bits: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``p2_prefill_paged`` once for K and V of every layer; raises
    on anything the kernel does not take."""
    dev = kdata.device
    if any(t.device != dev for t in (vdata, kscale, vscale, k, v, table_row)) \
            or not kdata.is_cuda:
        raise ValueError(f"{NAME}: every tensor on one CUDA device")
    args, keep = c_args(kdata, vdata, kscale, vscale, k, v, table_row, slot,
                        length, page_size=page_size, bits=bits)
    lib = _lib()
    B.check(lib, lib.p2_prefill_paged(
        *args, torch.cuda.current_stream(dev).cuda_stream), NAME)
    del keep
    B.note_launch(NAME)
    return kdata, vdata
