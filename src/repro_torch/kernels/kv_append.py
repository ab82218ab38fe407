"""The paged KV write as one launch per layer: K and V of every slot, S
tokens each, encoded under the slot's pow-2 scale and written into the
layer's pool pages in place (``csrc/kv_append.cu::p2_append_paged``). At S
= 1 it is the decode step's append, what
``repro/serve/kv_cache.py::append_token`` does twice a layer through the
row-scale encode kernel and a scatter; at S > 1 the chunk step's write,
what ``write_chunk`` does twice a layer through the scalar-scale encode
kernel and a scatter, and the speculative verify's block of every slot,
what ``append_tokens`` does twice a layer.

- ``append_paged_cuda``: the kernel. The page, offset, validity and step of
  each row are read on the device (``table``, ``lens``, ``active``,
  ``n_valid`` and the scales never come back to the host); each input is
  taken at its own slot and token strides, so V, a strided view of the
  fused kv projection, is read where it lies.
- ``append_paged_torch``: its plain PyTorch twin, the page arithmetic of
  ``token_pages`` with ``encode_rows_plain`` and an ``index_put_`` per
  tensor. The CPU path, and the oracle the kernel is held to on the card.
- ``token_pages``: the page and offset each row writes, under one of the
  reference's two rules for a valid row past the slot's last page:
  ``clamp_last=False`` (``append_token``: its ``take_along_axis`` fills the
  index and its scatter drops the write) sends it to the trash page;
  ``clamp_last=True`` (``write_chunk``: its gather clamps the index) writes
  it into the last page, and of two such rows that meet in one cell the
  later wins, as in the reference's scatter (the earlier goes to the trash
  page). Inactive slots and rows at or past ``n_valid`` go to the trash
  page; so does a negative position, and a page number outside the pool.

Layouts: pages ``(P + 1, page_size, *feat)`` codes (int8, int16, int32 or
f32), row P the trash page, which is write-only scratch; tokens ``(B, S,
*feat)`` f32, bf16 or f16, row j of slot b at position ``lens[b] + j``.
The two tensors' ``*feat`` may differ (MLA's latent ``c_kv`` and rope key,
``(kv_lora_rank,)`` and ``(qk_rope_head_dim,)``), each pool matching its
tokens; they still take one launch (GQA's K and V pass one width twice);
scales ``(B,)`` f32 ``scale_log2``; table ``(B, pages_per_slot)``; lens,
``n_valid`` and active ``(B,)`` (``n_valid`` None: every row valid; active
None: every slot active). Both versions update the pages in place and
return them.

Quant health: ``health``, a (2,) int64 tensor on the pages' device or
None, gets (clipped, total) of the rows written added to it — the
reference's ``append_health`` (``obs.pow2_clip_stats`` of the new K/V
against the slots' scales, summed over both tensors; a row counts where its
slot is active and it is below ``n_valid``). The kernel counts inside the
encode (``csrc/kv_append.cu``); the twin with ``pow2_clip_stats``. None
(the default) counts nothing and runs the counter-free kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..numerics import cuda_backend as CB
from . import build as B

NAME = "p2_append_paged"
SOURCE = "kv_append"


def token_pages(table: torch.Tensor, lens: torch.Tensor, active, s: int,
                page_size: int, trash: int, n_valid=None,
                clamp_last: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(page, offset) of each slot's S rows, int64 (B, S) each: the page
    of ``table`` holding position ``lens + j``, or ``trash`` for a row that
    writes no real page (see the module docstring for the two rules)."""
    pps = table.shape[1]
    j = torch.arange(s, device=table.device)
    pos = lens.long()[:, None] + j
    idx = torch.div(pos, page_size, rounding_mode="floor")
    ok = pos >= 0
    if active is not None:
        ok = ok & active.bool()[:, None]
    nv = None if n_valid is None else n_valid.long().clamp(max=s)[:, None]
    if nv is not None:
        ok = ok & (j < nv)
    if clamp_last:
        later = j + page_size < (s if nv is None else nv)
        ok = ok & ~((idx >= pps - 1) & later)
        idx = idx.clamp(max=pps - 1)
    ok = ok & (idx < pps)
    pages = table.long().gather(1, idx.clamp(0, pps - 1))
    ok = ok & (pages >= 0) & (pages <= trash)
    return torch.where(ok, pages, trash), pos % page_size


def _check(kdata, vdata, kscale, vscale, k, v, table, lens, active, n_valid,
           page_size: int, bits: int) -> int:
    """Raise on what the write does not take; the kernel's code for the
    pools' storage."""
    if kdata.shape[:2] != vdata.shape[:2] or kdata.dtype != vdata.dtype \
            or min(kdata.dim(), vdata.dim()) < 3 \
            or not (kdata.is_contiguous() and vdata.is_contiguous()):
        raise ValueError(f"{NAME}: want two contiguous (P+1, page, *feat) "
                         f"pools of one dtype and page count, got "
                         f"{tuple(kdata.shape)} {kdata.dtype} and "
                         f"{tuple(vdata.shape)} {vdata.dtype}")
    if kdata.shape[1] != page_size:
        raise ValueError(f"{NAME}: pages of {kdata.shape[1]} rows, "
                         f"page_size {page_size}")
    code = CB._check_storage(NAME, bits, kdata.dtype)
    if k.dim() < 2 or v.dim() < 2 or k.shape[:2] != v.shape[:2] \
            or tuple(k.shape[2:]) != tuple(kdata.shape[2:]) \
            or tuple(v.shape[2:]) != tuple(vdata.shape[2:]):
        raise ValueError(f"{NAME}: want (B, S) + {tuple(kdata.shape[2:])} "
                         f"and (B, S) + {tuple(vdata.shape[2:])} tokens, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != v.dtype or k.dtype not in CB._DTYPE_CODE:
        raise TypeError(f"{NAME}: want K and V of one dtype of "
                        f"{sorted(map(str, CB._DTYPE_CODE))}, got {k.dtype} "
                        f"and {v.dtype}")
    b = k.shape[0]
    if kscale.numel() != b or vscale.numel() != b or table.dim() != 2 \
            or table.shape[0] != b or lens.shape != (b,) \
            or (active is not None and active.shape != (b,)) \
            or (n_valid is not None and n_valid.shape != (b,)):
        raise ValueError(f"{NAME}: want (B,) scales, lens, active and "
                         f"n_valid and a (B, pages) table for B = {b}")
    return code


def _counted_rows(active, n_valid, b: int, s: int, device) -> torch.Tensor:
    """(B, S) bool: the rows the health counter counts (active slot, row
    below ``n_valid``)."""
    ok = torch.ones((b, s), dtype=torch.bool, device=device)
    if active is not None:
        ok = ok & active.bool()[:, None]
    if n_valid is not None:
        ok = ok & (torch.arange(s, device=device) < n_valid.long()[:, None])
    return ok


def append_paged_torch(kdata: torch.Tensor, vdata: torch.Tensor,
                       kscale: torch.Tensor, vscale: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                       lens: torch.Tensor, active, *, page_size: int,
                       bits: int, n_valid=None, clamp_last: bool = False,
                       health=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: per tensor, the row-scale encode of the
    (B * S, F) tokens under their slots' scales, scattered to their pages
    and offsets; with ``health``, ``pow2_clip_stats`` of each tensor over
    the counted rows added to it."""
    _check(kdata, vdata, kscale, vscale, k, v, table, lens, active, n_valid,
           page_size, bits)
    if health is not None:
        from ..obs.counters import pow2_clip_stats
        b, s = k.shape[:2]
        ok = _counted_rows(active, n_valid, b, s, k.device)
        for new, scale in ((k, kscale), (v, vscale)):
            c, t = pow2_clip_stats(
                new.reshape(b, s, -1), scale.reshape(b).float(), bits,
                valid=ok[..., None])
            health += torch.stack([c, t]).to(health.dtype)
    b, s = k.shape[:2]
    pages, offs = token_pages(table, lens, active, s, page_size,
                              kdata.shape[0] - 1, n_valid, clamp_last)
    for data, scale, new in ((kdata, kscale, k), (vdata, vscale, v)):
        srow = scale.reshape(b, 1).float().expand(b, s).reshape(b * s)
        codes = CB.encode_rows_plain(new.reshape(b * s, -1), srow, bits,
                                     data.dtype)
        data.index_put_((pages.reshape(-1), offs.reshape(-1)),
                        codes.reshape((b * s,) + tuple(data.shape[2:])))
    return kdata, vdata


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C signature of p2_append_paged, the stream last
ARGTYPES = (_P, _P, _I, _LL, _LL, _LL, _LL, _I, _P, _P, _I, _P, _P, _P, _LL,
            _I, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _P, _P)


def _lib() -> ctypes.CDLL:
    lib = B.load(SOURCE)
    if not getattr(lib, "_repro_typed", False):
        lib.p2_append_paged.argtypes = list(ARGTYPES)
        lib.p2_append_paged.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _token_rows(x: torch.Tensor, b: int, s: int, feat: int) -> torch.Tensor:
    """(B, S, F) view of (B, S, *feat) tokens with each row's F elements
    contiguous: a view where the layout allows one (V's strided slice of
    the fused projection does), else a copy."""
    x3 = x.reshape(b, s, feat)
    return x3 if feat <= 1 or x3.stride(2) == 1 else x3.contiguous()


def c_args(kdata: torch.Tensor, vdata: torch.Tensor, kscale: torch.Tensor,
           vscale: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           table: torch.Tensor, lens: torch.Tensor, active, *,
           page_size: int, bits: int, n_valid=None,
           clamp_last: bool = False, health=None) -> tuple[list, list]:
    """The kernel's C arguments but the stream (pointers as ints), after
    ``_check``, and the tensors they point into, which the caller keeps
    alive until the launch. K and V pass their own widths (``kfeat``,
    ``vfeat``: one value twice for GQA)."""
    code = _check(kdata, vdata, kscale, vscale, k, v, table, lens, active,
                  n_valid, page_size, bits)
    if health is not None and (health.dtype != torch.int64
                               or tuple(health.shape) != (2,)
                               or not health.is_contiguous()):
        raise ValueError(f"{NAME}: the health counter is a contiguous (2,) "
                         f"int64 tensor, got {tuple(health.shape)} "
                         f"{health.dtype}")
    b, s = k.shape[:2]
    kfeat, vfeat = math.prod(kdata.shape[2:]), math.prod(vdata.shape[2:])
    xk, xv = _token_rows(k, b, s, kfeat), _token_rows(v, b, s, vfeat)
    kscale = kscale.reshape(b).to(torch.float32).contiguous()
    vscale = vscale.reshape(b).to(torch.float32).contiguous()
    table = table.to(torch.int32)
    if table.stride(1) != 1:
        table = table.contiguous()
    lens = lens.to(torch.int32).contiguous()
    if active is not None:
        active = active.to(torch.bool).contiguous()
    if n_valid is not None:
        n_valid = n_valid.to(torch.int32).contiguous()
    args = [xk.data_ptr(), xv.data_ptr(), CB._DTYPE_CODE[k.dtype],
            xk.stride(0), xv.stride(0), xk.stride(1), xv.stride(1), s,
            kdata.data_ptr(), vdata.data_ptr(), code, kscale.data_ptr(),
            vscale.data_ptr(), table.data_ptr(), table.stride(0),
            table.shape[1], lens.data_ptr(),
            None if active is None else active.data_ptr(),
            None if n_valid is None else n_valid.data_ptr(), int(clamp_last),
            b, kfeat, vfeat, page_size, kdata.shape[0] - 1, bits,
            None if health is None else health.data_ptr()]
    return args, [xk, xv, kscale, vscale, table, lens, active, n_valid]


def append_paged_cuda(kdata: torch.Tensor, vdata: torch.Tensor,
                      kscale: torch.Tensor, vscale: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                      lens: torch.Tensor, active, *, page_size: int,
                      bits: int, n_valid=None, clamp_last: bool = False,
                      health=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``p2_append_paged`` once for K and V of every row of every
    slot (adding the health counts to ``health`` when given); raises on
    anything the kernel does not take."""
    dev = kdata.device
    tensors = [kdata, vdata, kscale, vscale, k, v, table, lens] + [
        t for t in (active, n_valid, health) if t is not None]
    if any(t.device != dev for t in tensors) or not kdata.is_cuda:
        raise ValueError(f"{NAME}: every tensor on one CUDA device")
    args, keep = c_args(kdata, vdata, kscale, vscale, k, v, table, lens,
                        active, page_size=page_size, bits=bits,
                        n_valid=n_valid, clamp_last=clamp_last,
                        health=health)
    lib = _lib()
    B.check(lib, lib.p2_append_paged(
        *args, torch.cuda.current_stream(dev).cuda_stream), NAME)
    del keep
    B.note_launch(NAME)
    return kdata, vdata
