"""Fused paged attention over the int8 (or model-dtype) KV pool — the port
of ``repro/kernels/paged_attention.py``.

Two implementations of one dataflow:

- ``paged_attention_cuda``: the hand-written CUDA kernel
  (``csrc/paged_attention.cu``), one block per (slot, KV head) walking the
  slot's page list with an online softmax; see the source note for its
  design and limits.
- ``paged_attention_torch``: the same page walk in plain PyTorch — the
  counterpart of ``paged_attention_jnp`` at ``page_chunk=1``: per page,
  gather one page per slot, dequantize, fold into (m, l, acc) with
  ``_block_update`` (the Pallas kernel's exact update). It is the CPU
  path, and the oracle the kernel is held against on the card.

Numerics contract (``repro``'s): per slot, query row j computes
softmax(q_j·K^T / sqrt(Dh), masked to ``pos <= lens[slot] + j``) @ V in
f32, masked scores are ``NEG_INF = -1e30``, and the output is
``acc / max(l, 1e-30)`` in q's dtype.

Layouts: q (B, S, Hq, Dh), or rank-3 (B, Hq, Dh) for S=1 decode (returned
rank-3); k/v pages (P+1, page, Hkv, Dh), row P the trash page; kscale/
vscale (B,) f32 pow-2 ``scale_log2``; table (B, pages_per_slot) int32;
lens (B,) int32 position of the first query row.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build as B

NEG_INF = -1e30
NAME = "paged_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _norm_q(q: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Accept (B, Hq, Dh) [S=1 decode] or (B, S, Hq, Dh); return the rank-4
    view plus whether to squeeze the S axis back out of the result."""
    if q.dim() == 3:
        return q[:, None], True
    if q.dim() == 4:
        return q, False
    raise ValueError(f"q must be rank 3 or 4, got {tuple(q.shape)}")


def _block_update(m, l, acc, qf, k, v, base_pos: int, limit, scale: float):
    """One online-softmax step (``repro``'s ``_block_update``).

    qf: (b, S, Hkv, g, Dh) f32 grouped queries; k/v: (b, cp, Hkv, Dh) f32
    dequantized keys/values at positions base_pos..base_pos+cp-1; limit:
    (b, S) per-row causal limits; m/l: (b, S, Hq, 1); acc: (b, S, Hq, Dh)."""
    b, sq, hkv, g, dh = qf.shape
    cp = k.shape[1]
    hq = hkv * g
    s = torch.einsum("bshgd,bphd->bshgp", qf, k) * scale
    pos = base_pos + torch.arange(cp, device=qf.device)
    s = torch.where(pos <= limit[:, :, None, None, None], s, NEG_INF)
    s = s.reshape(b, sq, hq, cp)
    m_new = torch.maximum(m, s.amax(dim=3, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=3, keepdim=True)
    acc_new = acc * corr + torch.einsum(
        "bshgp,bphd->bshgd", p.reshape(b, sq, hkv, g, cp), v
    ).reshape(b, sq, hq, dh)
    return m_new, l_new, acc_new


def paged_attention_torch(q: torch.Tensor, kdata: torch.Tensor,
                          vdata: torch.Tensor, kscale: torch.Tensor,
                          vscale: torch.Tensor, table: torch.Tensor,
                          lens: torch.Tensor, *, page_size: int,
                          quantized: bool) -> torch.Tensor:
    """Plain page walk, one page per step over every slot at once."""
    q, squeeze = _norm_q(q)
    b, sq, hq, dh = q.shape
    pp = table.shape[1]
    hkv = kdata.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().reshape(b, sq, hkv, g, dh)
    ks = torch.exp2(kscale.float())[:, None, None, None]
    vs = torch.exp2(vscale.float())[:, None, None, None]
    limit = lens.long()[:, None] + torch.arange(sq, device=q.device)[None]
    m = torch.full((b, sq, hq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, sq, hq, 1), device=q.device)
    acc = torch.zeros((b, sq, hq, dh), device=q.device)
    for p in range(pp):
        pages = table[:, p].long()
        k = kdata[pages].float()                  # (B, page, Hkv, Dh)
        v = vdata[pages].float()
        if quantized:
            k = k * ks
            v = v * vs
        m, l, acc = _block_update(m, l, acc, qf, k, v, p * page_size, limit,
                                  scale)
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out[:, 0] if squeeze else out


def _lib() -> ctypes.CDLL:
    lib = B.load(NAME)
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention.argtypes = [p, i, p, p, i, p, p, p, p, p,
                                        i, i, i, i, i, i, i, p]
        lib.paged_attention.restype = i
        lib._repro_typed = True
    return lib


def paged_attention_cuda(q: torch.Tensor, kdata: torch.Tensor,
                         vdata: torch.Tensor, kscale: torch.Tensor,
                         vscale: torch.Tensor, table: torch.Tensor,
                         lens: torch.Tensor, *, page_size: int,
                         quantized: bool) -> torch.Tensor:
    """Launch the CUDA kernel. Every operand must lie on one CUDA device;
    shapes and dtypes the kernel does not take raise."""
    q4, squeeze = _norm_q(q)
    b, sq, hq, dh = q4.shape
    dev = q4.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (kdata, vdata, kscale, vscale, table, lens)):
        raise ValueError(f"{NAME}: every operand must be on one CUDA device")
    if q4.dtype not in _DTYPE_CODE:
        raise TypeError(f"{NAME}: unsupported q dtype {q4.dtype}")
    want = torch.int8 if quantized else q4.dtype
    if kdata.dtype != want or vdata.dtype != want:
        raise TypeError(f"{NAME}: pages must be {want}, got {kdata.dtype}")
    if kdata.dim() != 4 or kdata.shape != vdata.shape \
            or kdata.shape[1] != page_size or kdata.shape[3] != dh:
        raise ValueError(f"{NAME}: pages {tuple(kdata.shape)} do not match "
                         f"page_size={page_size}, Dh={dh}")
    hkv = kdata.shape[2]
    if hq % hkv:
        raise ValueError(f"{NAME}: Hq={hq} is not a multiple of Hkv={hkv}")
    if table.dim() != 2 or table.shape[0] != b or lens.shape != (b,) \
            or kscale.shape != (b,) or vscale.shape != (b,):
        raise ValueError(f"{NAME}: table/lens/scales must be (B, pps)/(B,)")
    q4 = q4.contiguous()
    kdata, vdata = kdata.contiguous(), vdata.contiguous()
    table = table.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    kscale = kscale.to(torch.float32).contiguous()
    vscale = vscale.to(torch.float32).contiguous()
    out = torch.empty_like(q4)
    lib = _lib()
    B.check(lib, lib.paged_attention(
        q4.data_ptr(), _DTYPE_CODE[q4.dtype], kdata.data_ptr(),
        vdata.data_ptr(), int(quantized), kscale.data_ptr(),
        vscale.data_ptr(), table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, sq, hq, hkv, dh, page_size, table.shape[1],
        torch.cuda.current_stream(dev).cuda_stream), NAME)
    B.note_launch(NAME)
    return out[:, 0] if squeeze else out
