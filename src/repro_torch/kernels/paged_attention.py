"""Fused paged attention over the int8 (or model-dtype) KV pool — the port
of ``repro/kernels/paged_attention.py``.

Two implementations of one dataflow:

- ``paged_attention_cuda``: the hand-written CUDA kernels
  (``csrc/paged_attention.cu``), flash-decoding style: ``pa_split_cuda``
  launches one CTA per (slot, KV head, span of ``pages_per_split``
  pages) writing a partial (m, l, acc) to f32 scratch, and
  ``pa_combine_cuda`` merges the spans in split order; the launch plan is
  the pure function ``plan``. See the source note for the design.
- ``paged_attention_torch``: the page walk in plain PyTorch — the
  counterpart of ``paged_attention_jnp`` at ``page_chunk=1``: per page,
  gather one page per slot, dequantize, fold into (m, l, acc) with
  ``_block_update`` (the Pallas kernel's exact update). It is the CPU
  path, and the oracle the kernels are held against on the card.

``pa_split_torch`` and ``pa_combine_torch`` mirror the two kernels in plain
PyTorch, partial for partial (the CPU tests hold the mirror to the page
walk and the Pallas kernel, and the card holds each kernel to its mirror).

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
import functools
import math
from dataclasses import astuple, dataclass

import torch

from . import build as B

NEG_INF = -1e30
NAME = "paged_attention"
COMBINE = "paged_attention_combine"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
PAGES_PER_SPLIT = 8         # pages a split CTA takes (128 keys at page 16)
THREADS = 256               # csrc/paged_attention.cu kThreads
SMEM_MAX = 232_448          # the most shared memory a CTA may ask for

PLAN_FIELDS = ("B", "S", "Hq", "Hkv", "Dh", "page", "pps", "pps_split",
               "n_split", "R", "gb", "pitch", "kp", "qs_off", "ps_off",
               "smem", "grid")


@dataclass(frozen=True)
class Plan:
    B: int
    S: int
    Hq: int
    Hkv: int
    Dh: int
    page: int
    pps: int             # pages per slot
    pps_split: int       # pages per span (a split CTA)
    n_split: int         # spans per slot
    R: int               # query rows per CTA: S * Hq / Hkv
    gb: int              # copy granule bytes of a K/V row (16 or 4)
    pitch: int           # shared-memory bytes between K (V) rows
    kp: int              # lanes sharing a (row, column quad) in P @ V
    qs_off: int          # byte offset of the queries in shared memory
    ps_off: int          # and of the scores
    smem: int            # dynamic shared-memory bytes
    grid: int            # split CTAs

    @functools.cached_property
    def fields(self) -> ctypes.Array:
        """The plan as the C side's ``int32[17]``."""
        return (ctypes.c_int * len(PLAN_FIELDS))(*astuple(self))


assert tuple(Plan.__dataclass_fields__) == PLAN_FIELDS


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


@functools.lru_cache(maxsize=256)
def plan(b: int, s: int, hq: int, hkv: int, dh: int, page: int, pps: int,
         kv_elsize: int, kv_misalign: int = 0,
         pages_per_split: int = PAGES_PER_SPLIT) -> Plan:
    """The split pass's launch plan: spans of ``pages_per_split`` pages
    (fewer where a span's K and V would not fit shared memory), ``n_split``
    of them per slot from ``pps`` alone; K/V rows copied in 16-byte
    granules where the row (``dh * kv_elsize`` bytes) and the pages'
    address (``kv_misalign``, mod 16) allow, else 4; rows padded to an odd
    number of 16-byte units; ``kp`` lanes per (row, column quad) in
    P @ V, so a pass of the CTA's threads covers the rows."""
    if min(b, s, hkv, dh, page, pps, pages_per_split) <= 0 or hq % hkv \
            or dh % 4 or kv_elsize not in (1, 2, 4):
        raise ValueError(f"{NAME}: bad shape B={b} S={s} Hq={hq} Hkv={hkv} "
                         f"Dh={dh} page={page} pps={pps}")
    r = s * (hq // hkv)
    row = dh * kv_elsize
    gb = 16 if row % 16 == 0 and kv_misalign % 16 == 0 else 4
    if row % gb or kv_misalign % gb:
        raise ValueError(f"{NAME}: K/V rows of {row} bytes at offset "
                         f"{kv_misalign} take no 4-byte copies")
    units = _cdiv(row, 16)
    pitch = 16 * (units + (1 if units % 2 == 0 else 2))
    pps_split = min(pages_per_split, pps)

    def layout(n: int) -> tuple[int, int, int]:
        keys = n * page
        qs_off = 2 * keys * pitch
        ps_off = qs_off + r * dh * 4
        return qs_off, ps_off, ps_off + _cdiv(r * keys * 4, 16) * 16
    while pps_split > 1 and layout(pps_split)[2] > SMEM_MAX:
        pps_split -= 1
    qs_off, ps_off, smem = layout(pps_split)
    if smem > SMEM_MAX:
        raise ValueError(f"{NAME}: a one-page span needs {smem} bytes of "
                         "shared memory")
    n_split = _cdiv(pps, pps_split)
    items = r * (dh // 4)
    kp = 1
    while kp < 32 and items * kp * 2 <= THREADS:
        kp *= 2
    return Plan(b, s, hq, hkv, dh, page, pps, pps_split, n_split, r, gb,
                pitch, kp, qs_off, ps_off, smem, b * hkv * n_split)


def spans_needed(lens: torch.Tensor, s: int, page: int, pps: int,
                 pps_split: int) -> torch.Tensor:
    """Spans each slot needs: those holding a page with a position <=
    lens + S - 1 (the kernels compute the same from ``lens`` on the
    card)."""
    n_pages = torch.clamp((lens.long() + s - 1) // page + 1, max=pps)
    return (n_pages + pps_split - 1) // pps_split


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


def pa_split_torch(q: torch.Tensor, kdata: torch.Tensor, vdata: torch.Tensor,
                   kscale: torch.Tensor, vscale: torch.Tensor,
                   table: torch.Tensor, lens: torch.Tensor, *, page_size: int,
                   quantized: bool, pages_per_split: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split kernel's partials in plain PyTorch: for each (slot, KV
    head, span) over the span's keys up to the slot's last needed page,
    m = max score (-1e30 where every key is masked), l = sum e^(s - m) and
    acc = sum e^(s - m) v, as (B, Hkv, n_split, R) and (..., R, Dh) f32.
    Spans a slot does not need hold m = -1e30, l = 0, acc = 0 (the kernel
    leaves them unwritten; the combine never reads them)."""
    q4, _ = _norm_q(q)
    b, sq, hq, dh = q4.shape
    pps = table.shape[1]
    hkv = kdata.shape[2]
    g = hq // hkv
    r = sq * g
    ps = min(pages_per_split, pps)
    ns = _cdiv(pps, ps)
    dev = q4.device
    # (B, Hkv, R, Dh), row r = j * g + gi
    qg = q4.float().reshape(b, sq, hkv, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, r, dh)
    scale = 1.0 / math.sqrt(dh)
    limit = lens.long()[:, None] + torch.arange(r, device=dev)[None] // g
    n_keys = torch.clamp((lens.long() + sq - 1) // page_size + 1,
                         max=pps) * page_size
    m = torch.full((b, hkv, ns, r), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, ns, r), device=dev)
    acc = torch.zeros((b, hkv, ns, r, dh), device=dev)
    for sp in range(ns):
        cols = table[:, sp * ps:(sp + 1) * ps].long()       # (B, np)
        k = kdata[cols].float().flatten(1, 2)        # (B, keys, Hkv, Dh)
        v = vdata[cols].float().flatten(1, 2)
        if quantized:
            k = k * torch.exp2(kscale.float())[:, None, None, None]
            v = v * torch.exp2(vscale.float())[:, None, None, None]
        pos = sp * ps * page_size + torch.arange(k.shape[1], device=dev)
        sc = torch.einsum("bhrd,bthd->bhrt", qg, k) * scale
        sc = torch.where(pos[None, None, None] <= limit[:, None, :, None],
                         sc, NEG_INF)
        # keys past the slot's last needed page are not in the span at all
        sc = torch.where(pos[None, None, None] < n_keys[:, None, None, None],
                         sc, -math.inf)
        mx = sc.amax(dim=3)
        e = torch.exp(sc - mx[..., None])
        m[:, :, sp], l[:, :, sp] = mx, e.sum(dim=3)
        acc[:, :, sp] = torch.einsum("bhrt,bthd->bhrd", e, v)
    need = spans_needed(lens, sq, page_size, pps, ps).to(dev)
    on = torch.arange(ns, device=dev)[None] < need[:, None]       # (B, ns)
    on = on[:, None, :, None]
    return (torch.where(on, m, NEG_INF), torch.where(on, l, 0.0),
            torch.where(on[..., None], acc, 0.0))


def pa_combine_torch(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     lens: torch.Tensor, *, s: int, page_size: int, pps: int,
                     pages_per_split: int, dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel in plain PyTorch: the spans a slot needs meet with
    weights e^(m_s - M); out = acc / max(L, 1e-30) as (B, S, Hq, Dh) of
    ``dtype``. Spans it does not need are never read (their scratch may
    hold anything)."""
    b, hkv, ns, r = m.shape
    dh = acc.shape[-1]
    ps = min(pages_per_split, pps)
    need = spans_needed(lens, s, page_size, pps, ps).to(m.device)
    on = (torch.arange(ns, device=m.device)[None] < need[:, None]
          )[:, None, :, None]                                     # (B,1,ns,1)
    mv = torch.where(on, m, -math.inf)
    big = mv.amax(dim=2, keepdim=True)
    w = torch.exp(mv - big)                                       # 0 when off
    L = torch.where(on, w * l, 0.0).sum(dim=2)
    num = torch.where(on[..., None], w[..., None] * acc, 0.0).sum(dim=2)
    out = num / torch.clamp(L, min=1e-30)[..., None]       # (B, Hkv, R, Dh)
    g = r // s
    return out.reshape(b, hkv, s, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, s, hkv * g, dh).to(dtype)


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/paged_attention.cu``) with its two
    entries given their C signatures."""
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fields = ctypes.POINTER(ctypes.c_int)
        lib.paged_attention_split.argtypes = [p, i, p, p, i, p, p, p, p, p,
                                              p, p, fields, p]
        lib.paged_attention_split.restype = i
        lib.paged_attention_combine.argtypes = [p, p, p, p, p, i, fields, p]
        lib.paged_attention_combine.restype = i
        lib._repro_typed = True
    return lib


def _checked(q, kdata, vdata, kscale, vscale, table, lens, page_size,
             quantized):
    """Check and normalise the operands for the kernels; returns them with
    the rank-4 q, whether to squeeze S back out, and the launch plan."""
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
    mis = (kdata.data_ptr() % 16) | (vdata.data_ptr() % 16)
    p = plan(b, sq, hq, hkv, dh, page_size, table.shape[1],
             kdata.element_size(), mis)
    return (q4, kdata, vdata, kscale.to(torch.float32).contiguous(),
            vscale.to(torch.float32).contiguous(),
            table.to(torch.int32).contiguous(),
            lens.to(torch.int32).contiguous(), squeeze, p)


def pa_split_cuda(q4, kdata, vdata, kscale, vscale, table, lens, p: Plan,
                  quantized: bool, lib: ctypes.CDLL | None = None):
    """Launch the split pass (``csrc/paged_attention.cu``'s, or ``lib``'s,
    a build of it elsewhere) on checked operands (``_checked``): the
    partials (m, l, acc) in fresh f32 scratch; spans a slot does not need
    are left unwritten. Counts one launch of ``paged_attention``."""
    dev = q4.device
    m = torch.empty((p.B, p.Hkv, p.n_split, p.R), device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((p.B, p.Hkv, p.n_split, p.R, p.Dh), device=dev)
    lib = typed(lib or B.load(NAME))
    B.check(lib, lib.paged_attention_split(
        q4.data_ptr(), _DTYPE_CODE[q4.dtype], kdata.data_ptr(),
        vdata.data_ptr(), int(quantized), kscale.data_ptr(),
        vscale.data_ptr(), table.data_ptr(), lens.data_ptr(), m.data_ptr(),
        l.data_ptr(), acc.data_ptr(), p.fields,
        torch.cuda.current_stream(dev).cuda_stream), NAME)
    B.note_launch(NAME)
    return m, l, acc


def pa_combine_cuda(m, l, acc, lens, p: Plan, dtype: torch.dtype
                    ) -> torch.Tensor:
    """Launch the combine pass: (B, S, Hq, Dh) of ``dtype``. Counts one
    launch of ``paged_attention_combine``."""
    out = torch.empty((p.B, p.S, p.Hq, p.Dh), dtype=dtype, device=m.device)
    lib = typed(B.load(NAME))
    B.check(lib, lib.paged_attention_combine(
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), lens.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[dtype], p.fields,
        torch.cuda.current_stream(m.device).cuda_stream), COMBINE)
    B.note_launch(COMBINE)
    return out


def paged_attention_cuda(q: torch.Tensor, kdata: torch.Tensor,
                         vdata: torch.Tensor, kscale: torch.Tensor,
                         vscale: torch.Tensor, table: torch.Tensor,
                         lens: torch.Tensor, *, page_size: int,
                         quantized: bool) -> torch.Tensor:
    """Launch the split and combine kernels. Every operand must lie on one
    CUDA device; shapes and dtypes the kernels do not take raise."""
    q4, kdata, vdata, kscale, vscale, table, lens, squeeze, p = _checked(
        q, kdata, vdata, kscale, vscale, table, lens, page_size, quantized)
    m, l, acc = pa_split_cuda(q4, kdata, vdata, kscale, vscale, table, lens,
                              p, quantized)
    out = pa_combine_cuda(m, l, acc, lens, p, q4.dtype)
    return out[:, 0] if squeeze else out
