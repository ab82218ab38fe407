"""Slot-paged KV-cache pool with pow-2 int8 storage — the port of
``repro/serve/kv_cache.py``.

The pool is a set of fixed-size *pages* shared by all request slots; token
position ``t`` of a slot lives at ``(page_table[slot, t // page_size],
t % page_size)``. Inactive slots and padding write to a reserved *trash
page* (row ``total_pages``). An attention sublayer caches two tensors a
token: GQA's K and V, or MLA's latent ``c_kv`` and rope key ``k_rope``,
of different widths (``kv_feature_shapes``); the paged kernels take the
pair in one launch either way, each at its own width. With
``quantized=True`` the tensors are int8 codes on
a power-of-2 grid, ``x ≈ q * 2^scale_log2``, one ``scale_log2`` per
(layer, slot, tensor) chosen from the prompt's range at prefill and reused
by decode appends (the paper's §3.2 numerics applied to serving).

Every pool write goes through an encode kernel and every gathered read
through a decode kernel (on CPU tensors their plain versions): a decode
step's append, a speculative verify block's and a chunk step's write
through ``p2_append_paged`` (``kernels/kv_append.py``: K and V of every
row into the layer's pages in one launch), a whole-prompt prefill's write through ``p2_prefill_paged``
(``kernels/kv_prefill.py``: K and V of every layer into the slot's pages
in one launch that also chooses the slot's scales), a chunk step's history
read and the gather engine's decode read through ``p2_read_paged``
(``kernels/kv_read.py``: K and V of every slot off the pages in one
launch). The fused path reads pages straight from the pool inside the
paged-attention kernel. A model-dtype pool runs no kernel: its writes are
scatters and its reads gathers, as in the reference.

In-place updates: where the reference donates the pool to a jitted step
and rebuilds it with ``.at[].set``, the port writes into the preallocated
pool tensors with ``index_put_``. The functions below mutate their pool
arguments and return them for symmetry with the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.kv_append import token_pages
from ..models.common import torch_dtype
from ..numerics import QTensor, QuantSpec, get_codec

CODEC_BACKEND = "cuda"


def _kv_spec(bits: int) -> QuantSpec:
    """The ``kv_cache`` site: pow-2 int8 codes, per-tensor-max scale chosen
    at prefill."""
    return QuantSpec("pow2", bits, 0, "int8", "per_tensor_max")


@dataclass(frozen=True)
class PoolConfig:
    """Geometry + numerics of the paged pool."""
    num_slots: int              # max concurrent requests (decode batch)
    page_size: int = 16         # tokens per page
    pages_per_slot: int = 8     # max pages one slot may hold
    num_pages: int = 0          # physical pages shared by all slots
                                # (0 => num_slots * pages_per_slot)
    quantized: bool = False     # int8 pow-2 storage vs model-dtype storage
    bits: int = 8

    @property
    def spec(self) -> QuantSpec:
        return _kv_spec(self.bits)

    @property
    def max_len(self) -> int:
        return self.page_size * self.pages_per_slot

    @property
    def total_pages(self) -> int:
        return self.num_pages or self.num_slots * self.pages_per_slot

    @property
    def trash_page(self) -> int:
        """Reserved page absorbing writes from inactive/padded positions."""
        return self.total_pages

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)


# ---------------------------------------------------------------------------
# Pool construction
# ---------------------------------------------------------------------------

def kv_feature_shapes(sub) -> dict[str, tuple[int, ...]]:
    """Per-token trailing feature shape of each cached tensor of a
    sublayer (the layouts ``models/attention.py`` caches). Recurrent mixers
    (mamba, rwkv6) cache no per-token tensors (their O(1) state lives in
    ``state_cache``'s pool), so they map to {}."""
    if sub.mixer_kind == "attn_gqa":
        d = sub.mixer
        return {"k": (d.num_kv_heads, d.head_dim),
                "v": (d.num_kv_heads, d.head_dim)}
    if sub.mixer_kind == "attn_mla":
        m = sub.mixer.m
        return {"c_kv": (m.kv_lora_rank,), "k_rope": (m.qk_rope_head_dim,)}
    if sub.mixer_kind in ("mamba", "rwkv6"):
        return {}
    raise ValueError(f"unknown mixer kind {sub.mixer_kind!r}")


def init_pool(lm, pcfg: PoolConfig, device: torch.device) -> dict:
    """Allocate the pool: {"data": {sub_i: {name: (L, P+1, page, *feat)
    int8|dtype}}, "scale_log2": {sub_i: {name: (L, num_slots) f32}}}.
    Recurrent sublayers get empty dicts (their state lives in
    ``state_cache``'s pool, keyed alike)."""
    store = torch.int8 if pcfg.quantized else torch_dtype(lm.cfg.dtype)
    L = lm.n_periods
    data, scale = {}, {}
    for i, sub in enumerate(lm.period):
        feats = kv_feature_shapes(sub)
        data[f"sub_{i}"] = {
            name: torch.zeros((L, pcfg.total_pages + 1, pcfg.page_size) + f,
                              dtype=store, device=device)
            for name, f in feats.items()}
        scale[f"sub_{i}"] = {
            name: torch.zeros((L, pcfg.num_slots), dtype=torch.float32,
                              device=device)
            for name in feats}
    return {"data": data, "scale_log2": scale}


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def pool_bytes(pool: dict) -> int:
    """Resident bytes of the cache pool (storage + scales)."""
    return sum(t.numel() * t.element_size() for t in _leaves(pool))


def pool_bytes_fp32(pool: dict) -> int:
    """What the same pool's data would cost stored as f32 (scales excluded)."""
    return 4 * sum(t.numel() for t in _leaves(pool["data"]))


def page_nbytes(pool: dict, pcfg: PoolConfig) -> int:
    """Physical bytes of ONE page summed across every cached tensor of
    every layer (each data leaf (L, P+1, page, *feat) gives each of its
    P+1 pages an equal slice); per-slot scales excluded."""
    n = pcfg.total_pages + 1
    return sum(t.numel() * t.element_size() // n
               for t in _leaves(pool["data"]))


# ---------------------------------------------------------------------------
# Quantize / dequantize — the ``kv_cache`` site of the codec registry
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor, scale_log2: torch.Tensor,
             bits: int) -> torch.Tensor:
    """fp -> int8 codes; scale_log2 broadcast against x's leading dims (one
    encode launch: the scalar kernel for a one-element scale, else the
    row-scale kernel)."""
    spec = _kv_spec(bits)
    return get_codec(spec, CODEC_BACKEND).encode(x, spec, scale_log2).codes


def dequantize(q: torch.Tensor, scale_log2: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    spec = _kv_spec(8)
    return get_codec(spec, CODEC_BACKEND).decode(QTensor(q, scale_log2, spec),
                                                 dtype)


# ---------------------------------------------------------------------------
# Per-layer primitives (used by the engine's layer loop)
# ---------------------------------------------------------------------------

def gather_slots(data_l: torch.Tensor, scale_l: torch.Tensor,
                 table: torch.Tensor, pcfg: PoolConfig,
                 dtype: torch.dtype) -> torch.Tensor:
    """Materialize every slot's cache view for one layer: data_l (P+1,
    page, *feat), scale_l (B,), table (B, pages_per_slot) -> (B, max_len,
    *feat) in ``dtype``, dequantized on read (one decode launch: rows = B,
    or the scalar kernel for the chunk step's one slot)."""
    g = data_l[table.long()]                              # (B, pp, page, *f)
    b = table.shape[0]
    g = g.reshape((b, pcfg.max_len) + tuple(g.shape[3:]))
    if pcfg.quantized:
        return dequantize(g, scale_l.reshape((b,) + (1,) * (g.dim() - 1)),
                          dtype)
    return g.to(dtype)


def fused_attend(kdata_l: torch.Tensor, vdata_l: torch.Tensor,
                 kscale_l: torch.Tensor, vscale_l: torch.Tensor,
                 q: torch.Tensor, table: torch.Tensor, lens: torch.Tensor,
                 pcfg: PoolConfig) -> torch.Tensor:
    """GQA attention straight off one layer's pages (the paged-attention
    kernel): the (B, max_len, *feat) slot view is never materialized.
    q: (B, Hq, Dh) decode or (B, S, Hq, Dh); returns the same rank."""
    from ..kernels.ops import paged_attention
    return paged_attention(q, kdata_l, vdata_l, kscale_l, vscale_l, table,
                           lens, page_size=pcfg.page_size,
                           quantized=pcfg.quantized)


def append_tokens(data_l: torch.Tensor, scale_l: torch.Tensor,
                  new: torch.Tensor, table: torch.Tensor, lens: torch.Tensor,
                  active: torch.Tensor, pcfg: PoolConfig) -> torch.Tensor:
    """Write S new tokens per slot at positions lens .. lens+S-1, one
    tensor, in place (the reference's ``append_tokens``, the speculative
    verify write; one tensor's half of ``append_kv``).

    new: (B, S, *feat). Inactive slots and rows at or past ``max_len`` (a
    verify block overhanging the slot's horizon) go to the trash page.
    Values clip into the slot's prefill scale. A rejected tail's K/V stays
    above the slot's length, where no read looks and a later write
    overwrites it: rollback moves no data (``Scheduler.trim_unused``)."""
    b, s = new.shape[:2]
    pages, offs = token_pages(table, lens, active, s, pcfg.page_size,
                              pcfg.trash_page)
    if pcfg.quantized:
        vals = quantize(new, scale_l.reshape((b,) + (1,) * (new.dim() - 1)),
                        pcfg.bits)
    else:
        vals = new.to(data_l.dtype)
    return data_l.index_put_((pages, offs), vals)


def append_health(new: torch.Tensor, scale_l: torch.Tensor,
                  active: torch.Tensor, pcfg: PoolConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(clipped, total) of one decode append against the slots' prefill-
    frozen scales — the ``kv_cache`` quant-health signal, the reference's
    ``append_health``: new (B, 1, *feat), scale_l (B,), active (B,) bool.
    Integer-exact. The engine's decode step takes the same counts from the
    append itself (``append_kv(..., health=)``: on the card inside the
    ``p2_append_paged`` launch, on the CPU through this function)."""
    from ..obs.counters import pow2_clip_stats
    vals = new[:, 0]
    valid = active.reshape((-1,) + (1,) * (vals.dim() - 1))
    return pow2_clip_stats(vals, scale_l, pcfg.bits, valid=valid)


def append_kv(kdata_l: torch.Tensor, vdata_l: torch.Tensor,
              kscale_l: torch.Tensor, vscale_l: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor, table: torch.Tensor,
              lens: torch.Tensor, active: torch.Tensor, pcfg: PoolConfig,
              health: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A sublayer's two cached tensors (B, S, *feat) of one layer into its
    pages at positions lens .. lens+S-1, in place (K and V, or MLA's
    ``c_kv`` and ``k_rope`` at their own widths, in the ``k``/``v``
    arguments): S = 1 is the decode step's
    append, S = k+1 the speculative verify block. A quantized pool takes
    one ``p2_append_paged`` launch (its plain twin on CPU tensors), rows
    past the slot's last page to the trash page; a model-dtype pool
    ``append_tokens`` per tensor (the reference runs no kernel there
    either). ``health`` (a (2,) int64 tensor, quantized pools only) gets
    ``append_health`` of both tensors added, counted by the launch."""
    if pcfg.quantized:
        from ..kernels.ops import append_paged
        return append_paged(kdata_l, vdata_l, kscale_l, vscale_l, k_new,
                            v_new, table, lens, active,
                            page_size=pcfg.page_size, bits=pcfg.bits,
                            health=health)
    if health is not None:
        raise ValueError("append_kv: quant health counts a quantized pool")
    return (append_tokens(kdata_l, kscale_l, k_new, table, lens, active,
                          pcfg),
            append_tokens(vdata_l, vscale_l, v_new, table, lens, active,
                          pcfg))


def write_prefill(pool: dict, cache: dict, table_row: torch.Tensor,
                  slot: int, length, pcfg: PoolConfig) -> dict:
    """Scatter a whole-prompt prefill cache (``lm_forward``'s, leaves
    (L, 1, S, *feat)) into the pool for one slot, all layers at once, in
    place. Rows past ``length`` (an int, or a (1,) int tensor read on the
    device; bucket padding) go to the trash page. A quantized pool takes
    one ``p2_prefill_paged`` launch a sublayer for its two cached tensors
    (K and V, or ``c_kv`` and ``k_rope``, under the cache's own names) of
    every layer, which chooses the slot's per-layer scales on the device
    (its plain twin on CPU tensors); a model-dtype pool a scatter per
    tensor (the reference runs no kernel there either)."""
    if pcfg.quantized:
        from ..kernels.ops import prefill_paged
        for key, kinds in cache.items():
            data, scale = pool["data"][key], pool["scale_log2"][key]
            kn, vn = data
            prefill_paged(data[kn], data[vn], scale[kn], scale[vn],
                          kinds[kn][:, 0], kinds[vn][:, 0], table_row, slot,
                          length, page_size=pcfg.page_size, bits=pcfg.bits)
        return pool
    sample = next(iter(next(iter(cache.values())).values()))
    s = sample.shape[2]
    pos = torch.arange(s, device=sample.device)
    page_idx = torch.clamp(pos // pcfg.page_size, max=pcfg.pages_per_slot - 1)
    pages = torch.where(pos < length, table_row.long()[page_idx],
                        pcfg.trash_page)
    offs = pos % pcfg.page_size
    for key, kinds in cache.items():
        for name, arr in kinds.items():
            dest = pool["data"][key][name]
            dest[:, pages, offs] = arr[:, 0].to(dest.dtype)
    return pool


def write_chunk(data_l: torch.Tensor, scale_l: torch.Tensor,
                vals: torch.Tensor, table_row: torch.Tensor, start,
                valid_len, slot: int, pcfg: PoolConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a prefill chunk of one slot into one layer's pool, in place.

    vals: (S, *feat) fp (positions start..start+S-1; only the first
    ``valid_len`` rows are real; each an int or a 0-d tensor). The slot's
    scale must already be set (the first prefill chunk goes through
    ``write_prefill``, or a prefix hit adopts its donor's); this chunk
    clips into that range, one scalar-scale encode launch. Pad rows go to the trash page; their page index is
    clamped first (the reference's gather clamps it silently, PyTorch's
    indexing would raise past the slot's last page)."""
    s = vals.shape[0]
    dev = vals.device
    j = torch.arange(s, device=dev)
    pos = start + j
    page_idx = torch.clamp(pos // pcfg.page_size, max=pcfg.pages_per_slot - 1)
    pages = torch.where(j < valid_len, table_row.long()[page_idx],
                        pcfg.trash_page)
    offs = pos % pcfg.page_size
    if pcfg.quantized:
        vals = quantize(vals, scale_l[slot][None], pcfg.bits)
    else:
        vals = vals.to(data_l.dtype)
    data_l.index_put_((pages, offs), vals)
    return data_l, scale_l


def write_chunk_kv(kdata_l: torch.Tensor, vdata_l: torch.Tensor,
                   kscale_l: torch.Tensor, vscale_l: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, table: torch.Tensor,
                   start: torch.Tensor, n_valid: torch.Tensor,
                   pcfg: PoolConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """A chunk's two cached tensors (B, S, *feat) of one layer (K and V, or
    ``c_kv`` and ``k_rope``) into its pages, in place: row j of slot b at position ``start[b] + j``, the first
    ``n_valid[b]`` rows real, the others to the trash page, under the
    slots' scales ``kscale_l``/``vscale_l`` (B,) (the engine's chunk step
    passes its slot's as (1,) views). ``start`` and ``n_valid`` are (B,)
    int tensors, read on the device. A quantized pool takes one
    ``p2_append_paged`` launch with ``write_chunk``'s rule for a row past
    the slot's last page (its page index clamped); a model-dtype pool
    ``write_chunk`` per slot and tensor (the reference runs no kernel
    there either)."""
    if pcfg.quantized:
        from ..kernels.ops import append_paged
        return append_paged(kdata_l, vdata_l, kscale_l, vscale_l, k, v,
                            table, start, None, page_size=pcfg.page_size,
                            bits=pcfg.bits, n_valid=n_valid, clamp_last=True)
    for b in range(k.shape[0]):
        write_chunk(kdata_l, kscale_l, k[b], table[b], start[b], n_valid[b],
                    b, pcfg)
        write_chunk(vdata_l, vscale_l, v[b], table[b], start[b], n_valid[b],
                    b, pcfg)
    return kdata_l, vdata_l


def read_kv(kdata_l: torch.Tensor, vdata_l: torch.Tensor,
            kscale_l: torch.Tensor, vscale_l: torch.Tensor,
            table: torch.Tensor, pcfg: PoolConfig, dtype: torch.dtype
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every slot's (B, max_len, *feat) views of one layer's two cached
    tensors (K and V, or ``c_kv`` and ``k_rope``) in ``dtype``:
    ``gather_slots`` of each tensor. A quantized pool takes one
    ``p2_read_paged`` launch, decoding straight off the pages; a
    model-dtype pool ``gather_slots`` per tensor."""
    if pcfg.quantized:
        from ..kernels.ops import read_paged
        return read_paged(kdata_l, vdata_l, kscale_l, vscale_l, table,
                          dtype=dtype)
    return (gather_slots(kdata_l, kscale_l, table, pcfg, dtype),
            gather_slots(vdata_l, vscale_l, table, pcfg, dtype))


class PageRefs:
    """Host-side reference counts over the pool's physical pages.

    A page's count is the number of *readers* currently holding it mapped
    or reserved: every slot that acquired the page as a shared prefix page,
    plus the slot (if any) that reserved it as a COW-fork source. Tree
    ownership itself (``serve/prefix.py``) is NOT a reference — a cached
    page with no live readers has count 0 and is evictable."""

    def __init__(self, num_pages: int):
        self._refs = np.zeros(num_pages, np.int32)

    def acquire(self, pages: list[int]) -> None:
        for p in pages:
            self._refs[p] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] < 0:
                raise AssertionError(f"page {p} released below zero")

    def count(self, page: int) -> int:
        return int(self._refs[page])

    def unreferenced(self, pages: list[int]) -> bool:
        return all(self._refs[p] == 0 for p in pages)


def fork_page(pool: dict, src: int, dst: int) -> dict:
    """Copy-on-write page copy, in place: physical page ``src`` into
    ``dst`` for every cached tensor of every layer, codes (or fp values)
    verbatim — no dequant/requant, so a forked page is the donor's up to
    the fork point. The reader must adopt the donor's scales
    (``adopt_scales``) for those codes to decode to the donor's values."""
    for t in _leaves(pool["data"]):
        t[:, dst] = t[:, src]
    return pool


def snapshot_scales(pool: dict, slot: int) -> dict:
    """Copy of one slot's per-layer scales, {key: {name: (L,) f32}}, on the
    pool's device. Taken after prefill so the prefix tree can hand the same
    decode grid to every future reader of the inserted pages."""
    return {key: {name: arr[:, slot].clone() for name, arr in kinds.items()}
            for key, kinds in pool["scale_log2"].items()}


def adopt_scales(pool: dict, slot: int, snap: dict) -> dict:
    """Set one slot's scale rows from a prefix node's snapshot (leaves
    (L,)), in place. Shared int8 pages then decode under the exact grid
    they were written with; the reader's own suffix chunks and decode
    appends clip into it, as chunked prefill does."""
    for key, kinds in snap.items():
        for name, vals in kinds.items():
            pool["scale_log2"][key][name][:, slot] = torch.as_tensor(vals)
    return pool
