"""Slot-paged KV-cache pool with pow-2 int8 storage — the port of
``repro/serve/kv_cache.py``.

The pool is a set of fixed-size *pages* shared by all request slots; token
position ``t`` of a slot lives at ``(page_table[slot, t // page_size],
t % page_size)``. Inactive slots and padding write to a reserved *trash
page* (row ``total_pages``). With ``quantized=True`` K/V are int8 codes on
a power-of-2 grid, ``x ≈ q * 2^scale_log2``, one ``scale_log2`` per
(layer, slot, tensor) chosen from the prompt's range at prefill and reused
by decode appends (the paper's §3.2 numerics applied to serving).

Every pool write goes through the row-scale encode kernel and every
gathered read through the row-scale decode kernel (``numerics``' ``cuda``
codec; on CPU tensors their plain versions). The fused path reads pages
straight from the pool inside the paged-attention kernel.

In-place updates: where the reference donates the pool to a jitted step
and rebuilds it with ``.at[].set``, the port writes into the preallocated
pool tensors with ``index_put_``. The functions below mutate their pool
arguments and return them for symmetry with the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.common import torch_dtype
from ..numerics import QTensor, QuantSpec, get_codec, per_tensor_max_scale_log2

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
    sublayer. GQA only in this slice."""
    if sub.mixer_kind == "attn_gqa":
        d = sub.mixer
        return {"k": (d.num_kv_heads, d.head_dim),
                "v": (d.num_kv_heads, d.head_dim)}
    raise NotImplementedError(f"{sub.mixer_kind!r} sublayers are a later "
                              "slice of the port")


def init_pool(lm, pcfg: PoolConfig, device: torch.device) -> dict:
    """Allocate the pool: {"data": {sub_i: {name: (L, P+1, page, *feat)
    int8|dtype}}, "scale_log2": {sub_i: {name: (L, num_slots) f32}}}."""
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


# ---------------------------------------------------------------------------
# Quantize / dequantize — the ``kv_cache`` site of the codec registry
# ---------------------------------------------------------------------------

def choose_scale_log2(x: torch.Tensor, valid: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """Smallest pow-2 step covering max|x| over valid rows, one per layer.

    x: (L, S, *feat); valid: (S,) bool. Returns (L,) f32 integer-valued."""
    mask = valid.reshape((1, -1) + (1,) * (x.dim() - 2))
    return per_tensor_max_scale_log2(x, _kv_spec(bits), valid=mask,
                                     reduce_axes=tuple(range(1, x.dim())))


def quantize(x: torch.Tensor, scale_log2: torch.Tensor,
             bits: int) -> torch.Tensor:
    """fp -> int8 codes; scale_log2 broadcast against x's leading dims (one
    row-scale encode launch)."""
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
    *feat) in ``dtype``, dequantized on read (rows = B)."""
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


def append_token(data_l: torch.Tensor, scale_l: torch.Tensor,
                 new: torch.Tensor, table: torch.Tensor, lens: torch.Tensor,
                 active: torch.Tensor, pcfg: PoolConfig) -> torch.Tensor:
    """Write one new token per slot at its own length, in place.

    new: (B, 1, *feat); inactive slots go to the trash page. Decode appends
    reuse the slot's prefill scale (clipping into its range); rows = B."""
    b = new.shape[0]
    lens = lens.long()
    pages = table.long().gather(1, (lens // pcfg.page_size)[:, None])[:, 0]
    pages = torch.where(active, pages, pcfg.trash_page)
    offs = lens % pcfg.page_size
    vals = new[:, 0]
    if pcfg.quantized:
        vals = quantize(vals, scale_l.reshape((b,) + (1,) * (vals.dim() - 1)),
                        pcfg.bits)
    else:
        vals = vals.to(data_l.dtype)
    return data_l.index_put_((pages, offs), vals)


def write_prefill(pool: dict, cache: dict, table_row: torch.Tensor,
                  slot: int, length: int, pcfg: PoolConfig) -> dict:
    """Scatter a whole-prompt prefill cache (``lm_forward``'s, leaves
    (L, 1, S, *feat)) into the pool for one slot, all layers at once, in
    place. Rows past ``length`` (bucket padding) go to the trash page. With
    a quantized pool the slot's per-layer scales are chosen here and each
    tensor is encoded in one launch (rows = L)."""
    sample = next(iter(next(iter(cache.values())).values()))
    s = sample.shape[2]
    dev = sample.device
    pos = torch.arange(s, device=dev)
    valid = pos < length
    page_idx = torch.clamp(pos // pcfg.page_size, max=pcfg.pages_per_slot - 1)
    pages = torch.where(valid, table_row.long()[page_idx], pcfg.trash_page)
    offs = pos % pcfg.page_size
    for key, kinds in cache.items():
        for name, arr in kinds.items():
            vals = arr[:, 0]                             # (L, S, *feat)
            dest = pool["data"][key][name]
            if pcfg.quantized:
                step = choose_scale_log2(vals, valid, pcfg.bits)   # (L,)
                pool["scale_log2"][key][name][:, slot] = step
                vals = quantize(vals, step[:, None], pcfg.bits)
            else:
                vals = vals.to(dest.dtype)
            dest[:, pages, offs] = vals
    return pool
