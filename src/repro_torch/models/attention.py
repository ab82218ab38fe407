"""Attention — the port of ``repro/models/attention.py``: GQA/MQA/MHA and
DeepSeek-V2's multi-head latent attention (MLA).

``chunked_attention`` is the prefill path: an online softmax over KV
chunks inside a loop over Q chunks, in the reference's update order. The
decode helpers (``gqa_decode_qkv``, ``gqa_attend``) serve the engine's
gather path; ``gqa_decode`` with ``cache_append`` and ``gqa_init_cache``
is static decode's attention step over a dense (B, T) cache. Score
einsums take f32 operands, as the reference's
``preferred_element_type=f32`` does: products of bf16 values are exact in
f32, so the two agree up to summation order.

MLA caches a latent ``c_kv`` (``kv_lora_rank``) and one shared rope key
``k_rope`` (``qk_rope_head_dim``) a token. Prefill and training
(``mla_forward``) rebuild per-head K and V and run ``chunked_attention``;
decode and the engine's chunk step attend in the latent space
(``mla_decode_q`` absorbs ``k_up`` into the queries, ``mla_attend``
applies ``v_up`` after P @ c_kv), with the reference's casts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..configs.base import MLAConfig, ModelConfig
from .common import (SiteDef, apply_site, init_site, make_site, rms_norm,
                     rope)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Core chunked attention
# ---------------------------------------------------------------------------

def _attn_one_qchunk(q, k, v, qpos, kpos, *, causal: bool, scale: float,
                     kv_chunk: int) -> torch.Tensor:
    """Online softmax over KV chunks for one Q chunk.

    q: (B, Sq, Hq, D)   k/v: (B, T, Hkv, D)   qpos: (Sq,)  kpos: (T,)
    returns (B, Sq, Hq, D). KV heads are expanded to Hq per chunk."""
    b, sq, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float()
    m = torch.full((b, hq, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq), device=q.device)
    acc = torch.zeros((b, hq, sq, d), device=q.device)
    for c0 in range(0, t, kv_chunk):
        kc, vc = k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk]
        kp = kpos[c0:c0 + kv_chunk]
        if g > 1:
            kc = torch.repeat_interleave(kc, g, dim=2)      # (B, ck, Hq, D)
            vc = torch.repeat_interleave(vc, g, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float()) * scale
        if causal:
            s = torch.where((qpos[:, None] >= kp[None, :])[None, None], s,
                            NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """General attention. q: (B,S,Hq,D); k,v: (B,T,Hkv,D)."""
    b, s, hq, d = q.shape
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    t_pad = (-t) % kv_chunk
    if t_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, t_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, t_pad))
    kpos = torch.arange(t + t_pad, device=q.device)
    kpos = torch.where(kpos < t, kpos, torch.iinfo(torch.int32).max)
    if s % q_chunk:
        raise ValueError(f"sequence {s} is not a multiple of q_chunk "
                         f"{q_chunk}")
    outs = []
    for q0 in range(0, s, q_chunk):
        qpos = q_offset + q0 + torch.arange(q_chunk, device=q.device)
        outs.append(_attn_one_qchunk(q[:, q0:q0 + q_chunk], k, v, qpos, kpos,
                                     causal=causal, scale=scale,
                                     kv_chunk=kv_chunk))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GQADef:
    q: SiteDef
    kv: SiteDef
    o: SiteDef
    num_heads: int          # padded head count used in the attention kernel
    num_kv_heads: int
    head_dim: int
    real_heads: int         # the arch's true head count


def make_gqa(cfg: ModelConfig) -> GQADef:
    hd = cfg.resolved_head_dim
    hq = cfg.num_heads
    pad_to = getattr(cfg, "pad_heads_to", 0)
    hp = max(hq, pad_to) if pad_to else hq
    return GQADef(
        q=make_site(cfg, "attn_qkv", hp * hd, cfg.d_model),
        kv=make_site(cfg, "attn_qkv", 2 * cfg.num_kv_heads * hd, cfg.d_model),
        o=make_site(cfg, "attn_o", cfg.d_model, hq * hd),
        num_heads=hp, num_kv_heads=cfg.num_kv_heads, head_dim=hd,
        real_heads=hq)


def init_gqa(gen: torch.Generator, d: GQADef, cfg: ModelConfig,
             device: torch.device) -> dict:
    return {"q": init_site(gen, d.q, cfg, device),
            "kv": init_site(gen, d.kv, cfg, device),
            "o": init_site(gen, d.o, cfg, device)}


def gqa_qkv(params: dict, x: torch.Tensor, d: GQADef, cfg: ModelConfig,
            positions: torch.Tensor):
    """q (B,S,Hq,Dh) and k/v (B,S,Hkv,Dh); K and V come out of one ``kv``
    projection viewed (B, S, 2, Hkv, Dh), as in the reference."""
    b, s, _ = x.shape
    q = apply_site(params["q"], x, d.q, cfg).reshape(b, s, d.num_heads,
                                                     d.head_dim)
    kv = apply_site(params["kv"], x, d.kv, cfg).reshape(
        b, s, 2, d.num_kv_heads, d.head_dim)
    k, v = kv[:, :, 0], kv[:, :, 1]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


# decode / chunk projections are the same computation over (B, S) positions
gqa_decode_qkv = gqa_qkv


def gqa_forward(params: dict, x: torch.Tensor, d: GQADef, cfg: ModelConfig,
                *, causal: bool, positions: torch.Tensor) -> torch.Tensor:
    q, k, v = gqa_qkv(params, x, d, cfg, positions)
    out = chunked_attention(q, k, v, causal=causal)
    b, s = x.shape[:2]
    if d.real_heads != d.num_heads:
        out = out[:, :, :d.real_heads]
    return apply_site(params["o"], out.reshape(b, s, -1), d.o, cfg)


def len_positions(cur_len, b: int, device=None) -> torch.Tensor:
    """(B,1) query positions from a scalar (int or 0-d tensor) or a
    per-slot (B,) ``cur_len``."""
    cl = torch.as_tensor(cur_len, dtype=torch.int32, device=device)
    if cl.dim() == 0:
        return cl.expand(b, 1)
    return cl.reshape(b, 1)


def cache_append(cache_arr: torch.Tensor, new: torch.Tensor,
                 cur_len) -> torch.Tensor:
    """A copy of ``cache_arr`` (B, T, ...) with one new token (B, 1, ...)
    written at position ``cur_len`` along axis 1: every row at a shared
    scalar position, or each row at its own (B,) position."""
    out = cache_arr.clone()
    new = new.to(cache_arr.dtype)
    cl = torch.as_tensor(cur_len, device=cache_arr.device).long()
    if cl.dim() == 0:
        out[:, cl:cl + 1] = new
    else:
        out[torch.arange(out.shape[0], device=out.device), cl] = new[:, 0]
    return out


def causal_len_mask(qpos: torch.Tensor, t: int) -> torch.Tensor:
    """(B, S, T) mask: key position visible iff kpos <= qpos."""
    kpos = torch.arange(t, device=qpos.device)
    return kpos[None, None, :] <= qpos[:, :, None]


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d: GQADef,
               qpos: torch.Tensor) -> torch.Tensor:
    """Decode-style attention over a full cache with per-row lengths.

    q: (B,S,Hq,Dh); k,v: (B,T,Hkv,Dh); qpos: (B,S) absolute query positions
    (key position kpos attends iff kpos <= qpos). Returns (B,S,real*Dh)."""
    b, s = q.shape[:2]
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d.head_dim)
    g = d.num_heads // d.num_kv_heads
    qg = q.reshape(b, s, d.num_kv_heads, g, d.head_dim)
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    mask = causal_len_mask(qpos, t)                       # (B, S, T)
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    out = out.reshape(b, s, d.num_heads, d.head_dim)[:, :, :d.real_heads]
    return out.reshape(b, s, d.real_heads * d.head_dim)


def gqa_decode(params: dict, x: torch.Tensor, cache: dict, d: GQADef,
               cfg: ModelConfig, cur_len) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B,1,D). cache: {"k","v"}: (B,T,Hkv,Dh).
    ``cur_len``: scalar shared length, or (B,) per-slot lengths. Returns
    (y, the new cache); the old one is unchanged."""
    b = x.shape[0]
    positions = len_positions(cur_len, b, x.device)
    q, k_new, v_new = gqa_decode_qkv(params, x, d, cfg, positions)
    k = cache_append(cache["k"], k_new, cur_len)
    v = cache_append(cache["v"], v_new, cur_len)
    out = gqa_attend(q, k, v, d, positions)
    y = apply_site(params["o"], out, d.o, cfg)
    return y, {"k": k, "v": v}


def gqa_init_cache(d: GQADef, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device) -> dict:
    shape = (batch, max_len, d.num_kv_heads, d.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2) block
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLADef:
    q_down: SiteDef
    q_up: SiteDef
    kv_down: SiteDef        # -> kv_lora + rope dim
    k_up: SiteDef           # kv_lora -> H * qk_nope
    v_up: SiteDef           # kv_lora -> H * v_head
    o: SiteDef
    num_heads: int
    m: MLAConfig


def make_mla(cfg: ModelConfig) -> MLADef:
    m = cfg.mla
    h = cfg.num_heads
    return MLADef(
        q_down=make_site(cfg, "attn_qkv", m.q_lora_rank, cfg.d_model),
        q_up=make_site(cfg, "attn_qkv",
                       h * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                       m.q_lora_rank),
        kv_down=make_site(cfg, "attn_qkv", m.kv_lora_rank + m.qk_rope_head_dim,
                          cfg.d_model),
        k_up=make_site(cfg, "attn_qkv", h * m.qk_nope_head_dim, m.kv_lora_rank),
        v_up=make_site(cfg, "attn_qkv", h * m.v_head_dim, m.kv_lora_rank),
        o=make_site(cfg, "attn_o", cfg.d_model, h * m.v_head_dim),
        num_heads=h, m=m)


def init_mla(gen: torch.Generator, d: MLADef, cfg: ModelConfig,
             device: torch.device) -> dict:
    """The six sites as ``init_site``, the two norm scales 1 (f32)."""
    def ones(n):
        return {"scale": torch.ones((n,), dtype=torch.float32, device=device)}
    return {"q_down": init_site(gen, d.q_down, cfg, device),
            "q_norm": ones(d.m.q_lora_rank),
            "q_up": init_site(gen, d.q_up, cfg, device),
            "kv_down": init_site(gen, d.kv_down, cfg, device),
            "kv_norm": ones(d.m.kv_lora_rank),
            "k_up": init_site(gen, d.k_up, cfg, device),
            "v_up": init_site(gen, d.v_up, cfg, device),
            "o": init_site(gen, d.o, cfg, device)}


def _mla_q(params: dict, x: torch.Tensor, d: MLADef, cfg: ModelConfig,
           positions: torch.Tensor):
    b, s, _ = x.shape
    m = d.m
    cq = apply_site(params["q_down"], x, d.q_down, cfg)
    cq = rms_norm(cq, params["q_norm"]["scale"], cfg.norm_eps)
    q = apply_site(params["q_up"], cq, d.q_up, cfg).reshape(
        b, s, d.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_kv_latent(params: dict, x: torch.Tensor, d: MLADef,
                   cfg: ModelConfig, positions: torch.Tensor):
    """(c_kv (B,S,kv_lora) normed, k_rope (B,S,rope) roped as one shared
    head)."""
    m = d.m
    ckv = apply_site(params["kv_down"], x, d.kv_down, cfg)
    c_kv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c_kv = rms_norm(c_kv, params["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_forward(params: dict, x: torch.Tensor, d: MLADef, cfg: ModelConfig,
                *, causal: bool, positions: torch.Tensor) -> torch.Tensor:
    """Prefill/train path: per-head K/V rebuilt from the latent, chunked
    attention with V's head dim padded to q's, sliced after."""
    b, s, _ = x.shape
    m = d.m
    q_nope, q_rope = _mla_q(params, x, d, cfg, positions)
    c_kv, k_rope = _mla_kv_latent(params, x, d, cfg, positions)
    k_nope = apply_site(params["k_up"], c_kv, d.k_up, cfg).reshape(
        b, s, d.num_heads, m.qk_nope_head_dim)
    v = apply_site(params["v_up"], c_kv, d.v_up, cfg).reshape(
        b, s, d.num_heads, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, d.num_heads, m.qk_rope_head_dim)], dim=-1)
    v = torch.nn.functional.pad(v, (0, q.shape[-1] - v.shape[-1]))
    out = chunked_attention(q, k, v, causal=causal)
    out = out[..., :m.v_head_dim].reshape(b, s, -1)
    return apply_site(params["o"], out, d.o, cfg)


def _absorb_weight(psite: dict, site: SiteDef,
                   cfg: ModelConfig) -> torch.Tensor:
    """Dense (in, out) weight of a site, materializing TT factors if
    needed."""
    if "w" in psite:
        return psite["w"]
    from ..core.tt_layer import effective_cores
    from ..core.ttm import ttm_to_dense
    cores = effective_cores(psite, site.spec, cfg.tt, cfg.quant)
    return ttm_to_dense(cores, site.spec).T


def mla_decode_q(params: dict, x: torch.Tensor, d: MLADef, cfg: ModelConfig,
                 positions: torch.Tensor):
    """Absorbed decode queries. x: (B,S,D); positions (B,S). Returns q_abs
    (B,S,H,kv_lora) and q_rope (B,S,H,rope)."""
    m = d.m
    q_nope, q_rope = _mla_q(params, x, d, cfg, positions)
    wk = _absorb_weight(params["k_up"], d.k_up, cfg).reshape(
        m.kv_lora_rank, d.num_heads, m.qk_nope_head_dim)
    q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, wk.to(q_nope.dtype))
    return q_abs, q_rope


def mla_attend(params: dict, q_abs: torch.Tensor, q_rope: torch.Tensor,
               ckv: torch.Tensor, kr: torch.Tensor, d: MLADef,
               cfg: ModelConfig, qpos: torch.Tensor) -> torch.Tensor:
    """Latent-space attention. ckv: (B,T,kv_lora); kr: (B,T,rope); qpos:
    (B,S). Scores in f32; P cast to the cache's dtype before P @ c_kv, as
    the reference casts. Returns (B,S,H*v_head) before the o projection."""
    m = d.m
    b, s = q_abs.shape[:2]
    t = ckv.shape[1]
    s_nope = torch.einsum("bqhl,btl->bhqt", q_abs.float(), ckv.float())
    s_rope = torch.einsum("bqhd,btd->bhqt", q_rope.float(), kr.float())
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    sc = (s_nope + s_rope) * scale
    sc = torch.where(causal_len_mask(qpos, t)[:, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out_lat = torch.einsum("bhqt,btl->bqhl", p.to(ckv.dtype), ckv)
    wv = _absorb_weight(params["v_up"], d.v_up, cfg).reshape(
        m.kv_lora_rank, d.num_heads, m.v_head_dim)
    out = torch.einsum("bqhl,lhd->bqhd", out_lat, wv.to(out_lat.dtype))
    return out.reshape(b, s, -1)


def mla_decode(params: dict, x: torch.Tensor, cache: dict, d: MLADef,
               cfg: ModelConfig, cur_len) -> tuple[torch.Tensor, dict]:
    """Absorbed one-token decode over a dense (B, T) latent cache
    {"c_kv", "k_rope"}; ``cur_len`` a scalar or (B,). Returns (y, the new
    cache); the old one is unchanged."""
    b = x.shape[0]
    positions = len_positions(cur_len, b, x.device)
    q_abs, q_rope = mla_decode_q(params, x, d, cfg, positions)
    c_new, kr_new = _mla_kv_latent(params, x, d, cfg, positions)
    ckv = cache_append(cache["c_kv"], c_new, cur_len)
    kr = cache_append(cache["k_rope"], kr_new, cur_len)
    out = mla_attend(params, q_abs, q_rope, ckv, kr, d, cfg, positions)
    y = apply_site(params["o"], out, d.o, cfg)
    return y, {"c_kv": ckv, "k_rope": kr}


def mla_init_cache(d: MLADef, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device) -> dict:
    return {"c_kv": torch.zeros((batch, max_len, d.m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, d.m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
