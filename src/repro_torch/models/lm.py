"""Unified LM — the port of ``repro/models/lm.py``: the dense GQA family,
MoE stacks, DeepSeek-V2's MLA attention, pure-SSM RWKV6, the Jamba hybrid
(Mamba + attention, dense or MoE FFNs) and the audio and vision frontends
(precomputed frame or patch embeddings, ``models/frontend.py``).

Structure: embed -> periods of sublayers -> final norm -> head. A period
is a fixed pattern of sublayers (one for homogeneous stacks; Jamba's
interleave of Mamba and attention). Where the reference stacks layer
params on a leading axis for ``lax.scan``, the port keeps a Python list of
per-period dicts (``params["layers"][l]``) and loops;
``convert.params_from_jax`` unstacks a JAX tree into it.

Parameters are plain nested dicts of tensors with the reference's names,
so the two packages' trees correspond key for key; an MoE sublayer's
expert stacks keep their ``(E, in, out)`` leaves, or, TT, their ``(E,
...)`` core, λ and step leaves (``models/moe.py``). An
audio model has no embedding site (``LMDef.embed`` is None): its frames
replace the token embeddings; a vision model's patches are prepended to
them (``lm_forward(embeds=...)``).

Static decode (``lm_init_cache``, ``lm_decode_step``) is the reference's:
one token a step against a cache of per-token K/V for attention
sublayers (MLA's latent ``c_kv`` and ``k_rope``) and the recurrent state
for the others; the serving engine's token identity is held against it.

Every weight site may be TT-factorized (``with_tt``): TT sites add the
rank-shrinkage prior (``lm_prior_loss``) and take the closed-form λ update
(``lm_lambda_update``); with a managed scale tree ``lm_forward`` runs the
policy's ``activation`` quant edges. ``remat="full"`` recomputes each
layer's forward in the backward (``torch.utils.checkpoint``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.quant import quant_edge_shared
from ..core.tt_layer import effective_cores
from ..device import resolve_device
from . import attention as A
from . import ffn as F
from . import moe as M
from . import ssm as S
from .common import (SiteDef, apply_site, init_site, make_site, rms_norm,
                     site_lambda_update, site_prior_loss, torch_dtype)


@dataclass(frozen=True)
class SubDef:
    mixer_kind: str          # "attn_gqa" | "attn_mla" | "mamba" | "rwkv6"
    mixer: Any
    ffn_kind: str | None     # "ffn" | "moe" | None (rwkv6 has its own)
    ffn: Any


@dataclass(frozen=True)
class LMDef:
    cfg: ModelConfig
    embed: SiteDef | None    # None when the audio frontend replaces it
    head: SiteDef
    period: tuple[SubDef, ...]
    n_periods: int


STATE_MIXERS = ("mamba", "rwkv6")


def build_lm(cfg: ModelConfig) -> LMDef:
    """Every zoo family: dense and MoE stacks with GQA or MLA attention,
    RWKV6, the Jamba hybrid; no embedding site under the audio
    frontend."""
    def attn() -> tuple[str, Any]:
        if cfg.attn_kind == "mla":
            return "attn_mla", A.make_mla(cfg)
        return "attn_gqa", A.make_gqa(cfg)

    def ffn_for(use_moe: bool) -> tuple[str, Any]:
        if use_moe and cfg.moe.num_experts > 0:
            return "moe", M.make_moe(cfg)
        return "ffn", F.make_ffn(cfg)

    if cfg.family == "ssm_rwkv6":
        subs = [SubDef("rwkv6", S.make_rwkv6(cfg), None, None)]
        n_periods = cfg.num_layers
    elif cfg.family == "hybrid_jamba":
        subs = []
        for pos in range(cfg.period):
            mixer = (attn() if pos in cfg.attn_positions
                     else ("mamba", S.make_mamba(cfg)))
            subs.append(SubDef(*mixer, *ffn_for(pos in cfg.moe_positions)))
        if cfg.num_layers % cfg.period:
            raise ValueError(f"{cfg.num_layers} layers are not whole "
                             f"periods of {cfg.period}")
        n_periods = cfg.num_layers // cfg.period
    else:
        subs = [SubDef(*attn(), *ffn_for(True))]
        n_periods = cfg.num_layers
    embed = (None if cfg.frontend == "audio"
             else make_site(cfg, "embed", cfg.vocab_size, cfg.d_model))
    head = make_site(cfg, "head", cfg.vocab_size, cfg.d_model)
    return LMDef(cfg, embed, head, tuple(subs), n_periods)


def _init_sub(gen: torch.Generator, sub: SubDef, cfg: ModelConfig,
              device: torch.device) -> dict:
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
    p = {"norm1": {"scale": ones.clone()}}
    if sub.mixer_kind == "attn_gqa":
        p["mixer"] = A.init_gqa(gen, sub.mixer, cfg, device)
    elif sub.mixer_kind == "attn_mla":
        p["mixer"] = A.init_mla(gen, sub.mixer, cfg, device)
    elif sub.mixer_kind == "mamba":
        p["mixer"] = S.init_mamba(gen, sub.mixer, cfg, device)
    else:
        p["mixer"] = S.init_rwkv6(gen, sub.mixer, cfg, device)
        p["norm2"] = {"scale": ones.clone()}
        return p
    if sub.ffn_kind == "moe":
        p["norm2"] = {"scale": ones.clone()}
        p["moe"] = M.init_moe(gen, sub.ffn, cfg, device)
    elif sub.ffn_kind is not None:
        p["norm2"] = {"scale": ones.clone()}
        p["ffn"] = F.init_ffn(gen, sub.ffn, cfg, device)
    return p


def init_lm(gen: torch.Generator, lm: LMDef, device=None) -> dict:
    """Random weights with the reference's distributions (``lm.py:119``):
    embedding ``N(0, 1/d_model)``, dense sites ``N(0, 2/(in+out))``, norm
    scales 1; no ``embed`` without an embedding site. ``gen`` must live on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``). The numbers differ from a JAX init of the same seed —
    parity tests transfer weights instead."""
    device = resolve_device(device)
    cfg = lm.cfg
    params = {}
    if lm.embed is not None and lm.embed.use_tt:
        params["embed"] = init_site(gen, lm.embed, cfg, device)
    elif lm.embed is not None:
        sigma = 1.0 / math.sqrt(cfg.d_model)
        w = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=device, dtype=torch.float32) * sigma
        params["embed"] = {"w": w.to(torch_dtype(cfg.dtype))}
    params["layers"] = [{f"sub_{i}": _init_sub(gen, sub, cfg, device)
                         for i, sub in enumerate(lm.period)}
                        for _ in range(lm.n_periods)]
    params["final_norm"] = {"scale": torch.ones((cfg.d_model,),
                                                device=device)}
    params["head"] = init_site(gen, lm.head, cfg, device)
    return params


def embed_tokens(params: dict, tokens: torch.Tensor, lm: LMDef) -> torch.Tensor:
    if lm.embed is not None and lm.embed.use_tt:
        return tt_embed_lookup(params["embed"], tokens, lm.embed, lm.cfg)
    return params["embed"]["w"][tokens.long()].to(torch_dtype(lm.cfg.dtype))


def tt_embed_lookup(eparams: dict, tokens: torch.Tensor, site: SiteDef,
                    cfg: ModelConfig) -> torch.Tensor:
    """Row lookup in a TT-represented (V, D) table: V is factored over the
    cores' J dims, each token id split into mixed-radix digits (most
    significant first), and the row is the product of the selected core
    slices, contracted in f32 in the reference's order."""
    spec = site.spec
    cores = effective_cores(eparams, spec, cfg.tt, cfg.quant)
    ids = tokens.reshape(-1).long()
    digits, rem = [], ids
    for n in range(spec.d - 1, -1, -1):
        digits.append(rem % spec.j_dims[n])
        rem = rem // spec.j_dims[n]
    digits = digits[::-1]
    t = ids.shape[0]
    m = torch.ones((t, 1, 1), dtype=torch.float32, device=ids.device)
    for n in range(spec.d):
        g = cores[n].float()                              # (R, J, I, R')
        gsel = g[:, digits[n]].movedim(1, 0)              # (T, R, I, R')
        m = torch.einsum("tpr,trik->tpik", m, gsel).reshape(t, -1,
                                                            g.shape[3])
    return m[..., 0].reshape(tuple(tokens.shape) + (spec.in_dim,)).to(
        torch_dtype(cfg.dtype))


def _sub_forward(pp: dict, x: torch.Tensor, sub: SubDef, cfg: ModelConfig,
                 positions: torch.Tensor, return_cache: bool,
                 token_mask: torch.Tensor | None = None,
                 capacity_tokens: int | None = None):
    """One sublayer (mixer + FFN). Returns (x, aux, cache_entry): the MoE
    aux loss (None without an MoE); K/V for attention, the post-sequence
    recurrent state for mamba and rwkv6. ``token_mask`` and
    ``capacity_tokens`` reach the MoE router (``_ffn``)."""
    h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
    if sub.mixer_kind == "attn_gqa":
        q, k, v = A.gqa_qkv(pp["mixer"], h, sub.mixer, cfg, positions)
        out = A.chunked_attention(q, k, v, causal=not cfg.is_encoder)
        b, s = h.shape[:2]
        if sub.mixer.real_heads != sub.mixer.num_heads:
            out = out[:, :, :sub.mixer.real_heads]
        out = apply_site(pp["mixer"]["o"], out.reshape(b, s, -1),
                         sub.mixer.o, cfg)
        cache = {"k": k, "v": v}
    elif sub.mixer_kind == "attn_mla":
        out = A.mla_forward(pp["mixer"], h, sub.mixer, cfg,
                            causal=not cfg.is_encoder, positions=positions)
        cache = {}
        if return_cache:
            c_kv, k_rope = A._mla_kv_latent(pp["mixer"], h, sub.mixer, cfg,
                                            positions)
            cache = {"c_kv": c_kv, "k_rope": k_rope}
    elif sub.mixer_kind == "mamba":
        out, cache = S.mamba_forward(pp["mixer"], h, sub.mixer, cfg, None)
    else:
        out, st = S.rwkv6_time_mix(pp["mixer"], h, sub.mixer, cfg, None)
        x = x + out
        h2 = rms_norm(x, pp["norm2"]["scale"], cfg.norm_eps)
        out2, st2 = S.rwkv6_channel_mix(pp["mixer"], h2, sub.mixer, cfg,
                                        None)
        return x + out2, None, ({**st, **st2} if return_cache else {})
    x, aux = _ffn(pp, x + out, sub, cfg, token_mask, capacity_tokens)
    return x, aux, cache if return_cache else {}


def _act_quant_edge(x: torch.Tensor, scales: dict,
                    cfg: ModelConfig) -> torch.Tensor:
    """The policy-owned ``activation`` site of the zoo LMs: fake-quant the
    residual stream forward at ``act_bits`` and its gradient backward at
    ``grad_bits`` (clipped STE), with the shared managed scales of the
    ``TrainState.scales`` tree."""
    return quant_edge_shared(x, scales["activation"], scales["grad_edge"],
                             cfg.quant.act_bits, cfg.quant.grad_bits)


def _remat_wrap(fn, cfg: ModelConfig):
    """``"full"``: the layer's forward runs again in the backward and only
    its inputs are kept (``torch.utils.checkpoint``, non-reentrant), as
    ``jax.checkpoint`` with ``nothing_saveable``; only while autograd
    records. A recurrent layer's scan chunks keep their own inputs inside
    it (``ssm._ScanChunk``): the recompute runs each chunk once more
    without recording, and a chunk's backward runs it a third time.
    ``"dots"`` (keep the products, recompute the rest) raises: the TT
    sites' products are kernel launches outside the dispatcher, so a
    selective checkpoint cannot keep them (ROADMAP queue 1)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        raise NotImplementedError(
            'remat="dots" is not ported: the TT products are kernel '
            "launches a selective checkpoint cannot save (ROADMAP queue 1)")
    if cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


def lm_forward(params: dict, lm: LMDef, *,
               tokens: torch.Tensor | None = None,
               embeds: torch.Tensor | None = None,
               return_cache: bool = False, scales: dict | None = None,
               token_mask: torch.Tensor | None = None,
               capacity_tokens: int | None = None):
    """Train/prefill forward. tokens: (B, S) int and/or embeds: (B, P, D)
    frontend outputs (vision: prepended to the token embeddings; audio:
    in their place). Returns (logits, aux, cache): aux is the sum of the
    MoE layers' load-balance losses (0 without MoE); ``token_mask`` (B, S) bool of real tokens keeps padding
    out of the MoE routers' capacity, ``capacity_tokens`` replaces their
    capacity's token basis (``moe._capacity``). cache (when asked) holds each
    sublayer's entry with leaves stacked over periods, the reference's
    layout: ``{"k", "v"}`` (L, B, S, Hkv, Dh) for GQA, ``{"c_kv",
    "k_rope"}`` (L, B, S, kv_lora / rope) for MLA, the state
    after the last token for mamba (``conv``, ``h``) and rwkv6
    (``shift``, ``wkv``, ``shift_ffn``).

    ``scales``: the policy's managed scale-state tree
    (``TrainState.scales``). With it (and ``cfg.quant.enable``) the
    ``activation`` site goes live: the residual stream is fake-quantized
    after the embedding and after every sublayer with the shared managed
    scales, and the return gains a 4th element ``obs``, the per-layer
    mean |activation| the scale manager consumes:
    (logits, aux, cache, obs)."""
    cfg = lm.cfg
    # the edge quantizes forward AND backward: both managed sites needed
    quant_acts = (scales is not None and cfg.quant.enable
                  and "activation" in scales and "grad_edge" in scales)
    if embeds is not None and tokens is not None:
        xt = embed_tokens(params, tokens, lm)
        x = torch.cat([embeds.to(xt.dtype), xt], dim=1)
    elif embeds is not None:
        x = embeds.to(torch_dtype(cfg.dtype))
    else:
        x = embed_tokens(params, tokens, lm)
    b, s, _ = x.shape
    if quant_acts:
        x = _act_quant_edge(x, scales, cfg)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)

    def layer(pp, x):
        layer_cache, layer_aux = {}, None
        for i, sub in enumerate(lm.period):
            x, a, c = _sub_forward(pp[f"sub_{i}"], x, sub, cfg, positions,
                                   return_cache, token_mask, capacity_tokens)
            if quant_acts:
                x = _act_quant_edge(x, scales, cfg)
            if a is not None:
                layer_aux = a if layer_aux is None else layer_aux + a
            layer_cache[f"sub_{i}"] = c
        return x, layer_aux, layer_cache

    layer = _remat_wrap(layer, cfg)
    caches: list[dict] = []
    amean = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pp in params["layers"]:
        x, layer_aux, layer_cache = layer(pp, x)
        if layer_aux is not None:
            aux = aux + layer_aux
        caches.append(layer_cache)
        if quant_acts:
            amean = amean + torch.mean(torch.abs(x.detach().float()))
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = apply_site(params["head"], x, lm.head, cfg)
    if cfg.logits_softcap > 0:
        logits = torch.tanh(logits / cfg.logits_softcap) * cfg.logits_softcap
    cache = None
    if return_cache:
        cache = {key: {name: torch.stack([c[key][name] for c in caches])
                       for name in caches[0][key]}
                 for key in caches[0]}
    if scales is None:
        return logits, aux, cache
    obs = {"activation": (amean / lm.n_periods)[None]} if quant_acts else {}
    return logits, aux, cache, obs


def _ffn(pp: dict, x: torch.Tensor, sub: SubDef, cfg: ModelConfig,
         token_mask: torch.Tensor | None, capacity_tokens: int | None):
    """Post-mixer FFN or MoE half of a sublayer: (x, the MoE aux loss, or
    None without an MoE). ``token_mask`` (B, S) keeps inactive serve slots
    and prefill padding out of the MoE router's capacity; a dense FFN
    ignores it and ``capacity_tokens`` (per-token math cannot interfere
    across rows)."""
    if sub.ffn_kind is None:
        return x, None
    h = rms_norm(x, pp["norm2"]["scale"], cfg.norm_eps)
    if sub.ffn_kind == "moe":
        out, aux = M.moe_forward(pp["moe"], h, sub.ffn, cfg,
                                 token_mask=token_mask,
                                 capacity_tokens=capacity_tokens)
        return x + out, aux
    return x + F.ffn_forward(pp["ffn"], h, sub.ffn, cfg), None


def sub_ffn_decode(pp: dict, x: torch.Tensor, sub: SubDef, cfg: ModelConfig,
                   token_mask: torch.Tensor | None = None,
                   capacity_tokens: int | None = None) -> torch.Tensor:
    """Post-mixer FFN or MoE half of a sublayer (shared by static decode and
    the serving engine's decode, chunk and verify steps); see ``_ffn``."""
    return _ffn(pp, x, sub, cfg, token_mask, capacity_tokens)[0]


# ---------------------------------------------------------------------------
# Static decode: one token a step against a carried cache
# ---------------------------------------------------------------------------

def _sub_decode(pp: dict, x: torch.Tensor, cc: dict, sub: SubDef,
                cfg: ModelConfig, cur_len):
    h = rms_norm(x, pp["norm1"]["scale"], cfg.norm_eps)
    if sub.mixer_kind == "attn_gqa":
        out, cnew = A.gqa_decode(pp["mixer"], h, cc, sub.mixer, cfg, cur_len)
    elif sub.mixer_kind == "attn_mla":
        out, cnew = A.mla_decode(pp["mixer"], h, cc, sub.mixer, cfg, cur_len)
    elif sub.mixer_kind == "mamba":
        out, cnew = S.mamba_forward(pp["mixer"], h, sub.mixer, cfg, cc)
    else:
        out, st = S.rwkv6_time_mix(pp["mixer"], h, sub.mixer, cfg, cc)
        x = x + out
        h2 = rms_norm(x, pp["norm2"]["scale"], cfg.norm_eps)
        out2, st2 = S.rwkv6_channel_mix(pp["mixer"], h2, sub.mixer, cfg, cc)
        return x + out2, {**st, **st2}
    return sub_ffn_decode(pp, x + out, sub, cfg), cnew


def lm_decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                   cur_len, lm: LMDef):
    """One-token decode. tokens: (B,1). cache leaves stacked over periods
    (``lm_init_cache``, or ``lm_forward``'s with attention leaves padded
    to the horizon). ``cur_len``: a shared position (int or 0-d tensor),
    or a per-slot (B,) vector, each row appending and attending at its
    own length. Returns (logits, new_cache); the old cache is unchanged."""
    cfg = lm.cfg
    x = embed_tokens(params, tokens, lm)
    layers = []
    for l, pp in enumerate(params["layers"]):
        new_cc = {}
        for i, sub in enumerate(lm.period):
            key = f"sub_{i}"
            cc = {n: t[l] for n, t in cache[key].items()}
            x, new_cc[key] = _sub_decode(pp[key], x, cc, sub, cfg, cur_len)
        layers.append(new_cc)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = apply_site(params["head"], x, lm.head, cfg)
    new_cache = {key: {n: torch.stack([c[key][n] for c in layers])
                       for n in cache[key]} for key in cache}
    return logits, new_cache


def lm_init_cache(lm: LMDef, batch: int, max_len: int, device=None) -> dict:
    """A zero decode cache: per sublayer, K/V over ``max_len`` positions or
    the recurrent state, stacked over periods. ``device`` defaults to
    ``"cuda"`` (raises without a card unless ``device="cpu"``)."""
    device = resolve_device(device)
    cfg = lm.cfg
    dtype = torch_dtype(cfg.dtype)

    def one_sub(sub: SubDef) -> dict:
        if sub.mixer_kind == "attn_gqa":
            return A.gqa_init_cache(sub.mixer, batch, max_len, dtype, device)
        if sub.mixer_kind == "attn_mla":
            return A.mla_init_cache(sub.mixer, batch, max_len, dtype, device)
        if sub.mixer_kind == "mamba":
            return S.mamba_init_state(sub.mixer, batch, dtype, device)
        return S.rwkv6_init_state(sub.mixer, batch, cfg.d_model, dtype,
                                  device)

    return {f"sub_{i}": {n: a[None].repeat((lm.n_periods,) + (1,) * a.dim())
                         for n, a in one_sub(sub).items()}
            for i, sub in enumerate(lm.period)}


# ---------------------------------------------------------------------------
# TT-site walking (prior loss, λ update, param counting)
# ---------------------------------------------------------------------------

_MIXER_SITES = {
    "attn_gqa": ("q", "kv", "o"),
    "attn_mla": ("q_down", "q_up", "kv_down", "k_up", "v_up", "o"),
    "mamba": ("in_proj", "x_proj", "dt_proj", "out_proj"),
    "rwkv6": ("r", "k", "v", "g", "o", "w_lora_a", "w_lora_b", "ffn_k",
              "ffn_v", "ffn_r"),
}


def _walk_sites(lm: LMDef):
    """Yield (path in the reference's stacked tree, SiteDef) for every
    weight site; a ``layers`` path names the site in every layer."""
    if lm.embed is not None:
        yield ("embed",), lm.embed
    for i, sub in enumerate(lm.period):
        base = ("layers", f"sub_{i}")
        for n in _MIXER_SITES[sub.mixer_kind]:
            yield base + ("mixer", n), getattr(sub.mixer, n)
        if sub.ffn_kind == "ffn":
            for n in ("gate", "up", "down"):
                yield base + ("ffn", n), getattr(sub.ffn, n)
        elif sub.ffn_kind == "moe":
            for n in ("router", "gate", "up", "down"):
                yield base + ("moe", n), getattr(sub.ffn, n)
            if sub.ffn.shared is not None:
                for n in ("gate", "up", "down"):
                    yield (base + ("moe", "shared", n),
                           getattr(sub.ffn.shared, n))
    yield ("head",), lm.head


def _get_path(params, path):
    node = params
    for p in path:
        node = node[p]
    return node


def _site_params(params: dict, path: tuple) -> list[tuple[tuple, dict]]:
    """(port path, site params) of a ``_walk_sites`` path: one per layer for
    a ``layers`` path, in layer order; else the one."""
    if path[0] != "layers":
        return [(path, _get_path(params, path))]
    return [(("layers", l) + path[1:], _get_path(pp, path[1:]))
            for l, pp in enumerate(params["layers"])]


def lm_prior_loss(params: dict, lm: LMDef) -> torch.Tensor:
    """Sum of every TT site's prior over every layer."""
    dev = params["final_norm"]["scale"].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for path, site in _walk_sites(lm):
        if site.use_tt:
            for _, p in _site_params(params, path):
                total = total + site_prior_loss(p, site, lm.cfg)
    return total


def lm_lambda_update(params: dict, lm: LMDef) -> dict:
    """Every TT site's λ updated in closed form (Eq. 4), layer by layer;
    a new tree (dicts and the layer list copied), the old one untouched."""
    if not lm.cfg.tt.enable or not lm.cfg.tt.rank_adapt:
        return params

    def copy(node):
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, list):
            return [copy(v) for v in node]
        return node
    new = copy(params)
    for path, site in _walk_sites(lm):
        if site.use_tt:
            for full, p in _site_params(new, path):
                _get_path(new, full[:-1])[full[-1]] = site_lambda_update(
                    p, site, lm.cfg)
    return new


def lm_param_counts(params: dict, lm: LMDef) -> dict:
    """Dense-equivalent vs TT vs live (after rank pruning) parameter
    counts, as the reference counts them (an expert stack counts one
    expert's ``out * in``, as there). Reads λ on the host."""
    dense = actual = live = 0
    th = lm.cfg.tt.prune_threshold
    for path, site in _walk_sites(lm):
        mult = lm.n_periods if path[0] == "layers" else 1
        if not site.use_tt:
            n = site.out_dim * site.in_dim * mult
            dense += n
            actual += n
            live += n
            continue
        spec = site.spec
        dense += site.out_dim * site.in_dim * mult
        actual += spec.num_params * mult
        for _, p in _site_params(params, path):
            lambdas = [p[f"lambda_{n}"] for n in range(spec.d - 1)
                       if f"lambda_{n}" in p]
            if not lambdas:
                live += spec.num_params
                continue
            eff = [int(torch.sum(lam > th * torch.max(lam)))
                   for lam in lambdas]
            ranks = [1] + eff + [1]
            live += sum(ranks[n] * spec.j_dims[n] * spec.i_dims[n]
                        * ranks[n + 1] for n in range(spec.d))
    return {"dense": dense, "tt": actual, "live": live,
            "compression": dense / max(live, 1)}
