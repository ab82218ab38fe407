"""Mixture-of-Experts FFN — the port of ``repro/models/moe.py``, its
single-device path.

Routing: top-k softmax renormalised over the selected experts, GShard
capacity dropping, the switch load-balance aux loss. Dispatch gathers the
top-C tokens of every expert (``x2d[cidx]``), runs the experts' SwiGLU
and combines with ``index_add_`` into a zero tensor, as the reference's
``.at[].add`` does. Dense experts are batched products over the ``(E, D,
F)`` stacks (a batched matmul). TT experts (``"expert"`` in
``TTConfig.apply_to``) are E TT sites stacked on a leading axis, the tree
of the reference's vmapped ``init_site`` (cores ``(E, R, J, I, R)``, λ
``(E, R)``, ``wscale_log2`` ``(E, d)``): each of gate, up and down is one
grouped TT matvec over ``xe (E, C, D)`` (``tt_layer.tt_linear_apply`` on
stacked params), so every PE1 / PE2 / PE3 launch of a site serves all E
experts and each core's fake-quant is one ``p2_fq_rows`` launch.

Both top-k selections (the router's k of E experts, the capacity's C of T
tokens) break ties toward the lower index, as ``lax.top_k`` does
(``_topk``): a stable descending sort and a slice, on the CPU and the card
alike. The reference depends on it: equal router weights send the earlier
tokens to an expert and drop the later ones.

Casts are the reference's: the router in f32 over ``x2d.float()``, the
renormalised top-k weights cast to ``x.dtype``, the per-expert token
weights and ``cw * valid`` in f32, then cast to the experts' output dtype.

Not ported: the expert-parallel ``shard_map`` path (``mesh``; ROADMAP
queue 1, item 8). The router and the shared experts are ordinary
``"ffn"`` sites and take the TT path of ``common.apply_site`` when the
config makes them TT.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from ..core import rank_adapt as RA
from ..core import tt_layer as TL
from ..core.ttm import core_sigma
from .common import (SiteDef, apply_site, init_site, make_site, silu,
                     torch_dtype)


@dataclass(frozen=True)
class FFNLike:
    gate: SiteDef
    up: SiteDef
    down: SiteDef


@dataclass(frozen=True)
class MoEDef:
    router: SiteDef
    gate: SiteDef           # per-expert, stacked on axis 0
    up: SiteDef
    down: SiteDef
    shared: FFNLike | None
    num_experts: int
    top_k: int
    capacity_factor: float
    d_ff: int


def make_moe(cfg: ModelConfig, d_ff: int | None = None) -> MoEDef:
    f = d_ff or cfg.d_ff
    m = cfg.moe
    shared = None
    if m.num_shared > 0:
        fs = f * m.num_shared
        shared = FFNLike(
            gate=make_site(cfg, "ffn", fs, cfg.d_model),
            up=make_site(cfg, "ffn", fs, cfg.d_model),
            down=make_site(cfg, "ffn", cfg.d_model, fs))
    return MoEDef(
        router=make_site(cfg, "ffn", m.num_experts, cfg.d_model),
        gate=make_site(cfg, "expert", f, cfg.d_model),
        up=make_site(cfg, "expert", f, cfg.d_model),
        down=make_site(cfg, "expert", cfg.d_model, f),
        shared=shared, num_experts=m.num_experts, top_k=m.top_k,
        capacity_factor=m.capacity_factor, d_ff=f)


def _init_stack(gen: torch.Generator, site: SiteDef, e: int, cfg: ModelConfig,
                device: torch.device) -> dict:
    """``e`` sites stacked on axis 0, with ``init_site``'s distributions,
    drawn at once: dense ``w ~ N(0, 2/(in+out))`` drawn in f32; TT cores of
    std ``core_sigma``, λ ones, the fixed steps, a zero bias where the
    site has one (the reference's vmapped ``init_site`` tree)."""
    dtype = torch_dtype(cfg.dtype)
    if site.use_tt:
        spec = site.spec
        sigma = core_sigma(spec)
        p = {f"core_{n}": (torch.randn((e,) + shape, generator=gen,
                                       device=device, dtype=torch.float32)
                           * sigma).to(dtype)
             for n, shape in enumerate(spec.core_shapes)}
        if site.use_bias:
            p["bias"] = torch.zeros((e, site.out_dim), dtype=dtype,
                                    device=device)
        if cfg.tt.rank_adapt:
            for n, lam in enumerate(RA.init_lambdas(spec, device)):
                p[f"lambda_{n}"] = lam.expand(e, -1).clone()
        p["wscale_log2"] = torch.full(
            (e, spec.d), TL.weight_scale_log2(sigma, 4), dtype=torch.int32,
            device=device)
        return p
    sigma = (2.0 / (site.in_dim + site.out_dim)) ** 0.5
    w = torch.randn((e, site.in_dim, site.out_dim), generator=gen,
                    device=device, dtype=torch.float32) * sigma
    return {"w": w.to(dtype)}


def init_moe(gen: torch.Generator, d: MoEDef, cfg: ModelConfig,
             device: torch.device) -> dict:
    """Random weights with the reference's distributions and tree: the
    router and shared experts as ``init_site``, each expert stack
    ``(E, in, out)`` or, TT, ``(E, ...)`` leaves of a TT site."""
    e = d.num_experts
    p = {"router": init_site(gen, d.router, cfg, device),
         "gate": _init_stack(gen, d.gate, e, cfg, device),
         "up": _init_stack(gen, d.up, e, cfg, device),
         "down": _init_stack(gen, d.down, e, cfg, device)}
    if d.shared is not None:
        p["shared"] = {n: init_site(gen, getattr(d.shared, n), cfg, device)
                       for n in ("gate", "up", "down")}
    return p


def _topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, ties to the
    lower index (a stable descending sort keeps equal values in index
    order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params: dict, x2d: torch.Tensor, d: MoEDef, cfg: ModelConfig,
           mask: torch.Tensor | None = None):
    """x2d: (T, D) -> (topk_idx (T, k), topk_w (T, k), aux).

    ``mask``: optional (T,) bool of real tokens. Masked tokens (inactive
    serve slots, prefill padding) get zero combine weight, so they never
    win a capacity slot against a real token in ``_dispatch_local``, and
    are left out of the load-balance statistics."""
    logits = apply_site(params["router"], x2d.float(), d.router,
                        cfg).float()
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = _topk(probs, d.top_k)
    topk_w = topk_w / torch.clamp(topk_w.sum(-1, keepdim=True), min=1e-9)
    # switch aux loss: E * sum_e f_e * p_e, f_e counting top-1 choices (a
    # comparison, not one_hot, which reads the indices' range on the host)
    e = d.num_experts
    dispatch = (topk_idx[:, :1] == torch.arange(e, device=x2d.device)
                ).float()
    if mask is not None:
        mf = mask.float()[:, None]
        topk_w = topk_w * mf
        n = torch.clamp(mf.sum(), min=1.0)
        f_e = (dispatch * mf).sum(0) / n
        p_e = (probs * mf).sum(0) / n
    else:
        f_e = dispatch.mean(0)
        p_e = probs.mean(0)
    aux = e * torch.sum(f_e * p_e)
    return topk_idx, topk_w.to(x2d.dtype), aux


def _expert_glu(params: dict, xe: torch.Tensor, d: MoEDef,
                cfg: ModelConfig) -> torch.Tensor:
    """xe: (E, C, D) through each expert's SwiGLU, batched over the
    stacks by ``apply_site``: dense ``(E, in, out)`` a batched matmul
    (expert sites have no bias), TT one grouped TT matvec a site."""
    def site(name, x):
        return apply_site(params[name], x, getattr(d, name), cfg)
    return site("down", silu(site("gate", xe)) * site("up", xe))


def _select(w_tok: torch.Tensor, capacity: int):
    """The top-``capacity`` tokens of each expert's row of ``w_tok`` (E, T):
    (weights, token indices), ties to the earlier token. The capacity
    selection on its own, so a caller can count or record what it keeps."""
    return _topk(w_tok, capacity)


def _dispatch_local(x2d: torch.Tensor, topk_idx: torch.Tensor,
                    topk_w: torch.Tensor, params: dict, d: MoEDef,
                    cfg: ModelConfig, capacity: int) -> torch.Tensor:
    """Gather the top-C tokens of every expert, run the experts' GLU,
    scatter-add back (the reference's single-shard dispatch)."""
    e = d.num_experts
    eids = torch.arange(e, device=x2d.device)
    match = topk_idx[None] == eids[:, None, None]              # (E, T, k)
    w_tok = torch.where(match, topk_w[None].float(), 0.0).sum(-1)  # (E, T)
    cw, cidx = _select(w_tok, capacity)                        # (E, C)
    valid = cw > 0.0
    flat = cidx.reshape(-1)
    xe = x2d[flat].reshape(e, capacity, -1)
    ye = _expert_glu(params, xe, d, cfg)
    ye = ye * (cw * valid)[..., None].to(ye.dtype)
    return torch.zeros_like(x2d).index_add_(0, flat,
                                            ye.reshape(-1, ye.shape[-1]))


def moe_forward(params: dict, x: torch.Tensor, d: MoEDef, cfg: ModelConfig,
                *, mesh=None, token_mask: torch.Tensor | None = None,
                capacity_tokens: int | None = None):
    """x: (B, S, D) -> (out, aux).

    ``token_mask``: optional (B, S) bool of real tokens; masked tokens are
    dropped from the router so they cannot take expert capacity.
    ``capacity_tokens``: optional token basis for the capacity (the serving
    engine's chunked-prefill parity; see ``_capacity``)."""
    if mesh is not None:
        raise NotImplementedError("expert-parallel MoE is a later slice "
                                  "(ROADMAP queue 1, item 8: multi-device)")
    b, s, dm = x.shape
    x2d = x.reshape(b * s, dm)
    mask = None if token_mask is None else token_mask.reshape(b * s)
    topk_idx, topk_w, aux = _route(params, x2d, d, cfg, mask)
    cap = _capacity(b * s, d, capacity_tokens)
    out = _dispatch_local(x2d, topk_idx, topk_w, params, d, cfg,
                          cap).reshape(b, s, dm)
    if d.shared is not None:
        sh = params["shared"]
        g = apply_site(sh["gate"], x, d.shared.gate, cfg)
        u = apply_site(sh["up"], x, d.shared.up, cfg)
        out = out + apply_site(sh["down"], silu(g) * u, d.shared.down, cfg)
    return out, aux


def _capacity(tokens_per_shard: int, d: MoEDef,
              capacity_tokens: int | None = None) -> int:
    """Per-expert capacity: cf * tokens * k / E, at least 8, rounded up to
    8, clamped to the visible token count (decode steps have few tokens).

    ``capacity_tokens`` replaces the token basis but not the clamp: the
    serving engine's chunked-prefill parity, where capacity derives from
    the whole prompt so a chunk never drops a token the whole-prompt
    routing would keep."""
    basis = (capacity_tokens if capacity_tokens is not None
             else tokens_per_shard)
    cap = int(d.capacity_factor * basis * d.top_k / d.num_experts)
    cap = max(8, cap)
    cap = (cap + 7) // 8 * 8
    return min(cap, tokens_per_shard)
