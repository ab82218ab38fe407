"""State-space blocks — the port of ``repro/models/ssm.py``: Mamba-1's
selective scan (Jamba's mixer) and RWKV6 "Finch" (data-dependent decay
linear attention).

Both are O(1)-state decoders. Projections are weight sites (dense or TT,
``apply_site``); the recurrences carry per-channel vectors. The reference
runs each recurrence as a ``lax.scan`` outside any Pallas kernel, so here
each is a per-token Python loop over one step function (``_ssm_step``,
``_wkv6_step``). Decode is the forward at S = 1 against the carried state,
so prefill, static decode and the engine's decode step run one op
sequence, which the engine's token identity with static decode rests on.

The reference's remat of the scans is kept: while autograd records, the
loop runs in chunks of ``SCAN_CHUNK`` tokens (one chunk where S is not a
multiple of ``min(SCAN_CHUNK, S)``), each one ``_ScanChunk``: its forward
runs without recording and keeps only the chunk's inputs and its entry
state, and its backward runs the chunk again with autograd and
differentiates it (``jax.checkpoint`` with ``nothing_saveable``, as the
reference wraps a chunk). A backward so holds one state a chunk and one
chunk's per-token states at a time, not one state a token; nested in the
layer's checkpoint (``remat="full"``) a chunk runs three times, its
backward once. ``SCAN_CHUNK`` is read at each call. The chunks run the
same per-token ops as one loop, so the forward's bits do not change;
without grad the loop runs whole.

Names, parameter trees and op order follow the reference (the steps fold
a multiply and an add into ``addcmul``), so weights carried by
``convert.params_from_jax`` give the same numbers to float32 roundoff.
softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from .common import (SiteDef, apply_site, init_site, make_site, rms_norm,
                     silu, torch_dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Mamba-1 (selective scan)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MambaDef:
    in_proj: SiteDef        # D -> 2 * d_inner  (x and z)
    x_proj: SiteDef         # d_inner -> dt_rank + 2*d_state
    dt_proj: SiteDef        # dt_rank -> d_inner
    out_proj: SiteDef       # d_inner -> D
    d_inner: int
    d_state: int
    d_conv: int
    dt_rank: int


def make_mamba(cfg: ModelConfig) -> MambaDef:
    di = cfg.ssm.expand * cfg.d_model
    dtr = cfg.ssm.dt_rank or max(1, math.ceil(cfg.d_model / 16))
    return MambaDef(
        in_proj=make_site(cfg, "ssm_proj", 2 * di, cfg.d_model),
        x_proj=make_site(cfg, "ssm_proj", dtr + 2 * cfg.ssm.d_state, di),
        dt_proj=make_site(cfg, "ssm_proj", di, dtr, use_bias=True),
        out_proj=make_site(cfg, "ssm_proj", cfg.d_model, di),
        d_inner=di, d_state=cfg.ssm.d_state, d_conv=cfg.ssm.d_conv,
        dt_rank=dtr)


def init_mamba(gen: torch.Generator, d: MambaDef, cfg: ModelConfig,
               device: torch.device) -> dict:
    """The reference's distributions: S4D-real ``A_log`` = log(1..N) per
    channel, ``conv_w ~ N(0, 1/d_conv)`` in the model dtype, zero
    ``conv_b``, ``D`` ones."""
    dtype = torch_dtype(cfg.dtype)
    a = torch.arange(1, d.d_state + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(d.d_inner, 1)
    conv_w = torch.randn((d.d_conv, d.d_inner), generator=gen, device=device,
                         dtype=torch.float32) * (1.0 / math.sqrt(d.d_conv))
    return {
        "in_proj": init_site(gen, d.in_proj, cfg, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((d.d_inner,), dtype=dtype, device=device),
        "x_proj": init_site(gen, d.x_proj, cfg, device),
        "dt_proj": init_site(gen, d.dt_proj, cfg, device),
        "A_log": torch.log(a),
        "D": torch.ones((d.d_inner,), dtype=torch.float32, device=device),
        "out_proj": init_site(gen, d.out_proj, cfg, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C). Returns (y, new_state)
    where state holds the last K-1 inputs for decode."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(k))
    new_state = xp[:, -(k - 1):, :]
    return y + b[None, None, :], new_state


SCAN_CHUNK = 256


class _ScanChunk(torch.autograd.Function):
    """One chunk of a scan under the reference's remat: ``steps(h, *xs) ->
    (ys, h_last)`` run without recording, only ``h`` and ``xs`` kept; the
    backward runs it again with autograd on detached copies and returns
    their gradients (``torch.autograd.grad``, so no parameter's ``.grad``
    is touched)."""

    @staticmethod
    def forward(ctx, steps, h, *xs):
        ctx.steps = steps
        ctx.save_for_backward(h, *xs)
        return steps(h, *xs)

    @staticmethod
    def backward(ctx, *gouts):
        ins = [t.detach().requires_grad_(t.requires_grad)
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.steps(*ins)
        pairs = [(o, g) for o, g in zip(outs, gouts)
                 if g is not None and o.requires_grad]
        need = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], need,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and need else ())
        return (None, *(next(got) if t.requires_grad else None
                        for t in ins))


def _scan_chunked(steps, h, seqs, consts):
    """``steps(h, *seqs, *consts) -> (ys, h_last)`` over (B, S, ...)
    sequences: in one call without grad; while autograd records, one
    ``_ScanChunk`` a chunk of the reference's length (the module
    docstring). The chunks' outputs concatenate along S."""
    if not torch.is_grad_enabled():
        return steps(h, *seqs, *consts)
    s = seqs[0].shape[1]
    n = min(SCAN_CHUNK, s)
    if s % n:
        n = s                   # odd lengths: a single chunk
    ys = []
    for c0 in range(0, s, n):
        y, h = _ScanChunk.apply(steps, h, *(x[:, c0:c0 + n] for x in seqs),
                                *consts)
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h


def _ssm_step(h, u_t, dt_t, bt, ct, a):
    """One selective-scan step: h (B,Di,N) f32, u_t/dt_t (B,Di), bt/ct
    (B,N). Returns (h_new, y (B,Di)). ``addcmul`` and ``matmul`` rather than
    separate ops and ``einsum``: the scan issues this once a token a
    layer, so each launch and each einsum parse is host time."""
    da_t = torch.exp(dt_t[..., None] * a[None])              # (B,Di,N)
    x_t = (dt_t * u_t)[..., None] * bt[:, None, :]
    h = torch.addcmul(x_t, da_t, h)                          # da_t*h + x_t
    y = torch.matmul(h, ct[..., None])[..., 0]
    return h, y


def _selective_scan(u, dt, a, b_t, c_t, d_skip, h0=None):
    """u,dt: (B,S,Di); a: (Di,N); b_t,c_t: (B,S,N). Returns (y, h_last).
    exp(dt·A) and dt·B·u are computed inside the step, never materialized
    over (B,S,Di,N)."""
    bsz, s, di = u.shape
    n = a.shape[-1]
    h = (torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0)
    uf, dtf = u.float(), dt.float()
    y, h = _scan_chunked(_ssm_steps, h, (uf, dtf, b_t.float(), c_t.float()),
                         (a,))
    return (y + uf * d_skip[None, None]).to(u.dtype), h


def _ssm_steps(h, u, dt, b_t, c_t, a):
    """The selective scan's token loop over f32 (B, T, ...) inputs:
    ((B, T, Di) outputs, last state). The tokens are ``unbind``'s views:
    under autograd one node a chunk and input gives their gradients back,
    where a slice a token would scatter each into a zero tensor of the
    whole input."""
    ys = []
    for u_t, dt_t, bt, ct in zip(*(x.unbind(1) for x in (u, dt, b_t, c_t))):
        h, y = _ssm_step(h, u_t, dt_t, bt, ct, a)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def mamba_forward(params: dict, x: torch.Tensor, d: MambaDef,
                  cfg: ModelConfig, state: dict | None = None):
    """x: (B,S,D) -> (y, new_state). state = {"conv": (B,K-1,Di),
    "h": (B,Di,N)}. Decode is S = 1 with the carried state."""
    xz = apply_site(params["in_proj"], x, d.in_proj, cfg)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi, new_conv = _causal_conv(xi, params["conv_w"].to(xi.dtype),
                                params["conv_b"].to(xi.dtype),
                                None if state is None else state["conv"])
    xi = silu(xi)
    proj = apply_site(params["x_proj"], xi, d.x_proj, cfg)
    dt = proj[..., :d.dt_rank]
    b_t = proj[..., d.dt_rank:d.dt_rank + d.d_state].float()
    c_t = proj[..., d.dt_rank + d.d_state:].float()
    dt = _softplus(apply_site(params["dt_proj"], dt, d.dt_proj, cfg).float())
    a = -torch.exp(params["A_log"])
    h0 = None if state is None else state["h"]
    y, h_last = _selective_scan(xi.float(), dt, a, b_t, c_t, params["D"], h0)
    y = y.to(x.dtype) * silu(z)
    out = apply_site(params["out_proj"], y, d.out_proj, cfg)
    return out, {"conv": new_conv.to(x.dtype), "h": h_last}


def mamba_init_state(d: MambaDef, batch: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    return {"conv": torch.zeros((batch, d.d_conv - 1, d.d_inner),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, d.d_inner, d.d_state),
                             dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# RWKV6 "Finch"
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RWKV6Def:
    r: SiteDef
    k: SiteDef
    v: SiteDef
    g: SiteDef
    o: SiteDef
    w_lora_a: SiteDef       # D -> lora_dim
    w_lora_b: SiteDef       # lora_dim -> D
    ffn_k: SiteDef          # channel-mix
    ffn_v: SiteDef
    ffn_r: SiteDef
    num_heads: int
    head_dim: int


W_LORA_DIM = 64


def make_rwkv6(cfg: ModelConfig) -> RWKV6Def:
    hd = cfg.ssm.head_dim
    nh = cfg.d_model // hd
    dm = cfg.d_model
    return RWKV6Def(
        r=make_site(cfg, "ssm_proj", dm, dm),
        k=make_site(cfg, "ssm_proj", dm, dm),
        v=make_site(cfg, "ssm_proj", dm, dm),
        g=make_site(cfg, "ssm_proj", dm, dm),
        o=make_site(cfg, "ssm_proj", dm, dm),
        w_lora_a=make_site(cfg, "ssm_proj", W_LORA_DIM, dm),
        w_lora_b=make_site(cfg, "ssm_proj", dm, W_LORA_DIM),
        ffn_k=make_site(cfg, "ffn", cfg.d_ff, dm),
        ffn_v=make_site(cfg, "ffn", dm, cfg.d_ff),
        ffn_r=make_site(cfg, "ffn", dm, dm),
        num_heads=nh, head_dim=hd)


def init_rwkv6(gen: torch.Generator, d: RWKV6Def, cfg: ModelConfig,
               device: torch.device) -> dict:
    """The reference's distributions: decay base ``w0`` linspace(-6, -1),
    bonus ``u ~ N(0, 0.01)``, token-shift mixes 0.5, ``ln_x_scale`` 1."""
    dm = cfg.d_model
    p = {n: init_site(gen, getattr(d, n), cfg, device)
         for n in ("r", "k", "v", "g", "o", "w_lora_a", "w_lora_b")}
    p["w0"] = torch.linspace(-6.0, -1.0, dm, dtype=torch.float32,
                             device=device)
    p["u"] = torch.randn((d.num_heads, d.head_dim), generator=gen,
                         device=device, dtype=torch.float32) * 0.1
    p["mu_x"] = torch.full((5, dm), 0.5, dtype=torch.float32, device=device)
    for n in ("ffn_k", "ffn_v", "ffn_r"):
        p[n] = init_site(gen, getattr(d, n), cfg, device)
    p["mu_ffn"] = torch.full((2, dm), 0.5, dtype=torch.float32, device=device)
    p["ln_x_scale"] = torch.ones((dm,), dtype=torch.float32, device=device)
    return p


def _token_shift(x: torch.Tensor, last: torch.Tensor | None):
    """shift(x)[t] = x[t-1]; returns (shifted, new_last)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    shifted = torch.cat([last, x[:, :-1]], dim=1)
    return shifted, x[:, -1:]


def _wkv6_step(s, rt, kt, vt, wt, u):
    """One WKV6 recurrence step: s (B,H,Dh,Dh) f32 state, rt/kt/vt/wt
    (B,H,Dh) f32, u (H,Dh) bonus. Returns (s_new, out (B,H,Dh)), in four
    launches (see ``_ssm_step``)."""
    kv = kt[..., :, None] * vt[..., None, :]                # k^T v
    out = torch.matmul(rt[..., None, :],
                       torch.addcmul(s, u[None, :, :, None], kv))[..., 0, :]
    s = torch.addcmul(kv, wt[..., None], s)                 # w*s + kv
    return s, out


def _wkv6_scan(r, k, v, w, u, h0):
    """RWKV6 recurrence. r,k,v: (B,S,H,Dh); w: (B,S,H,Dh) decay in (0,1);
    u: (H,Dh) bonus; state (B,H,Dh_k,Dh_v):
      out_t = (S_{t-1} + diag(u) k_t^T v_t) applied to r_t
      S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    Returns ((B,S,H,Dh) f32, last state)."""
    return _scan_chunked(_wkv6_steps, h0,
                         (r.float(), k.float(), v.float(), w.float()), (u,))


def _wkv6_steps(s, r, k, v, w, u):
    """The WKV6 token loop over f32 (B, T, H, Dh) inputs: ((B, T, H, Dh)
    outputs, last state), the tokens ``unbind``'s views (``_ssm_steps``)."""
    outs = []
    for rt, kt, vt, wt in zip(*(x.unbind(1) for x in (r, k, v, w))):
        s, out = _wkv6_step(s, rt, kt, vt, wt, u)
        outs.append(out)
    return torch.stack(outs, dim=1), s


def rwkv6_time_mix(params, x, d: RWKV6Def, cfg: ModelConfig,
                   state: dict | None):
    """x: (B,S,D) -> (y, {"shift", "wkv"}). Decode is S = 1 with the
    carried state."""
    b, s, _ = x.shape
    nh, hd = d.num_heads, d.head_dim
    last = None if state is None else state["shift"]
    xs, new_last = _token_shift(x, last)
    mu = params["mu_x"].to(x.dtype)                  # (5, D)
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i][None, None] for i in range(5))
    r = apply_site(params["r"], xr, d.r, cfg).reshape(b, s, nh, hd)
    k = apply_site(params["k"], xk, d.k, cfg).reshape(b, s, nh, hd)
    v = apply_site(params["v"], xv, d.v, cfg).reshape(b, s, nh, hd)
    g = apply_site(params["g"], xg, d.g, cfg)
    # data-dependent decay (the Finch contribution)
    dw = apply_site(params["w_lora_b"],
                    torch.tanh(apply_site(params["w_lora_a"], xw, d.w_lora_a,
                                          cfg)),
                    d.w_lora_b, cfg)
    w = torch.exp(-torch.exp(params["w0"][None, None].float()
                             + dw.float()))             # (B,S,D) in (0,1)
    h0 = (torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
          if state is None else state["wkv"])
    out, h_last = _wkv6_scan(r, k, v, w.reshape(b, s, nh, hd), params["u"],
                             h0)
    out = out.reshape(x.shape).to(x.dtype)
    out = rms_norm(out, params["ln_x_scale"], cfg.norm_eps)  # group-norm proxy
    out = out * silu(g)
    return apply_site(params["o"], out, d.o, cfg), {"shift": new_last,
                                                   "wkv": h_last}


def rwkv6_channel_mix(params, x, d: RWKV6Def, cfg: ModelConfig,
                      state: dict | None):
    last = None if state is None else state["shift_ffn"]
    xs, new_last = _token_shift(x, last)
    mu = params["mu_ffn"].to(x.dtype)
    xk = x + (xs - x) * mu[0][None, None]
    xr = x + (xs - x) * mu[1][None, None]
    k = apply_site(params["ffn_k"], xk, d.ffn_k, cfg)
    k = torch.square(torch.relu(k))
    kv = apply_site(params["ffn_v"], k, d.ffn_v, cfg)
    r = torch.sigmoid(apply_site(params["ffn_r"], xr, d.ffn_r, cfg))
    return r * kv, {"shift_ffn": new_last}


def rwkv6_init_state(d: RWKV6Def, batch: int, d_model: int,
                     dtype: torch.dtype, device: torch.device) -> dict:
    return {
        "shift": torch.zeros((batch, 1, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, d.num_heads, d.head_dim, d.head_dim),
                           dtype=torch.float32, device=device),
        "shift_ffn": torch.zeros((batch, 1, d_model), dtype=dtype,
                                 device=device),
    }
