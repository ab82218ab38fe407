"""Per-slot token sampling: greedy / temperature / top-k / top-p, and the
speculative-decoding accept math — the port of ``repro/serve/sampling.py``.

The knobs are per-slot tensors, so requests with different settings share
one decode batch. ``temperature <= 0`` is greedy argmax for that slot.

Knob semantics (vLLM order, as fixed in the reference): top-k truncates to
the k largest logits first, then the nucleus is taken over the
renormalized truncated distribution; ``top_p = 0`` keeps the argmax;
greedy rows never divide by the temperature floor, so their processed
distribution is an exact argmax one-hot.

Randomness comes from an explicit ``torch.Generator`` on the logits'
device. It does not reproduce ``jax.random`` draws: only greedy decoding
is token-comparable across the two packages. The speculative path
(``sample_from_probs``, ``spec_accept``) never reads a tensor back to the
host, so a draft loop that calls it k times stays asynchronous.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SamplingParams(NamedTuple):
    """Per-request sampling knobs (host-side; vectorized by the engine)."""
    temperature: float = 0.0    # <= 0: greedy
    top_k: int = 0              # 0: disabled
    top_p: float = 1.0          # 1.0: disabled


def _masked(logits: torch.Tensor, temp: torch.Tensor, top_k: torch.Tensor,
            top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scale each row (B, V) and -inf-mask everything outside
    the top-k / nucleus truncation (the reference's ``_masked_row``)."""
    v = logits.shape[-1]
    lf = logits.float()
    temp = temp.float()[:, None]
    scaled = torch.where(temp > 0.0, lf / torch.clamp(temp, min=1e-6), lf)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    ar = torch.arange(v, device=logits.device)[None]
    top_k = top_k.long()[:, None]
    keep_k = (top_k <= 0) | (ar < top_k)
    desc_k = torch.where(keep_k, desc, -torch.inf)
    probs = torch.softmax(desc_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = ((cum - probs) < top_p.float()[:, None]) & keep_k
    keep[:, 0] = True           # the top logit is always kept (top_p = 0)
    cutoff = torch.where(keep, desc, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(scaled < cutoff, -torch.inf, scaled)


def processed_probs(logits: torch.Tensor, temperature: torch.Tensor,
                    top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot processed sampling distributions of (B, V) or (B, S, V)
    logits (knobs are (B,) either way). Greedy slots get argmax one-hots."""
    if logits.dim() == 3:
        b, s, v = logits.shape
        rep = lambda t: t.repeat_interleave(s)   # noqa: E731
        return processed_probs(logits.reshape(b * s, v), rep(temperature),
                               rep(top_k), rep(top_p)).reshape(b, s, v)
    masked = _masked(logits, temperature, top_k, top_p)
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    return torch.where(temperature.float()[:, None] <= 0.0, onehot,
                       torch.softmax(masked, dim=-1))


def sample_tokens(logits: torch.Tensor, gen: torch.Generator,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """One token per row of (B, V) logits; (B,) int32."""
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temperature > 0).any()):
        return greedy.to(torch.int32)
    probs = torch.softmax(_masked(logits, temperature, top_k, top_p), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)


def sample_from_probs(probs: torch.Tensor, gen: torch.Generator
                      ) -> torch.Tensor:
    """One token per row of processed distributions (B, V) (unnormalised
    rows are fine); (B,) int32. This is ``torch.multinomial``'s own
    one-sample draw, argmax of p / E with E ~ Exp(1) from ``gen``, written
    out so that no validity check reads back to the host. A category of
    zero mass never wins, so a one-hot row (greedy) gives its argmax
    whatever the draw."""
    e = torch.empty_like(probs, dtype=torch.float32).exponential_(
        generator=gen)
    race = torch.where(probs > 0, probs.float() / e, -1.0)
    return torch.argmax(race, dim=-1).to(torch.int32)


def spec_accept(target_logits: torch.Tensor, draft_probs: torch.Tensor,
                draft_tokens: torch.Tensor, gen: torch.Generator,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched speculative accept (the reference's ``spec_accept`` over its
    ``_spec_accept_row``, every slot at once on the device).

    target_logits (B, k+1, V): the target's logits at the incoming token
    and the k proposals; draft_probs (B, k, V): the processed draft
    distributions Q each proposal was drawn from; draft_tokens (B, k).
    The knobs (B,) process the target's logits into P as decode does.
    Position i accepts when ``u * q_i < p_i`` (strict: with u in [0, 1) a
    greedy match always accepts, a mismatch never); the accepted prefix
    is the ``cumprod`` of the tests. The next token is drawn from the
    residual max(P_a - Q_a, 0) at the first rejection a, from P_k when all
    k accept (Q_k = 0), and from P_a when roundoff empties the residual.

    Returns (accept_len (B,) int32 in [0, k], next_token (B,) int32): slot
    b emits draft_tokens[b, :accept_len[b]], then next_token[b]."""
    b, k = draft_tokens.shape
    tprobs = processed_probs(target_logits, temperature, top_k, top_p)
    qprobs = draft_probs.float()
    dtok = draft_tokens.long()[..., None]
    p_tok = tprobs[:, :k].gather(2, dtok)[..., 0]
    q_tok = qprobs.gather(2, dtok)[..., 0]
    u = torch.rand((b, k), generator=gen, device=tprobs.device)
    accept = (u * q_tok < p_tok).to(torch.int32)
    a = torch.cumprod(accept, dim=1).sum(dim=1)                    # (B,)
    v = tprobs.shape[-1]
    p_a = tprobs.gather(1, a[:, None, None].expand(b, 1, v))[:, 0]
    q_a = qprobs.gather(1, a.clamp(max=k - 1)[:, None, None].expand(
        b, 1, v))[:, 0]
    q_a = torch.where((a < k)[:, None], q_a, 0.0)
    resid = torch.clamp(p_a - q_a, min=0.0)
    dist = torch.where(resid.sum(dim=-1, keepdim=True) > 0.0, resid, p_a)
    return a.to(torch.int32), sample_from_probs(dist, gen)
