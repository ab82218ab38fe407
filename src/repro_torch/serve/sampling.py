"""Per-slot token sampling: greedy / temperature / top-k / top-p — the port
of ``repro/serve/sampling.py`` (speculative accept is a later slice).

The knobs are per-slot tensors, so requests with different settings share
one decode batch. ``temperature <= 0`` is greedy argmax for that slot.

Knob semantics (vLLM order, as fixed in the reference): top-k truncates to
the k largest logits first, then the nucleus is taken over the
renormalized truncated distribution; ``top_p = 0`` keeps the argmax;
greedy rows never divide by the temperature floor, so their processed
distribution is an exact argmax one-hot.

Randomness comes from an explicit ``torch.Generator`` on the logits'
device. It does not reproduce ``jax.random`` draws: only greedy decoding
is token-comparable across the two packages.
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
