"""Synthetic datasets (no downloads), copies of ``repro/data/synthetic.py``'s
generators in numpy alone, so the two packages draw the same data from the
same seed:

- ``lm_batch``: Zipf-distributed token streams with a learnable structure
  (the next token correlated with a linear hash of the previous two), so
  that training loss can fall.
- ``fashion_like``: the FashionMNIST drop-in of the paper reproduction,
  28×28 grayscale 10-class images synthesized from class-specific low-rank
  templates + noise, padded to 28×32 and flattened to 896 exactly as the
  paper's input (Appendix B).
"""
from __future__ import annotations

import numpy as np


def lm_batch(step: int, *, batch: int, seq: int, vocab: int,
             shard: int = 0, num_shards: int = 1, seed: int = 0) -> dict:
    """Deterministic and stateless: the batch is a pure function of (seed,
    step, shard, num_shards). ``{"tokens", "labels"}``, each (batch //
    num_shards, seq) int32, labels the tokens shifted by one."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, num_shards]))
    b = batch // num_shards
    # zipf-ish marginal + markov structure
    base = rng.zipf(1.3, size=(b, seq + 1)).astype(np.int64) % vocab
    a1, a2, c = 6364136223846793005, 1442695040888963407, 1013904223
    for t in range(2, seq + 1):
        mix = (base[:, t - 1] * a1 + base[:, t - 2] * a2 + c) % vocab
        use = rng.random(b) < 0.5
        base[:, t] = np.where(use, mix, base[:, t])
    tokens = base[:, :seq].astype(np.int32)
    labels = base[:, 1:seq + 1].astype(np.int32)
    return {"tokens": tokens, "labels": labels}


_TEMPLATES = None


def _templates(vocab_classes: int = 10):
    global _TEMPLATES
    if _TEMPLATES is None:
        r = np.random.default_rng(1234)
        # class templates: low-rank smooth structures, fixed across calls
        u = r.normal(size=(vocab_classes, 28, 3))
        v = r.normal(size=(vocab_classes, 3, 28))
        _TEMPLATES = np.einsum("cik,ckj->cij", u, v)
        _TEMPLATES /= np.abs(_TEMPLATES).max(axis=(1, 2), keepdims=True)
    return _TEMPLATES


def fashion_like(n: int, *, seed: int = 0, noise: float = 0.35):
    """(images (n, 896) float32 in [-1,1] with zero-padded columns, labels
    (n,) int32)."""
    rng = np.random.default_rng(seed)
    t = _templates()
    labels = rng.integers(0, 10, size=n)
    imgs = t[labels] + noise * rng.normal(size=(n, 28, 28))
    imgs = np.clip(imgs, -1, 1)
    out = np.zeros((n, 28, 32), np.float32)
    out[:, :, 2:30] = imgs
    return out.reshape(n, -1), labels.astype(np.int32)
