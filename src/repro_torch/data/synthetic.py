"""``fashion_like`` — the FashionMNIST drop-in of the paper reproduction:
28×28 grayscale 10-class images synthesized from class-specific low-rank
templates + noise, padded to 28×32 and flattened to 896 exactly as the
paper's input (Appendix B).

A copy of ``repro/data/synthetic.py``'s generator in numpy alone, so the
two packages draw the same images and labels from the same seed.
"""
from __future__ import annotations

import numpy as np

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
