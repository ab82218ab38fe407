"""Synthetic datasets of the training slices (numpy only)."""
from .synthetic import fashion_like, lm_batch  # noqa: F401
