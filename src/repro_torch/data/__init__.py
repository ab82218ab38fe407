"""Synthetic datasets of the training slice (numpy only)."""
from .synthetic import fashion_like  # noqa: F401
