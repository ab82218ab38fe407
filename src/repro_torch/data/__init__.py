"""Synthetic datasets of the training slices (numpy only) and the host
pipeline: the background ``Prefetcher`` and ``host_shard_info``."""
from .pipeline import Prefetcher, host_shard_info  # noqa: F401
from .synthetic import fashion_like, lm_batch  # noqa: F401
