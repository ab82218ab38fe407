"""repro_torch.serve — continuous-batching inference over a slot-paged,
pow-2 int8 KV pool with chunked prefill and a radix COW prefix cache (the
port of ``repro.serve``'s attention path)."""
from .engine import Completion, Engine, EngineConfig  # noqa: F401
from .kv_cache import PoolConfig, init_pool, pool_bytes  # noqa: F401
from .metrics import ServeMetrics  # noqa: F401
from .prefix import RadixPrefixCache  # noqa: F401
from .sampling import (SamplingParams, processed_probs,  # noqa: F401
                       sample_tokens)
from .scheduler import Request, Scheduler  # noqa: F401
