"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892]. head_dim=64 → 32 heads.

Serving (repro.serve): attention-free, so the engine runs the scheduler
unpaged — per-slot memory is the O(1) recurrent state in the
``serve/state_cache.py`` pool (per layer: shift 2·d_model + wkv
heads·head_dim² = 135168 f32 elements/slot at full size, int8-quantized
under the ``ssm_state`` policy site), independent of context length."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm_rwkv6", num_layers=24, d_model=2048,
    d_ff=7168, vocab_size=65536, num_heads=32, num_kv_heads=32,
    ssm=SSMConfig(head_dim=64),
)
STRATEGY = "tp"

REDUCED = CONFIG.replace(num_layers=2, d_model=64, d_ff=128, vocab_size=64,
                         num_heads=4, num_kv_heads=4,
                         ssm=SSMConfig(head_dim=16))
