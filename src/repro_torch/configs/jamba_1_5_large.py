"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2 — Mamba+attn 1:7 interleave [arXiv:2403.19887].

Period of 8 layers: attention at position 4 (Jamba's attn_layer_offset),
Mamba elsewhere; MoE FFN at odd positions, dense FFN at even (Jamba applies
MoE every other layer).

Serving (repro.serve): hybrid routing — the 1-in-8 attention sublayers page
K/V through the quantized KV pool while the 7-in-8 Mamba sublayers keep
O(1) state (conv (d_conv-1)·d_inner + h d_inner·d_state per layer) in the
``serve/state_cache.py`` pool, so resident serving memory is dominated by
the single attention layer's pages, not the Mamba stack."""
from .base import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large", family="hybrid_jamba", num_layers=72,
    d_model=8192, num_heads=64, num_kv_heads=8, d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    period=8, attn_positions=(4,), moe_positions=(1, 3, 5, 7),
)
STRATEGY = "tp"

REDUCED = CONFIG.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    vocab_size=64, period=4, attn_positions=(1,), moe_positions=(1, 3),
    moe=MoEConfig(num_experts=4, top_k=2),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2))
