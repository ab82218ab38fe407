"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA (kv_lora=512) expert
d_ff=1536, 2 shared + 160 routed top-6, vocab=102400 [arXiv:2405.04434].
Per the assigned spec all layers are MoE (HF: first layer dense — deviation
recorded). Optimizer states default to int8 (blockwise) so the 236B state
fits a 256-chip pod (DESIGN.md §5)."""
from .base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    num_heads=128, num_kv_heads=128, d_ff=1536, vocab_size=102400,
    attn_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, num_shared=2),
)
STRATEGY = "tp"

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=48,
    vocab_size=128,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=1))
