"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) expert
d_ff=1408 vocab=163840, MoE 64e top-6 [hf:moonshotai/Moonlight-16B-A3B].
Per the assigned one-line spec: all layers MoE, no shared experts (HF config
has 2 shared + first dense layer — deviation recorded in DESIGN.md §4).
The 163,840-row embedding is the zoo's biggest TTM win when --tt is on."""
from .base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b", family="moe", num_layers=48, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6),
)
STRATEGY = "tp"

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=4, d_ff=96, vocab_size=128,
                         moe=MoEConfig(num_experts=8, top_k=2))
