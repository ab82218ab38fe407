"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 —
llama-arch GQA [arXiv:2403.04652]. 56 heads do not divide the 16-way model
axis → q-heads padded to 64 for TP (pad outputs sliced before o-proj:
numerically identical, +14% attention FLOPs; beat the cp/ZeRO-3 baseline by
2.7x on the memory roofline term — EXPERIMENTS.md §Perf)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=20480, vocab_size=64000,
    pad_heads_to=64,
)
STRATEGY = "tp"

REDUCED = CONFIG.replace(num_layers=2, d_model=112, num_heads=7,
                         num_kv_heads=1, head_dim=16, d_ff=256, vocab_size=64)
