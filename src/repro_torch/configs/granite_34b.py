"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense", num_layers=88, d_model=6144,
    num_heads=48, num_kv_heads=1, d_ff=24576, vocab_size=49152,
)
STRATEGY = "tp"

REDUCED = CONFIG.replace(num_layers=2, d_model=128, num_heads=8,
                         num_kv_heads=1, d_ff=256, vocab_size=64)
