"""stablelm-3b [dense]: 32L d_model=2560 32H (MHA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b family]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", num_layers=32, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=6912, vocab_size=50304,
)
STRATEGY = "tp"

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=4, d_ff=112, vocab_size=64)
