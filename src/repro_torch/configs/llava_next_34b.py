"""llava-next-34b [vlm]: yi-34b backbone (60L d_model=7168 56H GQA kv=8
d_ff=20480 vocab=64000) + anyres vision frontend STUB — input_specs provides
precomputed patch embeddings (projector output)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="dense", num_layers=60, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=20480, vocab_size=64000,
    frontend="vision", pad_heads_to=64,
)
STRATEGY = "tp"
N_PATCHES = 2304          # anyres 672x672: (2x2+1 tiles + newline tokens)

REDUCED = CONFIG.replace(num_layers=2, d_model=112, num_heads=7,
                         num_kv_heads=1, head_dim=16, d_ff=256, vocab_size=64)
