"""hubert-xlarge [audio]: 48L d_model=1280 16H (GQA kv=16) d_ff=5120
vocab=504 — encoder-only [arXiv:2106.07447]. Frontend (CNN feature
extractor) is a stub: input_specs provides precomputed frame embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="dense", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
    is_encoder=True, frontend="audio", rope_theta=1e4,
)
STRATEGY = "tp"

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=4, d_ff=128, vocab_size=64)
