"""The paper's own experiment: 2-layer TT MLP on (Fashion)MNIST
(Appendix B). Model defined in models/mlp_tt.py; this registry entry only
carries the training hyperparameters."""
from .base import QuantConfig, TTConfig, TrainConfig

TT = TTConfig(enable=True, d=4, max_rank=16, rank_adapt=True,
              prune_threshold=1e-2)
QUANT = QuantConfig(enable=True, weight_bits=4, act_bits=8, grad_bits=16)
TRAIN = TrainConfig(learning_rate=3e-3, warmup_steps=20, total_steps=600,
                    weight_decay=0.0, grad_clip=0.0)
BATCH = 64                 # paper: batches of 64 samples
