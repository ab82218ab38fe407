"""Config system: plain dataclasses, JSON-serializable, CLI-overridable.

One ``ModelConfig`` describes any arch in the zoo (dense / GQA / MLA / MoE /
Mamba / RWKV6 / hybrid); ``TTConfig``/``QuantConfig`` toggle the paper's
technique per weight-site; ``ShapeConfig`` is one assigned input-shape cell.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

# ---------------------------------------------------------------------------
# Paper technique configs
# ---------------------------------------------------------------------------

# Weight sites the TTM factorization / QAT can be applied to.
TT_SITES = ("attn_qkv", "attn_o", "ffn", "expert", "embed", "head", "ssm_proj")


@dataclass(frozen=True)
class TTConfig:
    """Tensor-Train-Matrix factorization config (paper §2, §3.1)."""
    enable: bool = False
    apply_to: tuple[str, ...] = ("ffn", "attn_qkv", "attn_o")
    d: int = 3                      # number of TT cores per matrix
    max_rank: int = 32              # initial rank R_n (adapted downward in training)
    rank_adapt: bool = True         # Bayesian rank shrinkage (Eq. 2/4)
    prune_threshold: float = 1e-3   # lambda_n(r)/max(lambda_n) below this -> slice pruned
    gamma: float = 1.0              # weight on the log-posterior prior term g(.)
    min_elements: int = 1 << 16     # matrices below this stay dense


@dataclass(frozen=True)
class QuantConfig:
    """Low-precision training config (paper §3.2-3.3)."""
    enable: bool = False
    weight_bits: int = 4            # TT factors
    act_bits: int = 8               # activations + bias
    grad_bits: int = 16             # gradients
    weight_scale_log2: int = -2     # fixed pow-2 scale for TT factors (paper: fixed)
    # scale manager (§3.3): keep mean |x/2^k| within [lo, hi]
    target_lo: float = 0.1
    target_hi: float = 0.3
    ema: float = 0.9                # running-mean decay for |x| tracking
    health: bool = False            # trace quant-health aggregates (repro.obs)

    def policy(self):
        """Lower onto the unified numerics policy (lazy import: configs
        stay importable without the numerics modules)."""
        from ..numerics.policy import policy_from_quant_config
        return policy_from_quant_config(self)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # 0 => dense FFN everywhere
    top_k: int = 2
    num_shared: int = 0             # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01   # load-balance aux loss


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba / RWKV6 block parameters."""
    d_state: int = 16               # mamba state dim
    d_conv: int = 4                 # mamba conv width
    expand: int = 2                 # mamba inner expansion
    head_dim: int = 64              # rwkv6 head size
    dt_rank: int = 0                # 0 => ceil(d_model/16)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm_rwkv6 | hybrid_jamba | encoder
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4           # GQA; ==num_heads -> MHA; 1 -> MQA
    head_dim: int = 0               # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    max_seq_len: int = 8192
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # attention kind: "gqa" | "mla"
    attn_kind: str = "gqa"
    # pad q-head count up to this for TP divisibility (0 = no padding);
    # pad-head outputs are sliced before o-proj: numerically identical to
    # the unpadded arch, +pad/real extra attention FLOPs, even sharding.
    pad_heads_to: int = 0
    mla: MLAConfig | None = None
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (jamba): layers per period and which position is attention
    period: int = 1                 # 1 => homogeneous stack
    attn_positions: tuple[int, ...] = ()   # positions within period that are attention
    moe_positions: tuple[int, ...] = ()    # positions within period whose FFN is MoE
    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"
    is_encoder: bool = False        # encoder-only (no causal mask, no decode)
    # paper technique
    tt: TTConfig = field(default_factory=TTConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    # numerics / memory
    dtype: str = "bfloat16"         # activation/param compute dtype
    remat: str = "full"             # "none" | "full" | "dots"
    logits_softcap: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input-shape cells (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatch: int = 0             # 0 => no grad accumulation
    opt_state_dtype: str = "float32"   # "float32" | "int8" (blockwise-quantized m/v)
    grad_compress: bool = False     # int8+error-feedback DP all-reduce
    seed: int = 0
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 200
    log_every: int = 10


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1
    pods: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pods


def asdict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)
