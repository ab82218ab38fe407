"""Model zoo: weight sites, GQA attention, SwiGLU FFN, the recurrent
mixers (Mamba, RWKV6) and the unified LM with static decode."""
from . import attention, common, ffn, lm, ssm  # noqa: F401
from .lm import (LMDef, build_lm, init_lm, lm_decode_step,  # noqa: F401
                 lm_forward, lm_init_cache)
