"""Model zoo: weight sites, GQA and MLA attention, SwiGLU FFN, MoE, the
recurrent mixers (Mamba, RWKV6), the frontend stubs and the unified LM with
static decode."""
from . import attention, common, ffn, frontend, lm, ssm  # noqa: F401
from .lm import (LMDef, build_lm, init_lm, lm_decode_step,  # noqa: F401
                 lm_forward, lm_init_cache)
