"""Model zoo, dense GQA family (the serving slice): weight sites, GQA
attention, SwiGLU FFN and the unified LM."""
from . import attention, common, ffn, lm  # noqa: F401
from .lm import LMDef, build_lm, init_lm, lm_forward  # noqa: F401
