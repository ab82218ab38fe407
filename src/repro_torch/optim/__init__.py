"""AdamW with f32 or blockwise-int8 moments, the int8 gradient wire with
error feedback, and the BinaryConnect deploy quantization — the port of
``repro.optim`` for the paper's training step, with the LR schedule
and global-norm clipping of the zoo-LM step."""
from .adam import (MOMENT_SPEC, AdamState, adam_update,  # noqa: F401
                   clip_by_global_norm, global_norm, init_adam,
                   moment_nbytes)
from .grad_compress import (WIRE_SPEC, compress_decompress,  # noqa: F401
                            residual_nbytes, wire_nbytes)
from .schedule import lr_at  # noqa: F401
