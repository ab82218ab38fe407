"""repro_torch.numerics — the pow-2 quantization API of ``repro.numerics``
as far as the serving and training slices use it: ``QuantSpec``/
``QTensor``, the ``reference`` codec, the ``cuda`` codec (row-scale
encode/decode and scalar fake-quant kernels, bit-identical), and the §3.3
scale manager (``policy``). ``NumericsPolicy`` and the blockwise codec
come with the wire slice."""
from .codecs import (BACKENDS, decode, encode, fake_quant,  # noqa: F401
                     get_codec, per_tensor_max_scale_log2, register_codec,
                     roundtrip)
from .policy import (ScaleState, init_scale, step_log2,  # noqa: F401
                     update_scale)
from .spec import QTensor, QuantSpec, packed_trailing, qrange  # noqa: F401
