"""repro_torch.numerics — the pow-2 quantization API of ``repro.numerics``
as far as the serving slice uses it: ``QuantSpec``/``QTensor``, the
``reference`` codec and the ``cuda`` row-scale codec (bit-identical codes).
``NumericsPolicy``, ``fake_quant`` and the blockwise codec come with the
training slice."""
from .codecs import (BACKENDS, decode, encode, get_codec,  # noqa: F401
                     per_tensor_max_scale_log2, register_codec)
from .spec import QTensor, QuantSpec, packed_trailing, qrange  # noqa: F401
