"""repro_torch.numerics — the quantization API of ``repro.numerics``:
``QuantSpec``/``QTensor``, the ``reference`` codecs (pow2 with int4x2
packing, blockwise), the ``cuda`` codecs (scalar- and row-scale, packed
and blockwise encode/decode and the scalar- and row-scale fake-quant
kernels, bit-identical), the
``NumericsPolicy`` site map and the §3.3 scale manager (``policy``)."""
from .codecs import (BACKENDS, blockwise_geometry, decode,  # noqa: F401
                     decode_many, encode, encode_many, fake_quant, fake_quant_many,
                     fake_quant_stats,
                     get_codec, pack_int4,
                     per_tensor_max_scale_log2, register_codec, roundtrip,
                     to_storage, unpack_int4)
from .policy import (SITES, NumericsPolicy, ScaleState,  # noqa: F401
                     init_scale, policy_from_quant_config, step_log2,
                     update_scale)
from .spec import (QTensor, QuantSpec, packed_trailing, qrange,  # noqa: F401
                   spec_nbytes)
