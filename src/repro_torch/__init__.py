"""repro_torch — the PyTorch/CUDA port of ``repro``, slice by slice.

The JAX package ``repro`` stays the reference; this package imports
nothing of it (nor ``jax``). Its layout mirrors ``repro``'s (``configs``,
``numerics``, ``kernels``, ``models``, ``serve``), and every Pallas kernel
on a ported path has a hand-written CUDA kernel under ``kernels/csrc``
with a plain PyTorch twin beside its wrapper.

Entry points (``Engine``, ``init_lm``, the kernel wrappers) run on the
card: their ``device`` defaults to ``"cuda"`` and they raise when no card
is present unless the caller asks for ``device="cpu"`` (see
``device.resolve_device``).
"""
from .device import resolve_device  # noqa: F401
