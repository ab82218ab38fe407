"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their ctypes
wrappers and plain PyTorch twins. Nothing is compiled at import: each
library is built by ``build.load`` at its first launch."""
