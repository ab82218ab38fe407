"""Public kernel entry points — the port of ``repro/kernels/ops.py`` as far
as the serving slice goes.

``impl`` names what runs, and the tensors' device decides nothing behind
the caller's back:

- ``"cuda"`` (default): on CUDA tensors the hand-written kernel launches
  (or the call raises); CPU tensors run the kernel's plain PyTorch version.
- ``"torch"``: the plain version, CPU tensors only.

There is no fallback from a failed launch to the plain version. Launch
counts live in ``kernels.build.LAUNCHES``.
"""
from __future__ import annotations

import torch

from . import paged_attention as PA


def paged_attention(q: torch.Tensor, kdata: torch.Tensor,
                    vdata: torch.Tensor, kscale: torch.Tensor,
                    vscale: torch.Tensor, table: torch.Tensor,
                    lens: torch.Tensor, *, page_size: int, quantized: bool,
                    impl: str = "cuda") -> torch.Tensor:
    """Fused paged attention (per-page dequant + online softmax over each
    slot's page list). q is (B, Hq, Dh) for decode or (B, S, Hq, Dh) for a
    q-block; ``lens`` is the position of the first query row. Layouts in
    ``kernels/paged_attention.py``."""
    args = (q, kdata, vdata, kscale, vscale, table, lens)
    kw = dict(page_size=page_size, quantized=quantized)
    if impl == "torch":
        if any(t.is_cuda for t in args):
            raise ValueError("paged_attention impl='torch' takes CPU tensors "
                             "only; CUDA tensors go to impl='cuda'")
        return PA.paged_attention_torch(*args, **kw)
    if impl == "cuda":
        if q.is_cuda:
            return PA.paged_attention_cuda(*args, **kw)
        return PA.paged_attention_torch(*args, **kw)
    raise ValueError(f"unknown paged_attention impl {impl!r}")
