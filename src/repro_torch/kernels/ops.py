"""Public kernel entry points — the port of ``repro/kernels/ops.py`` as far
as the serving and training slices go: paged attention, the paged KV
append, the whole-prompt prefill's paged write, the paged read, the
PE1/PE2/PE3 contractions, the fused pow-2 fake-quant, and the TTM chain
through the PE kernels.

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

from . import kv_append, kv_prefill, kv_read
from . import paged_attention as PA
from . import ttm_pe1, ttm_pe2, ttm_pe3


def _route(name: str, impl: str, tensors, cuda_fn, torch_fn):
    """``impl="cuda"``: the kernel on CUDA tensors, its plain version on CPU
    tensors; ``impl="torch"``: the plain version, CPU tensors only."""
    on_card = any(t.is_cuda for t in tensors)
    if impl == "torch":
        if on_card:
            raise ValueError(f"{name} impl='torch' takes CPU tensors only; "
                             "CUDA tensors go to impl='cuda'")
        return torch_fn
    if impl == "cuda":
        return cuda_fn if on_card else torch_fn
    raise ValueError(f"unknown {name} impl {impl!r}")


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


def append_paged(kdata: torch.Tensor, vdata: torch.Tensor,
                 kscale: torch.Tensor, vscale: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, table: torch.Tensor, lens: torch.Tensor,
                 active, *, page_size: int, bits: int, n_valid=None,
                 clamp_last: bool = False, health=None, impl: str = "cuda"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """S tokens per slot (S = 1: the decode append; S > 1: a chunk), K and
    V of one layer, encoded under each slot's pow-2 scale into the
    quantized pool's pages in place (inactive slots and rows at or past
    ``n_valid`` to the trash page; ``clamp_last`` picks the rule for a row
    past the slot's last page); ``health`` (a (2,) int64 tensor) gets the
    rows' (clipped, total) added. Layouts in ``kernels/kv_append.py``."""
    fn = _route("append_paged", impl, (kdata, vdata, k, v),
                kv_append.append_paged_cuda, kv_append.append_paged_torch)
    return fn(kdata, vdata, kscale, vscale, k, v, table, lens, active,
              page_size=page_size, bits=bits, n_valid=n_valid,
              clamp_last=clamp_last, health=health)


def prefill_paged(kdata: torch.Tensor, vdata: torch.Tensor,
                  kscale: torch.Tensor, vscale: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, table_row: torch.Tensor,
                  slot: int, length, *, page_size: int, bits: int,
                  impl: str = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """A whole-prompt prefill's K and V (L, S, *feat), every layer, into
    one slot's pages of the quantized pools (L, P+1, page, *feat) in place,
    each (tensor, layer) scale chosen from the first ``length`` rows and
    written to column ``slot`` of the (L, num_slots) scales; rows at or past
    ``length`` to the trash page. Layouts in ``kernels/kv_prefill.py``."""
    fn = _route("prefill_paged", impl, (kdata, vdata, k, v),
                kv_prefill.prefill_paged_cuda, kv_prefill.prefill_paged_torch)
    return fn(kdata, vdata, kscale, vscale, k, v, table_row, slot, length,
              page_size=page_size, bits=bits)


def read_paged(kdata: torch.Tensor, vdata: torch.Tensor,
               kscale: torch.Tensor, vscale: torch.Tensor,
               table: torch.Tensor, *, dtype: torch.dtype,
               impl: str = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Every slot's (B, pages_per_slot * page_size, *feat) view of K and V
    of one layer, decoded from the quantized pool's pages under each slot's
    pow-2 scale into ``dtype``. Layouts in ``kernels/kv_read.py``."""
    fn = _route("read_paged", impl, (kdata, vdata),
                kv_read.read_paged_cuda, kv_read.read_paged_torch)
    return fn(kdata, vdata, kscale, vscale, table, dtype=dtype)


def pe1(z: torch.Tensor, g: torch.Tensor, step_log2=None,
        bits: int | None = None, impl: str = "cuda") -> torch.Tensor:
    """PE1 (Eq. 5): Z(a,b,c) x G(b,d,c) -> (a,d), optional fused requantize
    (``bits`` selects the pow-2 grid at ``step_log2``; the plain version's
    epilogue is the codec registry's, the kernel's is held to it bit for
    bit)."""
    step = 0.0 if step_log2 is None else step_log2
    fn = _route("pe1", impl, (z, g), ttm_pe1.pe1_cuda, ttm_pe1.pe1_torch)
    return fn(z, g, step, bits)


def pe2(z: torch.Tensor, g: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    """PE2 (Eq. 6): Z(a,b,c) x G(b,d) -> (a,d,c)."""
    return _route("pe2", impl, (z, g), ttm_pe2.pe2_cuda,
                  ttm_pe2.pe2_torch)(z, g)


def pe3(ybar: torch.Tensor, x: torch.Tensor,
        impl: str = "cuda") -> torch.Tensor:
    """PE3: Ybar(b,j) x X(b,i) -> What(j,i) (batch-contracted outer
    product)."""
    return _route("pe3", impl, (ybar, x), ttm_pe3.pe3_cuda,
                  ttm_pe3.pe3_torch)(ybar, x)


def quantize_fused(x: torch.Tensor, step_log2, bits: int,
                   impl: str = "cuda") -> torch.Tensor:
    """Fused pow-2 quantize-dequantize over an arbitrary-shape tensor with
    one ``step_log2`` (no gradient rule; ``numerics.fake_quant`` adds the
    clipped STE)."""
    from ..numerics import cuda_backend as CB
    return _route("quantize_fused", impl, (x,), CB.fake_quant_scalar,
                  CB.fake_quant_plain)(x, step_log2, bits)


def ttm_matvec_kernels(cores, x, spec, impl: str = "cuda"):
    """TTM forward chain routed through the PE kernels (kernel-path analogue
    of ``core.ttm.ttm_matvec``)."""
    from ..core.ttm import ttm_matvec_pe
    return ttm_matvec_pe(cores, x, spec,
                         pe1=lambda z, g: pe1(z, g, impl=impl),
                         pe2=lambda z, g: pe2(z, g, impl=impl))
