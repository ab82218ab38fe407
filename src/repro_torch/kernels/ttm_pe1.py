"""PE1 — two-index contraction over the last dims of both operands (paper
Eq. 5), with the FPGA PE's optional requantize-on-writeback epilogue:

    Z'(a, d) = sum_{b, c}  Z(a, b, c) * G(b, d, c)

The port of ``repro/kernels/ttm_pe1.py``. ``pe1_cuda`` launches the
hand-written kernel (``csrc/ttm_pe1.cu``: (b, c) walked in chunks, Z's rows
staged by cp.async, G's slice transposed into shared memory, an rm x 4
register tile per thread stored as float4); its launch plan is the pure
function ``plan``, which the CPU tests check where no kernel runs.
``pe1_torch`` is its plain version (einsum + the codec's ``epilogue``), the
CPU path and the kernel's oracle on the card. Both accumulate in f32 (f64
inputs stay f64 in the plain version) and return Z's dtype.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass

import torch

from ..numerics.codecs import Pow2Reference
from ..numerics.spec import QuantSpec
from . import build as B
from . import tt_contract

NAME = "pe1"
SOURCE = "ttm_pe1"
BK = 16                     # csrc/ttm_pe1.cu: c values per chunk
MAX_THREADS = 256
MAX_TD = 16                 # threads along d (4 columns each) per CTA
ZS_MAX = 32 << 10           # the Z region's shared memory at most
SMS = tt_contract.SMS

PLAN_FIELDS = ("a", "b", "c", "d", "rm", "td", "ta", "threads", "tiles_a",
               "tiles_d", "grid", "gz", "gg", "zs_bytes", "smem", "vec_out")


@dataclass(frozen=True)
class Plan:
    a: int
    b: int
    c: int
    d: int
    rm: int              # rows of a per thread (1, 2, 4 or 8)
    td: int              # threads along d, four columns each
    ta: int              # threads along a
    threads: int         # CTA size, a multiple of 32
    tiles_a: int
    tiles_d: int
    grid: int            # CTAs
    gz: int              # copy granule bytes of Z rows (16/8/4, or 2)
    gg: int              # and of G rows
    zs_bytes: int        # bytes of the Z region (16-aligned)
    smem: int            # dynamic shared memory bytes
    vec_out: int         # outputs stored 4 at a time

    @property
    def at(self) -> int:
        return self.rm * self.ta

    @property
    def dt(self) -> int:
        return 4 * self.td

    @functools.cached_property
    def fields(self) -> ctypes.Array:
        """The plan as the C side's ``int32[16]``."""
        return (ctypes.c_int * len(PLAN_FIELDS))(*astuple(self))


assert tuple(Plan.__dataclass_fields__) == PLAN_FIELDS


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def _granule(c: int, elsize: int, misalign: int) -> int:
    """Largest copy size (16, 8, 4 bytes; 2 for a plain bf16 load) that
    divides a row of c elements, a chunk of BK and the pointer's
    alignment."""
    for g in (16, 8, 4, 2):
        if g >= elsize and (c * elsize) % g == 0 and \
                (BK * elsize) % g == 0 and misalign % g == 0:
            return g
    return elsize


@functools.lru_cache(maxsize=512)
def plan(a: int, b: int, c: int, d: int, elsize: int, z_misalign: int = 0,
         g_misalign: int = 0) -> Plan:
    """The launch plan of ``Y(a,d) = sum_{b,c} Z(a,b,c) G(b,d,c)``;
    ``elsize`` is 4 (f32) or 2 (bf16), ``*_misalign`` the operands'
    addresses mod 16. Tiles of up to 64 columns of d (wider tiles ran
    slower on the H100 at the step's shapes) by up to 16 x rm rows of a,
    rm the largest that still gives CTAs for 7/8 of the SMs."""
    if min(a, b, c, d) < 0 or elsize not in (2, 4):
        raise ValueError(f"bad contraction {(a, b, c, d)} elsize {elsize}")
    td = max(1, min(_cdiv(d, 4), MAX_TD))
    ta = max(1, MAX_THREADS // td)
    tiles_d = _cdiv(d, 4 * td)
    rm = 1
    for r in (8, 4, 2):
        if r * ta * BK * elsize <= ZS_MAX and \
                8 * _cdiv(a, r * ta) * tiles_d >= 7 * SMS:
            rm = r
            break
    # a tile no taller than a needs: fewer idle rows where a is small
    while ta > 1 and rm * (ta // 2) >= a:
        ta //= 2
    threads = _cdiv(td * ta, 32) * 32
    tiles_a = _cdiv(a, rm * ta)
    zs_bytes = _cdiv(rm * ta * BK * elsize, 16) * 16
    return Plan(a, b, c, d, rm, td, ta, threads, tiles_a, tiles_d,
                tiles_a * tiles_d,
                _granule(c, elsize, z_misalign),
                _granule(c, elsize, g_misalign), zs_bytes,
                zs_bytes + BK * 4 * td * 4, int(d % 4 == 0))


def _shapes(z: torch.Tensor, g: torch.Tensor) -> tuple[int, int, int, int]:
    if z.dim() != 3 or g.dim() != 3 or z.shape[1] != g.shape[0] \
            or z.shape[2] != g.shape[2]:
        raise ValueError(f"{NAME}: want Z (a,b,c) and G (b,d,c), got "
                         f"{tuple(z.shape)} and {tuple(g.shape)}")
    a, b, c = z.shape
    return a, b, c, g.shape[1]


def pe1_torch(z: torch.Tensor, g: torch.Tensor, step_log2=None,
              bits: int | None = None) -> torch.Tensor:
    _shapes(z, g)
    acc_t = torch.promote_types(z.dtype, torch.float32)
    acc = torch.einsum("abc,bdc->ad", z.to(acc_t), g.to(acc_t))
    if bits is not None:
        acc = Pow2Reference().epilogue(acc, QuantSpec("pow2", bits),
                                       step_log2)
    return acc.to(z.dtype)


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/ttm_pe1.cu``) with ``pe1`` given its C
    signature."""
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pe1.argtypes = [p, p, p, i, ctypes.POINTER(ctypes.c_int), i, p,
                            i, p]
        lib.pe1.restype = i
        lib._repro_typed = True
    return lib


def launch(z: torch.Tensor, g: torch.Tensor, out: torch.Tensor, step=None,
           bits: int | None = None, lib: ctypes.CDLL | None = None) -> Plan:
    """Launch ``csrc/ttm_pe1.cu``'s kernel (or ``lib``'s, a build of it
    elsewhere) on ``out``'s stream: ``z`` (a, b, c), ``g`` (b, d, c), ``out``
    (a, d), all contiguous, one dtype; ``bits`` turns on the requant
    epilogue at ``step``, a one-element f32 tensor on the card. Counts one
    launch of ``pe1``; returns the plan."""
    a, b, c, d = _shapes(z, g)
    p = plan(a, b, c, d, z.element_size(), z.data_ptr() % 16,
             g.data_ptr() % 16)
    lib = typed(lib or B.load(SOURCE))
    B.check(lib, lib.pe1(
        z.data_ptr(), g.data_ptr(), out.data_ptr(),
        tt_contract.DTYPE_CODE[z.dtype], p.fields, int(bits is not None),
        None if step is None else step.data_ptr(), bits or 0,
        torch.cuda.current_stream(z.device).cuda_stream), NAME)
    B.note_launch(NAME)
    return p


def pe1_cuda(z: torch.Tensor, g: torch.Tensor, step_log2=None,
             bits: int | None = None) -> torch.Tensor:
    """Launch the kernel (``csrc/ttm_pe1.cu``) on Z's stream; counts one
    launch of ``pe1``."""
    a, b, c, d = _shapes(z, g)
    tt_contract.check_operands(NAME, z, g)
    if bits is not None and not 2 <= bits <= 16:
        raise ValueError(f"{NAME}: epilogue bits must be 2..16, got {bits}")
    z, g = z.contiguous(), g.contiguous()
    out = torch.empty((a, d), dtype=z.dtype, device=z.device)
    tt_contract.check_sizes(NAME, z, g, out)
    step = None if bits is None else torch.as_tensor(
        step_log2, dtype=torch.float32, device=z.device).reshape(1)
    launch(z, g, out, step, bits)
    return out
