"""PE1 — two-index contraction over the last dims of both operands (paper
Eq. 5), with the FPGA PE's optional requantize-on-writeback epilogue:

    Z'(a, d) = sum_{b, c}  Z(a, b, c) * G(b, d, c)

The port of ``repro/kernels/ttm_pe1.py``. ``pe1_cuda`` launches one of the
two hand-written kernels of ``csrc/ttm_pe1.cu``, by the route the pure
function ``plan_pe1`` gives for the dtype, shapes and alignment:

- ``pe1_mma_kernel``, wgmma on the tensor cores, for bf16 with b = 1 (the
  chain's Eq. 8 form: a plain GEMM, M = a, N = d, K = c), even c at most
  64, d a multiple of 8 and operands on 4-byte boundaries: every call of
  the LM step and of the frontends' steps. Persistent CTAs walk tiles that
  span all of d, G stays in shared memory, Z streams through a TMA ring
  (or, for rows of c that are not 16-byte multiples, or operands off 16
  bytes, a ring of cp.async granules of 8 or 4 bytes: ``MmaPlan.gran``),
  and each tile leaves through TMA tensor stores from a double-buffered
  staging tile (``MmaPlan``).
- ``pe1_kernel``, FMA on the CUDA cores, for everything else (the MLP's f32
  calls): (b, c) walked in chunks, Z's rows staged by cp.async, G's slice
  transposed into shared memory, an rm x 4 register tile per thread stored
  as float4; its launch plan is the pure function ``plan``.

Both count as ``pe1`` launches and both carry the epilogue, and both take
a leading group axis (the experts of an MoE layer): Z (E, a, b, c) and G
(E, b, d, c) give Y (E, a, d) in one launch, the group the grid's second
coordinate (``groups``; each group's operands are its own tensors, the
TMA's maps carry the group as their outermost dimension, so a box never
reads the next group's rows). The CPU tests check both plans where no
kernel runs. ``pe1_torch`` is the plain version
(einsum + the codec's ``epilogue``), the CPU path and the kernels' oracle on
the card. All accumulate in f32 (f64 inputs stay f64 in the plain version)
and return Z's dtype.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass

import torch

from ..numerics.codecs import Pow2Reference
from ..numerics.spec import QuantSpec
from . import build as B
from . import tt_contract, tt_mma

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
         g_misalign: int = 0, groups: int = 1) -> Plan:
    """The launch plan of ``Y(a,d) = sum_{b,c} Z(a,b,c) G(b,d,c)`` for
    each of ``groups`` groups; ``elsize`` is 4 (f32) or 2 (bf16),
    ``*_misalign`` the operands' addresses mod 16. Tiles of up to 64
    columns of d (wider tiles ran slower on the H100 at the step's shapes)
    by up to 16 x rm rows of a, rm the largest that still gives CTAs for
    7/8 of the SMs over all groups; ``grid`` is the CTAs of one group."""
    if min(a, b, c, d) < 0 or elsize not in (2, 4) or groups < 1:
        raise ValueError(f"bad contraction {(a, b, c, d)} elsize {elsize} "
                         f"groups {groups}")
    z_misalign = tt_mma.group_misalign(z_misalign, a * b * c * elsize, groups)
    g_misalign = tt_mma.group_misalign(g_misalign, b * d * c * elsize, groups)
    td = max(1, min(_cdiv(d, 4), MAX_TD))
    ta = max(1, MAX_THREADS // td)
    tiles_d = _cdiv(d, 4 * td)
    rm = 1
    for r in (8, 4, 2):
        if r * ta * BK * elsize <= ZS_MAX and \
                8 * _cdiv(a, r * ta) * tiles_d * groups >= 7 * SMS:
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


# ---------------------------------------------------------------------------
# the tensor-core route (bf16, b = 1)
# ---------------------------------------------------------------------------

MMA_THREADS = 2 * 128 + 32    # two consumer warpgroups and the producer warp
MMA_STAGES = 8                # Z ring slots at most
OUT_BUFS = 2                  # staging tiles per warpgroup (1 where 2 do not fit)
OUT_BOX = 64                  # columns of the output's TMA box (128 bytes)
MAX_C = 64                    # K within one 128-byte swizzle row

MMA_FIELDS = ("a", "c", "d", "wgn", "sw", "ksteps", "wm", "wn", "tiles_m",
              "tiles_n", "tiles", "grid", "threads", "stages", "nbuf",
              "stage", "g_bytes", "out_bytes", "smem", "gran")


@dataclass(frozen=True)
class MmaPlan:
    a: int
    c: int
    d: int
    wgn: int             # columns of d per warpgroup (the template): 64-256
    sw: int              # bytes of a row of Z and G in shared memory and
    #                      their swizzle (the template): 32, 64, 128
    ksteps: int          # wgmma k-steps of 16 (c zero-filled to 16 ksteps)
    wm: int              # consumer warpgroups along a
    wn: int              # and along d
    tiles_m: int
    tiles_n: int
    tiles: int
    grid: int            # CTAs (persistent) of one group
    threads: int
    stages: int          # Z ring slots
    nbuf: int            # staging tiles per warpgroup
    stage: int           # bytes of a ring slot: bm rows of sw bytes
    g_bytes: int         # bytes of resident G: tiles_n * bn rows of sw
    out_bytes: int       # bytes of a staging tile: 64 rows of wgn bf16
    smem: int            # dynamic shared memory bytes
    gran: int = 0        # Z's and G's cp.async granule bytes (8, 4), 0: TMA

    @property
    def bm(self) -> int:
        return 64 * self.wm

    @property
    def bn(self) -> int:
        return self.wgn * self.wn

    @functools.cached_property
    def fields(self) -> ctypes.Array:
        """The plan as the C side's ``int32[20]``."""
        return (ctypes.c_int * len(MMA_FIELDS))(*astuple(self))


assert tuple(MmaPlan.__dataclass_fields__) == MMA_FIELDS


@functools.lru_cache(maxsize=512)
def plan_pe1(a: int, b: int, c: int, d: int, elsize: int,
             z_misalign: int = 0, g_misalign: int = 0,
             groups: int = 1) -> MmaPlan | None:
    """The tensor-core plan of ``Y(a,d) = sum_{b,c} Z(a,b,c) G(b,d,c)``, or
    ``None`` for the FMA route (``plan``). ``elsize`` is 2 (bf16) or 4
    (f32), ``*_misalign`` the operands' addresses mod 16. A tile spans all
    of d up to 512 columns (two warpgroups of up to 256 along a, or two of
    256 along d past 256), G is resident, the ring as deep as shared memory
    allows up to ``MMA_STAGES``. Rows of c the TMA cannot take (c not a
    multiple of 8, or an operand off 16 bytes) are staged by cp.async
    granules (``gran``: 8 or 4 bytes, whatever divides the rows and both
    offsets) into the same swizzled rows; 2-byte offsets and odd c stay on
    the CUDA cores, and so does d off a multiple of 8 (Y's TMA stores).
    ``groups`` > 1: the groups' operands follow one another, each group's
    start shares the granule (``tt_mma.group_misalign``), ``grid`` is
    ``tt_mma.group_grid``'s."""
    if elsize != 2 or b != 1 or min(a, c, d) < 1 or c % 2 or d % 8 \
            or c > MAX_C:
        return None
    z_misalign = tt_mma.group_misalign(z_misalign, a * c * 2, groups)
    g_misalign = tt_mma.group_misalign(g_misalign, d * c * 2, groups)
    gran = 0
    if c % 8 or z_misalign % 16 or g_misalign % 16:
        gran = tt_mma.granule(2 * c, z_misalign | g_misalign)
        if not gran:
            return None
    ksteps = _cdiv(c, 16)
    sw = next(w for w in (32, 64, 128) if w >= 32 * ksteps)
    wgn = next(n for n in (64, 128, 256) if n >= min(d, 256))
    wn = 2 if d > wgn else 1
    wm = 2 // wn
    bm, bn = 64 * wm, wgn * wn
    tiles_m, tiles_n = _cdiv(a, bm), _cdiv(d, bn)
    stage, g_bytes, out_bytes = bm * sw, tiles_n * bn * sw, 64 * wgn * 2

    def smem_for(stages: int, nbuf: int) -> int:
        return tt_mma.ALIGN + g_bytes + stages * stage \
            + wm * wn * nbuf * out_bytes + 16 * stages + 8

    fits = [n for n in range(OUT_BUFS, 0, -1)
            if smem_for(2, n) <= tt_mma.SMEM_MAX]
    if not fits:
        return None
    nbuf = fits[0]
    stages = 2
    while stages < MMA_STAGES and \
            smem_for(stages + 1, nbuf) <= tt_mma.SMEM_MAX:
        stages += 1
    tiles = tiles_m * tiles_n
    return MmaPlan(a, c, d, wgn, sw, ksteps, wm, wn, tiles_m, tiles_n, tiles,
                   tt_mma.group_grid(tiles, groups), wm * wn * 128 + 32,
                   stages, nbuf, stage, g_bytes, out_bytes,
                   smem_for(stages, nbuf), gran)


def plan_pe1_for(z: torch.Tensor, g: torch.Tensor) -> MmaPlan | None:
    """The tensor-core plan of contiguous operands ``z`` ([E,] a, b, c),
    ``g`` ([E,] b, d, c), or ``None``."""
    e, a, b, c, d = _shapes(z, g)
    return plan_pe1(a, b, c, d, z.element_size(), z.data_ptr() % 16,
                    g.data_ptr() % 16, e)


def _shapes(z: torch.Tensor, g: torch.Tensor
            ) -> tuple[int, int, int, int, int]:
    """(groups, a, b, c, d) of Z (a, b, c) and G (b, d, c), or of the
    grouped Z (E, a, b, c) and G (E, b, d, c) (groups 1 ungrouped)."""
    lead = z.dim() - 3
    if lead not in (0, 1) or g.dim() != z.dim() \
            or z.shape[:lead] != g.shape[:lead] \
            or z.shape[-2] != g.shape[-3] or z.shape[-1] != g.shape[-1]:
        raise ValueError(f"{NAME}: want Z ([E,] a,b,c) and G ([E,] b,d,c), "
                         f"got {tuple(z.shape)} and {tuple(g.shape)}")
    a, b, c = z.shape[-3:]
    return (z.shape[0] if lead else 1), a, b, c, g.shape[-2]


def pe1_torch(z: torch.Tensor, g: torch.Tensor, step_log2=None,
              bits: int | None = None) -> torch.Tensor:
    _shapes(z, g)
    acc_t = torch.promote_types(z.dtype, torch.float32)
    acc = torch.einsum("...abc,...bdc->...ad", z.to(acc_t), g.to(acc_t))
    if bits is not None:
        acc = Pow2Reference().epilogue(acc, QuantSpec("pow2", bits),
                                       step_log2)
    return acc.to(z.dtype)


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/ttm_pe1.cu``) with ``pe1`` and ``pe1_mma``
    given their C signatures."""
    if not getattr(lib, "_repro_typed", False):
        p, i, fields = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(
            ctypes.c_int)
        lib.pe1.argtypes = [p, p, p, i, fields, i, p, i, i, p]
        lib.pe1_mma.argtypes = [p, p, p, fields, i, p, i, i, p]
        lib.pe1.restype = lib.pe1_mma.restype = i
        lib._repro_typed = True
    return lib


def launch(z: torch.Tensor, g: torch.Tensor, out: torch.Tensor, step=None,
           bits: int | None = None, lib: ctypes.CDLL | None = None) -> Plan:
    """Launch ``csrc/ttm_pe1.cu``'s CUDA-core kernel (or ``lib``'s, a
    build of it elsewhere) on ``out``'s stream, whatever route
    ``plan_pe1`` gives: ``z`` ([E,] a, b, c), ``g`` ([E,] b, d, c),
    ``out`` ([E,] a, d), all contiguous, one dtype; ``bits`` turns on the
    requant epilogue at ``step``, a one-element f32 tensor on the card.
    Counts one launch of ``pe1`` (``pe1_grouped`` grouped); returns the
    plan."""
    e, a, b, c, d = _shapes(z, g)
    p = plan(a, b, c, d, z.element_size(), z.data_ptr() % 16,
             g.data_ptr() % 16, e)
    lib = typed(lib or B.load(SOURCE))
    B.check(lib, lib.pe1(
        z.data_ptr(), g.data_ptr(), out.data_ptr(),
        tt_contract.DTYPE_CODE[z.dtype], p.fields, int(bits is not None),
        None if step is None else step.data_ptr(), bits or 0, e,
        torch.cuda.current_stream(z.device).cuda_stream), NAME)
    B.note_launch(tt_mma.counted(NAME, z))
    return p


def launch_mma(p: MmaPlan, z: torch.Tensor, g: torch.Tensor,
               out: torch.Tensor, step=None,
               bits: int | None = None) -> MmaPlan:
    """Launch ``csrc/ttm_pe1.cu``'s tensor-core kernel on ``out``'s stream
    under ``p`` (``plan_pe1_for(z, g)``): ``z`` ([E,] a, 1, c), ``g``
    ([E,] 1, d, c), ``out`` ([E,] a, d), contiguous bf16; the epilogue as
    ``launch``'s. Counts one launch of ``pe1`` (``pe1_grouped``
    grouped)."""
    if out.data_ptr() % 16:
        raise ValueError(f"{NAME}: output not 16-byte aligned")
    lib = typed(B.load(SOURCE))
    B.check(lib, lib.pe1_mma(
        z.data_ptr(), g.data_ptr(), out.data_ptr(), p.fields,
        int(bits is not None), None if step is None else step.data_ptr(),
        bits or 0, _shapes(z, g)[0],
        torch.cuda.current_stream(z.device).cuda_stream), "pe1_mma")
    B.note_launch(tt_mma.counted(NAME, z))
    return p


def pe1_cuda(z: torch.Tensor, g: torch.Tensor, step_log2=None,
             bits: int | None = None) -> torch.Tensor:
    """Launch one of the kernels of ``csrc/ttm_pe1.cu`` on Z's stream, by
    the route ``plan_pe1`` gives (a grouped call in one launch); counts one
    launch of ``pe1``."""
    _, a, b, c, d = _shapes(z, g)
    tt_contract.check_operands(NAME, z, g)
    if bits is not None and not 2 <= bits <= 16:
        raise ValueError(f"{NAME}: epilogue bits must be 2..16, got {bits}")
    z, g = z.contiguous(), g.contiguous()
    out = torch.empty(z.shape[:-3] + (a, d), dtype=z.dtype, device=z.device)
    tt_contract.check_sizes(NAME, z, g, out)
    step = None if bits is None else torch.as_tensor(
        step_log2, dtype=torch.float32, device=z.device).reshape(1)
    p = plan_pe1_for(z, g)
    if p is None:
        launch(z, g, out, step, bits)
    else:
        launch_mma(p, z, g, out, step, bits)
    return out
