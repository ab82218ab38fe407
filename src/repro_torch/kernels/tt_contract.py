"""Launch plans and the ctypes launch shared by the PE2 and PE3 kernels
(``csrc/ttm_pe2.cu``, ``csrc/ttm_pe3.cu``, both on ``csrc/tt_contract.cuh``):
the streamed contraction ``O(a, d, c) = sum_b Z(a, b, c) G(b, d)``, PE3
being it at ``a = 1``; a grouped call (the experts of an MoE layer: Z (E,
a, b, c), G (E, b, d), O (E, a, d, c)) is the same plan for each group,
the group the grid's second coordinate.

``plan`` is a pure function of the shapes, the element size and the
operands' alignment, so the CPU tests can check it (every output covered
once, shared memory within the card's limit, the grid filling the SMs)
where no kernel can run. A CTA owns ``spc`` slabs and one tile of
``dg * rd`` rows of d by ``cg * 4`` columns of c; ``split`` threads share a
tile over b. ``check_operands`` and ``DTYPE_CODE`` serve PE1's wrapper
too. The libraries are built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass

import torch

from . import build as B
from . import tt_mma

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132                   # H100 SXM streaming multiprocessors
MAX_THREADS = 256           # tt_contract::kMaxThreads
MIN_THREADS = 128           # split b until a CTA has this many threads ...
MIN_ROWS = 2                # ... while each share keeps this many b rows
MAX_STAGES = 4              # tt_contract::kMaxStages ring slots
RING_BYTES = 48 << 10       # the stages' shared memory at most
SMEM_MAX = 232_448          # tt_contract::kMaxSmem (227 KB)
INT32_MAX = 2 ** 31 - 1

PLAN_FIELDS = ("a", "b", "c", "d", "rd", "cg", "dg", "spc", "split",
               "threads", "bc", "stages", "gz", "gg", "zp", "gp", "z_stage",
               "stage", "smem", "tiles_c", "tiles_d", "grid", "vec_out")


@dataclass(frozen=True)
class Plan:
    a: int
    b: int
    c: int
    d: int
    rd: int              # d rows per thread (1, 2 or 4)
    cg: int              # c groups of 4 per tile
    dg: int              # d groups of rd per tile
    spc: int             # slabs per CTA, side by side
    split: int           # threads sharing a tile over b
    threads: int         # CTA size, a multiple of 32
    bc: int              # b rows per chunk
    stages: int          # 1 (all of b), or ring slots of b-chunks, 2..4
    gz: int              # copy granule bytes of Z rows (16/8/4, or 2: plain)
    gg: int              # and of G rows
    zp: int              # shared-memory row pitch of Z, elements
    gp: int              # and of G (rows over 16 bytes padded by 16)
    z_stage: int         # bytes of a slot's Z region
    stage: int           # bytes of a slot
    smem: int            # dynamic shared memory bytes
    tiles_c: int
    tiles_d: int
    grid: int            # CTAs
    vec_out: int         # outputs stored 4 at a time

    @property
    def ct(self) -> int:
        return 4 * self.cg

    @property
    def dt(self) -> int:
        return self.rd * self.dg

    @property
    def runs(self) -> int:
        return -(-self.a // self.spc)

    @functools.cached_property
    def fields(self) -> ctypes.Array:
        """The plan as the C side's ``int32[23]``."""
        return (ctypes.c_int * len(PLAN_FIELDS))(*astuple(self))


assert tuple(Plan.__dataclass_fields__) == PLAN_FIELDS


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def _even(n: int, width: int) -> int:
    """Tile width that cuts n into as many equal tiles as ``width`` does."""
    return _cdiv(n, _cdiv(n, width))


def _round16(n: int) -> int:
    return _cdiv(n, 16) * 16


def _granule(row: int, tile: int, elsize: int, misalign: int) -> int:
    """Largest cp.async size (16, 8 or 4 bytes) that divides a tensor row, a
    tile row and the pointer's alignment; ``elsize`` (a plain copy) if none
    does."""
    for g in (16, 8, 4):
        if g >= elsize and (row * elsize) % g == 0 and \
                (tile * elsize) % g == 0 and misalign % g == 0:
            return g
    return elsize


@functools.lru_cache(maxsize=512)
def plan(a: int, b: int, c: int, d: int, elsize: int, z_misalign: int = 0,
         g_misalign: int = 0, groups: int = 1) -> Plan:
    """The launch plan of ``O(a,d,c) = sum_b Z(a,b,c) G(b,d)`` for each of
    ``groups`` groups; ``elsize`` is 4 (f32) or 2 (bf16), ``*_misalign``
    the operands' addresses mod 16. The tiles fill the SMs over all the
    groups; ``grid`` is the CTAs of one group."""
    if min(a, b, c, d) < 0 or elsize not in (2, 4) or groups < 1:
        raise ValueError(f"bad contraction {(a, b, c, d)} elsize {elsize} "
                         f"groups {groups}")
    z_misalign = tt_mma.group_misalign(z_misalign, a * b * c * elsize, groups)
    g_misalign = tt_mma.group_misalign(g_misalign, b * d * elsize, groups)
    rd = 1 if d == 1 else 2 if d == 2 else 4
    cgs, dgs = _cdiv(c, 4), _cdiv(d, rd)
    if a == 0 or cgs == 0 or dgs == 0:
        return Plan(a, b, c, d, rd, 1, 1, 1, 1, 32, 1, 1, elsize, elsize,
                    4, rd, 0, 0, 0, 0, 0, 0, 0)
    # widest tiles first (up to 128 columns and 256 threads), narrowed
    # until the grid has a wave of CTAs or the tiles are one group wide
    cg = _even(cgs, 32)
    dg = _even(dgs, MAX_THREADS // cg)

    def units() -> int:
        return groups * a * _cdiv(cgs, cg) * _cdiv(dgs, dg)
    while units() < SMS:
        if cg > 2:
            cg = _even(cgs, _cdiv(cg, 2))
        elif dg > 1:
            dg = _even(dgs, _cdiv(dg, 2))
        elif cg > 1:
            cg = 1
        else:
            break
    # slabs per CTA: the fewest slab-tiles on the busiest SM (CTAs are
    # alike, so ceil(grid / SMS) * spc), then a full wave, then fewer CTAs
    tile_threads, tiles = cg * dg, units() // a

    def cost(n: int) -> tuple:
        grid = _cdiv(a, n) * tiles
        return _cdiv(grid, SMS) * n, grid < min(SMS, units()), -n
    spc = min(range(1, min(MAX_THREADS // tile_threads, a) + 1), key=cost)
    split = 1
    while (tile_threads * spc * split < MIN_THREADS
           and tile_threads * spc * split * 2 <= MAX_THREADS
           and b >= 2 * split * MIN_ROWS):
        split *= 2
    return _layout(a, b, c, d, elsize, rd, cg, dg, spc, split, z_misalign,
                   g_misalign)


def _layout(a: int, b: int, c: int, d: int, elsize: int, rd: int, cg: int,
            dg: int, spc: int, split: int, z_misalign: int = 0,
            g_misalign: int = 0) -> Plan:
    """The rest of a plan once its tiling is chosen: CTA size, the b-chunks
    and ring slots, copy granules, shared memory, grid and reduction."""
    threads = _cdiv(cg * dg * spc * split, 32) * 32
    ct, dt = 4 * cg, rd * dg
    gz = _granule(c, ct, elsize, z_misalign)
    gg = _granule(d, dt, elsize, g_misalign)
    # with a b-split, shared rows longer than 16 bytes are padded by 16, so
    # a tile's shares (neighbouring lanes, neighbouring rows) read distinct
    # banks
    pad = 16 // elsize if split > 1 else 0
    zp = ct + (pad if ct * elsize > 16 else 0)
    gp = dt + (pad if dt * elsize > 16 else 0)
    # all of b in one stage where it fits RING_BYTES; else b-chunks (whole
    # rounds of the split) through a ring of MAX_STAGES slots
    per_row = (spc * zp + gp) * elsize
    if b * per_row <= RING_BYTES:
        bc, stages = max(b, 1), 1
    else:
        bc = max(split, RING_BYTES // per_row // MAX_STAGES // split * split)
        stages = min(MAX_STAGES, _cdiv(b, bc))
    z_stage = _round16(spc * bc * zp * elsize)
    stage = z_stage + _round16(bc * gp * elsize)
    # a split over 32 shares adds each warp's sums through shared memory
    red = (split // 32) * cg * dg * spc * rd * 4 * 4 if split > 32 else 0
    tiles_c, tiles_d = _cdiv(_cdiv(c, 4), cg), _cdiv(_cdiv(d, rd), dg)
    return Plan(a, b, c, d, rd, cg, dg, spc, split, threads, bc, stages, gz,
                gg, zp, gp, z_stage, stage, max(stages * stage, red), tiles_c,
                tiles_d, _cdiv(a, spc) * tiles_c * tiles_d, int(c % 4 == 0))


def check_operands(name: str, *ts: torch.Tensor) -> None:
    """Raise on what the kernels do not take: operands off the card, on
    two devices, of two dtypes, or of a dtype other than f32/bf16."""
    dev, dt = ts[0].device, ts[0].dtype
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name}: all operands must be on one CUDA device")
    if any(t.dtype != dt for t in ts) or dt not in DTYPE_CODE:
        raise TypeError(f"{name}: operands must share one dtype of "
                        f"{sorted(map(str, DTYPE_CODE))}, got "
                        f"{[str(t.dtype) for t in ts]}")


def check_sizes(name: str, *ts: torch.Tensor) -> None:
    """The kernels index in 32 bits: refuse tensors of 2^31 elements."""
    if any(t.numel() > INT32_MAX for t in ts):
        raise ValueError(f"{name}: tensors of 2^31 or more elements are "
                         "not taken (32-bit indices)")


def typed(lib: ctypes.CDLL, entry: str) -> ctypes.CDLL:
    """``lib`` with its entry ``entry`` given its C signature."""
    if not getattr(lib, "_repro_typed", False):
        p = ctypes.c_void_p
        fn = getattr(lib, entry)
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def launch(name: str, source: str, z: torch.Tensor, g: torch.Tensor,
           out: torch.Tensor, lib: ctypes.CDLL | None = None) -> Plan:
    """Launch ``csrc/<source>.cu``'s entry ``name`` (or ``lib``'s, a build
    of it elsewhere) on ``out``'s stream: ``z`` ([E,] a, b, c), ``g``
    ([E,] b, d), ``out`` ([E,] a, d, c), all contiguous, one dtype. Counts
    one launch of ``name`` (``tt_mma.counted``); returns the plan."""
    e = z.shape[0] if z.dim() == 4 else 1
    a, b, c = z.shape[-3:]
    es = z.element_size()
    p = plan(a, b, c, g.shape[-1], es, z.data_ptr() % 16, g.data_ptr() % 16,
             e)
    lib = typed(lib or B.load(source), name)
    B.check(lib, getattr(lib, name)(
        z.data_ptr(), g.data_ptr(), out.data_ptr(), DTYPE_CODE[z.dtype],
        p.fields, e, torch.cuda.current_stream(z.device).cuda_stream), name)
    B.note_launch(tt_mma.counted(name, z))
    return p
