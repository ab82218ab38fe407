"""Launch plan and ctypes launch of the PE2/PE3 tensor-core route
(``csrc/tt_mma.cuh``, in ``csrc/ttm_pe2.cu`` as ``pe2_mma_kernel`` and in
``csrc/ttm_pe3.cu`` as ``pe3_mma_kernel``): ``O(a, d, c) = sum_b Z(a, b, c)
G(b, d)`` in bf16 on wgmma, each output tile the product ``A^T B`` with
M = d, N = c and K = b, A a tile of G and B a tile of Z, both MN-major.

``plan`` is a pure function of the element size, the shapes and the two
operands' addresses mod 16: the same inputs always give the same route.
It returns ``None`` (the FMA route, ``tt_contract``) for every f32 call and
for bf16 calls it cannot tile. Rows of Z and G that are 16-byte multiples
on 16-byte aligned operands arrive by the TMA (its stride unit); rows of
even c or d that are not (the frontends' c = 20 / 28, d = 10 / 20), or
operands 4 or 8 bytes off 16, are staged by cp.async granules of 8 or 4
bytes (``gz``, ``gg``; ``granule``) into the same swizzled tiles: Z in the
stacked tiling only (c <= 32, d c a multiple of 8), G only where it is
resident and not under the 64 x 256 warpgroups. Odd rows, 2-byte offsets
and the rest stay on the FMA route. The calls the TMA takes keep the
plans they had before granules, field for field (``gz`` = ``gg`` = 0).
Every other bf16 call takes the tensor cores, in one of three tilings:

- ``stacked`` (c = 16 or 32): a tile is 64 / c whole slabs side by side
  (N = 64) by up to four warpgroups of 64 rows of d; B arrives as one 3-D
  TMA box (c, 64, slabs) under the 32- or 64-byte swizzle. On Z's
  granules, any even c <= 32: 64 // c slabs in 128-byte rows (the
  128-byte swizzle; c = 20: 60 of the 64 columns), a producer warpgroup.
- ``thin`` (d <= 64): one slab's 256 columns of c by 64 rows of d (d
  padded by the TMA's zero fill), two warpgroups of 64 x 128.
- ``wide`` (otherwise: PE3's Ŵ): 128 rows of d by 256 columns of c, two
  warpgroups of 64 x 256.

Where all of a CTA's tiles share one row of tiles of G and the whole of G
fits beside at least two stages, G is ``resident``: loaded once per CTA.
The ring then holds only Z's 64-row chunks, as many stages as fit. The
grid is persistent: one CTA per SM, at most one per tile. CPU tests check
all of it; the libraries are built at the first launch, never at import.
PE1's tensor-core route runs on the same helpers of ``csrc/tt_mma.cuh``
and is planned by ``ttm_pe1.plan_pe1``.

Grouped calls (the experts of an MoE layer: Z (E, a, b, c), G (E, b, d),
O (E, a, d, c)) take each group's plan, the group as the grid's second
coordinate and as the TMA maps' outermost dimension (a box never reads
the next group's rows: the maps' zero fill pads each group's tail), and
``group_grid`` CTAs a group; a resident G is its CTA's group's.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass

import torch

from . import build as B

SMS = 132                   # H100 SXM streaming multiprocessors
SMEM_MAX = 232_448          # tt_mma::kMaxSmem (227 KB)
BK = 64                     # tt_mma::kBK, b rows per chunk
ABOX = 64                   # tt_mma::kABox, columns of d in G's box
MAX_STAGES = 8
ALIGN = 1024                # slack to align the dynamic shared memory

PLAN_FIELDS = ("a", "b", "c", "d", "wgn", "sw", "wm", "wn", "nk", "stages",
               "resident", "slabs", "bw", "tiles_m", "tiles_c", "tiles_n",
               "tiles", "grid", "threads", "a_chunk", "b_chunk", "stage",
               "a_res", "out_pitch", "smem", "gz", "gg")
# (wgn, sw) of the kernel instances, and each instance's most warpgroups;
# (64, 128) is the stacked tiling on granules
INSTANCES = {(64, 32): 4, (64, 64): 4, (64, 128): 4, (128, 128): 2,
             (256, 128): 2}
GRANULES = (8, 4)           # cp.async granule bytes, widest first


@dataclass(frozen=True)
class Plan:
    a: int
    b: int
    c: int
    d: int
    wgn: int             # columns of a tile per warpgroup (the template)
    sw: int              # Z's swizzle bytes (the template): 32, 64, 128
    wm: int              # consumer warpgroups along d
    wn: int              # and along c
    nk: int              # b-chunks of BK rows
    stages: int          # ring slots
    resident: int        # 1: G loaded once per CTA; 0: streamed per chunk
    slabs: int           # slabs side by side in a tile (stacked), else 1
    bw: int              # columns of Z's TMA box
    tiles_m: int
    tiles_c: int
    tiles_n: int         # slab groups x tiles_c
    tiles: int
    grid: int            # CTAs (persistent) of one group
    threads: int         # consumers and the producer (warp or warpgroup)
    a_chunk: int         # bytes of G's chunk (wm boxes of 64 x BK)
    b_chunk: int         # bytes of Z's chunk
    stage: int           # bytes of a ring slot
    a_res: int           # bytes of resident G (0 when streamed)
    out_pitch: int       # staging row bytes (stacked: dense, a slab's
    #                      rows as in O; else 16 past a row, 4 banks apart)
    smem: int            # dynamic shared memory bytes
    gz: int = 0          # Z's cp.async granule bytes (8 or 4), 0: TMA
    gg: int = 0          # G's (resident) granule bytes, 0: TMA

    @property
    def orientation(self) -> str:
        if self.slabs > 1:
            return "stacked"
        return "thin" if self.wn > 1 else "wide"

    @property
    def bm(self) -> int:
        return 64 * self.wm

    @property
    def bn(self) -> int:
        return self.wgn * self.wn

    @functools.cached_property
    def fields(self) -> ctypes.Array:
        """The plan as the C side's ``int32[25]``."""
        return (ctypes.c_int * len(PLAN_FIELDS))(*astuple(self))


assert tuple(Plan.__dataclass_fields__) == PLAN_FIELDS


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def group_grid(tiles: int, groups: int) -> int:
    """Persistent CTAs of one group: one an SM for a single group; for
    ``groups`` at once an equal share of the SMs each (at least one), so
    the grid's groups x CTAs stays one wave where the groups are no more
    than the SMs. A CTA's tiles are then all of one group, whose operands
    it keeps (a resident G is one group's)."""
    return min(tiles, max(1, SMS // groups))


def group_misalign(misalign: int, group_bytes: int, groups: int) -> int:
    """The misalignment every group's operand shares: a group's start is
    ``group_bytes`` past the previous one, so a granule must divide both
    (bits of a power of two: the OR of the two residues mod 16)."""
    return misalign | (group_bytes % 16 if groups > 1 else 0)


def counted(name: str, z: torch.Tensor) -> str:
    """The launch counter's name of a PE call: ``name``, or
    ``<name>_grouped`` where Z carries the leading group axis (PE1 and PE2
    (E, a, b, c); PE3's X as (E, 1, b, i)), so a step's grouped launches
    (the MoE experts') count apart from its others."""
    return f"{name}_grouped" if z.dim() == 4 else name


def granule(row_bytes: int, misalign: int) -> int:
    """The widest cp.async granule (8, 4 bytes) that divides a row and the
    operand's address mod 16; 0 where none does (2-byte rows or offsets)."""
    return next((g for g in GRANULES
                 if row_bytes % g == 0 and misalign % g == 0), 0)


@functools.lru_cache(maxsize=512)
def plan(a: int, b: int, c: int, d: int, elsize: int, z_misalign: int = 0,
         g_misalign: int = 0, groups: int = 1) -> Plan | None:
    """The tensor-core plan of ``O(a,d,c) = sum_b Z(a,b,c) G(b,d)``, or
    ``None`` for the FMA route. ``elsize`` is 2 (bf16) or 4 (f32),
    ``*_misalign`` the operands' addresses mod 16. An operand whose rows
    the TMA cannot take (not 16-byte multiples, or off 16 bytes) is staged
    by cp.async granules: Z in the stacked tiling only (even c <= 32, whole
    slabs in N = 64, runs of O of 16-byte multiples), G where it is
    resident and the producer keeps its registers. ``groups`` > 1: each
    group's start shares the granule, ``grid`` is
    ``group_grid``'s."""
    if elsize != 2 or min(a, b, c, d) < 1:
        return None
    z_misalign = group_misalign(z_misalign, a * b * c * 2, groups)
    g_misalign = group_misalign(g_misalign, b * d * 2, groups)
    z_tma = c % 8 == 0 and z_misalign % 16 == 0
    g_tma = d % 8 == 0 and g_misalign % 16 == 0
    gz = 0 if z_tma else granule(2 * c, z_misalign)
    gg = 0 if g_tma else granule(2 * d, g_misalign)
    if not (z_tma or gz) or not (g_tma or gg):
        return None                  # odd rows, or 2-byte offsets
    if gz and (c > 32 or (c * d) % 8):
        return None
    if gz:                           # the stacked tiling on granules
        wgn, sw, wn = 64, 128, 1
        wm = min(4, _cdiv(d, 64))
        slabs, bw = 64 // c, c
    elif c in (16, 32):
        wgn, sw, wn = 64, 2 * c, 1
        wm = min(4, _cdiv(d, 64))
        slabs, bw = 64 // c, c
    elif d <= 64:
        wgn, sw, wm, wn, slabs, bw = 128, 128, 1, 2, 1, 64
    else:
        wgn, sw, wm, wn, slabs, bw = 256, 128, 2, 1, 1, 64
    bm, bn = 64 * wm, wgn * wn
    nk = _cdiv(b, BK)
    tiles_m = _cdiv(d, bm)
    tiles_c = 1 if slabs > 1 else _cdiv(c, bn)
    tiles_n = _cdiv(a, slabs) * tiles_c
    tiles = tiles_m * tiles_n
    a_chunk, b_chunk = bm * BK * 2, bn * BK * 2
    nwg = wm * wn
    out_pitch = wgn * 2 + (0 if slabs > 1 else 16)
    fixed = ALIGN + nwg * 64 * out_pitch

    def smem_for(stages: int, res: bool) -> int:
        stage = b_chunk + (0 if res else a_chunk)
        return fixed + (nk * a_chunk if res else 0) + stages * stage \
            + 16 * stages + 8

    resident = tiles_m == 1 and smem_for(2, True) <= SMEM_MAX
    if smem_for(2, resident) > SMEM_MAX or \
            (gg and (not resident or wgn == 256)):
        return None
    stage = b_chunk + (0 if resident else a_chunk)
    stages = 2
    while stages < MAX_STAGES and smem_for(stages + 1, resident) <= SMEM_MAX:
        stages += 1
    producer = 128 if wgn == 256 or gz else 32
    return Plan(a, b, c, d, wgn, sw, wm, wn, nk, stages, int(resident),
                slabs, bw, tiles_m, tiles_c, tiles_n, tiles,
                group_grid(tiles, groups),
                nwg * 128 + producer, a_chunk, b_chunk, stage,
                nk * a_chunk if resident else 0, out_pitch,
                smem_for(stages, resident), gz, gg)


def plan_for(z: torch.Tensor, g: torch.Tensor) -> Plan | None:
    """The plan of contiguous operands ``z`` ([E,] a, b, c), ``g`` ([E,]
    b, d)."""
    a, b, c = z.shape[-3:]
    return plan(a, b, c, g.shape[-1], z.element_size(), z.data_ptr() % 16,
                g.data_ptr() % 16, z.shape[0] if z.dim() == 4 else 1)


def _typed(lib: ctypes.CDLL, entry: str) -> ctypes.CDLL:
    """``lib`` with its entry ``entry`` given its C signature."""
    if not getattr(lib, "_repro_mma_typed", False):
        p = ctypes.c_void_p
        fn = getattr(lib, entry)
        fn.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                       p]
        fn.restype = ctypes.c_int
        lib._repro_mma_typed = True
    return lib


def launch(name: str, source: str, p: Plan, z: torch.Tensor,
           g: torch.Tensor, out: torch.Tensor) -> Plan:
    """Launch ``csrc/<source>.cu``'s entry ``<name>_mma`` on ``out``'s
    stream under ``p`` (``plan_for(z, g)``): ``z`` ([E,] a, b, c), ``g``
    ([E,] b, d), ``out`` ([E,] a, d, c), contiguous bf16. Counts one
    launch of ``counted(name, z)``."""
    if out.data_ptr() % 16:
        raise ValueError(f"{name}: output not 16-byte aligned")
    entry = f"{name}_mma"
    lib = _typed(B.load(source), entry)
    B.check(lib, getattr(lib, entry)(
        z.data_ptr(), g.data_ptr(), out.data_ptr(), p.fields,
        z.shape[0] if z.dim() == 4 else 1,
        torch.cuda.current_stream(z.device).cuda_stream), entry)
    B.note_launch(counted(name, z))
    return p
