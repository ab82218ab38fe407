"""Launch plan and ctypes launch of the f32 PE2/PE3 tile route
(``csrc/tt_tile.cuh``, in ``csrc/ttm_pe2.cu`` as ``pe2_tile_kernel`` and in
``csrc/ttm_pe3.cu`` as ``pe3_tile_kernel``): ``O(a, d, c) = sum_b Z(a, b, c)
G(b, d)`` in full FP32 on the CUDA cores as one GEMM with M = the (slab,
column) pairs, N = d and K = b, both operands read K-outer in place.

``plan`` is a pure function of the shapes, the element size and the two
operands' addresses mod 16: the same inputs always give the same route.
It returns ``None`` (the streamed body, ``tt_contract``) for bf16, for an
empty contraction and for calls under ``MIN_FLOPS``; ``layout`` is the
plan without that rule (the card tests launch it at small odd shapes).

- Two bodies (``tm``): the wide one, 16 x 8 sums a thread on 256 x 128
  tiles (256 threads, one CTA an SM, 32-row K-chunks), where those tiles
  fill the card and waste at most a fifth of their columns (LM100M's
  large PE2 calls and its head's Ŵ); else the square one, 8 x ``tn`` sums
  on tiles of at most 128 x 128 (two or three CTAs an SM).
- M-tile: ``spc`` whole slabs of ``ct = c`` columns (as many as fit 256
  rows in the wide body; the largest power of two within 128 in the
  square one: 8 at c = 12 or 16, 4 at c = 32), or where c >= 96 one slab
  cut into equal tiles of at most 256 or 128 columns.
- N-tile: ``bn = wn * tn`` of d (128 in the wide body); in the square one
  ``tn`` is 12, 8 or 4, chosen for the fewest columns computed past d,
  then the widest tile, then 8 (the fastest measured): 128 at d = 768 and
  PE3's Ŵ, 8, 12 and 32 at the thin calls.
- Threads: ``wm x wn`` of them a group; where a group has under 128
  threads, ``ks`` groups split each K-chunk (``kr`` rows each), and their
  sums meet in group order.
- K: chunks of ``bk = ks * kr`` rows through a ring of 3-6 ``cp.async``
  slots, copied in 16-, 8- or 4-byte granules (whatever the rows, the
  tiles and the pointers allow).
- Split-K: ``cs`` CTAs of a thread block cluster share a tile, each one
  contiguous range of ``kc`` chunks, where the tiles alone leave SMs idle:
  at least a CTA an SM where the work allows, then the least time in a
  model of the card's waves measured on the H100 (``_cost``), as for PE3's
  Ŵ 768 x 768 (36 tiles: 6 ranks). Their sums meet in rank order through
  distributed shared memory.

CPU tests check all of it; the libraries are built at the first launch,
never at import.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import astuple, dataclass

import torch

from . import build as B

SMS = 132                   # H100 SXM streaming multiprocessors
SMEM_MAX = 232_448          # tt_tile::kMaxSmem (227 KB)
MAX_THREADS = 256           # CTA size at most (tt_tile::max_threads)
MIN_THREADS = 128           # split K inside a CTA until it has this many
TM = 8                      # M rows a thread of the square body
TNS = (12, 8, 4)            # N columns a thread of the 8-row instances
WBM = 256                   # M rows of a 16 x 8 (wide) tile
BM = 128                    # M rows of a tile at most
BN = 128                    # N columns of a tile at most
WIDE_C = 96                 # from this c on, one slab cut into column tiles
MAX_KS = 8                  # K groups of a CTA at most
KR = {1: 16, 2: 8}          # K rows a group takes of a chunk, by K groups
#                             (4 from 4 groups on)
KR_WIDE = 32                # K rows a chunk of the wide body (its instance)
MIN_STAGES, MAX_STAGES = 3, 6   # ring slots (tt_tile::kMaxStages)
MAX_CLUSTER = 8             # tt_tile::kMaxCluster, the portable maximum
# the split-K cost model (_cost), measured on the H100 (8 x 8 tiles, 128 x
# 128, 16-row chunks, PE3's Ŵ 768 x 768 at cluster sizes 1-8): a chunk 2.3
# us for one CTA alone on an SM, 2.0 for each of two (SHARED 1.17), the
# combine ~7 us (COMBINE 3 chunks), ~10% more a wave (WAVE_GAP); and the
# clusters the card holds at once (cudaOccupancyMaxActiveClusters) by CTAs
# an SM holds, for cluster sizes 1-8
COMBINE = 3
SHARED = 1.17
WAVE_GAP = 0.1
CLUSTERS = {1: (132, 66, 39, 30, 22, 17, 15, 15),
            2: (264, 132, 79, 62, 47, 39, 32, 30),
            4: (528, 264, 163, 124, 94, 79, 69, 62)}
SMEM_SM = 233_472           # shared memory of an SM (228 KB)
INT32_MAX = 2 ** 31 - 1
# The tile route's threshold, in flops (2 a b c d). The FMNIST MLP's f32
# calls (at most 58.7 MFLOP, at launch latency) stay on the streamed body:
# on the H100 the tiles took 9.8-17.1 us at them against the streamed
# body's 7.1-12.4 us, slower at each (``chip_smoke.py`` train kernels,
# ``tile_ms``); LM100M's calls (1.2 to 928 GFLOP) take the tiles.
MIN_FLOPS = 1 << 28

PLAN_FIELDS = ("a", "b", "c", "d", "tm", "tn", "kr", "spc", "ct", "wm", "wn",
               "ks", "lm", "threads", "bn", "bk", "stages", "cs", "nk",
               "kc", "gz", "gg", "zp", "gp", "op", "z_stage", "stage",
               "smem", "tiles_m", "tiles_c", "tiles_n", "m_fast", "grid",
               "vec_out")


@dataclass(frozen=True)
class Plan:
    a: int
    b: int
    c: int
    d: int
    tm: int              # M rows a thread: 8 or 16 (the template)
    tn: int              # N columns a thread: 4, 8, 12, 16 (the template)
    kr: int              # K rows a group takes of a chunk (the template)
    spc: int             # slabs of an M-tile
    ct: int              # c columns of an M-tile
    wm: int              # threads along M, 8 rows each
    wn: int              # threads along N, tn columns each
    ks: int              # K groups of a CTA
    lm: int              # lanes along M in a warp (4, 8); 0: row-major
    threads: int         # CTA size, a multiple of 32
    bn: int              # N-tile
    bk: int              # K rows a chunk
    stages: int          # ring slots
    cs: int              # cluster size: CTAs splitting K over a tile
    nk: int              # K-chunks
    kc: int              # K-chunks a rank
    gz: int              # copy granule bytes of Z rows (16, 8, 4)
    gg: int              # and of G rows
    zp: int              # shared-memory row pitch of Z, floats
    gp: int              # and of G
    op: int              # and of the output tile
    z_stage: int         # bytes of a slot's Z region
    stage: int           # bytes of a slot
    smem: int            # dynamic shared-memory bytes
    tiles_m: int         # M-tiles: slab runs x tiles_c
    tiles_c: int         # c tiles of a slab run
    tiles_n: int         # N-tiles
    m_fast: int          # 1: consecutive tiles walk M (G is the larger)
    grid: int            # CTAs: tiles x cs
    vec_out: int         # outputs stored 4 at a time

    @property
    def bm(self) -> int:
        """The M-tile padded to whole thread rows."""
        return self.wm * self.tm

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    @property
    def runs(self) -> int:
        return -(-self.a // self.spc)

    def k_range(self, rank: int) -> tuple[int, int]:
        """K rows [start, stop) that cluster rank ``rank`` sums."""
        return (min(self.b, rank * self.kc * self.bk),
                min(self.b, (rank + 1) * self.kc * self.bk))

    def group_rows(self, group: int) -> range:
        """Rows of a chunk that K group ``group`` takes, in its order."""
        return range(group * self.kr, (group + 1) * self.kr)

    @functools.cached_property
    def fields(self) -> ctypes.Array:
        """The plan as the C side's ``int32[34]``."""
        return (ctypes.c_int * len(PLAN_FIELDS))(*astuple(self))


assert tuple(Plan.__dataclass_fields__) == PLAN_FIELDS


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def _even(n: int, width: int) -> int:
    """Tile width that cuts n into as many equal tiles as ``width`` does."""
    return _cdiv(n, _cdiv(n, width))


def _round16(n: int) -> int:
    return _cdiv(n, 16) * 16


def _granule(row: int, tile: int, misalign: int) -> int:
    """Largest cp.async size (16, 8 or 4 bytes) that divides an f32 tensor
    row, a tile row and the pointer's alignment."""
    for g in (16, 8):
        if (row * 4) % g == 0 and (tile * 4) % g == 0 and misalign % g == 0:
            return g
    return 4


def _resident(tm: int, tn: int, threads: int, smem: int) -> int:
    """CTAs of a plan an SM holds: by registers (the instance's bound:
    ``tt_tile::min_blocks``), threads and shared memory (1 KB reserved a
    CTA)."""
    regs = 255 if tm == 16 else 168 if tn == 12 else 128
    return max(1, min(65_536 // (threads * regs), 2048 // threads,
                      SMEM_SM // (smem + 1024)))


def _clusters(resident: int, cs: int) -> int:
    """Clusters of ``cs`` CTAs the card runs at once (``CLUSTERS``; other
    residencies from the one-CTA row)."""
    row = CLUSTERS.get(resident)
    return row[cs - 1] if row else resident * CLUSTERS[1][cs - 1]


def _cost(tiles: int, nk: int, cs: int, resident: int) -> float:
    """A launch's time in chunk times of one CTA alone on an SM: waves of
    as many clusters as the card runs at once; in a wave the busiest SM
    holds ceil(CTAs / SMS) of them, each ceil(nk / cs) chunks plus, under
    split-K, the combine, and two or more on an SM run ``SHARED`` times
    as fast together as one alone; each wave past the first adds
    ``WAVE_GAP`` of the total (a wave's clusters start as whole clusters
    of slots free up)."""
    cap = _clusters(resident, cs)
    work = _cdiv(nk, cs) + (COMBINE if cs > 1 else 0)

    def wave(n: int) -> float:
        per_sm = _cdiv(n * cs, SMS)
        return per_sm * work / (SHARED if per_sm > 1 else 1.0)
    full, rest = divmod(tiles, cap)
    waves = full + (rest > 0)
    return (full * wave(cap) + (wave(rest) if rest else 0.0)) * (
        1 + WAVE_GAP * (waves - 1))


def max_threads(tn: int, tm: int = TM) -> int:
    """tt_tile::max_threads: the CTA size at most of a kernel<tm, tn, kr>."""
    return MAX_THREADS // 2 if tm == 8 and tn > 8 else MAX_THREADS


def _n_tile(d: int, wm: int) -> tuple[int, int]:
    """(tn, wn): the fewest columns past d, then the widest tile, then 8
    columns a thread (the fastest measured), then the widest thread."""
    cands = [(tn, wn) for tn in TNS for wn in range(1, BN // tn + 1)
             if wm * wn <= max_threads(tn)]
    return min(cands, key=lambda t: (_cdiv(d, t[0] * t[1]) * t[0] * t[1],
                                     -t[0] * t[1], t[0] != 8, -t[0]))


@functools.lru_cache(maxsize=512)
def layout(a: int, b: int, c: int, d: int, z_misalign: int = 0,
           g_misalign: int = 0) -> Plan:
    """The tile plan of an f32 contraction ``O(a,d,c) = sum_b Z(a,b,c)
    G(b,d)`` (``*_misalign``: the operands' addresses mod 16), whatever
    its size."""
    if min(a, b, c, d) < 1:
        raise ValueError(f"empty contraction {(a, b, c, d)}")
    # 16 x 8 register tiles on 256 x 128 tiles where the N-tiles waste at
    # most a fifth of their columns and the tiles fill the card (the 16 x 8
    # body runs ~1.25x as fast as the 8 x 8 one); else 8 x tn on tiles of
    # at most 128
    wide_spc, wide_ct = (1, _even(c, WBM)) if c >= WIDE_C else (
        min(a, WBM // c), c)
    wide = (4 * _cdiv(d, BN) * BN <= 5 * d and _cdiv(a, wide_spc)
            * _cdiv(c, wide_ct) * _cdiv(d, BN) >= SMS)
    if wide:
        tm, spc, ct, wm, tn, wn = 16, wide_spc, wide_ct, 16, 8, BN // 8
    else:
        tm = TM
        spc, ct = (1, _even(c, BM)) if c >= WIDE_C else (
            min(a, 1 << ((BM // c).bit_length() - 1)), c)
        wm = _cdiv(spc * ct, TM)
        tn, wn = _n_tile(d, wm)
    bn, group = tn * wn, wm * wn
    ks = 1
    while ks < MAX_KS and group * ks * 2 <= max_threads(tn, tm) and (
            group * ks < MIN_THREADS or (group * ks) % 32):
        ks *= 2
    kr = KR_WIDE if wide else KR.get(ks, 4)
    bk = ks * kr
    lm = next((m for m in (4, 8) if wm % m == 0 and wn % (32 // m) == 0), 0)
    threads = _cdiv(group * ks, 32) * 32
    bm = wm * tm
    gz, gg = _granule(c, ct, z_misalign), _granule(d, bn, g_misalign)
    # K groups read rows of a chunk side by side: pad their rows by 16
    # bytes so the groups' reads fall in other banks
    pad = 4 if ks > 1 else 0
    zp, gp, op = bm + pad, bn + pad, bm + 4
    z_stage = _round16(bk * zp * 4)
    stage = z_stage + _round16(bk * gp * 4)
    out = ks * bn * op * 4
    # ring slots: as many as the output tile's bytes hold (3 at least), so
    # a square CTA keeps to half an SM; the wide body, alone on its SM, as
    # many as the CTA's shared memory holds
    stages = max(MIN_STAGES, min(MAX_STAGES, (SMEM_MAX if wide else out)
                                 // stage))
    tiles_c = _cdiv(c, ct)
    tiles_m, tiles_n = _cdiv(a, spc) * tiles_c, _cdiv(d, bn)
    nk = _cdiv(b, bk)
    # split-K: every rank a chunk at least, a CTA an SM where the work
    # allows, then the least time (_cost)
    tiles = tiles_m * tiles_n
    ranks = [s for s in range(1, MAX_CLUSTER + 1)
             if (s - 1) * _cdiv(nk, s) < nk]
    fill = min(SMS, tiles * ranks[-1])
    res = _resident(tm, tn, threads, max(stages * stage, out))
    cs = min((s for s in ranks if tiles * s >= fill),
             key=lambda s: (_cost(tiles, nk, s, res), s))
    return Plan(a, b, c, d, tm, tn, kr, spc, ct, wm, wn, ks, lm, threads, bn,
                bk, stages, cs, nk, _cdiv(nk, cs), gz, gg, zp, gp, op, z_stage,
                stage, max(stages * stage, out), tiles_m, tiles_c, tiles_n,
                int(b * d > a * b * c), tiles_m * tiles_n * cs,
                int(c % 4 == 0 and ct % 4 == 0))


def plan(a: int, b: int, c: int, d: int, elsize: int, z_misalign: int = 0,
         g_misalign: int = 0) -> Plan | None:
    """The tile plan of ``O(a,d,c) = sum_b Z(a,b,c) G(b,d)``, or ``None``
    for the streamed body: bf16 (``elsize`` 2), an empty contraction, or
    fewer than ``MIN_FLOPS`` products."""
    if elsize != 4 or min(a, b, c, d) < 1 or 2 * a * b * c * d < MIN_FLOPS:
        return None
    return layout(a, b, c, d, z_misalign % 16, g_misalign % 16)


def plan_for(z: torch.Tensor, g: torch.Tensor) -> Plan | None:
    """The plan of contiguous operands ``z`` (a, b, c), ``g`` (b, d); a
    grouped call (Z (E, a, b, c)) takes no tile plan: ``tt_contract``'s
    route takes it."""
    if z.dim() != 3:
        return None
    a, b, c = z.shape
    return plan(a, b, c, g.shape[1], z.element_size(), z.data_ptr() % 16,
                g.data_ptr() % 16)


def layout_for(z: torch.Tensor, g: torch.Tensor) -> Plan:
    """``layout`` of contiguous f32 operands, whatever their size."""
    a, b, c = z.shape
    return layout(a, b, c, g.shape[1], z.data_ptr() % 16, g.data_ptr() % 16)


def _typed(lib: ctypes.CDLL, entry: str) -> ctypes.CDLL:
    """``lib`` with its entry ``entry`` given its C signature."""
    if not getattr(lib, "_repro_tile_typed", False):
        p = ctypes.c_void_p
        fn = getattr(lib, entry)
        fn.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_int), p]
        fn.restype = ctypes.c_int
        lib._repro_tile_typed = True
    return lib


def launch(name: str, source: str, p: Plan, z: torch.Tensor,
           g: torch.Tensor, out: torch.Tensor,
           lib: ctypes.CDLL | None = None) -> Plan:
    """Launch ``csrc/<source>.cu``'s entry ``<name>_tile`` (or ``lib``'s, a
    build of it elsewhere) on ``out``'s stream under ``p``: ``z`` (a, b,
    c), ``g`` (b, d), ``out`` (a, d, c), contiguous f32. Counts one launch
    of ``name``; a plan the C side refuses raises."""
    if z.dtype != torch.float32:
        raise TypeError(f"{name}: the tile route takes f32, got {z.dtype}")
    entry = f"{name}_tile"
    lib = _typed(lib or B.load(source), entry)
    B.check(lib, getattr(lib, entry)(
        z.data_ptr(), g.data_ptr(), out.data_ptr(), p.fields,
        torch.cuda.current_stream(z.device).cuda_stream), entry)
    B.note_launch(name)
    return p


def clusters(p: Plan) -> int:
    """Diagnostic: the clusters of ``p``'s kernel, CTA size, shared memory
    and cluster size the card runs at once (``csrc/ttm_pe2.cu``'s
    ``pe2_tile_clusters``: cudaOccupancyMaxActiveClusters); the source of
    ``CLUSTERS``."""
    lib = B.load("ttm_pe2")
    fn = lib.pe2_tile_clusters
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    n = fn(p.fields)
    if n < 0:
        B.check(lib, -n, "pe2_tile_clusters")
    return n
