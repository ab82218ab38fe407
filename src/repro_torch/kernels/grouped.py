"""Launch plans of the grouped kernels: the pow-2 fake-quant group
(``csrc/pow2_fq.cu::p2_fq_group``), the blockwise encode and decode
groups (``csrc/blockwise.cu::bw_enc_group`` / ``bw_dec_group``) and the
packed int4 encode and decode groups (``csrc/pow2_packed.cu::
p2_enc_packed`` / ``p2_dec_packed``) and the recurrent-state pool's decode
and encode groups (``csrc/state_codec.cu::st_dec_group`` /
``st_enc_group``). One launch
covers a list of tensors, described by a table the C side passes to the
kernel by value.

The plans are pure functions of the shapes, so the CPU tests can check
them where no kernel can run:

- ``fq_plan``: the tensors chunked into launches of at most ``FQ_CAP``,
  each with the prefix of its tensors' unit counts (a unit is one CTA's
  work at a time and never straddles two tensors: ``FQ_TILE`` elements, or
  for a tensor of at least ``STREAM_MIN`` elements a wide unit of
  ``FQ_WIDE_BYTES``, four 16-byte loads a thread).
- ``bw_plan``: the leaves chunked into launches of at most ``BW_CAP``, each
  with the prefix of its leaves' warp tasks (32 consecutive blocks for a
  block width b <= 32, one block for b > 32, and for a stream leaf
  ``BW_STREAM_STEPS`` steps of 1024 / b blocks) and each leaf's offset in
  the launch's one flat codes buffer (on 16 bytes) and one flat scales
  buffer. A stream leaf (``bw_stream``) holds at least ``STREAM_MIN``
  elements in blocks of 256, 512 or 1024 on rows of whole float4.
- ``bwd_plan``: the leaves chunked into launches of at most ``BW_CAP``,
  each with the prefix of its leaves' tile counts (a tile is ``BWD_TILE``
  output elements, one CTA's work at a time, never two leaves) and each
  leaf's offset in the launch's one f32 output buffer (on 16 bytes).
- ``pk_plan``: the (rows, last) entries chunked into launches of at most
  ``PK_CAP``, each with the prefix of its entries' tile counts (a tile is
  ``PK_TILE`` packed bytes, one CTA's work at a time, never two entries),
  each entry's offset in the encode's one int8 codes buffer (on 16 bytes)
  and in the decode's one f32 values buffer (on 16 bytes).
- ``st_dec_plan``: the state pool's tensors chunked into launches of at
  most ``ST_CAP``, each with its units (``ST_UNIT`` codes of one row, a
  row being one (layer, slot)) and the prefix of its tiles (``ST_TILE``
  units, one CTA's work at a time, never two tensors).
- ``st_enc_plan``: the (tensor, layer) new states cut into pieces, at
  most ``ST_CAP`` pieces and ``ST_PTR_CAP`` new-state pointers a launch;
  a piece is a run of one tensor's layers, its rows (layer, slot) tasks
  of a cluster of ``ST_CLUSTER`` CTAs each where a row holds at least
  ``ST_BIG_BYTES`` of values, else ``ST_CLUSTER`` rows a task, one a CTA;
  a launch whose CTAs each take at most ``ST_STAGE_MAX`` bytes of values
  keeps them in shared memory between its two passes.

The caps keep each table within the 4 KB of a launch's parameters. The
routes follow from the shapes alone: the LM step's large entries (its
grad-edge group's embedding and head, its activation edges, the
embedding's and the head's moments, their wire leaves) take the stream
units; the MLP's tensors, a few thousand elements each, and the LM's TT
cores keep the units sized for launch latency. ``stream=False`` plans the
latter for every entry: the previous design, a yardstick only.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..numerics.codecs import blockwise_geometry
from ..numerics.spec import QuantSpec, packed_trailing

FQ_CAP = 64                 # pow2_fq.cu kFqCap
FQ_TILE = 1024              # pow2_fq.cu kTile: 256 threads x 4 elements
FQ_WIDE_BYTES = 16384       # pow2_fq.cu wide_tile: 256 threads x 4 x 16 B
STREAM_MIN = 1 << 20        # elements: an entry this large streams
BW_CAP = 48                 # blockwise.cu kBwCap
BW_STREAM_STEPS = 8         # blockwise.cu kStreamSteps
BW_STEP = 1024              # values a warp holds a step: 8 float4 a lane
WARP = 32
CODE_ALIGN = 16             # bytes: each leaf's codes start on 16 bytes
BWD_TILE = 1024             # blockwise.cu kDecTile: 256 threads x 4 outputs
OUT_ALIGN = 4               # f32 elements: each leaf's values on 16 bytes
PK_CAP = 64                 # pow2_packed.cu kPkCap
PK_TILE = 2048              # pow2_packed.cu kTile: 256 threads x 8 bytes


def chunks(n: int, cap: int) -> list[range]:
    """Indices 0..n-1 in runs of at most ``cap``, one per launch."""
    return [range(i, min(i + cap, n)) for i in range(0, n, cap)]


@dataclass(frozen=True)
class FqLaunch:
    index: range                 # the tensors of this launch
    tile_end: tuple[int, ...]    # prefix sum of ceil(n / unit)
    wide: tuple[bool, ...]       # each tensor's units: wide or FQ_TILE

    @property
    def tiles(self) -> int:
        return self.tile_end[-1]


def fq_unit(numel: int, itemsize: int, stream: bool = True) -> int:
    """Elements of one unit of a tensor: a wide unit (``FQ_WIDE_BYTES``)
    for one of at least ``STREAM_MIN`` elements, else ``FQ_TILE``."""
    if stream and numel >= STREAM_MIN:
        return FQ_WIDE_BYTES // itemsize
    return FQ_TILE


def fq_plan(numels: list[int], itemsize: int = 4, cap: int = FQ_CAP,
            stream: bool = True) -> list[FqLaunch]:
    """The fake-quant group's launches over tensors of ``numels`` elements
    of ``itemsize`` bytes (an empty list gives none)."""
    out = []
    for idx in chunks(len(numels), cap):
        ends, wide, acc = [], [], 0
        for i in idx:
            unit = fq_unit(numels[i], itemsize, stream)
            acc += -(-numels[i] // unit)
            ends.append(acc)
            wide.append(unit != FQ_TILE)
        out.append(FqLaunch(idx, tuple(ends), tuple(wide)))
    return out


@dataclass(frozen=True)
class BwLeaf:
    rows: int
    last: int
    b: int
    nb: int
    tasks: int                   # warp tasks
    code_off: int                # elements into the launch's codes buffer
    scale_off: int               # elements into its scales buffer
    stream: bool = False         # stream tasks (bw_stream)

    @property
    def codes(self) -> int:
        return self.rows * self.nb * self.b

    @property
    def scales(self) -> int:
        return self.rows * self.nb


@dataclass(frozen=True)
class BwLaunch:
    index: range                 # the leaves of this launch
    leaves: tuple[BwLeaf, ...]
    task_end: tuple[int, ...]    # prefix sum of the leaves' tasks
    codes: int                   # elements of the flat codes buffer
    scales: int                  # elements of the flat scales buffer

    @property
    def tasks(self) -> int:
        return self.task_end[-1]


def bw_stream(rows: int, last: int, b: int) -> bool:
    """Whether a leaf takes stream tasks: at least ``STREAM_MIN`` elements
    in blocks of 256, 512 or 1024 on rows of whole float4."""
    return rows * last >= STREAM_MIN and b in (256, 512, 1024) \
        and last % 4 == 0


def bw_tasks(rows: int, last: int, b: int, nb: int,
             stream: bool = False) -> int:
    """Warp tasks of one leaf: a warp per 32 blocks (b <= 32), per block
    (b > 32) or, for stream tasks, per ``BW_STREAM_STEPS`` steps of
    ``BW_STEP // b`` blocks; none for an empty leaf."""
    units = rows * nb if rows * last else 0
    if stream:
        return -(-units // (BW_STREAM_STEPS * (BW_STEP // b)))
    return -(-units // WARP) if b <= WARP else units


def bw_plan(shapes: list[tuple[int, int]], block: int,
            storage: torch.dtype = torch.int8,
            cap: int = BW_CAP, stream: bool = True) -> list[BwLaunch]:
    """The blockwise encode group's launches over (rows, last) leaves at
    ``block`` with codes of ``storage`` (an empty list gives none)."""
    per = CODE_ALIGN // storage.itemsize      # codes per 16 bytes
    spec = QuantSpec("blockwise", 8, block)
    out = []
    for idx in chunks(len(shapes), cap):
        leaves, ends, tasks, code, scale = [], [], 0, 0, 0
        for i in idx:
            rows, last = shapes[i]
            b, nb, _ = blockwise_geometry(spec, last)
            st = stream and bw_stream(rows, last, b)
            leaf = BwLeaf(rows, last, b, nb, bw_tasks(rows, last, b, nb, st),
                          code, scale, st)
            leaves.append(leaf)
            tasks += leaf.tasks
            ends.append(tasks)
            code += -(-leaf.codes // per) * per
            scale += leaf.scales
        out.append(BwLaunch(idx, tuple(leaves), tuple(ends), code, scale))
    return out


@dataclass(frozen=True)
class BwdLeaf:
    rows: int
    last: int
    b: int
    nb: int
    tiles: int                   # ceil(rows * last / BWD_TILE)
    out_off: int                 # elements into the launch's output buffer

    @property
    def numel(self) -> int:
        return self.rows * self.last


@dataclass(frozen=True)
class BwdLaunch:
    index: range                 # the leaves of this launch
    leaves: tuple[BwdLeaf, ...]
    tile_end: tuple[int, ...]    # prefix sum of the leaves' tiles
    out: int                     # elements of the f32 output buffer

    @property
    def tiles(self) -> int:
        return self.tile_end[-1]


def bwd_plan(leaves: list[tuple[int, int, int, int]],
             cap: int = BW_CAP) -> list[BwdLaunch]:
    """The blockwise decode group's launches over leaves given as (rows,
    last, b, nb) — codes (rows, nb * b), scales (rows, nb), values (rows,
    last) — (an empty list gives none)."""
    out = []
    for idx in chunks(len(leaves), cap):
        plan, ends, tiles, off = [], [], 0, 0
        for i in idx:
            rows, last, b, nb = leaves[i]
            leaf = BwdLeaf(rows, last, b, nb, -(-(rows * last) // BWD_TILE),
                           off)
            plan.append(leaf)
            tiles += leaf.tiles
            ends.append(tiles)
            off += -(-leaf.numel // OUT_ALIGN) * OUT_ALIGN
        out.append(BwdLaunch(idx, tuple(plan), tuple(ends), off))
    return out


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


@dataclass(frozen=True)
class PkLeaf:
    rows: int
    last: int
    tiles: int                   # ceil(rows * pk / PK_TILE)
    code_off: int                # bytes into the launch's codes buffer
    out_off: int                 # elements into its f32 values buffer

    @property
    def pk(self) -> int:
        return packed_trailing(self.last)

    @property
    def nbytes(self) -> int:
        return self.rows * self.pk

    @property
    def numel(self) -> int:
        return self.rows * self.last


@dataclass(frozen=True)
class PkLaunch:
    index: range                 # the entries of this launch
    leaves: tuple[PkLeaf, ...]
    tile_end: tuple[int, ...]    # prefix sum of the entries' tiles
    codes: int                   # bytes of the int8 codes buffer
    out: int                     # elements of the f32 values buffer

    @property
    def tiles(self) -> int:
        return self.tile_end[-1]


def pk_plan(shapes: list[tuple[int, int]],
            cap: int = PK_CAP) -> list[PkLaunch]:
    """The packed encode and decode groups' launches over (rows, last)
    entries, two codes a byte along ``last`` (an empty list gives none)."""
    out = []
    for idx in chunks(len(shapes), cap):
        plan, ends, tiles, code, val = [], [], 0, 0, 0
        for i in idx:
            rows, last = shapes[i]
            leaf = PkLeaf(rows, last,
                          -(-(rows * packed_trailing(last)) // PK_TILE),
                          code, val)
            plan.append(leaf)
            tiles += leaf.tiles
            ends.append(tiles)
            code += _align(leaf.nbytes, CODE_ALIGN)
            val += _align(leaf.numel, OUT_ALIGN)
        out.append(PkLaunch(idx, tuple(plan), tuple(ends), code, val))
    return out


ST_CAP = 16                 # state_codec.cu kCap
ST_PTR_CAP = 160            # state_codec.cu kPtrCap
ST_UNIT = 16                # state_codec.cu kUnit: int8 codes a unit
ST_TILE = 1024              # state_codec.cu kDecTile: units a decode tile
ST_CLUSTER = 16             # state_codec.cu kCluster
ST_BIG_BYTES = 1 << 16      # a row of this many bytes of values or more
                            # takes a cluster
ST_STAGE_MAX = 1 << 16      # a launch whose CTAs each take at most this
                            # many bytes of values stages them in shared
                            # memory between the encode's passes
_INT_MAX = (1 << 31) - 1


def st_table_bytes() -> tuple[int, int]:
    """Bytes of the decode's and the encode's tables as ``state_codec.cu``
    lays them out (``DecGroup``, ``EncGroup``, the one-slot form's slot
    pointer and pool width included; both must stay within the 4,096 of a
    launch's parameters)."""
    dec = ST_CAP * (3 * 8 + 4 * 4) + 8 + 4 * 2
    enc = ST_CAP * (2 * 8 + 6 * 4) + ST_PTR_CAP * 16 + 2 * 8 + 4 * 6
    return _align(dec, 8), _align(enc, 8)


@dataclass(frozen=True)
class StDecLaunch:
    index: range                 # the pool tensors of this launch
    units: tuple[int, ...]       # rows * ceil(feat / ST_UNIT) each
    tile_end: tuple[int, ...]    # prefix sum of ceil(units / ST_TILE)

    @property
    def tiles(self) -> int:
        return self.tile_end[-1]


def st_units(rows: int, feat: int) -> int:
    """Decode units of a pool tensor: ``ST_UNIT`` codes of one row (the
    last of a row may hold fewer)."""
    return rows * -(-feat // ST_UNIT)


def st_dec_plan(shapes: list[tuple[int, int]],
                cap: int = ST_CAP) -> list[StDecLaunch]:
    """The state decode group's launches over pool tensors given as (rows,
    feat): rows = layers x slots, feat the elements of one (layer, slot)
    (an empty list gives none). The one-slot form (``st_dec_slot``) plans
    rows = layers: its rows are one slot's."""
    out = []
    for idx in chunks(len(shapes), cap):
        units, ends, tiles = [], [], 0
        for i in idx:
            u = st_units(*shapes[i])
            tiles += -(-u // ST_TILE)
            if shapes[i][0] * shapes[i][1] > _INT_MAX // 2 \
                    or tiles * ST_TILE > _INT_MAX:
                raise ValueError(f"st_dec_plan: {shapes[i]} has more units "
                                 "than the kernel indexes")
            units.append(u)
            ends.append(tiles)
        out.append(StDecLaunch(idx, tuple(units), tuple(ends)))
    return out


@dataclass(frozen=True)
class StPiece:
    entry: int                   # the pool tensor
    layer0: int                  # its first layer here
    layers: int
    slots: int
    feat: int
    big: bool                    # a cluster a row
    tasks: int                   # rows (big) or ceil(rows / ST_CLUSTER)
    ptr0: int                    # its first new state in the launch's
                                 # pointers

    @property
    def rows(self) -> int:
        return self.layers * self.slots


@dataclass(frozen=True)
class StEncLaunch:
    pieces: tuple[StPiece, ...]
    task_end: tuple[int, ...]    # prefix sum of the pieces' tasks
    ptrs: int                    # new-state pointers
    stage_bytes: int             # the most values one CTA takes, in bytes

    @property
    def tasks(self) -> int:
        return self.task_end[-1]

    @property
    def stage(self) -> bool:
        """Whether the CTAs keep their values in shared memory between
        the encode's passes (else they re-read them, L2-warm)."""
        return self.stage_bytes <= ST_STAGE_MAX

    @property
    def ctas(self) -> int:
        return self.tasks * ST_CLUSTER


def st_big(feat: int, itemsize: int) -> bool:
    """Whether a row of ``feat`` values of ``itemsize`` bytes takes a
    cluster of ``ST_CLUSTER`` CTAs."""
    return feat * itemsize >= ST_BIG_BYTES


def _st_stage_bytes(feat: int, itemsize: int, big: bool) -> int:
    units = -(-feat // ST_UNIT)
    if big:
        units = -(-units // ST_CLUSTER)
    return units * ST_UNIT * itemsize


def st_enc_plan(entries: list[tuple[int, int, int, int]],
                cap: int = ST_CAP,
                ptr_cap: int = ST_PTR_CAP,
                cluster: bool = True) -> list[StEncLaunch]:
    """The state encode group's launches over pool tensors given as
    (layers, slots, feat, itemsize of the new states): each tensor's
    layers in pieces, a new launch where the pieces or the pointers would
    pass their caps (an empty tensor gives no piece; no piece gives no
    launch). The one-slot form (``st_enc_slot``) plans slots = 1.
    ``cluster=False`` gives every row one CTA, the large rows too: a
    yardstick ``chip_smoke.py`` times, on no path."""
    out = []
    pieces: list[StPiece] = []

    def close():
        if pieces:
            ends, acc = [], 0
            for pc in pieces:
                acc += pc.tasks
                ends.append(acc)
            stage = max(_st_stage_bytes(pc.feat, isz[pc.entry], pc.big)
                        for pc in pieces)
            out.append(StEncLaunch(tuple(pieces), tuple(ends),
                                   sum(pc.layers for pc in pieces), stage))
            pieces.clear()

    isz = [e[3] for e in entries]
    for e, (layers, slots, feat, itemsize) in enumerate(entries):
        if not layers * slots * feat:
            continue
        big = cluster and st_big(feat, itemsize)
        l0 = 0
        while l0 < layers:
            ptrs = sum(pc.layers for pc in pieces)
            if len(pieces) == cap or ptrs == ptr_cap:
                close()
                ptrs = 0
            n = min(layers - l0, ptr_cap - ptrs)
            rows = n * slots
            tasks = rows if big else -(-rows // ST_CLUSTER)
            if rows > _INT_MAX or feat > _INT_MAX:
                raise ValueError(f"st_enc_plan: ({layers}, {slots}, {feat}) "
                                 "is more than the kernel indexes")
            pieces.append(StPiece(e, l0, n, slots, feat, big, tasks, ptrs))
            l0 += n
    close()
    return out
