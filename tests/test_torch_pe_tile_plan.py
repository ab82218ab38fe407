"""The f32 PE2 / PE3 tile route (``repro_torch.kernels.tt_tile``) checked on
the CPU, where no kernel can run: the plan is a pure function of the
shapes, the element size and the alignment, so its route, tiling, thread
grid, split-K, shared memory and grid are held here at every PE2 / PE3
call of LM100M's f32 step (``with_tt(LM100M, d=3, max_rank=48)`` with TT
embedding and head, the calls ``chip_smoke.py::_ckpt_pe_rows`` times) and
at odd shapes. The index math below mirrors ``csrc/tt_tile.cuh::gemm``;
``_mirror`` walks a plan's tiles, ranks, K groups and chunks in the
kernel's order with f32 sums and is held to ``pe2_torch`` / ``pe3_torch``
and to the JAX Pallas kernels (interpret mode) at small shapes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as JOPS
from repro_torch.core.ttm import pe_shapes
from repro_torch.kernels import tt_contract, tt_mma, tt_tile, ttm_pe2, ttm_pe3

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _lm100m_calls():
    """(a, b, c, d) of every PE2 call of the step's TT sites' forward and
    transposed chains at 8 x 256 rows, then every PE3 call as PE2 at a = 1
    (c = i, d = j), in the order the sites are walked."""
    from repro_torch import configs as C
    from repro_torch.launch.train import LM100M
    from repro_torch.models.lm import _walk_sites, build_lm
    cfg = C.with_tt(LM100M, d=3, max_rank=48, apply_to=(
        "ffn", "attn_qkv", "attn_o", "expert", "embed", "head"),
        quantize=True)
    pe2, pe3 = [], []
    for path, site in _walk_sites(build_lm(cfg)):
        if not site.use_tt or path[0] == "embed":
            continue
        s = site.spec
        for sp in (s, s.transposed()):
            for kind, zs, gs in pe_shapes(sp, 8 * 256):
                if kind == "pe2" and (*zs, gs[1]) not in pe2:
                    pe2.append((*zs, gs[1]))
        if (1, 8 * 256, s.in_dim, s.out_dim) not in pe3:
            pe3.append((1, 8 * 256, s.in_dim, s.out_dim))
    return pe2, pe3


LM_PE2, LM_PE3 = _lm100m_calls()
LM = LM_PE2 + LM_PE3
# (a, b, c, d) -> (tm, tn, spc, ct, bn, ks, cs): the wide body (16 x 8
# sums a thread, 256 x 128 tiles) at the large PE2 calls and the head's Ŵ,
# the square one (8 x tn) at the thin calls and the small Ŵ, split over a
# cluster
WANT = {
    (16384, 384, 12, 384): (16, 8, 21, 12, 128, 1, 1),
    (2048, 384, 96, 8): (8, 8, 1, 96, 8, 8, 1),
    (16384, 384, 16, 576): (16, 8, 16, 16, 128, 1, 1),
    (2048, 384, 192, 8): (8, 8, 1, 96, 8, 8, 1),
    (16384, 576, 12, 384): (16, 8, 21, 12, 128, 1, 1),
    (16384, 384, 16, 768): (16, 8, 16, 16, 128, 1, 1),
    (2048, 384, 256, 12): (8, 12, 1, 128, 12, 8, 1),
    (24576, 768, 12, 384): (16, 8, 21, 12, 128, 1, 1),
    (2048, 576, 96, 8): (8, 8, 1, 96, 8, 8, 1),
    (16384, 384, 32, 1536): (16, 8, 8, 32, 128, 1, 1),
    (2048, 384, 1024, 32): (8, 8, 1, 128, 32, 2, 1),
    (65536, 1536, 12, 384): (16, 8, 21, 12, 128, 1, 1),
    (2048, 1536, 96, 8): (8, 8, 1, 96, 8, 8, 1),
    (1, 2048, 768, 768): (8, 8, 1, 128, 128, 1, 6),
    (1, 2048, 768, 1536): (8, 8, 1, 128, 128, 1, 3),
    (1, 2048, 768, 3072): (8, 8, 1, 128, 128, 1, 3),
    (1, 2048, 3072, 768): (8, 8, 1, 128, 128, 1, 3),
    (1, 2048, 768, 32768): (16, 8, 1, 256, 128, 1, 1),
}
# odd shapes: c not a multiple of 4 (8- and 4-byte granules), c = 1, d = 1,
# d and K no multiple of their tiles, a column tile cut from c >= 96, more
# K-chunks than ring slots, few tiles (split-K), a slab run past a
ODD = [(3, 40, 12, 20), (2, 33, 7, 9), (5, 70, 1, 130), (1, 100, 97, 5),
       (4, 300, 33, 48), (1, 500, 200, 96), (9, 37, 13, 1),
       (1, 64, 300, 256), (7, 90, 100, 12), (3, 77, 40, 32),
       (2, 64, 256, 576), (10, 50, 12, 384), (1, 1000, 100, 72),
       (1, 2100, 200, 96), (19, 7, 33, 21), (64, 2048, 16, 1),
       # the wide body: ragged a, K and d; a column tile of 250 (8-byte
       # granules)
       (2801, 70, 12, 480), (1, 300, 1000, 5000)]
SHAPES = LM + ODD
MISALIGN = (0, 4, 8, 12)


def test_lm100m_calls_are_the_issue_table():
    """13 PE2 and 5 PE3 calls (rows 13c and 14c), each on the tile route."""
    assert len(LM_PE2) == 13 and len(LM_PE3) == 5
    assert sorted(LM) == sorted(WANT)
    assert LM_PE3 == [(1, 2048, 768, 768), (1, 2048, 768, 1536),
                      (1, 2048, 768, 3072), (1, 2048, 3072, 768),
                      (1, 2048, 768, 32768)]


@pytest.mark.parametrize("shape", LM)
def test_lm100m_call_takes_the_tile_route(shape):
    a, b, c, d = shape
    assert tt_mma.plan(a, b, c, d, 4) is None       # no tensor-core plan
    p = tt_tile.plan(a, b, c, d, 4)
    assert p is not None
    assert (p.tm, p.tn, p.spc, p.ct, p.bn, p.ks, p.cs) == WANT[shape]
    assert p.gz == 16 and p.gg == 16 and p.vec_out == 1


def _cdiv(n, m):
    return -(-n // m)


def _threads(p):
    """(tid, group, tm, tn) of every thread that holds sums, as
    ``gemm`` places them."""
    group = p.wm * p.wn
    out = []
    for tid in range(group * p.ks):
        g, r = divmod(tid, group)
        if p.lm:
            lane, w, wpm = r & 31, r >> 5, p.wm // p.lm
            tm = (w % wpm) * p.lm + lane % p.lm
            tn = (w // wpm) * (32 // p.lm) + lane // p.lm
        else:
            tm, tn = r % p.wm, r // p.wm
        out.append((tid, g, tm, tn))
    return out


def _rows_cols(p, tm, tn):
    """A thread's M rows and N columns in the tile (p.tm/4 runs of 4 rows
    bm/(p.tm/4) apart; p.tn/4 runs of 4 columns bn/(p.tn/4) apart)."""
    mq = p.bm // (p.tm // 4)
    rows = [h * mq + tm * 4 + i for h in range(p.tm // 4) for i in range(4)]
    nq = p.bn // (p.tn // 4)
    cols = [q * nq + tn * 4 + j for q in range(p.tn // 4) for j in range(4)]
    return rows, cols


def _units(p, rank):
    """The write-back units of ``rank``: (slab, n, column) of the tile."""
    vo = 4 if p.vec_out else 1
    per_run = p.ct // vo
    units = p.spc * p.bn * per_run
    lo, hi = rank * units // p.cs, (rank + 1) * units // p.cs
    for u in range(lo, hi):
        q, t = u % per_run, u // per_run
        yield t // p.bn, t % p.bn, q * vo


def _tile_origin(p, tile):
    """(a0, c0, n0) of a tile index, as ``gemm`` decomposes it."""
    if p.m_fast:
        mt, ti_n = tile % p.tiles_m, tile // p.tiles_m
    else:
        mt, ti_n = tile // p.tiles_n, tile % p.tiles_n
    return (mt // p.tiles_c) * p.spc, (mt % p.tiles_c) * p.ct, ti_n * p.bn


def _once(starts_extents, n):
    seen = np.zeros(n, dtype=np.int64)
    for s, e in starts_extents:
        seen[s:s + e] += 1
    return (seen == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_every_output_written_once(shape):
    """Factored (the LM grids are too large to walk here): each K group's
    threads hold every (row, column) of the tile once; the ranks' write-back
    units cover the tile's (slab, n, column) once; the tiles cover a, c and
    d once, and CTA index -> (tile, rank) is one to one."""
    a, b, c, d = shape
    p = tt_tile.layout(a, b, c, d)
    held = np.zeros((p.ks, p.bm, p.bn), dtype=np.int64)
    for _, g, tm, tn in _threads(p):
        rows, cols = _rows_cols(p, tm, tn)
        assert max(rows) < p.bm and max(cols) < p.bn
        held[g][np.ix_(rows, cols)] += 1
    assert (held == 1).all()
    vo = 4 if p.vec_out else 1
    seen = np.zeros((p.spc, p.bn, p.ct), dtype=np.int64)
    for rank in range(p.cs):
        for s, n, col in _units(p, rank):
            seen[s, n, col:col + vo] += 1
    assert (seen == 1).all()
    assert p.spc * p.ct <= p.bm
    assert _once([(t * p.spc, min(p.spc, a - t * p.spc))
                  for t in range(p.runs)], a)
    assert _once([(t * p.ct, min(p.ct, c - t * p.ct))
                  for t in range(p.tiles_c)], c)
    assert _once([(t * p.bn, min(p.bn, d - t * p.bn))
                  for t in range(p.tiles_n)], d)
    if p.grid <= 1 << 16:
        cells = {(_tile_origin(p, bid // p.cs), bid % p.cs)
                 for bid in range(p.grid)}
        assert len(cells) == p.grid == p.tiles * p.cs


@pytest.mark.parametrize("shape", SHAPES)
def test_split_k_ranks_and_groups_take_every_row_once(shape):
    """Under split-K each K row lies in exactly one rank's range (contiguous,
    in rank order, every rank a chunk at least); inside a chunk the K
    groups take its rows once, each group in increasing order."""
    a, b, c, d = shape
    p = tt_tile.layout(a, b, c, d)
    assert 1 <= p.cs <= 8 and p.nk == _cdiv(b, p.bk)
    assert p.kc == _cdiv(p.nk, p.cs) and (p.cs - 1) * p.kc < p.nk
    ranges = [p.k_range(r) for r in range(p.cs)]
    assert ranges[0][0] == 0 and ranges[-1][1] == b
    assert all(r0 < r1 for r0, r1 in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(p.cs - 1))
    seen = np.zeros(p.nk * p.bk, dtype=np.int64)
    for r0, r1 in ranges:
        for k0 in range(r0, r1, p.bk):
            for g in range(p.ks):
                rows = [k0 + k for k in p.group_rows(g)]
                assert rows == sorted(rows)
                seen[rows] += 1
    assert (seen[:b] == 1).all() and p.bk == p.ks * p.kr


@pytest.mark.parametrize("shape", SHAPES)
def test_shared_memory_cluster_threads_and_grid(shape):
    a, b, c, d = shape
    p = tt_tile.layout(a, b, c, d)
    if p.tm == 16:      # the wide body: its tile and pitches are fixed
        assert (p.tn, p.wm, p.wn, p.bm, p.bn, p.ks) == (8, 16, 16, 256, 128, 1)
        assert (p.zp, p.gp, p.kr) == (256, 128, tt_tile.KR_WIDE)
    else:
        assert p.tm == 8 and p.tn in tt_tile.TNS and p.kr in (4, 8, 16)
        assert p.bn == p.wn * p.tn <= 128 and p.bm <= 128
    group = p.wm * p.wn
    assert p.threads % 32 == 0 and group * p.ks <= p.threads
    assert p.threads < group * p.ks + 32
    assert p.threads <= tt_tile.max_threads(p.tn, p.tm)
    if p.lm:
        assert p.wm % p.lm == 0 and p.wn % (32 // p.lm) == 0
    # the ring (3-6 slots) and the output tile that reuses it
    assert tt_tile.MIN_STAGES <= p.stages <= tt_tile.MAX_STAGES
    assert p.smem <= tt_tile.SMEM_MAX == 232_448
    assert p.smem >= p.stages * p.stage >= p.stages * (
        p.bk * p.zp * 4 + p.bk * p.gp * 4)
    assert p.smem >= p.ks * p.bn * p.op * 4
    assert p.z_stage % 16 == 0 and p.stage % 16 == 0
    assert p.zp >= p.bm and p.gp >= p.bn and p.op >= p.bm
    assert p.zp % 4 == 0 and p.gp % 4 == 0 and p.op % 4 == 0
    # a cluster of at most 8; a CTA an SM wherever the tiles and K allow
    assert p.grid == p.tiles * p.cs
    ranks = max(s for s in range(1, 9) if (s - 1) * _cdiv(p.nk, s) < p.nk)
    assert p.grid >= min(tt_tile.SMS, p.tiles * ranks)


@pytest.mark.parametrize("mis", MISALIGN)
@pytest.mark.parametrize("shape", SHAPES)
def test_copy_granules_fit_rows_tiles_and_pointers(shape, mis):
    a, b, c, d = shape
    p = tt_tile.layout(a, b, c, d, mis, mis)
    for gr, row, tile in ((p.gz, c, p.ct), (p.gg, d, p.bn)):
        assert gr in (16, 8, 4)
        assert (row * 4) % gr == 0 and (tile * 4) % gr == 0 and mis % gr == 0
    assert (p.zp * 4) % p.gz == 0 and (p.gp * 4) % p.gg == 0
    assert p.vec_out == int(c % 4 == 0 and p.ct % 4 == 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_indices_stay_under_2_31(shape):
    """The kernel indexes in int: the largest offset into Z, G and O, the
    grid and the write-back units all fit."""
    a, b, c, d = shape
    p = tt_tile.layout(a, b, c, d)
    assert a * b * c <= tt_tile.INT32_MAX and a * d * c <= tt_tile.INT32_MAX
    assert b * d <= tt_tile.INT32_MAX and p.grid <= tt_tile.INT32_MAX
    assert p.cs * p.spc * p.bn * p.ct <= tt_tile.INT32_MAX


def test_route_rules():
    """LM100M's f32 calls take the tiles; the FMNIST MLP's f32 calls
    (rows 13, 14) keep the streamed body; bf16 never takes the tiles, and
    internlm2's bf16 calls stay on the tensor cores."""
    from repro_torch import configs as C
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.models.lm import _walk_sites, build_lm
    mlp = MLP.make_mlp()
    step = {(*zs, gs[1]) for s in (mlp.spec1, mlp.spec2)
            for sp in (s, s.transposed())
            for kind, zs, gs in pe_shapes(sp, 64) if kind == "pe2"}
    step |= {(1, 64, s.in_dim, s.out_dim) for s in (mlp.spec1, mlp.spec2)}
    assert len(step) == 10
    lm = build_lm(C.with_tt(C.get_config("internlm2-1.8b"), quantize=True))
    specs = [site.spec for _, site in _walk_sites(lm) if site.use_tt]
    internlm2 = {(*zs, gs[1]) for s in specs for sp in (s, s.transposed())
                 for kind, zs, gs in pe_shapes(sp, 8 * 256) if kind == "pe2"}
    internlm2 |= {(1, 8 * 256, s.in_dim, s.out_dim) for s in specs}
    assert len(internlm2) == 9
    for shape in LM:
        assert tt_tile.plan(*shape, 4) is not None
        assert tt_tile.plan(*shape, 2) is None
    for shape in sorted(step):
        a, b, c, d = shape
        assert 2 * a * b * c * d < tt_tile.MIN_FLOPS
        assert tt_tile.plan(*shape, 4) is None
        assert tt_mma.plan(*shape, 4) is None
        assert tt_contract.plan(*shape, 4).grid > 0
    for shape in sorted(internlm2):
        assert tt_mma.plan(*shape, 2) is not None
        assert tt_tile.plan(*shape, 2) is None
    assert tt_tile.plan(0, 4, 4, 4, 4) is None


def test_plan_for_reads_dtype_and_alignment():
    """The plan reads the shapes, the dtype and the operands' addresses
    (stride-0 views stand in for LM100M's thin call)."""
    base = torch.zeros(2)
    z = base.as_strided((2048, 384, 96), (0, 0, 0))
    g = torch.zeros((384, 8))
    p = tt_tile.plan_for(z, g)
    assert p is not None and (p.gz, p.gg) == (16, 16)
    zh = base.to(torch.bfloat16).as_strided((2048, 384, 96), (0, 0, 0))
    assert tt_tile.plan_for(zh, g.to(torch.bfloat16)) is None
    q = tt_tile.plan_for(base.as_strided((2048, 384, 96), (0, 0, 0), 1), g)
    assert q is not None and q.gz == 4 and q.gg == 16


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CPU tensor reached the tile route")
    monkeypatch.setattr(tt_tile, "launch", refuse)
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(4, 96, 100).astype(np.float32))
    g = torch.from_numpy(rng.randn(96, 8).astype(np.float32))
    from repro_torch.kernels import ops
    assert torch.equal(ops.pe2(z, g), ttm_pe2.pe2_torch(z, g))
    assert torch.equal(ops.pe3(g, z[0]), ttm_pe3.pe3_torch(g, z[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ttm_pe2.pe2_cuda(z, g)


# ---------------------------------------------------------------------------
# the plain mirror of the kernel's walk
# ---------------------------------------------------------------------------

def _mirror(z: torch.Tensor, g: torch.Tensor, p) -> torch.Tensor:
    """``O(a, d, c)`` the way ``gemm`` walks ``p``: for each CTA (tile,
    rank), the rank's K-chunks in order, each K group's rows of a chunk in
    order, f32 sums over zero-filled tiles; the partial tiles met rank by
    rank, group by group, and the rank's write-back units stored once."""
    a, b, c, d = z.shape[0], z.shape[1], z.shape[2], g.shape[1]
    kpad = p.nk * p.bk
    zp = torch.zeros((p.runs * p.spc, kpad, p.tiles_c * p.ct))
    zp[:a, :b, :c] = z
    gp = torch.zeros((kpad, p.tiles_n * p.bn))
    gp[:b, :d] = g
    out = torch.full((a, d, c), float("nan"))
    count = torch.zeros((a, d, c), dtype=torch.int64)
    for tile in range(p.tiles):
        a0, c0, n0 = _tile_origin(p, tile)
        # the M-tile: slab s's ct columns at rows s * ct ..
        zt = zp[a0:a0 + p.spc, :, c0:c0 + p.ct].permute(1, 0, 2).reshape(
            kpad, p.spc * p.ct)
        gt = gp[:, n0:n0 + p.bn]
        part = torch.zeros((p.cs, p.ks, p.spc * p.ct, p.bn))
        for r in range(p.cs):
            k_lo = r * p.kc * p.bk
            k_hi = min(p.nk, (r + 1) * p.kc) * p.bk
            for k0 in range(k_lo, k_hi, p.bk):
                for grp in range(p.ks):
                    for k in p.group_rows(grp):
                        part[r, grp] += torch.outer(zt[k0 + k], gt[k0 + k])
        total = torch.zeros((p.spc * p.ct, p.bn))
        for r in range(p.cs):
            for grp in range(p.ks):
                total = total + part[r, grp]
        vo = 4 if p.vec_out else 1
        for r in range(p.cs):
            for s, n, col in _units(p, r):
                if a0 + s >= a or n0 + n >= d or c0 + col >= c:
                    continue
                m = s * p.ct + col
                out[a0 + s, n0 + n, c0 + col:c0 + col + vo] = \
                    total[m:m + vo, n]
                count[a0 + s, n0 + n, c0 + col:c0 + col + vo] += 1
    assert (count == 1).all(), "an output not stored once"
    return out


def _rand(shape, seed, scale=1.0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(x)


# small shapes of each tiling: stacked slabs (c = 12, 16, 32), a column
# tile of one slab with K groups (thin d), odd widths, split-K
MIRROR = [(10, 40, 12, 20), (9, 20, 16, 24), (5, 24, 32, 16), (2, 40, 96, 8),
          (1, 36, 200, 12), (3, 50, 13, 7), (1, 300, 40, 36), (4, 33, 7, 1)]


@pytest.mark.parametrize("shape", MIRROR)
def test_mirror_matches_the_plain_version(shape):
    a, b, c, d = shape
    p = tt_tile.layout(a, b, c, d)
    z, g = _rand((a, b, c), 1), _rand((b, d), 2, 0.2)
    got = _mirror(z, g, p)
    np.testing.assert_allclose(got.numpy(), ttm_pe2.pe2_torch(z, g).numpy(),
                               **F32_TOL)
    if a == 1:      # the same call as PE3: Ybar (b, j) = G, X (b, i) = Z[0]
        np.testing.assert_allclose(got[0].numpy(),
                                   ttm_pe3.pe3_torch(g, z[0]).numpy(),
                                   **F32_TOL)


def test_mirror_walks_split_k_and_k_groups():
    """The mirror shapes reach a cluster split and K groups."""
    plans = [tt_tile.layout(*s) for s in MIRROR]
    assert any(p.cs > 1 for p in plans) and any(p.ks > 1 for p in plans)
    assert any(p.spc > 1 for p in plans) and any(p.tiles_c > 1 for p in plans)


@pytest.mark.parametrize("shape", [(8, 48, 12, 40), (2, 64, 96, 8)])
def test_mirror_matches_jax_pe2(shape):
    a, b, c, d = shape
    p = tt_tile.layout(a, b, c, d)
    z, g = _rand((a, b, c), 3), _rand((b, d), 4, 0.2)
    want = np.asarray(JOPS.pe2(jnp.asarray(z.numpy()),
                               jnp.asarray(g.numpy())))
    np.testing.assert_allclose(_mirror(z, g, p).numpy(), want, **F32_TOL)


def test_mirror_matches_jax_pe3():
    b, j, i = 300, 36, 40
    p = tt_tile.layout(1, b, i, j)
    assert p.cs > 1
    y, x = _rand((b, j), 5, 0.2), _rand((b, i), 6)
    want = np.asarray(JOPS.pe3(jnp.asarray(y.numpy()),
                               jnp.asarray(x.numpy())))
    np.testing.assert_allclose(_mirror(x[None], y, p)[0].numpy(), want,
                               **F32_TOL)
