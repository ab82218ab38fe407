"""Launch plans of the PE2 / PE3 kernels (``repro_torch.kernels.tt_contract``)
checked on the CPU, where the kernels cannot run: the plan is a pure
function of the shapes, so its tiling is held here at every PE2/PE3 shape
of the FMNIST training step and at the card tests' odd shapes. The CTA and
thread index math below mirrors ``csrc/tt_contract.cuh::contract``.

Also: the kernel entry points refuse CPU tensors, and ``kernels.ops``
routes CPU tensors to the plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ttm import pe_shapes
from repro_torch.kernels import ops, tt_contract, ttm_pe2, ttm_pe3
from repro_torch.models import mlp_tt as MLP


def _step_shapes():
    """(a, b, c, d) of every PE2 call and every PE3 call (as PE2 at a = 1,
    c = i, d = j) of one FMNIST training step."""
    d = MLP.make_mlp()
    pe2 = [(*zs, gs[1]) for s in (d.spec1, d.spec2)
           for sp in (s, s.transposed())
           for kind, zs, gs in pe_shapes(sp, 64) if kind == "pe2"]
    pe3 = [(1, 64, s.in_dim, s.out_dim) for s in (d.spec1, d.spec2)]
    return sorted(set(pe2)), pe3


STEP_PE2, STEP_PE3 = _step_shapes()
ODD = [(19, 7, 33, 21), (1, 4, 16, 130), (5, 9, 13, 6), (64, 2048, 16, 1),
       (3, 2048, 5, 1), (1, 300, 96, 64), (4, 2048, 40, 48),
       (3, 4096, 33, 5), (9, 37, 33, 7), (64, 112, 128, 4), (6, 33, 20, 2),
       # PE3 (b, j, i) = (130, 47, 65), (8, 1, 300), (2100, 96, 200)
       (1, 130, 65, 47), (1, 8, 300, 1), (1, 2100, 200, 96)]
SHAPES = STEP_PE2 + STEP_PE3 + ODD
ELSIZES = [4, 2]


def test_step_shapes_are_the_issue_table():
    assert STEP_PE2 == sorted([
        (1792, 32, 16, 32), (448, 64, 32, 64), (64, 112, 128, 4),
        (64, 512, 16, 1), (1024, 32, 16, 32), (256, 64, 32, 64),
        (64, 64, 128, 7), (64, 16, 16, 32)])
    assert STEP_PE3 == [(1, 64, 896, 512), (1, 64, 512, 16)]


def _writes(p):
    """How many times each output element (a, d, c) is stored by the grid,
    following the kernel's CTA decomposition and thread placement: b share
    k fastest, then c group, d group, slab; share 0 of each tile stores it
    once the shares have met."""
    count = np.zeros((p.a, p.d, p.c), dtype=np.int64)
    ct, dt = p.ct, p.dt
    for bid in range(p.grid):
        ti_c = bid % p.tiles_c
        t = bid // p.tiles_c
        ti_d, run = t % p.tiles_d, t // p.tiles_d
        a0, c0, d0 = run * p.spc, ti_c * ct, ti_d * dt
        nslab = min(p.spc, p.a - a0)
        ncols, nrows = min(ct, p.c - c0), min(dt, p.d - d0)
        assert nslab > 0 and ncols > 0 and nrows > 0, "an empty CTA"
        for tid in range(p.threads):
            k, t = tid % p.split, tid // p.split
            cgi, t = t % p.cg, t // p.cg
            dgi, s = t % p.dg, t // p.dg
            if k != 0 or s >= p.spc or s >= nslab:
                continue
            for i in range(p.rd):
                dd = dgi * p.rd + i
                if dd >= nrows:
                    continue
                for j in range(4):
                    if cgi * 4 + j < ncols:
                        count[a0 + s, d0 + dd, c0 + cgi * 4 + j] += 1
    return count


@pytest.mark.parametrize("elsize", ELSIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_output_written_once(shape, elsize):
    p = tt_contract.plan(*shape, elsize)
    assert (_writes(p) == 1).all()


@pytest.mark.parametrize("elsize", ELSIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_threads_shared_memory_and_b_split(shape, elsize):
    a, b, c, d = shape
    p = tt_contract.plan(a, b, c, d, elsize)
    # every (slab, d group, c group, share) has a thread; CTA size legal
    assert p.cg * p.dg * p.spc * p.split <= p.threads <= 256
    assert p.threads % 32 == 0 and p.rd in (1, 2, 4)
    # shared memory: the slots, and the partials that reuse them
    assert p.smem <= tt_contract.SMEM_MAX == 232_448
    assert p.smem >= p.stages * p.stage
    assert p.stage % 16 == 0 and p.z_stage % 16 == 0
    assert p.z_stage >= p.spc * p.bc * p.ct * elsize
    assert p.stage - p.z_stage >= p.bc * p.dt * elsize
    # rows padded past 16 bytes; a split over 32 meets in shared memory
    assert p.zp >= p.ct and p.gp >= p.dt and (p.zp * elsize) % p.gz == 0
    assert p.z_stage >= p.spc * p.bc * p.zp * elsize
    assert p.stage - p.z_stage >= p.bc * p.gp * elsize
    if p.split > 32:
        assert p.smem >= 4 * (p.split // 32) * p.cg * p.dg * p.spc * p.rd * 4
    # one stage holding all of b, or a ring of 2-4 slots walking b-chunks
    assert 1 <= p.stages <= 4 and 1 <= p.bc
    assert (p.stages == 1) == (p.bc >= b)
    assert p.stages <= max(1, -(-b // p.bc))
    # the b-split: chunk by chunk, share k takes rows k, k + split, ...;
    # together they take every row of b once, each in increasing order
    seen = np.zeros(b, dtype=np.int64)
    for b0 in range(0, b, p.bc):
        rows = min(p.bc, b - b0)
        for k in range(p.split):
            seen[b0 + np.arange(k, rows, p.split)] += 1
    assert (seen == 1).all()
    # the shares of a tile: a power of two, neighbouring lanes (an xor
    # tree inside a warp, whole warps beyond 32)
    assert p.split & (p.split - 1) == 0
    assert p.split <= 32 or p.split % 32 == 0


@pytest.mark.parametrize("elsize", ELSIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_grid_fills_the_card_where_the_work_allows(shape, elsize):
    a, b, c, d = shape
    p = tt_contract.plan(a, b, c, d, elsize)
    assert p.grid == p.runs * p.tiles_c * p.tiles_d
    independent = a * -(-c // 4) * -(-d // p.rd)   # one 4-wide c group each
    assert p.grid >= min(tt_contract.SMS, independent)


@pytest.mark.parametrize("elsize", ELSIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_copy_granules_fit_rows_tiles_and_pointers(shape, elsize):
    a, b, c, d = shape
    for mis in (0, elsize, 2 * elsize, 3 * elsize):
        p = tt_contract.plan(a, b, c, d, elsize, mis, mis)
        for g, row, tile in ((p.gz, c, p.ct), (p.gg, d, p.dt)):
            assert g in (16, 8, 4, elsize)
            assert (row * elsize) % g == 0 and (tile * elsize) % g == 0
            assert mis % g == 0


def test_step_plans_take_the_fast_paths():
    """At the step's f32 shapes: 16-byte copies of Z, all of b in one
    stage, a wave of CTAs; PE2's d = 1 shape and PE3's 16 x 512 split b."""
    for shape in STEP_PE2 + STEP_PE3:
        p = tt_contract.plan(*shape, 4)
        assert p.gz == 16 and p.grid >= 132 and p.stages == 1, (shape, p)
    assert tt_contract.plan(64, 512, 16, 1, 4).split > 1
    assert tt_contract.plan(1, 64, 512, 16, 4).split > 1
    big = tt_contract.plan(1, 64, 896, 512, 4)      # PE3's 512 x 896
    assert (big.dt, big.ct, big.grid, big.split) == (32, 64, 224, 1)


def test_ring_refill_and_plain_copy_paths_are_exercised_by_the_card_tests():
    """The card tests' odd shapes have more chunks of b than ring slots (a
    slot is refilled) in both dtypes, a b that is no multiple of the chunk,
    and the plain (2-byte) copy in bf16."""
    for shape, es in (((4, 2048, 40, 48), 4), ((3, 4096, 33, 5), 2),
                      ((1, 2100, 200, 96), 2), ((1, 2100, 200, 96), 4)):
        p = tt_contract.plan(*shape, es)
        assert -(-shape[1] // p.bc) > p.stages, (shape, es, p)
    assert 2100 % tt_contract.plan(1, 2100, 200, 96, 4).bc != 0
    assert tt_contract.plan(19, 7, 33, 21, 2).gz == 2


def test_kernel_entry_points_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ttm_pe2.pe2_cuda(torch.randn(3, 4, 5), torch.randn(4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        ttm_pe3.pe3_cuda(torch.randn(4, 2), torch.randn(4, 3))


def test_ops_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached the kernel")
    monkeypatch.setattr(ttm_pe2, "pe2_cuda", refuse)
    monkeypatch.setattr(ttm_pe3, "pe3_cuda", refuse)
    rng = np.random.RandomState(0)
    z, g = (torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in ((3, 4, 5), (4, 2)))
    assert torch.equal(ops.pe2(z, g), ttm_pe2.pe2_torch(z, g))
    y, x = (torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in ((4, 2), (4, 3)))
    assert torch.equal(ops.pe3(y, x), ttm_pe3.pe3_torch(y, x))


# ---------------------------------------------------------------------------
# the zoo LM's step: with_tt(internlm2-1.8b) at 8 x 256 tokens
# ---------------------------------------------------------------------------

def _lm_shapes():
    """PE2 calls of every TT site's forward and transposed chains, and PE3
    (as PE2 at a = 1, c = i, d = j) of every site's Ŵ, at 2,048 rows."""
    from repro_torch import configs as C
    from repro_torch.models.lm import _walk_sites, build_lm
    lm = build_lm(C.with_tt(C.get_config("internlm2-1.8b"), quantize=True))
    specs = [site.spec for _, site in _walk_sites(lm) if site.use_tt]
    pe2 = sorted({(*zs, gs[1]) for s in specs
                  for sp in (s, s.transposed())
                  for kind, zs, gs in pe_shapes(sp, 8 * 256)
                  if kind == "pe2"})
    pe3 = sorted({(1, 8 * 256, s.in_dim, s.out_dim) for s in specs})
    return pe2, pe3


LM_PE2, LM_PE3 = _lm_shapes()
LM = LM_PE2 + LM_PE3


def test_lm_step_shapes_are_the_issue_table():
    assert LM_PE2 == [(2048, 128, 256, 8), (2048, 128, 512, 16),
                      (2048, 256, 256, 8), (16384, 256, 16, 256),
                      (16384, 256, 32, 256), (32768, 256, 16, 256)]
    assert LM_PE3 == [(1, 2048, 2048, 2048), (1, 2048, 2048, 8192),
                      (1, 2048, 8192, 2048)]


def _once(starts_extents, n):
    seen = np.zeros(n, dtype=np.int64)
    for s, e in starts_extents:
        seen[s:s + e] += 1
    return (seen == 1).all()


@pytest.mark.parametrize("elsize", ELSIZES)
@pytest.mark.parametrize("shape", LM)
def test_lm_shapes_write_every_output_once(shape, elsize):
    """``_writes`` factored (the grid is too large to walk here): share 0
    of each (slab, d group, c group) is one thread of the CTA, its rows
    and columns cover the tile once, the tiles cover a, d and c once, and
    CTA index -> (run, d tile, c tile) is one to one."""
    p = tt_contract.plan(*shape, elsize)
    owners = []
    for tid in range(p.threads):
        k, t = tid % p.split, tid // p.split
        cgi, t = t % p.cg, t // p.cg
        dgi, s = t % p.dg, t // p.dg
        if k == 0 and s < p.spc:
            owners.append((s, dgi, cgi))
    assert sorted(owners) == [(s, dg, cg) for s in range(p.spc)
                              for dg in range(p.dg) for cg in range(p.cg)]
    assert _once([(t * p.spc, min(p.spc, p.a - t * p.spc))
                  for t in range(p.runs)], p.a)
    assert _once([(t * p.dt, min(p.dt, p.d - t * p.dt))
                  for t in range(p.tiles_d)], p.d)
    assert _once([(t * p.ct, min(p.ct, p.c - t * p.ct))
                  for t in range(p.tiles_c)], p.c)
    cells = set()
    for bid in range(p.grid):
        t = bid // p.tiles_c
        cells.add((t // p.tiles_d, t % p.tiles_d, bid % p.tiles_c))
    assert len(cells) == p.grid == p.runs * p.tiles_d * p.tiles_c


@pytest.mark.parametrize("elsize", ELSIZES)
@pytest.mark.parametrize("shape", LM)
def test_lm_shapes_fit_the_card_and_32_bit_indices(shape, elsize):
    test_threads_shared_memory_and_b_split(shape, elsize)
    test_grid_fills_the_card_where_the_work_allows(shape, elsize)
    test_copy_granules_fit_rows_tiles_and_pointers(shape, elsize)
    a, b, c, d = shape
    p = tt_contract.plan(a, b, c, d, elsize)
    # the kernels index in int: every tensor under 2^31 elements
    assert a * b * c < 2 ** 31 and b * d < 2 ** 31 and a * d * c < 2 ** 31
    assert p.grid <= 2 ** 31 - 1 and p.grid >= tt_contract.SMS
