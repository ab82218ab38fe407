"""The PE1 kernel's launch plan (``repro_torch.kernels.ttm_pe1.plan``)
checked on the CPU, where the kernel cannot run: the plan is a pure
function of the shapes, so its tiling is held here at every PE1 shape of
the FMNIST training step and at the card tests' odd shapes. The CTA and
thread index math and the two copy walks below mirror
``csrc/ttm_pe1.cu::pe1_kernel`` (and ``tt_contract.cuh::copy_chunk``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ttm import pe_shapes
from repro_torch.kernels import ttm_pe1
from repro_torch.models import mlp_tt as MLP

SMS = 132
SMEM_MAX = 232_448


def _step_shapes():
    d = MLP.make_mlp()
    return [(*zs, gs[1]) for s in (d.spec1, d.spec2)
            for sp in (s, s.transposed())
            for kind, zs, gs in pe_shapes(sp, 64) if kind == "pe1"]


STEP = _step_shapes()
ODD = [(37, 5, 48, 18), (8, 7, 130, 8), (256, 16, 256, 128), (40, 3, 7, 9),
       (1, 1, 16, 256), (3, 2, 1, 1), (600, 4, 33, 300), (5000, 1, 16, 64)]
SHAPES = STEP + ODD


def test_step_shapes_are_the_issue_table():
    assert STEP == [(3584, 1, 16, 256), (2048, 1, 16, 256),
                    (2048, 1, 16, 256), (64, 1, 16, 256)]


def _writes(p):
    """How many times the grid stores each output (a, d): CTA bid owns
    tile (bid // tiles_d, bid % tiles_d); thread tid = ty * td + tx stores
    rows ty * rm + i of the tile, columns tx * 4 .. + 3."""
    count = np.zeros((p.a, p.d), dtype=np.int64)
    for bid in range(p.grid):
        ti_d, ti_a = bid % p.tiles_d, bid // p.tiles_d
        a0, d0 = ti_a * p.at, ti_d * p.dt
        nrows, ncols = min(p.at, p.a - a0), min(p.dt, p.d - d0)
        for tid in range(p.threads):
            tx, ty = tid % p.td, tid // p.td
            if ty >= p.ta:
                continue
            nc = ncols - tx * 4
            for i in range(p.rm):
                m = ty * p.rm + i
                if m >= nrows:
                    break
                for j in range(min(4, nc)):
                    count[a0 + m, d0 + tx * 4 + j] += 1
    return count


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("elsize", [4, 2])
def test_every_output_stored_once(shape, elsize):
    p = ttm_pe1.plan(*shape, elsize)
    assert (_writes(p) == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("elsize", [4, 2])
def test_fits_the_card_and_the_kernels_limits(shape, elsize):
    p = ttm_pe1.plan(*shape, elsize)
    assert p.rm in (1, 2, 4, 8) and 1 <= p.td <= ttm_pe1.MAX_TD
    assert p.threads % 32 == 0 and p.td * p.ta <= p.threads <= 256
    assert p.zs_bytes % 16 == 0 and p.zs_bytes >= p.at * ttm_pe1.BK * elsize
    assert p.zs_bytes <= ttm_pe1.ZS_MAX
    assert p.smem == p.zs_bytes + ttm_pe1.BK * p.dt * 4 <= SMEM_MAX
    assert p.tiles_a * p.tiles_d == p.grid
    assert p.vec_out == int(p.d % 4 == 0)
    assert len(p.fields) == 16 and list(p.fields)[:4] == list(shape)


def test_step_shapes_fill_the_card_and_a64_stays_small():
    for shape in STEP:
        p = ttm_pe1.plan(*shape, 4)
        if shape[0] >= 2048:
            assert 8 * p.grid >= 7 * SMS, p
        else:
            assert p.grid <= 16, p
        assert (p.gz, p.gg) == (16, 16)    # c = 16: 16-byte cp.async


@pytest.mark.parametrize("c", [1, 3, 7, 16, 33, 48, 130])
@pytest.mark.parametrize("elsize", [4, 2])
@pytest.mark.parametrize("misalign", [0, 2, 4, 8, 12])
def test_granules_divide_rows_chunks_and_pointers(c, elsize, misalign):
    if misalign % elsize:
        return
    p = ttm_pe1.plan(9, 2, c, 12, elsize, misalign, 0)
    for g, mis in ((p.gz, misalign), (p.gg, 0)):
        assert g in (16, 8, 4, 2) and g >= elsize
        assert (c * elsize) % g == 0 and (ttm_pe1.BK * elsize) % g == 0
        assert mis % g == 0


def _stage_g_walk(p, elsize):
    """The transposed G staging of one chunk: every (column, granule) of
    the tile visited once, columns fastest, in batches of four."""
    e = p.gg // elsize
    gq = ttm_pe1.BK // e
    dt, nt = p.dt, p.threads
    seen = np.zeros((dt, gq), dtype=np.int64)
    for tid in range(nt):
        n, q, sn, sq = tid % dt, tid // dt, nt % dt, nt // dt
        while q < gq:
            for _ in range(4):
                if q < gq:
                    seen[n, q] += 1
                n += sn
                if n >= dt:
                    n -= dt
                    q += 1
                q += sq
    return seen


def _z_copy_walk(p, elsize):
    """tt_contract::copy_chunk's (row, granule) walk over the Z tile."""
    e = p.gz // elsize
    zq = ttm_pe1.BK // e

    def digits(f):
        return f % zq, (f // zq) % p.at, f // (zq * p.at)
    seen = np.zeros((p.at, zq), dtype=np.int64)
    sg, sr, sq = digits(p.threads)
    for tid in range(p.threads):
        g, r, q = digits(tid)
        while q < 1:
            seen[r, g] += 1
            g += sg
            if g >= zq:
                g -= zq
                r += 1
            r += sr
            if r >= p.at:
                r -= p.at
                q += 1
            q += sq
    return seen


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("elsize", [4, 2])
def test_copy_walks_cover_each_granule_once(shape, elsize):
    p = ttm_pe1.plan(*shape, elsize)
    assert (_stage_g_walk(p, elsize) == 1).all()
    assert (_z_copy_walk(p, elsize) == 1).all()


def test_plan_refuses_bad_shapes_and_cpu_tensors_route_to_plain():
    with pytest.raises(ValueError):
        ttm_pe1.plan(4, 1, 16, 8, 3)
    with pytest.raises(ValueError):
        ttm_pe1.plan(-1, 1, 16, 8, 4)
    z, g = torch.randn(5, 2, 3), torch.randn(2, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ttm_pe1.pe1_cuda(z, g)
    assert ttm_pe1.plan(0, 1, 16, 8, 4).grid == 0
