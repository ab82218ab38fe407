"""The PE2 / PE3 tensor-core route (``repro_torch.kernels.tt_mma``) checked
on the CPU, where no kernel can run: the plan is a pure function of dtype,
shapes and alignment, so its route, tiling, shared memory and grid are held
here at every PE2 / PE3 call of the ``with_tt(internlm2-1.8b)`` step (the
calls ``chip_smoke.py::_lm_pe_calls`` times), and a plain mirror of the
plan's tile walk (``_mirror``: tiles in the CTAs' order, b-chunks of 64 rows
and k-steps of 16 in order, the TMA's zero fill at ragged edges, f32 sums,
masked stores) is held to ``pe2_torch`` / ``pe3_torch`` within 1e-5 in f32
and to the JAX Pallas kernels (interpret mode) at small shapes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as JOPS
from repro_torch.core.ttm import pe_shapes
from repro_torch.kernels import ops, tt_mma, ttm_pe2, ttm_pe3

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _lm_calls():
    """PE2 calls (a, b, c, d) of every TT site's forward and transposed
    chains, then PE3 calls as PE2 at a = 1 (c = i, d = j), at 2,048 rows."""
    from repro_torch import configs as C
    from repro_torch.models.lm import _walk_sites, build_lm
    lm = build_lm(C.with_tt(C.get_config("internlm2-1.8b"), quantize=True))
    specs = [site.spec for _, site in _walk_sites(lm) if site.use_tt]
    pe2 = sorted({(*zs, gs[1]) for s in specs
                  for sp in (s, s.transposed())
                  for kind, zs, gs in pe_shapes(sp, 8 * 256)
                  if kind == "pe2"})
    pe3 = sorted({(1, 8 * 256, s.in_dim, s.out_dim) for s in specs})
    return pe2 + pe3


LM_CALLS = _lm_calls()
# the step's nine PE2/PE3 calls: (a, b, c, d) -> (tiling, bm, bn, resident)
WANT = {
    (32768, 256, 16, 256): ("stacked", 256, 64, True),
    (16384, 256, 32, 256): ("stacked", 256, 64, True),
    (16384, 256, 16, 256): ("stacked", 256, 64, True),
    (2048, 128, 512, 16): ("thin", 64, 256, True),
    (2048, 256, 256, 8): ("thin", 64, 256, True),
    (2048, 128, 256, 8): ("thin", 64, 256, True),
    (1, 2048, 2048, 8192): ("wide", 128, 256, False),
    (1, 2048, 8192, 2048): ("wide", 128, 256, False),
    (1, 2048, 2048, 2048): ("wide", 128, 256, False),
}


def test_lm_calls_are_the_nine_calls():
    assert sorted(LM_CALLS) == sorted(WANT)


def _cdiv(n, m):
    return -(-n // m)


@pytest.mark.parametrize("shape", sorted(WANT))
def test_lm_call_takes_the_tensor_cores(shape):
    """Route, tiling, shared memory and grid at each of the nine calls."""
    a, b, c, d = shape
    p = tt_mma.plan(a, b, c, d, 2)
    assert p is not None
    orient, bm, bn, resident = WANT[shape]
    assert (p.orientation, p.bm, p.bn, bool(p.resident)) == \
        (orient, bm, bn, resident)
    # the kernel instance exists and holds the warpgroups
    nwg = p.wm * p.wn
    assert nwg <= tt_mma.INSTANCES[(p.wgn, p.sw)]
    assert p.threads == nwg * 128 + (128 if p.wgn == 256 else 32)
    # tiles cover a, d and c once; the grid is persistent
    assert p.tiles_m == _cdiv(d, bm) and p.tiles == p.tiles_m * p.tiles_n
    if orient == "stacked":
        assert p.slabs == 64 // c and p.tiles_c == 1 and p.bw == c
        assert p.tiles_n == _cdiv(a, p.slabs) and p.sw == 2 * c
    else:
        assert p.slabs == 1 and p.tiles_c == _cdiv(c, bn) and p.bw == 64
        assert p.tiles_n == a * p.tiles_c and p.sw == 128
    assert p.grid == min(p.tiles, tt_mma.SMS)
    # shared memory: resident G, the ring, the staging tiles, the barriers
    assert p.nk == _cdiv(b, tt_mma.BK)
    assert p.a_chunk == bm * tt_mma.BK * 2 and p.b_chunk == bn * tt_mma.BK * 2
    assert p.stage == p.b_chunk + (0 if p.resident else p.a_chunk)
    assert p.a_res == (p.nk * p.a_chunk if p.resident else 0)
    assert p.smem == (tt_mma.ALIGN + p.a_res + p.stages * p.stage
                      + nwg * 64 * p.out_pitch + 16 * p.stages + 8)
    assert p.smem <= 232_448 == tt_mma.SMEM_MAX
    assert 2 <= p.stages <= tt_mma.MAX_STAGES
    # one more stage would not fit: the ring is as deep as shared memory
    # allows, up to MAX_STAGES
    assert p.stages == tt_mma.MAX_STAGES or \
        p.smem + p.stage + 16 > tt_mma.SMEM_MAX


@pytest.mark.parametrize("shape", sorted(WANT))
def test_lm_call_layouts_fit_tma_and_wgmma(shape):
    """Swizzle atoms aligned, TMA boxes within 256 a side and 16-byte
    strides, wgmma's N legal, staging rows 16-byte aligned."""
    p = tt_mma.plan(*shape, 2)
    for n in (p.a_chunk, p.b_chunk, p.stage, p.a_res):
        assert n % 1024 == 0        # 128-byte swizzle atoms start aligned
    assert p.bw * 2 <= p.sw and p.bw * 2 in (32, 64, 128)
    assert max(tt_mma.ABOX, tt_mma.BK, p.bw, p.slabs) <= 256
    assert (p.c * 2) % 16 == 0 and (p.d * 2) % 16 == 0
    assert p.wgn in (64, 128, 256) and p.bn % (p.bw * p.slabs) == 0
    assert p.out_pitch % 16 == 0 and p.out_pitch >= p.wgn * 2
    assert len(p.fields) == len(tt_mma.PLAN_FIELDS) == 27
    assert p.gz == p.gg == 0        # both operands on the TMA
    # 32-bit indices inside the kernel: every tensor under 2^31 elements
    a, b, c, d = shape
    assert max(a * b * c, a * d * c, b * d) < 2 ** 31


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(WANT))
def test_f32_takes_the_cuda_cores(shape):
    assert tt_mma.plan(*shape, 4) is None


# (64, 112, 128, 4) and (64, 256, 16, 256) with G 8 bytes off take G's
# rows by granules since then: tests/test_torch_pe_granule.py holds their
# plans (test_cases_the_granules_now_admit)
@pytest.mark.parametrize("case", [
    dict(shape=(64, 256, 16, 255)),        # d = 255: odd rows of G
    dict(shape=(64, 512, 16, 1)),          # d = 1
    dict(shape=(19, 7, 33, 24)),           # c = 33
    dict(shape=(4, 2048, 40, 44)),         # d = 44: G not resident
    dict(shape=(64, 256, 16, 256), z=2),   # Z one element off 16 bytes
    dict(shape=(64, 256, 16, 256), g=2),   # G one element off 16 bytes
])
def test_misaligned_or_odd_bf16_takes_the_cuda_cores(case):
    assert tt_mma.plan(*case["shape"], 2, case.get("z", 0),
                       case.get("g", 0)) is None


@pytest.mark.parametrize("shape", [(64, 256, 16, 256), (5, 9, 32, 8),
                                   (3, 64, 8, 8), (1, 4, 16, 136),
                                   (2, 64, 264, 72)])
def test_aligned_bf16_takes_the_tensor_cores(shape):
    p = tt_mma.plan(*shape, 2)
    assert p is not None
    tt_mma.plan.cache_clear()
    assert tt_mma.plan(*shape, 2) == p     # a pure function of its inputs


@pytest.mark.parametrize("c", [8, 16, 24, 32, 64, 136])
@pytest.mark.parametrize("d", [8, 64, 72, 256, 1024])
def test_stacked_plans_take_one_warpgroup_column(c, d):
    """The stacked store indexes its slabs from the tile's first (no
    per-warpgroup offset along c), so ``launch`` refuses a stacked plan
    with ``wn > 1``: the planner never makes one."""
    for a, b in ((1, 64), (37, 256), (16384, 256)):
        p = tt_mma.plan(a, b, c, d, 2)
        if p is not None and p.slabs > 1:
            assert p.wn == 1 and p.orientation == "stacked"


def test_plan_for_reads_dtype_and_alignment():
    z = torch.zeros((1 + 4 * 64 * 16,), dtype=torch.bfloat16)
    g = torch.zeros((64, 256), dtype=torch.bfloat16)
    aligned = z[:4 * 64 * 16].view(4, 64, 16)
    assert tt_mma.plan_for(aligned, g) is not None
    assert tt_mma.plan_for(aligned.float(), g.float()) is None
    off = z[1:].view(4, 64, 16)
    if (off.data_ptr() % 16) != 0:
        assert tt_mma.plan_for(off, g) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(monkeypatch, dtype):
    """``ops`` sends CPU tensors to the plain versions, whatever the
    plan; the kernel entry points refuse them."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel wrapper")
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(8, 64, 16).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(64, 64).astype(np.float32)).to(dtype)
    with pytest.raises(ValueError):
        ttm_pe2.pe2_cuda(z, g)
    with pytest.raises(ValueError):
        ttm_pe3.pe3_cuda(g, g)
    monkeypatch.setattr(ttm_pe2, "pe2_cuda", refuse)
    monkeypatch.setattr(ttm_pe3, "pe3_cuda", refuse)
    assert torch.equal(ops.pe2(z, g), ttm_pe2.pe2_torch(z, g))
    assert torch.equal(ops.pe3(g, g), ttm_pe3.pe3_torch(g, g))


# ---------------------------------------------------------------------------
# the plain mirror of the tile walk
# ---------------------------------------------------------------------------

def _tiles(p):
    """(d0, a0, c0) of each tile in the order the CTAs walk them, as
    ``csrc/tt_mma.cuh::gemm`` decomposes a tile index (N fastest): rows
    d0.. of d, slabs a0.. (``p.slabs`` of them) and columns c0.. of c."""
    for t in range(p.tiles):
        tm, tn = divmod(t, p.tiles_n)
        yield tm * p.bm, (tn // p.tiles_c) * p.slabs, (tn % p.tiles_c) * p.bn


def _mirror(z: torch.Tensor, g: torch.Tensor, p) -> torch.Tensor:
    """``O(a, d, c)`` the way the kernel walks ``p``: each tile (``_tiles``,
    the CTAs' order) sums A^T B over its b-chunks of ``BK`` rows and their
    k-steps of 16 in order, in f32, from zero-filled tiles (the TMA reads 0
    past every edge); A is G's rows d0.. (``p.bm``), B the tile's columns:
    ``p.slabs`` whole slabs side by side (stacked) or columns c0.. of one
    slab. Every output must be stored once; stores past an edge are
    dropped."""
    a, b, c = z.shape
    d = g.shape[1]
    bk = tt_mma.BK
    a_pad = _cdiv(a, p.slabs) * p.slabs
    c_pad = c if p.slabs > 1 else p.tiles_c * p.bn
    zp = torch.zeros((a_pad, p.nk * bk, c_pad), dtype=torch.float32)
    zp[:a, :b, :c] = z.float()
    gp = torch.zeros((p.nk * bk, p.tiles_m * p.bm), dtype=torch.float32)
    gp[:b, :d] = g.float()
    out = torch.zeros((a_pad, p.tiles_m * p.bm, c_pad), dtype=torch.float32)
    count = torch.zeros(out.shape, dtype=torch.int64)
    for d0, a0, c0 in _tiles(p):
        acc = torch.zeros((p.bm, p.bn), dtype=torch.float32)
        for kc in range(p.nk):
            k0 = kc * bk
            at = gp[k0:k0 + bk, d0:d0 + p.bm]
            if p.slabs > 1:     # slab s's c columns at n = s * c ..
                bt = zp[a0:a0 + p.slabs, k0:k0 + bk, :].permute(
                    1, 0, 2).reshape(bk, p.bn)
            else:
                bt = zp[a0, k0:k0 + bk, c0:c0 + p.bn]
            for ks in range(0, bk, 16):
                acc += at[ks:ks + 16].t() @ bt[ks:ks + 16]
        if p.slabs > 1:
            out[a0:a0 + p.slabs, d0:d0 + p.bm, :] = acc.reshape(
                p.bm, p.slabs, c).permute(1, 0, 2)
            count[a0:a0 + p.slabs, d0:d0 + p.bm, :] += 1
        else:
            out[a0, d0:d0 + p.bm, c0:c0 + p.bn] = acc
            count[a0, d0:d0 + p.bm, c0:c0 + p.bn] += 1
    assert (count[:a, :d, :c] == 1).all(), "an output not stored once"
    return out[:a, :d, :c]


def _cut(shape):
    """A table call cut down for the CPU: a to 64 slabs (PE2), j and i to
    a sixteenth (PE3); each keeps its tiling."""
    a, b, c, d = shape
    if a > 1:
        return (64, b, c, d)
    return (1, b, c // 16, d // 16)


# the plan tests' odd shapes (tests/test_torch_pe_plan.py ODD) with c and d
# rounded up to multiples of 8, so the tensor cores take them: ragged a, b,
# c and d against every tiling
ODD_MMA = [(19, 7, 40, 24), (1, 4, 16, 136), (5, 9, 16, 8), (64, 2048, 16, 8),
           (3, 2048, 8, 8), (1, 300, 96, 64), (4, 2048, 40, 48),
           (3, 4096, 32, 8), (9, 37, 32, 8), (64, 112, 128, 8),
           (6, 33, 24, 8), (1, 130, 72, 48), (1, 8, 304, 8),
           (1, 2100, 200, 96)]


def _rand(shape, seed, scale=1.0):
    """f32 values that bf16 holds exactly (the route's operands)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float()


@pytest.mark.parametrize("shape", sorted({_cut(s) for s in WANT}) + ODD_MMA)
def test_mirror_matches_the_plain_version(shape):
    a, b, c, d = shape
    p = tt_mma.plan(a, b, c, d, 2)
    assert p is not None
    if shape in [_cut(s) for s in WANT]:
        assert p.orientation == WANT[next(
            s for s in WANT if _cut(s) == shape)][0]
    z, g = _rand((a, b, c), 1), _rand((b, d), 2, 0.2)
    want = ttm_pe2.pe2_torch(z, g)
    np.testing.assert_allclose(_mirror(z, g, p).numpy(), want.numpy(),
                               **F32_TOL)
    if a == 1:      # the same call as PE3: Ybar (b, j) = G, X (b, i) = Z[0]
        np.testing.assert_allclose(
            _mirror(z, g, p)[0].numpy(),
            ttm_pe3.pe3_torch(g, z[0]).numpy(), **F32_TOL)


@pytest.mark.parametrize("shape", [(16, 64, 16, 64), (8, 128, 32, 256),
                                   (8, 128, 128, 16)])
def test_mirror_matches_jax_pe2(shape):
    a, b, c, d = shape
    p = tt_mma.plan(a, b, c, d, 2)
    z, g = _rand((a, b, c), 3), _rand((b, d), 4, 0.2)
    jz, jg = jnp.asarray(z.numpy()), jnp.asarray(g.numpy())
    np.testing.assert_allclose(_mirror(z, g, p).numpy(),
                               np.asarray(JOPS.pe2(jz, jg)), **F32_TOL)


def test_mirror_matches_jax_pe3():
    b, j, i = 256, 128, 128
    p = tt_mma.plan(1, b, i, j, 2)
    assert p.orientation == "wide"
    y, x = _rand((b, j), 5, 0.2), _rand((b, i), 6)
    jy, jx = jnp.asarray(y.numpy()), jnp.asarray(x.numpy())
    np.testing.assert_allclose(_mirror(x[None], y, p)[0].numpy(),
                               np.asarray(JOPS.pe3(jy, jx)), **F32_TOL)
