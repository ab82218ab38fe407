"""The PE1 / PE2 tensor-core routes on cp.async granules, checked on the
CPU, where no kernel can run: rows of c or d that are not a multiple of 16
bytes (or operands off a 16-byte boundary) are staged by 4- or 8-byte
granules into the swizzled shared-memory tiles the TMA would have written
(``csrc/tt_mma.cuh::stage_slabs`` / ``stage_g``, ``csrc/ttm_pe1.cu::
stage_rows``). Held here: the plans at the ten bf16 PE calls of the
frontends' train steps (``with_tt(hubert-xlarge)``, ``with_tt(llava-next-
34b)``) that the tensor cores refused before, every other call of those
steps and of the ``with_tt(internlm2-1.8b)`` step on its earlier plan
field for field, the route rule at odd shapes and offsets, and plain
mirrors of the granule walks: each producer thread's granules as the
kernels walk them into byte-addressed tiles under the swizzle (ring slots
reused, stale bytes where no copy writes), read back through wgmma's view
of the tile, summed in f32 k-step by k-step, stored through the masks;
held to ``pe1_torch`` / ``pe2_torch`` / ``pe3_torch`` within 1e-5 in f32
and to the JAX Pallas kernels (interpret mode) at small shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as JOPS
from repro_torch.kernels import tt_mma, ttm_pe1, ttm_pe2, ttm_pe3

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BK = tt_mma.BK


def _cdiv(n, m):
    return -(-n // m)


def _plan(kind, key):
    """The tensor-core plan of a call keyed (a, b, c, d) as PE2 (PE3 at
    a = 1) or PE1."""
    if kind == "pe1":
        return ttm_pe1.plan_pe1(*key, 2)
    return tt_mma.plan(*key, 2)


def _step_calls(arch, layers, rows):
    """{(kind, (a, b, c, d))} of a model's TT train step at ``rows`` rows:
    every site's forward and transposed chains and its Ŵ (PE3 as PE2 at
    a = 1, c = in, d = out)."""
    from repro_torch import configs as C
    from repro_torch.core.ttm import pe_shapes
    from repro_torch.models.lm import _walk_sites, build_lm
    cfg = C.get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    lm = build_lm(C.with_tt(cfg, quantize=True))
    out = set()
    for path, site in _walk_sites(lm):
        if not site.use_tt or path[0] == "embed":
            continue
        s = site.spec
        for sp in (s, s.transposed()):
            for kind, zs, gs in pe_shapes(sp, rows):
                out.add((kind, (*zs, gs[1])))
        out.add(("pe3", (1, rows, s.in_dim, s.out_dim)))
    return out


# ---------------------------------------------------------------------------
# the plans: the ten frontend calls, and every earlier call unchanged
# ---------------------------------------------------------------------------

# the frontends' calls the tensor cores refused before (c or d not a
# multiple of 8): (kind, (a, b, c, d)) -> (tiling, gz, gg, stages, smem);
# PE1's tiling is its (bm, bn), its granules both operands'
TEN = {
    ("pe1", (524288, 1, 20, 256)): ((128, 256), 8, 8, 8, 214152),
    ("pe1", (131072, 1, 28, 256)): ((128, 256), 8, 8, 8, 214152),
    ("pe1", (131072, 1, 28, 448)): ((64, 512), 8, 8, 8, 197768),
    ("pe1", (131072, 1, 28, 512)): ((64, 512), 8, 8, 8, 197768),
    ("pe2", (16384, 160, 20, 256)): ("stacked", 8, 0, 8, 197768),
    ("pe2", (2048, 128, 256, 10)): ("thin", 0, 4, 5, 216152),
    ("pe2", (512, 256, 1024, 20)): ("thin", 0, 8, 4, 199752),
    ("pe2", (4096, 256, 28, 256)): ("stacked", 8, 0, 8, 230536),
    ("pe2", (8192, 256, 28, 256)): ("stacked", 8, 0, 8, 230536),
    ("pe2", (10240, 512, 28, 256)): ("stacked", 8, 0, 4, 197704),
}

# the with_tt(internlm2-1.8b) step's twelve calls, field for field as the
# plans gave them before granules (the new fields gz, gg / gran are 0)
LM_PLANS = {
    ("pe1", (262144, 1, 16, 256)): (262144, 16, 256, 256, 32, 1, 2, 1, 2048, 1, 2048, 132, 288, 8, 2, 4096, 8192, 32768, 173192),
    ("pe1", (262144, 1, 16, 512)): (262144, 16, 512, 256, 32, 1, 1, 2, 4096, 1, 4096, 132, 288, 8, 2, 2048, 16384, 32768, 165000),
    ("pe1", (524288, 1, 32, 256)): (524288, 32, 256, 256, 64, 2, 2, 1, 4096, 1, 4096, 132, 288, 8, 2, 8192, 16384, 32768, 214152),
    ("pe2", (32768, 256, 16, 256)): (32768, 256, 16, 256, 64, 32, 4, 1, 4, 8, 1, 4, 16, 1, 1, 8192, 8192, 132, 544, 32768, 8192, 8192, 131072, 128, 230536),
    ("pe2", (16384, 256, 32, 256)): (16384, 256, 32, 256, 64, 64, 4, 1, 4, 8, 1, 2, 32, 1, 1, 8192, 8192, 132, 544, 32768, 8192, 8192, 131072, 128, 230536),
    ("pe2", (16384, 256, 16, 256)): (16384, 256, 16, 256, 64, 32, 4, 1, 4, 8, 1, 4, 16, 1, 1, 4096, 4096, 132, 544, 32768, 8192, 8192, 131072, 128, 230536),
    ("pe2", (2048, 128, 512, 16)): (2048, 128, 512, 16, 128, 128, 1, 2, 2, 5, 1, 1, 64, 1, 2, 4096, 4096, 132, 288, 8192, 32768, 32768, 16384, 272, 216152),
    ("pe2", (2048, 256, 256, 8)): (2048, 256, 256, 8, 128, 128, 1, 2, 4, 4, 1, 1, 64, 1, 1, 2048, 2048, 132, 288, 8192, 32768, 32768, 32768, 272, 199752),
    ("pe2", (2048, 128, 256, 8)): (2048, 128, 256, 8, 128, 128, 1, 2, 2, 5, 1, 1, 64, 1, 1, 2048, 2048, 132, 288, 8192, 32768, 32768, 16384, 272, 216152),
    ("pe3", (1, 2048, 2048, 8192)): (1, 2048, 2048, 8192, 256, 128, 2, 1, 32, 3, 0, 1, 64, 64, 8, 8, 512, 132, 384, 16384, 32768, 49152, 0, 528, 216120),
    ("pe3", (1, 2048, 8192, 2048)): (1, 2048, 8192, 2048, 256, 128, 2, 1, 32, 3, 0, 1, 64, 16, 32, 32, 512, 132, 384, 16384, 32768, 49152, 0, 528, 216120),
    ("pe3", (1, 2048, 2048, 2048)): (1, 2048, 2048, 2048, 256, 128, 2, 1, 32, 3, 0, 1, 64, 16, 8, 8, 128, 128, 384, 16384, 32768, 49152, 0, 528, 216120),
}

FRONTENDS = (("hubert-xlarge", None, 8 * 256), ("llava-next-34b", 2, 2 * 256))


@pytest.fixture(scope="module")
def frontend_calls():
    return set().union(*(_step_calls(*f) for f in FRONTENDS))


def _old_rule(kind, key):
    """The tensor cores' rule before granules (aligned operands): c and d
    multiples of 8 (and PE1's b = 1, c <= 64)."""
    a, b, c, d = key
    return c % 8 == 0 and d % 8 == 0 and (
        kind != "pe1" or (b == 1 and c <= ttm_pe1.MAX_C))


def test_frontend_calls_refused_before_are_the_ten(frontend_calls):
    assert {c for c in frontend_calls if not _old_rule(*c)} == set(TEN)


def test_every_frontend_call_takes_the_tensor_cores(frontend_calls):
    for kind, key in frontend_calls:
        assert _plan(kind, key) is not None, (kind, key)


def test_lm_calls_are_the_twelve():
    assert _step_calls("internlm2-1.8b", None, 8 * 256) == set(LM_PLANS)


@pytest.mark.parametrize("call", sorted(LM_PLANS))
def test_lm_call_keeps_its_plan(call):
    """Field for field the plan the call had before granules; the
    granule fields are 0 (the TMA)."""
    kind, key = call
    t = dataclasses.astuple(_plan(kind, key))
    want = LM_PLANS[call]
    assert t[:len(want)] == want and not any(t[len(want):])


def test_frontend_calls_on_the_tma_keep_no_granules(frontend_calls):
    for kind, key in frontend_calls:
        if _old_rule(kind, key):
            p = _plan(kind, key)
            assert (p.gran if kind == "pe1" else p.gz or p.gg) == 0


@pytest.mark.parametrize("call", sorted(TEN))
def test_frontend_call_plan(call):
    """Route, tiling, granules, padding, shared memory and grid at each of
    the ten calls."""
    kind, (a, b, c, d) = call
    tiling, gz, gg, stages, smem = TEN[call]
    p = _plan(kind, (a, b, c, d))
    assert p is not None and p.stages == stages and p.smem == smem
    assert p.smem <= tt_mma.SMEM_MAX and p.grid == min(p.tiles, tt_mma.SMS)
    if kind == "pe1":
        assert (p.bm, p.bn) == tiling and p.gran == gz == gg
        # K = c padded to two k-steps of 16 in one 64-byte swizzle row
        assert (p.ksteps, p.sw) == (2, 64) and p.ksteps * 16 > c
        assert (2 * c) % p.gran == 0 and (2 * c) % 16      # off the TMA
        assert p.tiles_m == _cdiv(a, p.bm) and p.tiles_n == 1
        assert p.g_bytes == p.bn * p.sw >= d * p.sw
        assert p.threads == p.wm * p.wn * 128 + 32       # one producer warp
        return
    assert p.orientation == tiling and (p.gz, p.gg) == (gz, gg)
    assert p.nk == _cdiv(b, BK)                           # b padded to 64s
    if tiling == "stacked":
        # whole slabs of c side by side in N = 64, the rest unstored
        assert p.slabs == 64 // c and p.slabs * c <= 64 < (p.slabs + 1) * c
        assert (p.wgn, p.sw, p.wn, p.bw) == (64, 128, 1, c)
        assert p.tiles_n == _cdiv(a, p.slabs) and p.tiles_m == 1
        assert p.threads == p.wm * 128 + 128      # a producer warpgroup
        assert (2 * c) % p.gz == 0 and (2 * c) % 16 and (c * d) % 8 == 0
        assert p.resident == int(b <= 256)        # G at b = 512: 256 KB
    else:
        # G's rows of 20 or 40 bytes resident on granules, zero past d up
        # to the 64 rows of M; Z on the TMA
        assert (p.wgn, p.wm, p.wn, p.slabs) == (128, 1, 2, 1)
        assert p.resident and (2 * d) % p.gg == 0 and (2 * d) % 16
        assert p.a_res == p.nk * p.a_chunk and c % 8 == 0
        assert p.threads == 2 * 128 + 32


@pytest.mark.parametrize("call", sorted(TEN))
def test_frontend_call_fields_fit_the_kernels(call):
    """The C side's field counts, and the 32-bit indices."""
    kind, (a, b, c, d) = call
    p = _plan(kind, (a, b, c, d))
    n = len(ttm_pe1.MMA_FIELDS) if kind == "pe1" else len(tt_mma.PLAN_FIELDS)
    assert len(p.fields) == n == (20 if kind == "pe1" else 27)
    sizes = (a * c, d * c, a * d) if kind == "pe1" else \
        (a * b * c, b * d, a * d * c)
    assert max(sizes) < 2 ** 31


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # PE2: Z on granules (stacked), G on granules (resident), both
    dict(shape=(7, 100, 20, 256), gz=8, gg=0, tiling="stacked"),
    dict(shape=(7, 100, 22, 256), gz=4, gg=0, tiling="stacked"),
    dict(shape=(3, 7, 2, 200), gz=4, gg=0, tiling="stacked"),
    dict(shape=(9, 160, 16, 256), z=8, gz=8, gg=0, tiling="stacked"),
    dict(shape=(9, 160, 32, 256), z=4, gz=4, gg=0, tiling="stacked"),
    dict(shape=(6, 33, 20, 2), gz=8, gg=4, tiling="stacked"),
    dict(shape=(1, 4, 16, 130), gz=0, gg=4, tiling="stacked"),
    dict(shape=(3, 128, 256, 10), gz=0, gg=4, tiling="thin"),
    dict(shape=(7, 300, 64, 16), g=4, gz=0, gg=4, tiling="thin"),
    dict(shape=(7, 300, 64, 16), g=8, gz=0, gg=8, tiling="thin"),
    dict(shape=(2, 64, 264, 62), gz=0, gg=4, tiling="thin"),
])
def test_granules_take_even_rows_and_4_byte_offsets(case):
    a, b, c, d = case["shape"]
    p = tt_mma.plan(a, b, c, d, 2, case.get("z", 0), case.get("g", 0))
    assert p is not None and p.orientation == case["tiling"]
    assert (p.gz, p.gg) == (case["gz"], case["gg"])
    # the producer: a warpgroup for Z's granules (and under 64 x 256)
    assert p.threads == p.wm * p.wn * 128 + (
        128 if p.gz or p.wgn == 256 else 32)
    assert (p.wgn, p.sw) in tt_mma.INSTANCES


@pytest.mark.parametrize("case", [
    dict(shape=(9, 160, 21, 256)),            # c odd
    dict(shape=(9, 160, 20, 255)),            # d odd
    dict(shape=(9, 160, 20, 256), z=2),       # Z 2 bytes off
    dict(shape=(9, 160, 16, 256), g=6),       # G 2 bytes off a granule
    dict(shape=(9, 160, 36, 256)),            # Z on granules past c = 32
    dict(shape=(9, 160, 22, 2)),              # slab runs of 88 bytes
    dict(shape=(4, 2048, 40, 44)),            # G on granules, not resident
    dict(shape=(1, 64, 256, 100)),            # G on granules, wide tiling
])
def test_other_rows_stay_on_the_cuda_cores(case):
    assert tt_mma.plan(*case["shape"], 2, case.get("z", 0),
                       case.get("g", 0)) is None


@pytest.mark.parametrize("case", [
    dict(shape=(64, 1, 12, 256), gran=8),
    dict(shape=(64, 1, 20, 256), z=4, gran=4),
    dict(shape=(64, 1, 16, 256), g=8, gran=8),
    dict(shape=(64, 1, 16, 256), z=8, g=4, gran=4),
    dict(shape=(9, 1, 2, 8), gran=4),
    dict(shape=(9, 1, 62, 1024), gran=4),
])
def test_pe1_granules_take_even_c(case):
    a, b, c, d = case["shape"]
    p = ttm_pe1.plan_pe1(a, b, c, d, 2, case.get("z", 0), case.get("g", 0))
    assert p is not None and p.gran == case["gran"]
    assert p.ksteps == _cdiv(c, 16) and p.ksteps * 32 <= p.sw


@pytest.mark.parametrize("case", [
    dict(shape=(64, 1, 21, 256)),              # c odd
    dict(shape=(64, 1, 20, 252)),              # d off a multiple of 8
    dict(shape=(64, 1, 20, 256), z=2),         # 2 bytes off
    dict(shape=(64, 1, 20, 256), g=10),
    dict(shape=(64, 2, 20, 256)),              # b = 2
    dict(shape=(64, 1, 66, 256)),              # K past one 128-byte row
])
def test_pe1_other_rows_stay_on_the_cuda_cores(case):
    assert ttm_pe1.plan_pe1(*case["shape"], 2, case.get("z", 0),
                            case.get("g", 0)) is None


# the cases tests/test_torch_pe_mma.py and tests/test_torch_pe1_mma.py held
# on the CUDA cores before granules, with the plans they take now
MOVED = [
    ("pe2", dict(shape=(64, 112, 128, 4)), ("thin", 0, 8)),
    ("pe2", dict(shape=(64, 256, 16, 256), g=8), ("stacked", 0, 8)),
    ("pe1", dict(shape=(64, 1, 12, 256)), 8),
    ("pe1", dict(shape=(64, 1, 16, 256), g=8), 8),
]


@pytest.mark.parametrize("kind,case,want", MOVED)
def test_cases_the_granules_now_admit(kind, case, want):
    a, b, c, d = case["shape"]
    args = (a, b, c, d, 2, case.get("z", 0), case.get("g", 0))
    if kind == "pe1":
        p = ttm_pe1.plan_pe1(*args)
        assert p is not None and p.gran == want and (p.bm, p.bn) == (128, 256)
    else:
        p = tt_mma.plan(*args)
        assert p is not None and (p.orientation, p.gz, p.gg) == want
        assert p.resident


# ---------------------------------------------------------------------------
# plain mirrors of the granule walks
# ---------------------------------------------------------------------------

def _swz(o, sw):
    """``tt_mma::swz<SW>``: byte o of a tile of sw-byte rows, swizzled."""
    return o ^ ((o >> 3) & (sw - 16))


def _put(tile, dst, vals):
    """A granule's bf16 values (f32 here) at byte ``dst`` of a tile held
    as one value per 2 bytes; counts the writes per value."""
    i = dst // 2
    tile[0][i:i + len(vals)] = vals
    tile[1][i:i + len(vals)] += 1


def _stage_slabs(tile, z, a0, k0, p, n_threads):
    """``stage_slabs<GR, N>``: thread t of N takes the (slab, row) pairs
    t, t + N, ... and copies each pair's row of Z granule by granule to
    byte 2 c s of tile row k (swizzled); rows past b and slabs past a are
    zeros."""
    a, b, c = z.shape
    gr, row = p.gz, 2 * c
    el = gr // 2
    for t in range(n_threads):
        for i in range(t, p.slabs * BK, n_threads):
            s, k = divmod(i, BK)
            ok = a0 + s < a and k0 + k < b
            for q in range(0, row, gr):
                vals = z[a0 + s, k0 + k, q // 2:q // 2 + el] if ok else \
                    np.zeros(el, np.float32)
                _put(tile, k * 128 + ((s * row + q) ^ ((k & 7) << 4)), vals)


def _stage_g(a_res, g, p, n_threads):
    """``stage_g<GR>``: G's rows into the resident A tiles, box by box."""
    b, d = g.shape
    gr, row = p.gg, 2 * d
    gpr, el = row // gr, gr // 2
    for t in range(n_threads):
        for e in range(t, b * gpr, n_threads):
            k, x = e // gpr, (e % gpr) * gr
            r = k % BK
            _put(a_res, (k // BK) * p.a_chunk + (x >> 7) * (64 * BK * 2)
                 + r * 128 + ((x & 127) ^ ((r & 7) << 4)),
                 g[k, x // 2:x // 2 + el])


def _read_mn(tile, base, rows, cols):
    """wgmma's view of an MN-major operand under the 128-byte swizzle:
    element (k, n) at base + (n // 64) LBO + k * 128 + 2 (n % 64)."""
    k = np.arange(rows)[:, None]
    n = np.arange(cols)[None, :]
    o = (n // 64) * (BK * 128) + k * 128 + (n % 64) * 2
    return tile[0][(base + _swz(o, 128)) // 2]


def _mirror_pe2(z, g, p, grid=None):
    """``O(a, d, c)`` the way ``gemm`` walks a plan with granules: a
    persistent CTA's ring slots (stale NaN where no copy writes) filled
    chunk by chunk by the producer's granules (Z) or the TMA's zero-filled
    boxes, G resident (granules over zeros) or streamed, A^T B summed in
    f32 k-step by k-step, the epilogue's slab columns stored (stacked,
    columns past slabs * c dropped) or rows (thin), masked at a and d."""
    z, g = z.numpy(), g.numpy()
    a, b, c = z.shape
    d = g.shape[1]
    grid = grid or p.grid
    bm, bn = p.bm, p.bn
    nprod = 128 if p.gz or p.wgn == 256 else 32
    gpad = np.zeros((p.nk * BK, p.tiles_m * bm), np.float32)
    gpad[:b, :d] = g
    if p.resident and p.gg:
        a_res = [np.zeros(p.a_res // 2, np.float32), np.zeros(p.a_res // 2)]
        _stage_g(a_res, g, p, nprod)
        assert a_res[1].max() == 1 and a_res[1].sum() == b * d
    out = np.full((a, d, c), np.nan, np.float32)
    count = np.zeros((a, d, c), np.int64)
    for cta in range(grid):
        ring = [[np.full(p.b_chunk // 2, np.nan, np.float32),
                 np.zeros(p.b_chunk // 2)] for _ in range(p.stages)]
        st = 0
        for t in range(cta, p.tiles, grid):
            tm, tn = divmod(t, p.tiles_n)
            d0, a0 = tm * bm, (tn // p.tiles_c) * p.slabs
            c0 = (tn % p.tiles_c) * bn
            acc = np.zeros((bm, bn), np.float32)
            for kc in range(p.nk):
                slot = ring[st]
                st = (st + 1) % p.stages
                k0 = kc * BK
                if p.gz:
                    slot[1][:] = 0
                    _stage_slabs(slot, z, a0, k0, p, nprod)
                    # each granule of the slabs' rows written once
                    assert slot[1].max() == 1 and \
                        slot[1].sum() == p.slabs * BK * c
                    bt = _read_mn(slot, 0, BK, bn)
                else:           # the TMA's boxes, zero past every edge
                    bt = np.zeros((BK, bn), np.float32)
                    kk = min(b - k0, BK)
                    if p.slabs > 1:     # whole slabs side by side
                        for s in range(min(p.slabs, a - a0)):
                            bt[:kk, s * c:(s + 1) * c] = z[a0 + s, k0:k0 + kk]
                    elif a0 < a:        # columns c0.. of slab a0
                        cc = max(0, min(c - c0, bn))
                        bt[:kk, :cc] = z[a0, k0:k0 + kk, c0:c0 + cc]
                if p.resident and p.gg:
                    at = _read_mn(a_res, kc * p.a_chunk, BK, bm)
                else:
                    at = gpad[k0:k0 + BK, d0:d0 + bm]
                for ks in range(0, BK, 16):
                    acc += at[ks:ks + 16].T @ bt[ks:ks + 16]
            rows = max(0, min(bm, d - d0))
            if p.slabs > 1:
                for n in range(bn):
                    s = n // c
                    if s >= p.slabs or a0 + s >= a:
                        continue
                    out[a0 + s, d0:d0 + rows, n % c] = acc[:rows, n]
                    count[a0 + s, d0:d0 + rows, n % c] += 1
            else:
                n = max(0, min(bn, c - c0))
                out[a0, d0:d0 + rows, c0:c0 + n] = acc[:rows, :n]
                count[a0, d0:d0 + rows, c0:c0 + n] += 1
    assert (count == 1).all(), "an output not stored once"
    return torch.from_numpy(out)


def _stage_rows(tile, src, r0, n, rows, c, gr, sw):
    """``stage_rows<SW, GR>``: lane l of 32 walks granules l, l + 32, ...
    of rows r0 .. r0 + n - 1 by the kernel's counters; rows past ``rows``
    are zeros."""
    row = 2 * c
    gpr, el = row // gr, gr // 2
    dr, dq = 32 // gpr, 32 % gpr
    for lane in range(32):
        r, q = lane // gpr, lane % gpr
        for _ in range(lane, n * gpr, 32):
            ok = r0 + r < rows
            vals = src[r0 + r, q * el:(q + 1) * el] if ok else \
                np.zeros(el, np.float32)
            _put(tile, _swz(r * sw + q * gr, sw), vals)
            q, r = q + dq, r + dr
            if q >= gpr:
                q, r = q - gpr, r + 1


def _read_k(tile, base, rows, k, sw):
    """wgmma's view of a K-major operand whose K fits one sw-byte row:
    element (r, k) at base + r * sw + 2 k, swizzled."""
    r = np.arange(rows)[:, None]
    kk = np.arange(k)[None, :]
    return tile[0][(base + _swz(r * sw + kk * 2, sw)) // 2]


def _mirror_pe1(z, g, p, grid=None):
    """``Y(a, d)`` the way ``pe1_mma_kernel`` walks a plan on granules:
    shared memory zeroed at the start, G's rows staged once, Z's rows of
    each tile into the ring's slots (reused; rows past a zero-filled),
    each warpgroup's 64 rows against its wgn rows of G over k-steps of 16,
    f32 sums, stores dropped past a and d."""
    zz, gg = z[:, 0, :].numpy(), g[0].numpy()
    a, c = zz.shape
    d = gg.shape[0]
    grid = grid or p.grid
    kp = p.ksteps * 16
    out = np.full((a, d), np.nan, np.float32)
    count = np.zeros((a, d), np.int64)
    for cta in range(grid):
        g_res = [np.zeros(p.g_bytes // 2, np.float32), np.zeros(p.g_bytes // 2)]
        _stage_rows(g_res, gg, 0, d, d, c, p.gran, p.sw)
        assert g_res[1].max() == 1 and g_res[1].sum() == d * c
        bt_all = _read_k(g_res, 0, p.tiles_n * p.bn, kp, p.sw)
        ring = [[np.zeros(p.stage // 2, np.float32), np.zeros(p.stage // 2)]
                for _ in range(p.stages)]
        st = 0
        for t in range(cta, p.tiles, grid):
            tm, tn = divmod(t, p.tiles_n)
            slot = ring[st]
            st = (st + 1) % p.stages
            slot[1][:] = 0
            _stage_rows(slot, zz, tm * p.bm, p.bm, a, c, p.gran, p.sw)
            assert slot[1].max() == 1 and slot[1].sum() == p.bm * c
            for wg in range(p.wm * p.wn):
                wmi, wni = divmod(wg, p.wn)
                m0, n0 = tm * p.bm + 64 * wmi, tn * p.bn + p.wgn * wni
                at = _read_k(slot, wmi * 64 * p.sw, 64, kp, p.sw)
                bt = bt_all[n0:n0 + p.wgn]
                acc = np.zeros((64, p.wgn), np.float32)
                for ks in range(0, kp, 16):
                    acc += at[:, ks:ks + 16] @ bt[:, ks:ks + 16].T
                rows = max(0, min(64, a - m0))
                n = max(0, min(p.wgn, d - n0))
                out[m0:m0 + rows, n0:n0 + n] = acc[:rows, :n]
                count[m0:m0 + rows, n0:n0 + n] += 1
    assert (count == 1).all(), "an output not stored once"
    return torch.from_numpy(out)


def _rand(shape, seed, scale=1.0):
    """f32 values that bf16 holds exactly (the route's operands)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float()


# small shapes of every granule case: Z's slabs at c = 20 / 28 (the
# frontends'), 22 / 2 (4-byte granules), ragged a, b and d, G streamed
# (b = 520: 4 chunks past a resident G), G's rows of d = 10 / 20 (the
# frontends') and 2 / 130 on granules
PE2_CASES = [(7, 100, 20, 64), (5, 160, 20, 256), (4, 70, 28, 72),
             (3, 200, 28, 256), (5, 40, 22, 64), (3, 7, 2, 200),
             (3, 520, 28, 256), (6, 33, 20, 2), (3, 128, 256, 10),
             (2, 256, 1024, 20), (2, 64, 40, 20), (1, 4, 16, 130),
             (4, 64, 20, 10)]


@pytest.mark.parametrize("shape", PE2_CASES)
def test_pe2_granule_mirror_matches_the_plain_version(shape):
    a, b, c, d = shape
    p = tt_mma.plan(a, b, c, d, 2)
    assert p is not None and (p.gz or p.gg)
    z, g = _rand((a, b, c), 1), _rand((b, d), 2, 0.2)
    np.testing.assert_allclose(_mirror_pe2(z, g, p, grid=2).numpy(),
                               ttm_pe2.pe2_torch(z, g).numpy(), **F32_TOL)


@pytest.mark.parametrize("shape", [(300, 20, 256), (64, 28, 100),
                                   (130, 256, 10)])
def test_pe3_granule_mirror_matches_the_plain_version(shape):
    """PE3 (Ybar (b, j), X (b, i)) as PE2 at a = 1: Z = X, G = Ybar."""
    b, i, j = shape
    p = tt_mma.plan(1, b, i, j, 2)
    assert p is not None and (p.gz or p.gg)
    y, x = _rand((b, j), 3, 0.2), _rand((b, i), 4)
    np.testing.assert_allclose(_mirror_pe2(x[None], y, p)[0].numpy(),
                               ttm_pe3.pe3_torch(y, x).numpy(), **F32_TOL)


@pytest.mark.parametrize("shape", [(16, 64, 20, 64), (8, 128, 28, 256),
                                   (8, 128, 256, 10), (4, 256, 128, 20)])
def test_pe2_granule_mirror_matches_jax_pe2(shape):
    a, b, c, d = shape
    p = tt_mma.plan(a, b, c, d, 2)
    assert p.gz or p.gg
    z, g = _rand((a, b, c), 5), _rand((b, d), 6, 0.2)
    want = np.asarray(JOPS.pe2(jnp.asarray(z.numpy()), jnp.asarray(g.numpy())))
    np.testing.assert_allclose(_mirror_pe2(z, g, p).numpy(), want, **F32_TOL)


# PE1 on granules: c = 20 / 28 (the frontends'), 12, 2, 62 and 6 (4-byte
# granules), d across one and two warpgroups and past one tile, ragged a
PE1_CASES = [(300, 20, 256), (200, 28, 448), (70, 28, 512), (37, 12, 24),
             (5, 2, 8), (129, 62, 136), (77, 6, 1024)]


@pytest.mark.parametrize("shape", PE1_CASES)
def test_pe1_granule_mirror_matches_the_plain_version(shape):
    a, c, d = shape
    p = ttm_pe1.plan_pe1(a, 1, c, d, 2)
    assert p is not None and p.gran
    z, g = _rand((a, 1, c), 7), _rand((1, d, c), 8, 0.2)
    np.testing.assert_allclose(_mirror_pe1(z, g, p, grid=2).numpy(),
                               ttm_pe1.pe1_torch(z, g).numpy(), **F32_TOL)


@pytest.mark.parametrize("shape", [(37, 20, 24), (129, 28, 256),
                                   (200, 20, 512)])
def test_pe1_granule_mirror_matches_jax_pe1(shape):
    a, c, d = shape
    p = ttm_pe1.plan_pe1(a, 1, c, d, 2)
    z, g = _rand((a, 1, c), 9), _rand((1, d, c), 10, 0.2)
    want = np.asarray(JOPS.pe1(jnp.asarray(z.numpy()), jnp.asarray(g.numpy())))
    np.testing.assert_allclose(_mirror_pe1(z, g, p).numpy(), want, **F32_TOL)


@pytest.mark.parametrize("c,gr", [(20, 8), (28, 8), (22, 4), (2, 4),
                                  (30, 4), (4, 8)])
def test_slab_granules_cover_each_row_once(c, gr):
    """``stage_slabs`` writes every (slab, row, granule) once over the
    producer's 128 threads, in bytes 0 .. 2 c slabs of each swizzled row
    (16-byte chunks permuted within the row)."""
    p = dataclasses.replace(tt_mma.plan(3 * (64 // c), 64, c, 256, 2), gz=gr)
    tile = [np.zeros(BK * 64, np.float32), np.zeros(BK * 64)]
    z = np.ones((p.a, p.b, c), np.float32)
    _stage_slabs(tile, z, 0, 0, p, 128)
    hit = tile[1].reshape(BK, 64)
    assert hit.max() == 1 and hit.sum() == BK * p.slabs * c
    for k in range(BK):     # the row's written bytes, un-swizzled
        o = k * 128 + 2 * np.arange(64)
        logical = hit.reshape(-1)[_swz(o, 128) // 2]
        assert (logical[:p.slabs * c] == 1).all()
        assert (logical[p.slabs * c:] == 0).all()

