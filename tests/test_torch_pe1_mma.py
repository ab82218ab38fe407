"""The PE1 tensor-core route (``repro_torch.kernels.ttm_pe1.plan_pe1``,
``csrc/ttm_pe1.cu::pe1_mma_kernel``) checked on the CPU, where no kernel can
run: the plan is a pure function of dtype, shapes and alignment, so its
route, tile, shared memory, grid and TMA boxes are held here at the three
PE1 calls of the ``with_tt(internlm2-1.8b)`` step (the calls
``chip_smoke.py::_lm_pe_calls`` times), and a plain mirror of the plan's
tile walk (``_mirror``: tiles in the CTAs' order, each warpgroup's 64 rows
against its columns of d, k-steps of 16 in order, the TMA's zero fill past
a, c and d, f32 sums, the epilogue, stores dropped past a and d) is held to
``pe1_torch`` within 1e-5 in f32 (bit for bit with the epilogue on sums that
f32 holds exactly, whatever their order) and to JAX's ``pe1`` (the Pallas
kernel in interpret mode) at small shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro_torch.core.ttm import pe_shapes  # noqa: E402
from repro_torch.kernels import ops, tt_mma, ttm_pe1  # noqa: E402
from repro_torch.numerics.codecs import Pow2Reference  # noqa: E402
from repro_torch.numerics.spec import QuantSpec  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _lm_calls():
    """PE1 calls (a, b, c, d) of every TT site's forward and transposed
    chains of the LM step at 8 x 256 rows."""
    from repro_torch import configs as C
    from repro_torch.models.lm import _walk_sites, build_lm
    lm = build_lm(C.with_tt(C.get_config("internlm2-1.8b"), quantize=True))
    specs = [site.spec for _, site in _walk_sites(lm) if site.use_tt]
    return sorted({(*zs, gs[1]) for s in specs
                   for sp in (s, s.transposed())
                   for kind, zs, gs in pe_shapes(sp, 8 * 256)
                   if kind == "pe1"})


LM_CALLS = _lm_calls()
# the step's three PE1 calls: (a, b, c, d) -> (bm, bn, sw): one tile spans
# all of d, two warpgroups along a (d = 256) or along d (d = 512)
WANT = {
    (262144, 1, 16, 256): (128, 256, 32),
    (262144, 1, 16, 512): (64, 512, 32),
    (524288, 1, 32, 256): (128, 256, 64),
}


def _cdiv(n, m):
    return -(-n // m)


def test_lm_calls_are_the_three_calls():
    assert LM_CALLS == sorted(WANT)


@pytest.mark.parametrize("shape", sorted(WANT))
def test_lm_call_takes_the_tensor_cores(shape):
    """Route, tile, shared memory and grid at each of the three calls."""
    a, b, c, d = shape
    p = ttm_pe1.plan_pe1(a, b, c, d, 2)
    assert p is not None
    assert (p.bm, p.bn, p.sw) == WANT[shape]
    assert (p.a, p.c, p.d) == (a, c, d)
    assert p.wgn == 256 and p.wm * p.wn == 2
    assert p.threads == p.wm * p.wn * 128 + 32 == ttm_pe1.MMA_THREADS
    # the tiles cover a and d once, in one column of tiles; the grid is
    # persistent, one CTA per SM
    assert p.tiles_n == 1 and p.tiles_m == _cdiv(a, p.bm)
    assert p.tiles == p.tiles_m * p.tiles_n
    assert p.grid == min(p.tiles, tt_mma.SMS) == 132
    # shared memory: resident G, the ring, the staging tiles, the barriers
    assert p.ksteps == c // 16
    assert p.g_bytes == d * p.sw and p.stage == p.bm * p.sw
    assert p.out_bytes == 64 * p.wgn * 2 and p.nbuf == ttm_pe1.OUT_BUFS
    assert p.smem == (tt_mma.ALIGN + p.g_bytes + p.stages * p.stage
                      + 2 * p.nbuf * p.out_bytes + 16 * p.stages + 8)
    assert p.smem <= 232_448 == tt_mma.SMEM_MAX
    # the ring is as deep as shared memory allows, up to MMA_STAGES
    assert 2 <= p.stages <= ttm_pe1.MMA_STAGES
    assert p.stages == ttm_pe1.MMA_STAGES or \
        p.smem + p.stage + 16 > tt_mma.SMEM_MAX


@pytest.mark.parametrize("shape", sorted(WANT))
def test_lm_call_layouts_fit_tma_and_wgmma(shape):
    """TMA boxes within 256 a side, their inner bytes one swizzle row of
    32 / 64 bytes (c = 16 / 32), every buffer on a 1024-byte boundary,
    wgmma's N and K legal, 32-bit indices."""
    a, b, c, d = shape
    p = ttm_pe1.plan_pe1(a, b, c, d, 2)
    assert p.sw == 2 * c and p.sw in (32, 64)
    # Z's box (sw / 2, bm), G's (sw / 2, wgn), Y's (64, 64) under 128 B
    for box in ((p.sw // 2, p.bm), (p.sw // 2, p.wgn),
                (ttm_pe1.OUT_BOX, 64)):
        assert max(box) <= 256 and (box[0] * 2) % 16 == 0
    assert ttm_pe1.OUT_BOX * 2 == 128 and p.wgn % ttm_pe1.OUT_BOX == 0
    assert p.ksteps * 32 <= p.sw and p.ksteps * 16 >= c
    for n in (p.g_bytes, p.stage, p.out_bytes, p.wgn * p.sw):
        assert n % 1024 == 0
    assert p.wgn in (64, 128, 256) and p.wgn % 8 == 0
    assert (c * 2) % 16 == 0 and (d * 2) % 16 == 0
    assert len(p.fields) == len(ttm_pe1.MMA_FIELDS) == 20
    assert p.gran == 0              # both operands on the TMA
    assert max(a * c, a * d, d * c) < 2 ** 31


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(WANT))
def test_f32_takes_the_cuda_cores(shape):
    assert ttm_pe1.plan_pe1(*shape, 4) is None
    assert ttm_pe1.plan(*shape, 4).grid >= 1


# (64, 1, 12, 256) and (64, 1, 16, 256) with G 8 bytes off take their rows
# by granules since then: tests/test_torch_pe_granule.py holds their plans
# (test_cases_the_granules_now_admit)
@pytest.mark.parametrize("case", [
    dict(shape=(64, 2, 16, 256)),             # b = 2
    dict(shape=(37, 5, 48, 18)),              # b = 5, d = 18
    dict(shape=(64, 1, 13, 256)),             # c = 13: 26-byte rows
    dict(shape=(64, 1, 7, 256)),              # c = 7
    dict(shape=(64, 1, 72, 256)),             # c = 72: K past one 128 B row
    dict(shape=(64, 1, 16, 20)),              # d = 20
    dict(shape=(64, 1, 16, 256), z=2),        # Z one element off 16 bytes
    dict(shape=(64, 1, 16, 256), g=6),        # G 2 bytes off a granule
    dict(shape=(5, 1, 64, 4096)),             # G does not fit beside a ring
])
def test_other_bf16_calls_take_the_cuda_cores(case):
    shape = case["shape"]
    assert ttm_pe1.plan_pe1(*shape, 2, case.get("z", 0),
                            case.get("g", 0)) is None
    assert ttm_pe1.plan(*shape, 2, case.get("z", 0), case.get("g", 0)).grid


@pytest.mark.parametrize("shape", [(64, 1, 16, 256), (37, 1, 8, 24),
                                   (1, 1, 16, 8), (5, 1, 40, 136),
                                   (77, 1, 64, 64), (200, 1, 24, 1024)])
def test_aligned_bf16_takes_the_tensor_cores(shape):
    p = ttm_pe1.plan_pe1(*shape, 2)
    assert p is not None and p.smem <= tt_mma.SMEM_MAX and p.grid <= 132
    ttm_pe1.plan_pe1.cache_clear()
    assert ttm_pe1.plan_pe1(*shape, 2) == p     # a pure function


def test_plan_for_reads_dtype_and_alignment():
    z = torch.zeros((1 + 64 * 16,), dtype=torch.bfloat16)
    g = torch.zeros((1, 256, 16), dtype=torch.bfloat16)
    aligned = z[:64 * 16].view(64, 1, 16)
    assert ttm_pe1.plan_pe1_for(aligned, g) is not None
    assert ttm_pe1.plan_pe1_for(aligned.float(), g.float()) is None
    off = z[1:].view(64, 1, 16)
    if off.data_ptr() % 16:
        assert ttm_pe1.plan_pe1_for(off, g) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(monkeypatch, dtype):
    """``ops.pe1`` sends CPU tensors to ``pe1_torch``, whatever the plan;
    the kernel entry point refuses them."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel wrapper")
    rng = np.random.RandomState(0)
    z = torch.from_numpy(rng.randn(64, 1, 16).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(1, 256, 16).astype(np.float32)).to(dtype)
    assert dtype != torch.bfloat16 or ttm_pe1.plan_pe1_for(z, g) is not None
    with pytest.raises(ValueError):
        ttm_pe1.pe1_cuda(z, g)
    monkeypatch.setattr(ttm_pe1, "pe1_cuda", refuse)
    assert torch.equal(ops.pe1(z, g), ttm_pe1.pe1_torch(z, g))
    assert torch.equal(ops.pe1(z, g, -2.0, 8),
                       ttm_pe1.pe1_torch(z, g, -2.0, 8))


# ---------------------------------------------------------------------------
# the plain mirror of the tile walk
# ---------------------------------------------------------------------------

def _mirror(z: torch.Tensor, g: torch.Tensor, p, step=None,
            bits=None) -> torch.Tensor:
    """``Y(a, d)`` the way ``pe1_mma_kernel`` walks ``p``: CTA k takes
    tiles k, k + grid, ...; in a tile, warpgroup (wmi, wni) multiplies its
    64 rows of Z by its ``wgn`` rows of G over ``ksteps`` k-steps of 16 in
    order, in f32, from zero-filled operands (the TMA reads 0 past a, c and
    d), requantizes when ``bits`` is given, and stores its tile box by box
    (64 columns), rows past a and boxes past d dropped. Every output must
    be stored once."""
    a, _, c = z.shape
    d = g.shape[1]
    kp = p.ksteps * 16
    zp = torch.zeros((p.tiles_m * p.bm, kp), dtype=torch.float32)
    zp[:a, :c] = z[:, 0, :].float()
    gp = torch.zeros((p.tiles_n * p.bn, kp), dtype=torch.float32)
    gp[:d, :c] = g[0].float()
    out = torch.zeros((a, d), dtype=torch.float32)
    count = torch.zeros((a, d), dtype=torch.int64)
    for cta in range(p.grid):
        for t in range(cta, p.tiles, p.grid):
            tm, tn = divmod(t, p.tiles_n)
            for wg in range(p.wm * p.wn):
                wmi, wni = divmod(wg, p.wn)
                m0, n0 = tm * p.bm + 64 * wmi, tn * p.bn + p.wgn * wni
                at, bt = zp[m0:m0 + 64], gp[n0:n0 + p.wgn]
                acc = torch.zeros((64, p.wgn), dtype=torch.float32)
                for ks in range(0, kp, 16):
                    acc += at[:, ks:ks + 16] @ bt[:, ks:ks + 16].t()
                if bits is not None:
                    acc = Pow2Reference().epilogue(
                        acc, QuantSpec("pow2", bits), step)
                if m0 >= a:
                    continue
                rows = min(64, a - m0)
                for box in range(0, p.wgn, ttm_pe1.OUT_BOX):
                    col = n0 + box
                    if col >= d:
                        continue
                    n = min(ttm_pe1.OUT_BOX, d - col)
                    out[m0:m0 + rows, col:col + n] = acc[:rows, box:box + n]
                    count[m0:m0 + rows, col:col + n] += 1
    assert (count == 1).all(), "an output not stored once"
    return out.to(z.dtype)


def _cut(shape):
    """An LM call cut down for the CPU: a to 3,000 rows (ragged against
    every tile height), c and d kept."""
    a, b, c, d = shape
    return (3000, b, c, d)


# ragged a, c = 8 / 16 / 24 / 32 / 40 / 56 / 64 (the TMA's K fill), d in one
# warpgroup (24, 64, 136, 256), two along d (512, 520) and two tiles of d
ODD_MMA = [(37, 1, 8, 24), (1, 1, 16, 8), (129, 1, 32, 256),
           (300, 1, 16, 512), (5, 1, 40, 136), (77, 1, 64, 64),
           (200, 1, 24, 1024), (70, 1, 56, 520), (4500, 1, 16, 256)]


def _rand(shape, seed, scale=1.0):
    """f32 values that bf16 holds exactly (the route's operands)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _ints(shape, seed, hi=8):
    """Small integers as f32: every sum of up to 64 of their products is
    exact in f32, whatever its order."""
    x = np.random.RandomState(seed).randint(-hi, hi + 1, shape)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("shape", sorted({_cut(s) for s in WANT}) + ODD_MMA)
def test_mirror_matches_the_plain_version(shape):
    a, b, c, d = shape
    p = ttm_pe1.plan_pe1(a, b, c, d, 2)
    assert p is not None
    if shape in [_cut(s) for s in WANT]:
        want = WANT[next(s for s in WANT if _cut(s) == shape)]
        assert (p.bm, p.bn, p.sw) == want
    z, g = _rand((a, 1, c), 1), _rand((1, d, c), 2, 0.2)
    np.testing.assert_allclose(_mirror(z, g, p).numpy(),
                               ttm_pe1.pe1_torch(z, g).numpy(), **F32_TOL)


@pytest.mark.parametrize("bits,step", [(4, 3.0), (8, 1.0), (8, -2.0)])
@pytest.mark.parametrize("shape", [(3000, 1, 16, 256), (300, 1, 16, 512),
                                   (129, 1, 32, 256), (37, 1, 8, 24)])
def test_mirror_epilogue_bit_for_bit(shape, bits, step):
    """The epilogue on exact sums equals the plain version's (einsum + the
    codec's epilogue) bit for bit, in f32 and in bf16, and encode -> decode
    of the plain sum value for value (a sum that rounds to 0 from below is
    -0.0 in both epilogues, +0.0 out of the codes); the data clips at both
    ends of the grid."""
    a, b, c, d = shape
    p = ttm_pe1.plan_pe1(a, b, c, d, 2)
    z, g = _ints((a, 1, c), 3), _ints((1, d, c), 4)
    fused = _mirror(z, g, p, step, bits)
    assert torch.equal(fused, ttm_pe1.pe1_torch(z, g, step, bits))
    from repro_torch import numerics as TN
    spec = TN.QuantSpec("pow2", bits)
    unfused = TN.decode(TN.encode(ttm_pe1.pe1_torch(z, g), spec,
                                  torch.tensor(step), backend="reference"),
                        torch.float32, backend="reference")
    assert torch.equal(fused, unfused)
    zb, gb = z.to(torch.bfloat16), g.to(torch.bfloat16)
    fused_bf16 = _mirror(zb, gb, p, step, bits)
    assert torch.equal(fused_bf16.view(torch.int16),
                       ttm_pe1.pe1_torch(zb, gb, step, bits).view(torch.int16))
    assert torch.equal(fused_bf16.float(), unfused)
    # the grid's ends clip wherever the sums pass them (at c >= 16 they
    # pass both: the clipping is exercised)
    acc, q = ttm_pe1.pe1_torch(z, g) / 2.0 ** step, fused / 2.0 ** step
    top, bottom = 2 ** (bits - 1) - 1, -2 ** (bits - 1)
    assert c < 16 or step <= 0 or (acc.max() > top and acc.min() < bottom)
    assert q.max() == min(top, acc.max().round())
    assert q.min() == max(bottom, acc.min().round())


@pytest.mark.parametrize("shape", [(37, 1, 8, 24), (129, 1, 32, 256),
                                   (200, 1, 16, 512), (70, 1, 40, 136)])
def test_mirror_matches_jax_pe1(shape):
    a, b, c, d = shape
    p = ttm_pe1.plan_pe1(a, b, c, d, 2)
    z, g = _rand((a, 1, c), 5), _rand((1, d, c), 6, 0.2)
    jz, jg = jnp.asarray(z.numpy()), jnp.asarray(g.numpy())
    np.testing.assert_allclose(_mirror(z, g, p).numpy(),
                               np.asarray(JOPS.pe1(jz, jg)), **F32_TOL)


@pytest.mark.parametrize("bits,step", [(4, 3.0), (8, 1.0)])
def test_mirror_epilogue_matches_jax_pe1(bits, step):
    """The fused requantize against the Pallas kernel's (interpret mode) on
    exact sums: bit for bit."""
    a, b, c, d = 129, 1, 32, 256
    p = ttm_pe1.plan_pe1(a, b, c, d, 2)
    z, g = _ints((a, 1, c), 7), _ints((1, d, c), 8)
    want = np.asarray(JOPS.pe1(jnp.asarray(z.numpy()), jnp.asarray(g.numpy()),
                               step, bits))
    np.testing.assert_array_equal(_mirror(z, g, p, step, bits).numpy(), want)
