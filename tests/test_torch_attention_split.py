"""The split paged-attention kernels' plan and dataflow on the CPU.

``csrc/paged_attention.cu`` splits each slot's page walk across CTAs (a
span of ``pages_per_split`` pages each) that write partial (m, l, acc),
and a second pass combines them. Neither kernel runs here, so:

(a) the launch plan (``paged_attention.plan``) is held as a pure function:
    spans cover every page, shared memory fits, rows are padded to an odd
    number of 16-byte units, and the P @ V thread layout covers each
    (row, column quad) once;
(b) the plain mirror of split -> partials -> combine (``pa_split_torch``,
    ``pa_combine_torch``, what the card holds each kernel to) is held to
    the port's page walk and to JAX's Pallas kernel (interpret mode) at
    1e-5 in fp32, over S in {1, 4}, MHA/GQA/MQA, int8 and fp pages, span
    sizes of 1, 2, 3 and 8 pages, and slots whose row 0 sees up to the
    last key of a span, so the next span holds no unmasked key for it
    (m = -1e30, l counting masked keys, weight exactly 0 in the combine).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import paged_attention as JPA  # noqa: E402
from repro_torch.kernels import paged_attention as TPA  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _pool(seed, *, b, pp, page, hkv, hq, dh, s, quantized, pages_per_split):
    """Random pool + table as numpy; lens: slot 0 at position 0, slot 1
    with row 0's limit on a span's last key, the last slot at the horizon,
    the rest random."""
    rng = np.random.RandomState(seed)
    total = b * pp
    if quantized:
        kd = rng.randint(-128, 128, (total + 1, page, hkv, dh)).astype(np.int8)
        vd = rng.randint(-128, 128, (total + 1, page, hkv, dh)).astype(np.int8)
        ks = rng.randint(-9, -4, (b,)).astype(np.float32)
        vs = rng.randint(-9, -4, (b,)).astype(np.float32)
    else:
        kd = rng.randn(total + 1, page, hkv, dh).astype(np.float32)
        vd = rng.randn(total + 1, page, hkv, dh).astype(np.float32)
        ks = vs = np.zeros((b,), np.float32)
    table = rng.permutation(total).reshape(b, pp).astype(np.int32)
    hi = pp * page - s
    lens = rng.randint(0, hi + 1, (b,)).astype(np.int32)
    lens[0], lens[-1] = 0, hi
    lens[1] = min(min(pages_per_split, pp) * page - 1, hi)
    q = rng.randn(b, s, hq, dh).astype(np.float32)
    return q, kd, vd, ks, vs, table, lens


def _mirror(args, *, page, s, quantized, pages_per_split, dtype=None):
    t = [torch.from_numpy(a) for a in args]
    m, l, acc = TPA.pa_split_torch(*t, page_size=page, quantized=quantized,
                                   pages_per_split=pages_per_split)
    out = TPA.pa_combine_torch(m, l, acc, t[6], s=s, page_size=page,
                               pps=t[5].shape[1],
                               pages_per_split=pages_per_split,
                               dtype=dtype or t[0].dtype)
    return out, (m, l, acc), t


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

PLAN_CASES = [
    # B, S, Hq, Hkv, Dh, page, pps, kv bytes: the serving shape (int8, bf16
    # and f32 pages), its S = 4 q-block, the CPU and card tests' shapes
    (8, 1, 16, 8, 128, 16, 64, 1), (8, 4, 16, 8, 128, 16, 64, 1),
    (8, 1, 16, 8, 128, 16, 64, 2), (8, 1, 16, 8, 128, 16, 64, 4),
    (4, 4, 3, 1, 16, 8, 5, 1), (4, 1, 4, 4, 16, 8, 5, 4),
    (3, 2, 4, 2, 12, 8, 9, 1), (3, 2, 4, 2, 12, 8, 9, 2),
    (2, 4, 32, 2, 128, 16, 128, 1), (1, 1, 8, 8, 256, 64, 40, 4),
]


@pytest.mark.parametrize("case", PLAN_CASES)
@pytest.mark.parametrize("pages_per_split", [1, 3, 8])
def test_plan_fits_and_covers(case, pages_per_split):
    b, s, hq, hkv, dh, page, pps, kvb = case
    p = TPA.plan(b, s, hq, hkv, dh, page, pps, kvb,
                 pages_per_split=pages_per_split)
    row = dh * kvb
    assert p.R == s * (hq // hkv)
    assert 1 <= p.pps_split <= min(pages_per_split, pps)
    assert p.n_split * p.pps_split >= pps > (p.n_split - 1) * p.pps_split
    assert p.grid == b * hkv * p.n_split
    assert p.gb in (16, 4) and row % p.gb == 0
    assert p.pitch % 16 == 0 and (p.pitch // 16) % 2 == 1 and p.pitch >= row
    keys = p.pps_split * page
    assert p.qs_off == 2 * keys * p.pitch
    assert p.ps_off == p.qs_off + p.R * dh * 4
    assert p.ps_off + p.R * keys * 4 <= p.smem <= TPA.SMEM_MAX
    assert p.kp in (1, 2, 4, 8, 16, 32)
    items = p.R * (dh // 4)
    assert items * p.kp <= TPA.THREADS or p.kp == 1
    assert p.kp == 32 or items * p.kp * 2 > TPA.THREADS
    assert len(p.fields) == len(TPA.PLAN_FIELDS) == 17


def test_serving_shape_spans_and_big_pages_shrink():
    p = TPA.plan(8, 1, 16, 8, 128, 16, 64, 1)
    assert (p.pps_split, p.n_split, p.grid, p.gb, p.pitch) == (8, 8, 512, 16,
                                                               144)
    # f32 pages of 64 tokens x 256: eight pages would not fit
    big = TPA.plan(1, 1, 8, 8, 256, 64, 40, 4)
    assert big.pps_split < 8 and big.smem <= TPA.SMEM_MAX
    with pytest.raises(ValueError):
        TPA.plan(2, 1, 4, 2, 6, 8, 4, 1)          # Dh % 4
    with pytest.raises(ValueError):
        TPA.plan(2, 1, 3, 2, 16, 8, 4, 1)         # Hq % Hkv


@pytest.mark.parametrize("case", PLAN_CASES[:6] + [(2, 4, 32, 2, 128, 16, 128,
                                                   1)])
def test_pv_layout_covers_each_row_quad_once(case):
    """The P @ V passes: item = i0 + tid // kp is (row, column quad), lane
    k = tid % kp; lane 0 of each item writes it."""
    p = TPA.plan(*case)
    nq = p.Dh // 4
    items, per_pass = p.R * nq, TPA.THREADS // p.kp
    seen = np.zeros((p.R, nq), dtype=np.int64)
    for i0 in range(0, items, per_pass):
        for tid in range(TPA.THREADS):
            item = i0 + tid // p.kp
            if item < items and tid % p.kp == 0:
                seen[item // nq, item % nq] += 1
    assert (seen == 1).all()


def test_spans_needed_follows_the_last_needed_page():
    lens = torch.tensor([0, 15, 16, 127, 128, 1020], dtype=torch.int32)
    got = TPA.spans_needed(lens, 4, 16, 64, 8).tolist()
    # pages holding a position <= lens + 3: 1, 2, 2, 9, 9, 64
    assert got == [1, 1, 1, 2, 2, 8]


# ---------------------------------------------------------------------------
# (b) the mirror of split -> partials -> combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2), (3, 1)])  # MHA/GQA/MQA
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 8])
def test_split_combine_matches_page_walk_and_pallas(hq, hkv, quantized, s,
                                                    pages_per_split):
    page, pp = 8, 7
    args = _pool(hq + s + pages_per_split, b=4, pp=pp, page=page, hkv=hkv,
                 hq=hq, dh=16, s=s, quantized=quantized,
                 pages_per_split=pages_per_split)
    out, (m, l, _), t = _mirror(args, page=page, s=s, quantized=quantized,
                                pages_per_split=pages_per_split)
    walk = TPA.paged_attention_torch(*t, page_size=page, quantized=quantized)
    np.testing.assert_allclose(out.numpy(), walk.numpy(), **TOL)
    ref = JPA.paged_attention_kernel(*(jnp.asarray(a) for a in args),
                                     page_size=page, quantized=quantized,
                                     interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    ps = min(pages_per_split, pp)
    if s > 1 and pp > ps:
        # slot 1's row 0 has no unmasked key in span 1: m stays -1e30 and
        # l counts the span's (masked) keys
        lens1 = int(t[6][1])
        n_pages = min(pp, (lens1 + s - 1) // page + 1)
        assert float(m[1, 0, 1, 0]) == float(torch.tensor(TPA.NEG_INF))
        assert float(l[1, 0, 1, 0]) == min(ps, n_pages - ps) * page


def test_combine_ignores_unneeded_spans_whatever_they_hold():
    """Spans past a slot's last needed page are never read: filling them
    with NaN (the kernel leaves them unwritten) changes nothing."""
    page, pp, s = 8, 7, 2
    args = _pool(3, b=3, pp=pp, page=page, hkv=2, hq=4, dh=16, s=s,
                 quantized=True, pages_per_split=2)
    out, (m, l, acc), t = _mirror(args, page=page, s=s, quantized=True,
                                  pages_per_split=2)
    need = TPA.spans_needed(t[6], s, page, pp, 2)
    off = torch.arange(m.shape[2])[None] >= need[:, None]
    assert off.any()
    m2, l2, acc2 = m.clone(), l.clone(), acc.clone()
    sel = off[:, None, :].expand(m.shape[:3])
    m2[sel], l2[sel], acc2[sel] = float("nan"), float("nan"), float("nan")
    out2 = TPA.pa_combine_torch(m2, l2, acc2, t[6], s=s, page_size=page,
                                pps=pp, pages_per_split=2,
                                dtype=torch.float32)
    assert torch.equal(out, out2)


def test_bf16_q_mirror_within_rounding_of_walk():
    page, pp, s = 8, 5, 1
    args = _pool(12, b=3, pp=pp, page=page, hkv=2, hq=4, dh=16, s=s,
                 quantized=True, pages_per_split=2)
    t = [torch.from_numpy(a) for a in args]
    qb = t[0].to(torch.bfloat16)
    m, l, acc = TPA.pa_split_torch(qb, *t[1:], page_size=page,
                                   quantized=True, pages_per_split=2)
    out = TPA.pa_combine_torch(m, l, acc, t[6], s=s, page_size=page, pps=pp,
                               pages_per_split=2, dtype=torch.bfloat16)
    walk = TPA.paged_attention_torch(qb.float(), *t[1:], page_size=page,
                                     quantized=True)
    assert out.dtype == torch.bfloat16
    r = walk.abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(r, min=1e-30))) - 7)
    assert bool(((out.float() - walk).abs() <= ulp + 1e-5).all())
