"""The whole-prompt prefill's paged K/V write of repro_torch against repro
(the JAX reference), on the CPU.

On the card a whole-prompt prefill writes K and V of every layer into the
slot's pages in one ``p2_prefill_paged`` launch, which also chooses each
(tensor, layer) scale (``kernels/kv_prefill.py``); here its plain twin
runs, reached the way the engine reaches it (``kv_cache.write_prefill``
with the prompt's length as a (1,) int32 tensor), and is held bit for bit
to ``repro.serve.kv_cache.write_prefill`` on every real page and every
scale of the pool:

(a) L = 3 layers; S in {1, 15, 16, 17, 40} with every row valid and with
    bucket padding (length < S; pad rows hold values far past the valid
    rows' range, so a pad row in the max shows); 8- and 4-bit codes; f32
    and bf16 caches; V the strided half of a fused (..., 2, Hkv, Dh)
    array; an all-zero layer (the 1e-8 clamp); a slot of 4 pages of 8, so
    S = 40 reaches past its last page (the reference's gather clamps the
    page index and the later of two rows that meet in one cell wins,
    which the engine never reaches: its scheduler refuses prompt + new
    tokens > max_len); other slots' pages and scales left untouched;
(b) a max at ``qmax * 2^k`` and its f32 neighbours, k = -12..5: at and
    below the edge the scale and the pages equal JAX's; above it (m a few
    ulps past ``qmax * 2^k``) the reference's CPU log2 and PyTorch's may
    round to different sides of k, and the lock is that each picks k or
    k + 1 and that they differ nowhere else (``ROADMAP.md`` queue 3);
(c) the route: a quantized ``write_prefill`` is one ``ops.prefill_paged``
    for K and V of every layer and runs no row-scale codec; a model-dtype
    pool keeps its scatter, against JAX too;
(d) what the wrappers refuse.

Inputs are made with numpy from a seed and handed to both packages (JAX's
pool codec on the CPU is its reference). Tolerance: none, codes and scales
are bit-exact. The trash page is write-only scratch and is not compared.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro_torch.kernels import kv_prefill as KP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.serve import PoolConfig  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
L, SLOTS, PAGE, PPS, HKV, DH = 3, 3, 8, 4, 2, 8
TRASH = SLOTS * PPS
SLOT = 1


def _pcfg(bits, quantized=True):
    return dict(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS,
                quantized=quantized, bits=bits)


def _case(seed, s, length, quantized=True, zero_layer=False):
    rng = np.random.RandomState(seed)
    shape = (L, TRASH + 1, PAGE, HKV, DH)
    pools = [rng.randint(-128, 128, shape).astype(np.int8) if quantized
             else rng.standard_normal(shape).astype(np.float32)
             for _ in range(2)]
    kv = []
    for _ in range(2):
        x = rng.standard_normal((L, s, HKV, DH)) \
            * (2.0 ** rng.randint(-6, 4, (L, 1, 1, 1)))
        x[:, length:] *= 1e3                       # pad rows far past
        x.reshape(-1)[::11] = np.round(x.reshape(-1)[::11] * 4) / 4 + 0.125
        kv.append(x.astype(np.float32))
    if zero_layer:
        kv[0][1, :length] = 0.0
    return dict(kd=pools[0], vd=pools[1],
                ks=rng.randint(-6, 0, (L, SLOTS)).astype(np.float32),
                vs=rng.randint(-6, 0, (L, SLOTS)).astype(np.float32),
                table=rng.permutation(TRASH).reshape(SLOTS, PPS).astype(
                    np.int32),
                k=kv[0], v=kv[1])


def _jax_prefill(c, length, dtype, kw):
    pool = {"data": {"sub_0": {"k": jnp.asarray(c["kd"]),
                               "v": jnp.asarray(c["vd"])}},
            "scale_log2": {"sub_0": {"k": jnp.asarray(c["ks"]),
                                     "v": jnp.asarray(c["vs"])}}}
    cache = {"sub_0": {n: jnp.asarray(c[n][:, None]).astype(jnp.dtype(dtype))
                       for n in ("k", "v")}}
    out = JKC.write_prefill(pool, cache, jnp.asarray(c["table"][SLOT]),
                            jnp.int32(SLOT), jnp.int32(length), JPC(**kw))
    return ([np.asarray(out["data"]["sub_0"][n]) for n in ("k", "v")],
            [np.asarray(out["scale_log2"]["sub_0"][n]) for n in ("k", "v")])


def _port_pool(c):
    return {"data": {"sub_0": {"k": torch.from_numpy(c["kd"].copy()),
                               "v": torch.from_numpy(c["vd"].copy())}},
            "scale_log2": {"sub_0": {"k": torch.from_numpy(c["ks"].copy()),
                                     "v": torch.from_numpy(c["vs"].copy())}}}


def _port_prefill(c, length, dtype, kw):
    """The engine's call: the cache leaves (L, 1, S, Hkv, Dh), V the
    strided half of a fused projection, the length a (1,) int32 tensor."""
    pool = _port_pool(c)
    kv = torch.from_numpy(np.stack([c["k"], c["v"]], axis=-3)[:, None]).to(
        TORCH_DT[dtype])
    cache = {"sub_0": {"k": kv[..., 0, :, :].contiguous(),
                       "v": kv[..., 1, :, :]}}
    assert not cache["sub_0"]["v"].is_contiguous()
    out = TKC.write_prefill(pool, cache, torch.from_numpy(c["table"][SLOT]),
                            SLOT, torch.tensor([length], dtype=torch.int32),
                            PoolConfig(**kw))
    assert out is pool                                   # in place
    return ([pool["data"]["sub_0"][n].numpy() for n in ("k", "v")],
            [pool["scale_log2"]["sub_0"][n].numpy() for n in ("k", "v")])


def _assert_pool(got, want, c):
    (gd, gs), (wd, ws) = got, want
    mine = set(c["table"][SLOT].tolist())
    others = [p for p in range(TRASH) if p not in mine]
    for g, w, orig in zip(gd, wd, (c["kd"], c["vd"])):
        np.testing.assert_array_equal(g[:, :TRASH], w[:, :TRASH])
        # other slots' pages untouched
        np.testing.assert_array_equal(g[:, others], orig[:, others])
    for g, w, orig in zip(gs, ws, (c["ks"], c["vs"])):
        np.testing.assert_array_equal(g, w)
        keep = [i for i in range(SLOTS) if i != SLOT]
        np.testing.assert_array_equal(g[:, keep], orig[:, keep])


# ---------------------------------------------------------------------------
# (a) the twin against write_prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 40])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_equals_jax_write_prefill(dtype, bits, s, padded):
    length = s - 1 - s // 3 if padded else s
    c = _case(s * 7 + bits + padded, s, length, zero_layer=s == 17)
    kw = _pcfg(bits)
    want = _jax_prefill(c, length, dtype, kw)
    got = _port_prefill(c, length, dtype, kw)
    _assert_pool(got, want, c)
    if s == 17:                      # the all-zero layer: the 1e-8 clamp
        assert got[1][0][1, SLOT] == np.ceil(np.log2(np.float32(1e-8) / (
            2 ** (bits - 1) - 1)))
    if length:                       # it wrote the slot's first page
        first = c["table"][SLOT][0]
        assert not np.array_equal(got[0][0][:, first], c["kd"][:, first])


def test_prefill_twin_takes_an_int_length_and_any_slot():
    """``ops.prefill_paged`` called directly (impl="torch"): the length as
    an int, slot 0 and the last slot, equal to JAX's."""
    for slot in (0, SLOTS - 1):
        c = _case(3 + slot, 17, 12)
        kw = _pcfg(8)
        table = c["table"].copy()
        c["table"][SLOT] = table[slot]       # _jax_prefill writes SLOT
        want_d, _ = _jax_prefill(c, 12, "float32", kw)
        pool = _port_pool(c)
        d, sc = pool["data"]["sub_0"], pool["scale_log2"]["sub_0"]
        ops.prefill_paged(d["k"], d["v"], sc["k"], sc["v"],
                          torch.from_numpy(c["k"]), torch.from_numpy(c["v"]),
                          torch.from_numpy(table[slot]), slot, 12,
                          page_size=PAGE, bits=8, impl="torch")
        np.testing.assert_array_equal(d["k"].numpy()[:, :TRASH],
                                      want_d[0][:, :TRASH])
        np.testing.assert_array_equal(d["v"].numpy()[:, :TRASH],
                                      want_d[1][:, :TRASH])
        assert [i for i in range(SLOTS)
                if not np.array_equal(sc["k"].numpy()[:, i],
                                      c["ks"][:, i])] == [slot]


# ---------------------------------------------------------------------------
# (b) the scale step at qmax * 2^k and its f32 neighbours
# ---------------------------------------------------------------------------

def _edges(bits):
    qmax = 2 ** (bits - 1) - 1
    out = []
    for k in range(-12, 6):
        centre = np.float32(qmax * 2.0 ** k)
        for d in range(-3, 4):
            m = centre
            for _ in range(abs(d)):
                m = np.nextafter(m, np.float32(np.inf if d > 0 else -np.inf))
            out.append((k, d, np.float32(m)))
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_prefill_scale_at_pow2_edges(bits):
    """One layer per edge: K's max |x| is m (on a negative element), every
    other element at most m / 3; V random. Against JAX: equal scales and
    pages for m <= qmax * 2^k; above it both pick k or k + 1, and where
    they agree their pages agree too."""
    edges = _edges(bits)
    n = len(edges)
    rng = np.random.RandomState(bits)
    shape = (n, TRASH + 1, PAGE, HKV, DH)
    k = rng.uniform(-1, 1, (n, 12, HKV, DH)).astype(np.float32)
    for i, (_, _, m) in enumerate(edges):
        k[i] *= m / np.float32(3)
        k[i, 5, 1, 2] = -m
    c = dict(kd=rng.randint(-128, 128, shape).astype(np.int8),
             vd=rng.randint(-128, 128, shape).astype(np.int8),
             ks=np.zeros((n, SLOTS), np.float32),
             vs=np.zeros((n, SLOTS), np.float32),
             table=rng.permutation(TRASH).reshape(SLOTS, PPS).astype(
                 np.int32),
             k=k, v=rng.standard_normal((n, 12, HKV, DH)).astype(np.float32))
    kw = _pcfg(bits)
    (wd, ws) = _jax_prefill(c, 10, "float32", kw)
    (gd, gs) = _port_prefill(c, 10, "float32", kw)
    differ = []
    for i, (kk, d, m) in enumerate(edges):
        jw, pt = ws[0][i, SLOT], gs[0][i, SLOT]
        if d <= 0:
            assert jw == pt == kk, (kk, d, m, jw, pt)
        else:
            assert jw in (kk, kk + 1) and pt in (kk, kk + 1), (kk, d, jw, pt)
        if jw == pt:
            np.testing.assert_array_equal(gd[0][i, :TRASH], wd[0][i, :TRASH])
        else:
            differ.append((kk, d))
    assert all(d > 0 for _, d in differ)
    np.testing.assert_array_equal(gs[1], ws[1])
    np.testing.assert_array_equal(gd[1][:, :TRASH], wd[1][:, :TRASH])


# ---------------------------------------------------------------------------
# (c) the route, and the model-dtype pool
# ---------------------------------------------------------------------------

def test_quantized_write_prefill_is_one_prefill_paged(monkeypatch):
    calls = {"prefill_paged": 0, "encode_rows": 0, "encode_scalar": 0}
    for mod, name in ((ops, "prefill_paged"), (CB, "encode_rows"),
                      (CB, "encode_scalar")):
        def wrapped(*a, _n=name, _fn=getattr(mod, name), **k):
            calls[_n] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    c = _case(5, 16, 13)
    _port_prefill(c, 13, "bfloat16", _pcfg(8))
    assert calls == {"prefill_paged": 1, "encode_rows": 0,
                     "encode_scalar": 0}


@pytest.mark.parametrize("padded", [False, True])
def test_model_dtype_prefill_equals_jax(padded):
    length = 13 if padded else 16
    c = _case(6 + padded, 16, length, quantized=False)
    kw = _pcfg(8, quantized=False)
    (wd, ws) = _jax_prefill(c, length, "float32", kw)
    (gd, gs) = _port_prefill(c, length, "float32", kw)
    for g, w in zip(gd, wd):
        np.testing.assert_array_equal(g[:, :TRASH], w[:, :TRASH])
    for g, w in zip(gs, ws):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# (d) what the wrappers refuse
# ---------------------------------------------------------------------------

def _args(c):
    pool = _port_pool(c)
    d, sc = pool["data"]["sub_0"], pool["scale_log2"]["sub_0"]
    return [d["k"], d["v"], sc["k"], sc["v"], torch.from_numpy(c["k"]),
            torch.from_numpy(c["v"]), torch.from_numpy(c["table"][SLOT]),
            SLOT, 10]


def test_prefill_wrappers_refuse():
    c = _case(9, 12, 10)
    kw = dict(page_size=PAGE, bits=8)
    # the kernel on CPU tensors
    with pytest.raises(ValueError, match="CUDA device"):
        KP.prefill_paged_cuda(*_args(c), **kw)
    bad = _args(c)
    bad[1] = bad[1][:, :-1].contiguous()                  # pools differ
    with pytest.raises(ValueError, match="pools"):
        KP.prefill_paged_torch(*bad, **kw)
    bad = _args(c)
    bad[3] = bad[3].t().contiguous().t()                  # scale layout
    with pytest.raises(ValueError, match="scales"):
        KP.prefill_paged_torch(*bad, **kw)
    bad = _args(c)
    bad[7] = SLOTS                                        # slot past them
    with pytest.raises(ValueError, match="slot"):
        KP.prefill_paged_torch(*bad, **kw)
    bad = _args(c)
    bad[5] = bad[5][:, :-1]                               # K, V shapes
    with pytest.raises(ValueError, match="tokens"):
        KP.prefill_paged_torch(*bad, **kw)
    with pytest.raises(ValueError, match="bits"):
        KP.prefill_paged_torch(*_args(c), page_size=PAGE, bits=16)
    with pytest.raises(ValueError, match="page_size"):
        KP.prefill_paged_torch(*_args(c), page_size=4, bits=8)
