"""The chunk step's paged K/V write and the paged history read of
repro_torch against repro (the JAX reference), on the CPU.

On the card a chunk step writes K and V of one layer in one
``p2_append_paged`` launch (``kernels/kv_append.py`` at S > 1) and reads
every slot's history in one ``p2_read_paged`` launch
(``kernels/kv_read.py``); here their plain twins run, reached the way the
engine reaches them (``kv_cache.write_chunk_kv``, ``kv_cache.read_kv``),
and are held bit for bit to JAX:

(a) the chunk write against ``repro.serve.kv_cache.write_chunk`` called
    once per tensor: every real page of K and V, f32 and bf16 tokens, 8-
    and 4-bit codes, int8 and int16 pools, V the strided half of the fused
    kv projection; chunks that cross a page, carry pad rows, and hold valid
    rows past the slot's last page (the reference's gather clamps their
    page index, so they land in the last page, the later of two rows that
    meet in one cell winning, as in its scatter); a model-dtype pool;
(b) the other rule at S > 1 (``clamp_last=False``) against JAX's
    ``append_tokens`` (positions past the slot's pages and inactive slots
    to the trash page), and S = 1 against ``append_token``;
(c) the read against ``gather_slots``: B = 1 (the chunk step, with the
    slot's scale as a (1,) view) and B = num_slots (the gather engine's
    decode), bf16 and f32 values, int8 and int16 codes, every position of
    the view, a too-large page number reading the trash page; a
    model-dtype pool;
(d) what the wrappers refuse, and that ``kernels.build.SOURCES`` names
    every kernel source.

Inputs are made with numpy from a seed and handed to both packages (JAX's
pool codec on the CPU is its reference). Tolerance: none, codes and values
are bit-exact. The trash page is write-only scratch and is not compared.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import kv_append as KA  # noqa: E402
from repro_torch.kernels import kv_read as KR  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import PoolConfig  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NP_STORE = {"int8": np.int8, "int16": np.int16}
SLOTS, PAGE, PPS, HKV, DH, S = 3, 4, 3, 2, 8, 8
TRASH = SLOTS * PPS
# (start, valid) of a chunk of S = 8 rows in a slot of 3 pages of 4 (12
# positions): one that crosses a page with pad rows after it; a whole
# chunk from 0; pad rows that reach past the last page; valid rows past
# the last page, four of them meeting earlier rows in one cell; every row
# valid and past it from the last page's first offset
CHUNKS = ((6, 5), (0, 8), (9, 3), (10, 8), (8, 8))


def _tokens(rng, shape, bits, step):
    """fp values on a bits-bit grid of the given step: exact .5 ties and
    some far past the range (saturating)."""
    x = rng.standard_normal(shape) * 2 ** (bits - 2)
    x.reshape(-1)[::7] = np.round(x.reshape(-1)[::7]) + 0.5
    x.reshape(-1)[::5] *= 4
    return np.asarray(x * step, np.float32)


def _pool(rng, store, quantized=True):
    shape = (TRASH + 1, PAGE, HKV, DH)
    if quantized:
        return rng.randint(-128, 128, shape).astype(NP_STORE[store])
    return rng.standard_normal(shape).astype(np.float32)


def _fused_kv(k, v, dt):
    """Torch K contiguous and V the strided view of a fused (..., 2, Hkv,
    Dh) projection, as ``gqa_qkv`` slices it."""
    kv = torch.from_numpy(np.stack([k, v], axis=-3)).to(dt)
    return kv[..., 0, :, :].contiguous(), kv[..., 1, :, :]


# ---------------------------------------------------------------------------
# (a) the chunk write
# ---------------------------------------------------------------------------

def _chunk_case(seed, bits, store, quantized=True):
    rng = np.random.RandomState(seed)
    table = rng.permutation(SLOTS * PPS).reshape(SLOTS, PPS).astype(np.int32)
    scale = rng.randint(-6, 0, (SLOTS,)).astype(np.float32)
    step = 2.0 ** scale[1]
    return dict(kd=_pool(rng, store, quantized),
                vd=_pool(rng, store, quantized), ks=scale,
                vs=scale[::-1].copy(), table=table,
                k=_tokens(rng, (S, HKV, DH), bits, step),
                v=_tokens(rng, (S, HKV, DH), bits, 2.0 ** scale[::-1][1]))


def _jax_write_chunk(c, start, valid, slot, dtype, kw):
    pcfg = JPC(**kw)
    out = []
    for data, scale, new in (("kd", "ks", "k"), ("vd", "vs", "v")):
        d, _ = JKC.write_chunk(
            jnp.asarray(c[data]), jnp.asarray(c[scale]),
            jnp.asarray(c[new]).astype(jnp.dtype(dtype)),
            jnp.asarray(c["table"][slot]), jnp.int32(start),
            jnp.int32(valid), jnp.int32(slot), pcfg)
        out.append(np.asarray(d))
    return out


def _port_write_chunk(c, start, valid, slot, dtype, kw):
    """The engine's call: the slot's table row and its scales as (1,)
    views, start and the valid count as (1,) int32 tensors."""
    kd, vd = torch.from_numpy(c["kd"].copy()), torch.from_numpy(c["vd"].copy())
    ks, vs = torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"])
    k, v = _fused_kv(c["k"][None], c["v"][None], TORCH_DT[dtype])
    assert not v.is_contiguous()
    start_t, valid_t = torch.tensor([[start], [valid]], dtype=torch.int32)
    out = TKC.write_chunk_kv(kd, vd, ks[slot:slot + 1], vs[slot:slot + 1], k,
                             v, torch.from_numpy(c["table"])[slot][None],
                             start_t, valid_t, PoolConfig(**kw))
    assert out[0] is kd and out[1] is vd                 # in place
    return kd.numpy(), vd.numpy()


@pytest.mark.parametrize("start,valid", CHUNKS)
@pytest.mark.parametrize("store", ["int8", "int16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_write_equals_jax_write_chunk(dtype, bits, store, start,
                                            valid):
    c = _chunk_case(start * 10 + valid + bits, bits, store)
    kw = dict(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS,
              quantized=True, bits=bits)
    want = _jax_write_chunk(c, start, valid, 1, dtype, kw)
    got = _port_write_chunk(c, start, valid, 1, dtype, kw)
    for w, g, orig in zip(want, got, (c["kd"], c["vd"])):
        assert g.dtype == w.dtype == NP_STORE[store]
        np.testing.assert_array_equal(g[:TRASH], w[:TRASH])
        assert not np.array_equal(g[:TRASH], orig[:TRASH])      # it wrote
    # what the case covers: rows past the last page land in it, and the
    # written codes reach both clip ends
    pages, offs = KA.token_pages(torch.from_numpy(c["table"][1:2]),
                                 torch.tensor([start]), None, S, PAGE, TRASH,
                                 torch.tensor([valid]), clamp_last=True)
    past = [j for j in range(valid) if start + j >= PAGE * PPS]
    assert not past or any(pages[0, j] == int(c["table"][1, -1])
                           for j in past)
    real = pages < TRASH
    codes = got[0][pages[real].numpy(), offs[real].numpy()]
    assert codes.min() == -2 ** (bits - 1)
    assert codes.max() == 2 ** (bits - 1) - 1


@pytest.mark.parametrize("start,valid", [(6, 5), (10, 8)])
def test_chunk_write_model_dtype_pool_equals_jax(start, valid):
    """A model-dtype pool takes no kernel: ``write_chunk`` per tensor,
    equal to JAX's."""
    c = _chunk_case(start + valid, 8, "int8", quantized=False)
    kw = dict(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS)
    want = _jax_write_chunk(c, start, valid, 1, "float32", kw)
    got = _port_write_chunk(c, start, valid, 1, "float32", kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[:TRASH], w[:TRASH])


def test_clamp_rule_keeps_the_later_of_two_rows():
    """Rows at positions 10 and 14 of a 12-position slot meet in one cell
    (the last page, offset 2): the later keeps it, the earlier goes to the
    trash page; pad rows (j >= n_valid) too."""
    table = torch.tensor([[5, 1, 7]], dtype=torch.int32)
    pages, offs = KA.token_pages(table, torch.tensor([10]), None, 8, 4, 9,
                                 torch.tensor([6]), clamp_last=True)
    assert pages.tolist() == [[9, 9, 7, 7, 7, 7, 9, 9]]
    assert offs.tolist() == [[2, 3, 0, 1, 2, 3, 0, 1]]
    pages, _ = KA.token_pages(table, torch.tensor([10]), None, 8, 4, 9,
                              torch.tensor([6]), clamp_last=False)
    assert pages.tolist() == [[7, 7] + [9] * 6]


# ---------------------------------------------------------------------------
# (b) the drop rule at S > 1 and S = 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_rule_equals_jax_append_tokens(dtype, bits):
    """S = 3 rows a slot at lens .. lens + 2: rows past the slot's pages
    and inactive slots to the trash page, as JAX's ``append_tokens``."""
    rng = np.random.RandomState(bits)
    s = 3
    lens = np.asarray([0, 10, 5], np.int32)        # slot 1 runs past 12
    active = np.asarray([True, True, False])
    table = rng.permutation(SLOTS * PPS).reshape(SLOTS, PPS).astype(np.int32)
    scale = rng.randint(-6, 0, (SLOTS,)).astype(np.float32)
    step = (2.0 ** scale)[:, None, None, None]
    k = _tokens(rng, (SLOTS, s, HKV, DH), bits, step)
    v = _tokens(rng, (SLOTS, s, HKV, DH), bits, step)
    kd, vd = _pool(rng, "int8"), _pool(rng, "int8")
    pcfg = JPC(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS,
               quantized=True, bits=bits)
    want = [np.asarray(JKC.append_tokens(
        jnp.asarray(d), jnp.asarray(scale),
        jnp.asarray(x).astype(jnp.dtype(dtype)), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(active), pcfg))
        for d, x in ((kd, k), (vd, v))]
    tk, tv = _fused_kv(k, v, TORCH_DT[dtype])
    got = [torch.from_numpy(kd.copy()), torch.from_numpy(vd.copy())]
    ops.append_paged(*got, torch.from_numpy(scale), torch.from_numpy(scale),
                     tk, tv, torch.from_numpy(table), torch.from_numpy(lens),
                     torch.from_numpy(active), page_size=PAGE, bits=bits)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy()[:TRASH], w[:TRASH])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_token_path_equals_jax_append_token(dtype):
    """S = 1 through the generalized write is the decode append: equal to
    JAX's ``append_token`` per tensor, with a slot at the last offset of
    its last page and an inactive slot."""
    rng = np.random.RandomState(11)
    lens = np.asarray([PAGE * PPS - 1, 4, 7], np.int32)
    active = np.asarray([True, True, False])
    table = rng.permutation(SLOTS * PPS).reshape(SLOTS, PPS).astype(np.int32)
    scale = rng.randint(-6, 0, (SLOTS,)).astype(np.float32)
    step = (2.0 ** scale)[:, None, None, None]
    k = _tokens(rng, (SLOTS, 1, HKV, DH), 8, step)
    v = _tokens(rng, (SLOTS, 1, HKV, DH), 8, step)
    kd, vd = _pool(rng, "int8"), _pool(rng, "int8")
    pcfg = JPC(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS,
               quantized=True)
    want = [np.asarray(JKC.append_token(
        jnp.asarray(d), jnp.asarray(scale),
        jnp.asarray(x).astype(jnp.dtype(dtype)), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(active), pcfg))
        for d, x in ((kd, k), (vd, v))]
    tk, tv = _fused_kv(k, v, TORCH_DT[dtype])
    got = [torch.from_numpy(kd.copy()), torch.from_numpy(vd.copy())]
    TKC.append_kv(*got, torch.from_numpy(scale), torch.from_numpy(scale),
                  tk, tv, torch.from_numpy(table), torch.from_numpy(lens),
                  torch.from_numpy(active),
                  PoolConfig(num_slots=SLOTS, page_size=PAGE,
                             pages_per_slot=PPS, quantized=True))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# (c) the read
# ---------------------------------------------------------------------------

def _read_case(seed, store, quantized=True):
    rng = np.random.RandomState(seed)
    table = rng.permutation(SLOTS * PPS).reshape(SLOTS, PPS).astype(np.int32)
    table[2, 1] = TRASH                      # a slot mapping the trash page
    return dict(kd=_pool(rng, store, quantized),
                vd=_pool(rng, store, quantized), table=table,
                ks=rng.randint(-8, 3, (SLOTS,)).astype(np.float32),
                vs=rng.randint(-8, 3, (SLOTS,)).astype(np.float32))


def _jax_gather(c, table, ks, vs, dtype, kw):
    pcfg = JPC(**kw)
    return [np.asarray(JKC.gather_slots(
        jnp.asarray(c[d]), jnp.asarray(s), jnp.asarray(table), pcfg,
        jnp.dtype(dtype)).astype(jnp.float32))
        for d, s in (("kd", ks), ("vd", vs))]


@pytest.mark.parametrize("store", ["int8", "int16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", ["one slot", "every slot"])
def test_read_equals_jax_gather_slots(batch, dtype, store):
    c = _read_case(len(batch) + len(dtype), store)
    kw = dict(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS,
              quantized=True)
    kd, vd = torch.from_numpy(c["kd"]), torch.from_numpy(c["vd"])
    ks, vs = torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"])
    table = torch.from_numpy(c["table"])
    if batch == "one slot":                  # the chunk step's call, slot 2
        want = _jax_gather(c, c["table"][2][None], c["ks"][2:3],
                           c["vs"][2:3], dtype, kw)
        got = TKC.read_kv(kd, vd, ks[2:3], vs[2:3], table[2][None],
                          PoolConfig(**kw), TORCH_DT[dtype])
    else:                                    # the gather engine's decode
        want = _jax_gather(c, c["table"], c["ks"], c["vs"], dtype, kw)
        got = TKC.read_kv(kd, vd, ks, vs, table, PoolConfig(**kw),
                          TORCH_DT[dtype])
    for w, g in zip(want, got):
        assert g.dtype == TORCH_DT[dtype]
        assert tuple(g.shape) == w.shape == (w.shape[0], PAGE * PPS, HKV, DH)
        np.testing.assert_array_equal(g.float().numpy(), w)
    # the inputs reach every code and the trash page is read
    assert c["kd"][TRASH].any()


def test_read_too_large_page_number_reads_trash_as_jax():
    """JAX's gather clamps a page number past the pool to its last page
    (the trash page); the read does the same, and a negative number reads
    the trash page too."""
    c = _read_case(5, "int8")
    table = c["table"].copy()
    table[0, 0], table[1, 2] = TRASH + 3, TRASH + 100
    kw = dict(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS,
              quantized=True)
    want = _jax_gather(c, table, c["ks"], c["vs"], "float32", kw)
    got = ops.read_paged(torch.from_numpy(c["kd"]), torch.from_numpy(c["vd"]),
                         torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"]),
                         torch.from_numpy(table), dtype=torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    table[0, 0] = -2
    k, _ = ops.read_paged(torch.from_numpy(c["kd"]), torch.from_numpy(c["vd"]),
                          torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"]),
                          torch.from_numpy(table), dtype=torch.float32)
    np.testing.assert_array_equal(k[0, :PAGE].numpy(), want[0][0, :PAGE])


def test_read_model_dtype_pool_equals_jax():
    c = _read_case(6, "int8", quantized=False)
    kw = dict(num_slots=SLOTS, page_size=PAGE, pages_per_slot=PPS)
    want = _jax_gather(c, c["table"], c["ks"], c["vs"], "float32", kw)
    got = TKC.read_kv(torch.from_numpy(c["kd"]), torch.from_numpy(c["vd"]),
                      torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"]),
                      torch.from_numpy(c["table"]), PoolConfig(**kw),
                      torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# (d) refusals and the build's source list
# ---------------------------------------------------------------------------

def _append_args():
    c = _chunk_case(1, 8, "int8")
    k, v = _fused_kv(c["k"][None], c["v"][None], torch.float32)
    lens, n_valid = torch.tensor([[3], [5]], dtype=torch.int32)
    return [torch.from_numpy(c["kd"]), torch.from_numpy(c["vd"]),
            torch.from_numpy(c["ks"][:1]), torch.from_numpy(c["vs"][:1]), k,
            v, torch.from_numpy(c["table"][:1]), lens, None], dict(
                page_size=PAGE, bits=8, n_valid=n_valid, clamp_last=True)


def test_append_paged_refuses():
    args, kw = _append_args()
    ops.append_paged(*args, **kw)                         # the twin takes it
    bad = [(4, args[4][..., :-1], ValueError),             # feature shape
           (4, args[4].to(torch.int32), TypeError),        # K's dtype
           (5, args[5][:, :-1], ValueError),               # S differs from K
           (7, torch.tensor([3, 4]), ValueError),          # lens of 2 slots
           (8, torch.tensor([True, False]), ValueError)]   # active likewise
    for i, t, err in bad:
        a = list(args)
        a[i] = t
        with pytest.raises(err):
            ops.append_paged(*a, **kw)
    with pytest.raises(ValueError):
        ops.append_paged(*args, **{**kw, "n_valid": torch.tensor([1, 2])})
    with pytest.raises(TypeError):                        # K and V dtypes
        a = list(args)
        a[4], a[5] = args[4].double(), args[5].double()
        ops.append_paged(*a, **kw)
    with pytest.raises(ValueError):                       # a 12-bit grid
        ops.append_paged(*args, **{**kw, "bits": 12})
    with pytest.raises(ValueError):
        ops.append_paged(*args, **kw, impl="auto")
    with pytest.raises(ValueError, match="CUDA device"):  # CPU tensors
        KA.append_paged_cuda(*args, **kw)
    a = list(args)
    a[6] = args[6].to("meta")                             # mixed devices
    with pytest.raises(ValueError, match="CUDA device"):
        KA.append_paged_cuda(*a, **kw)


def test_read_paged_refuses():
    c = _read_case(2, "int8")
    kd, vd = torch.from_numpy(c["kd"]), torch.from_numpy(c["vd"])
    ks, vs = torch.from_numpy(c["ks"]), torch.from_numpy(c["vs"])
    table = torch.from_numpy(c["table"])
    ops.read_paged(kd, vd, ks, vs, table, dtype=torch.bfloat16)
    for args, err in (((kd, vd[:-1], ks, vs, table), ValueError),
                      ((kd, vd.to(torch.int16), ks, vs, table), ValueError),
                      ((kd.to(torch.uint8), vd.to(torch.uint8), ks, vs,
                        table), TypeError),
                      ((kd, vd, ks[:2], vs, table), ValueError),
                      ((kd, vd, ks, vs, table[0]), ValueError),
                      ((kd, vd, ks, vs, table.float()), ValueError),
                      ((kd[:, :, 0], vd[:, :, 0], ks, vs, table), ValueError)):
        with pytest.raises(err):
            ops.read_paged(*args, dtype=torch.float32)
    with pytest.raises(TypeError):
        ops.read_paged(kd, vd, ks, vs, table, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.read_paged(kd, vd, ks, vs, table, dtype=torch.float32,
                       impl="auto")
    with pytest.raises(ValueError, match="CUDA device"):
        KR.read_paged_cuda(kd, vd, ks, vs, table, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        KR.read_paged_cuda(kd, vd, ks, vs, table.to("meta"),
                           dtype=torch.float32)


def test_build_sources_name_every_kernel_source():
    stems = {p.stem for p in Path(B.CSRC).glob("*.cu")}
    assert set(B.SOURCES) == stems and len(B.SOURCES) == len(stems)
    assert {"kv_append", "kv_read"} <= stems
