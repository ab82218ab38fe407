"""The decode step's paged KV append of repro_torch
(``kernels/kv_append.py``: ``p2_append_paged`` on the card, its plain twin
here) against repro (the JAX reference), on the CPU.

On the card one launch writes K and V of every slot of a layer into its
pool pages; its plain twin and the engine's ``kv_cache.append_kv`` (which
routes a quantized pool to it) are held here to JAX's
``repro.serve.kv_cache.append_token`` called once per tensor, bit for bit
on the whole pool:

(a) f32 and bf16 tokens, 8- and 4-bit codes, V as the strided view of the
    fused kv projection, inactive slots going to the trash page, slots
    writing the first and the last offset of a page and the last offset of
    their last page, values past the scale's range saturating, exact .5
    ties, ``lens`` in int32;
(b) the page arithmetic (``token_pages`` of one token a slot) at the
    last page: a position
    past it goes to the trash page, where JAX's ``take_along_axis`` fills
    the index and its scatter drops the write, so no real page changes in
    either package;
(c) a one-slot batch, a model-dtype pool, and the routing of
    ``ops.append_paged``.

Inputs are made with numpy from a seed and handed to both packages (JAX's
pool codec on the CPU is its reference). Tolerance: none, codes are
bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import PoolConfig as JPC  # noqa: E402
from repro.serve import kv_cache as JKC  # noqa: E402
from repro_torch.kernels import kv_append as KA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import PoolConfig  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# slot: (lens, active) — the first offset of a page, the last offset of a
# page, the last offset of the last page, an inactive slot, a mid-page
# slot, a second inactive slot at another trash offset
SLOTS = ((0, True), (3, True), (11, True), (5, False), (6, True), (2, False))


def _pool(seed, *, slots=6, page=4, pps=3, hkv=2, dh=8, bits=8,
          dtype="float32", lens_active=SLOTS):
    """A case: (kw of PoolConfig, numpy inputs dict). Pages hold random
    codes, so untouched positions are compared too."""
    rng = np.random.RandomState(seed)
    total = slots * pps
    lens = np.asarray([la[0] for la in lens_active], np.int32)
    active = np.asarray([la[1] for la in lens_active], bool)
    table = rng.permutation(total).reshape(slots, pps).astype(np.int32)
    qmax = 2 ** (bits - 1)
    scale = rng.randint(-6, 0, slots).astype(np.float32)
    step = (2.0 ** scale)[:, None, None, None]

    def token():
        x = rng.standard_normal((slots, 1, hkv, dh)) * (qmax / 2)
        x.reshape(-1)[::7] = np.round(x.reshape(-1)[::7]) + 0.5  # ties
        x.reshape(-1)[::5] *= 4                                   # saturate
        return np.asarray(x * step, np.float32)

    def data():
        return rng.randint(-128, 128, (total + 1, page, hkv, dh)
                           ).astype(np.int8)
    kw = dict(num_slots=slots, page_size=page, pages_per_slot=pps,
              quantized=True, bits=bits)
    return kw, dict(k=token(), v=token(), kd=data(), vd=data(),
                    ks=scale, vs=scale[::-1].copy(), table=table, lens=lens,
                    active=active, dtype=dtype)


def _jax(kw, c):
    """JAX's append_token for K, then for V: the pools as numpy."""
    pcfg = JPC(**kw)
    out = []
    for data, scale, new in (("kd", "ks", "k"), ("vd", "vs", "v")):
        out.append(np.asarray(JKC.append_token(
            jnp.asarray(c[data]), jnp.asarray(c[scale]),
            jnp.asarray(c[new]).astype(jnp.dtype(c["dtype"])),
            jnp.asarray(c["table"]), jnp.asarray(c["lens"]),
            jnp.asarray(c["active"]), pcfg)))
    return out


def _torch(c):
    """The port's inputs: fresh pools, K contiguous, V the strided view of
    a fused (B, 1, 2, Hkv, Dh) projection as ``gqa_qkv`` slices it."""
    dt = TORCH_DT[c["dtype"]]
    kv = torch.from_numpy(np.stack([c["k"], c["v"]], axis=2)).to(dt)
    k, v = kv[:, :, 0].contiguous(), kv[:, :, 1]
    assert v.shape[0] == 1 or not v.is_contiguous()
    return dict(kd=torch.from_numpy(c["kd"].copy()),
                vd=torch.from_numpy(c["vd"].copy()),
                ks=torch.from_numpy(c["ks"]), vs=torch.from_numpy(c["vs"]),
                k=k, v=v, table=torch.from_numpy(c["table"]),
                lens=torch.from_numpy(c["lens"]),
                active=torch.from_numpy(c["active"]))


def _run(how, kw, c):
    t = _torch(c)
    pcfg = PoolConfig(**kw)
    args = (t["kd"], t["vd"], t["ks"], t["vs"], t["k"], t["v"], t["table"],
            t["lens"], t["active"])
    if how == "twin":
        KA.append_paged_torch(*args, page_size=pcfg.page_size,
                              bits=pcfg.bits)
    elif how == "ops":
        ops.append_paged(*args, page_size=pcfg.page_size, bits=pcfg.bits)
    elif how == "append_kv":
        TKC.append_kv(*args, pcfg)
    else:                                  # the per-tensor form
        TKC.append_tokens(t["kd"], t["ks"], t["k"], t["table"], t["lens"],
                          t["active"], pcfg)
        TKC.append_tokens(t["vd"], t["vs"], t["v"], t["table"], t["lens"],
                          t["active"], pcfg)
    return t["kd"].numpy(), t["vd"].numpy()


@pytest.mark.parametrize("how", ["twin", "ops", "append_kv", "append_tokens"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_equals_jax_append_token_per_tensor(dtype, bits, how):
    kw, c = _pool(bits + len(dtype), bits=bits, dtype=dtype)
    want_k, want_v = _jax(kw, c)
    got_k, got_v = _run(how, kw, c)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_v, want_v)
    # what the case covers: every written code in range, both clip ends
    # reached, the trash page written at both inactive offsets, and no
    # other page than the targets touched
    lo, hi = -2 ** (bits - 1), 2 ** (bits - 1) - 1
    trash, page = kw["num_slots"] * kw["pages_per_slot"], kw["page_size"]
    pages, offs = KA.token_pages(torch.from_numpy(c["table"]),
                                 torch.from_numpy(c["lens"]),
                                 torch.from_numpy(c["active"]), 1, page,
                                 trash)
    written = got_k[pages.numpy(), offs.numpy()]
    assert written.min() == lo and written.max() == hi
    assert sorted(offs[pages == trash].tolist()) == [1, 2]
    touched = np.zeros(got_k.shape[:2], bool)
    touched[pages.numpy(), offs.numpy()] = True
    np.testing.assert_array_equal(got_k[~touched], c["kd"][~touched])


def test_append_slots_at_the_last_page():
    """Position max_len - 1 writes the last offset of the slot's last page;
    max_len (past it) and an inactive slot go to the trash page. JAX
    drops the write past the last page: its real pages stay as they were,
    and so do the port's."""
    page, pps = 4, 3
    table = torch.tensor([[5, 1, 7], [2, 0, 4], [8, 3, 6]], dtype=torch.int32)
    for dt in (torch.int32, torch.int64):
        lens = torch.tensor([page * pps - 1, page * pps, page * pps - 1],
                            dtype=dt)
        active = torch.tensor([True, True, False])
        pages, offs = KA.token_pages(table, lens, active, 1, page, 9)
        assert pages.tolist() == [[7], [9], [9]]
        assert offs.tolist() == [[3], [0], [3]]
        assert pages.dtype == offs.dtype == torch.int64
    kw, c = _pool(3, slots=3, pps=pps, lens_active=((11, True), (12, True),
                                                     (11, False)))
    want_k, want_v = _jax(kw, c)
    got_k, got_v = _run("append_kv", kw, c)
    np.testing.assert_array_equal(got_k[:-1], want_k[:-1])
    np.testing.assert_array_equal(got_v[:-1], want_v[:-1])
    # slot 1's write, dropped by JAX, lands on the trash page here
    assert not np.array_equal(got_k[-1], c["kd"][-1])
    np.testing.assert_array_equal(want_k[-1, :3], c["kd"][-1, :3])


def test_one_slot_batch_equals_jax():
    """B = 1: append_tokens' codec takes the scalar-scale path, the twin
    the row path; both equal JAX."""
    kw, c = _pool(9, slots=1, lens_active=((6, True),))
    want = _jax(kw, c)
    for how in ("twin", "append_tokens"):
        got = _run(how, kw, c)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_model_dtype_pool_appends_through_index_put():
    """A model-dtype pool takes no kernel: append_kv is append_tokens per
    tensor, equal to JAX's."""
    kw, c = _pool(4)
    kw["quantized"] = False
    rng = np.random.RandomState(4)
    for key in ("kd", "vd"):
        c[key] = np.asarray(rng.standard_normal(c[key].shape), np.float32)
    want_k, want_v = _jax(kw, c)
    t = _torch(c)
    TKC.append_kv(t["kd"], t["vd"], t["ks"], t["vs"], t["k"], t["v"],
                  t["table"], t["lens"], t["active"], PoolConfig(**kw))
    np.testing.assert_array_equal(t["kd"].numpy(), want_k)
    np.testing.assert_array_equal(t["vd"].numpy(), want_v)


def test_append_paged_routes_and_refuses():
    kw, c = _pool(5)
    want = _run("twin", kw, c)
    t = _torch(c)
    args = (t["kd"], t["vd"], t["ks"], t["vs"], t["k"], t["v"], t["table"],
            t["lens"], t["active"])
    ops.append_paged(*args, page_size=4, bits=8, impl="torch")
    np.testing.assert_array_equal(t["kd"].numpy(), want[0])
    with pytest.raises(ValueError):
        ops.append_paged(*args, page_size=4, bits=8, impl="auto")
    with pytest.raises(ValueError):          # the kernel takes CUDA tensors
        KA.append_paged_cuda(*args, page_size=4, bits=8)
