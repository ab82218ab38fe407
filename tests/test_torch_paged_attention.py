"""repro_torch's paged attention against repro's (the JAX reference).

The port's plain page walk (``paged_attention_torch``, the CPU path and
the oracle its CUDA kernel meets on the card) must agree with the Pallas
kernel in interpret mode and with gather + ``gqa_attend`` over MHA/GQA/MQA
head layouts, int8 and fp pages, S in {1, 4}, ragged lens including the
first position, exact page boundaries and the last position that fits.
Tolerance: atol/rtol 1e-5 in fp32 — the two packages sum the online
softmax in different orders, so they agree to float roundoff, not bits.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import paged_attention as JPA  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import paged_attention as TPA  # noqa: E402
from repro_torch.models.attention import GQADef, gqa_attend  # noqa: E402
from repro_torch.serve import kv_cache as TKC  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _pool(seed, *, b, pp, page, hkv, hq, dh, s, quantized):
    """Random pool + table + ragged lens as numpy; q-block rows sit at
    lens..lens+s-1, all within the slot horizon."""
    rng = np.random.RandomState(seed)
    total = b * pp
    if quantized:
        kd = rng.randint(-128, 128, (total + 1, page, hkv, dh)).astype(np.int8)
        vd = rng.randint(-128, 128, (total + 1, page, hkv, dh)).astype(np.int8)
        # scales put |K|, |V| <= 127 * 2^-5 ~ 4, the range the pool's
        # per-tensor-max scale gives real activations
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
    if b > 2:
        lens[1] = page - 1 if s > 1 else page   # straddle / hit a boundary
    q = rng.randn(b, s, hq, dh).astype(np.float32)
    return q, kd, vd, ks, vs, table, lens


def _torch(args):
    return tuple(torch.from_numpy(a) for a in args)


def _gather_reference(q, kd, vd, ks, vs, table, lens, *, page, quantized):
    """The port's own gather path: dequantized slot views + gqa_attend with
    per-row positions lens + j."""
    b, s, hq, dh = q.shape
    pcfg = TKC.PoolConfig(num_slots=b, page_size=page,
                          pages_per_slot=table.shape[1], quantized=quantized)
    k = TKC.gather_slots(kd, ks, table, pcfg, torch.float32)
    v = TKC.gather_slots(vd, vs, table, pcfg, torch.float32)
    pos = lens[:, None].long() + torch.arange(s)[None]
    d = GQADef(None, None, None, hq, kd.shape[2], dh, hq)
    out = gqa_attend(q, k, v, d, pos)
    return out.reshape(b, s, hq, dh)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2), (3, 1)])  # MHA/GQA/MQA
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("s", [1, 4])
def test_page_walk_matches_pallas_kernel_and_gather(hq, hkv, quantized, s):
    args = _pool(5, b=4, pp=5, page=8, hkv=hkv, hq=hq, dh=16, s=s,
                 quantized=quantized)
    ref = JPA.paged_attention_kernel(*(jnp.asarray(a) for a in args),
                                     page_size=8, quantized=quantized,
                                     interpret=True)
    targs = _torch(args)
    out = TPA.paged_attention_torch(*targs, page_size=8, quantized=quantized)
    assert out.shape == targs[0].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    gat = _gather_reference(*targs, page=8, quantized=quantized)
    np.testing.assert_allclose(out.numpy(), gat.numpy(), **TOL)


def test_rank3_decode_equals_rank4_s1():
    q, *rest = _torch(_pool(8, b=3, pp=4, page=8, hkv=2, hq=4, dh=16, s=1,
                            quantized=True))
    f = functools.partial(TPA.paged_attention_torch, page_size=8,
                          quantized=True)
    r3 = f(q[:, 0], *rest)
    r4 = f(q, *rest)
    assert tuple(r3.shape) == (3, 4, 16)
    assert torch.equal(r3, r4[:, 0])


def test_qblock_rows_match_sequential_single_token_calls():
    """Row j of an S-row call equals an S=1 call at lens + j."""
    q, kd, vd, ks, vs, table, lens = _torch(_pool(
        9, b=3, pp=5, page=8, hkv=2, hq=4, dh=16, s=4, quantized=True))
    f = functools.partial(TPA.paged_attention_torch, page_size=8,
                          quantized=True)
    blk = f(q, kd, vd, ks, vs, table, lens)
    for j in range(4):
        row = f(q[:, j], kd, vd, ks, vs, table, lens + j)
        np.testing.assert_allclose(blk[:, j].numpy(), row.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_ops_impl_routing_on_cpu():
    """On CPU tensors impl="cuda" runs the plain version, bitwise the same
    as impl="torch"; unknown impls raise. (CUDA tensors are refused by
    impl="torch" — exercised on the card by test_torch_cuda.py.)"""
    args = _torch(_pool(3, b=2, pp=3, page=8, hkv=2, hq=4, dh=16, s=3,
                        quantized=True))
    kw = dict(page_size=8, quantized=True)
    a = TOPS.paged_attention(*args, impl="cuda", **kw)
    b = TOPS.paged_attention(*args, impl="torch", **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TOPS.paged_attention(*args, impl="pallas", **kw)


def test_bf16_q_returns_bf16_within_rounding():
    """A bf16 q-block (the serving dtype) comes back bf16, equal to the
    f32 walk rounded once."""
    q, *rest = _torch(_pool(12, b=2, pp=3, page=8, hkv=2, hq=4, dh=16, s=1,
                            quantized=True))
    qb = q.to(torch.bfloat16)
    out = TPA.paged_attention_torch(qb, *rest, page_size=8, quantized=True)
    ref = TPA.paged_attention_torch(qb.float(), *rest, page_size=8,
                                    quantized=True)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.to(torch.bfloat16))
