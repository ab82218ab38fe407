"""repro_torch's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and nvcc and skips without one;
this file imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

(a) the row-scale pow-2 encode/decode kernels are BIT-identical to their
    plain versions on the vector and scalar paths, for f32/bf16/f16;
(b) the paged-attention kernel matches the plain page walk within 1e-5
    (fp32) over MHA/GQA/MQA, S in {1, 4}, int8 and fp pages, head dims
    that are and are not multiples of the warp;
(c) the engine's fused and gather paths emit identical greedy tokens in
    fp32 on the card, and each path launches its kernels;
(d) the scalar pow-2 fake-quant kernel is BIT-identical to its plain
    version at bits 4/8/16, f32 and bf16, on the vector and scalar paths;
(e) the PE1/PE2/PE3 kernels match their plain versions (f32 1e-4, bf16
    2e-2, the JAX kernel tests' tolerances) at odd shapes and at every
    shape of the FMNIST training step; PE2 and PE3 also on unaligned and
    sliced operands, over the b-split and two-stage paths, and repeat bit
    for bit; PE1's fused epilogue is bit-identical to its own unfused
    output through encode -> decode;
(f) one training step of the FMNIST TT MLP on the card matches the same
    step on the CPU and launches each kernel the counted number of times;
(g) the blockwise encode/decode kernels are BIT-identical to their plain
    versions (codes, scales, values) at b = 1, 16, 256, 1024, padded
    blocks and an all-zero block, and the packed int4x2 encode/decode
    kernels at the FMNIST cores' sizes, per-row steps and odd trailing
    dims;
(h) one full-wire step (int8 moments and the gradient wire) on the card
    matches the CPU step and launches the counted codec kernels;
(i) the scalar-scale encode/decode kernels are BIT-identical to their
    plain versions on the vector path, the scalar tail and unaligned
    views, and a one-element scale dispatches to them; the row-scale
    fake-quant kernel is BIT-identical in values and STE gradient;
(j) chunked prefill with the prefix cache on the card: prefix on == off
    in fp32 and 48 scalar encode + decode launches per chunk step.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as C  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.numerics import codecs  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ttm_pe1, ttm_pe2, ttm_pe3  # noqa: E402
from repro_torch.launch import train_fmnist as TF  # noqa: E402
from repro_torch.models import build_lm, init_lm  # noqa: E402
from repro_torch.models import mlp_tt as MLP  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.optim import adam as A  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; run on the card with "
                    "-m cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols", [(8, 1024), (5, 37), (24, 4096)])
def test_row_scale_codec_kernels_bit_identical(cuda, dtype, rows, cols):
    g = torch.Generator(device=cuda).manual_seed(rows * cols)
    x = (torch.randn((rows, cols), generator=g, device=cuda) * 50).to(dtype)
    s = torch.randint(-4, 2, (rows,), generator=g, device=cuda).float()
    q = CB.encode_rows(x, s, 8)
    assert torch.equal(q, CB.encode_rows_plain(x, s, 8))
    assert torch.equal(CB.decode_rows(q, s, dtype),
                       CB.decode_rows_plain(q, s, dtype))
    # a strided (non-contiguous) input is copied, not misread
    xt = x.t().contiguous().t()
    assert torch.equal(CB.encode_rows(xt, s, 8), q)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (16, 8), (3, 1)])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("s_rows", [1, 4])
@pytest.mark.parametrize("dh", [16, 128])
def test_paged_attention_kernel_matches_page_walk(cuda, hq, hkv, quantized,
                                                  s_rows, dh):
    g = torch.Generator(device=cuda).manual_seed(hq + dh + s_rows)
    b, pp, page = 4, 5, 8
    total = b * pp
    if quantized:
        kd = torch.randint(-128, 128, (total + 1, page, hkv, dh),
                           generator=g, device=cuda).to(torch.int8)
        vd = torch.randint(-128, 128, (total + 1, page, hkv, dh),
                           generator=g, device=cuda).to(torch.int8)
        ks = torch.randint(-9, -4, (b,), generator=g, device=cuda).float()
        vs = torch.randint(-9, -4, (b,), generator=g, device=cuda).float()
    else:
        kd = torch.randn((total + 1, page, hkv, dh), generator=g, device=cuda)
        vd = torch.randn((total + 1, page, hkv, dh), generator=g, device=cuda)
        ks = vs = torch.zeros(b, device=cuda)
    table = torch.randperm(total, generator=g, device=cuda).reshape(b, pp
                                                                    ).int()
    hi = pp * page - s_rows
    lens = torch.tensor([0, page - 1, page, hi], device=cuda,
                        dtype=torch.int32)
    q = torch.randn((b, s_rows, hq, dh), generator=g, device=cuda)
    kw = dict(page_size=page, quantized=quantized)
    out = ops.paged_attention(q, kd, vd, ks, vs, table, lens, **kw)
    ref = PA.paged_attention_torch(q, kd, vd, ks, vs, table, lens, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    if s_rows == 1:
        r3 = ops.paged_attention(q[:, 0], kd, vd, ks, vs, table, lens, **kw)
        assert torch.equal(r3, out[:, 0])
    with pytest.raises(ValueError):
        ops.paged_attention(q, kd, vd, ks, vs, table, lens, impl="torch",
                            **kw)


def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((2, 4, 16), device=cuda)
    kd = torch.zeros((5, 8, 2, 16), device=cuda, dtype=torch.int8)
    sc = torch.zeros(2, device=cuda)
    table = torch.zeros((2, 2), device=cuda, dtype=torch.int32)
    lens = torch.zeros(2, device=cuda, dtype=torch.int32)
    with pytest.raises(TypeError):      # fp pages declared quantized
        PA.paged_attention_cuda(q, kd.float(), kd.float(), sc, sc, table,
                                lens, page_size=8, quantized=True)
    with pytest.raises(ValueError):     # page size mismatch
        PA.paged_attention_cuda(q, kd, kd, sc, sc, table, lens, page_size=4,
                                quantized=True)
    with pytest.raises(TypeError):
        CB.decode_rows(torch.zeros((2, 4), device=cuda), sc, torch.float32)


def test_engine_fused_equals_gather_fp32_on_card(cuda):
    cfg = C.get_reduced("internlm2-1.8b").replace(dtype="float32")
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device=cuda).manual_seed(0), lm,
                     device=cuda)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, int(rng.randint(5, 16))
                           ).tolist() for _ in range(4)]
    outs, launches = [], []
    for fused in (True, False):
        B.reset_launches()
        eng = Engine(lm, params, EngineConfig(
            pool=PoolConfig(num_slots=2, page_size=4, pages_per_slot=8,
                            quantized=True), fused_attention=fused),
            device=cuda)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        res = eng.run()
        outs.append([res[r].tokens for r in rids])
        launches.append((dict(B.LAUNCHES), eng.summary()["decode_steps"]))
    assert outs[0] == outs[1]
    (fl, steps), (gl, _) = launches
    assert fl["paged_attention"] == steps * cfg.num_layers
    assert fl["p2_enc_rows"] > 0 and gl["p2_dec_rows"] > 0


# ---------------------------------------------------------------------------
# (d)-(f) the training slice's kernels
# ---------------------------------------------------------------------------

def _fq_data(n, bits, dtype, gen, cuda):
    """Values on, between and far outside a bits-bit grid of step 2^-3:
    exact .5 ties, random values and both clip ends."""
    hi = 2 ** (bits - 1)
    codes = torch.randint(-hi - 20, hi + 20, (n,), generator=gen,
                          device=cuda).float()
    kind = torch.randint(0, 3, (n,), generator=gen, device=cuda)
    noise = torch.randn((n,), generator=gen, device=cuda) * hi
    x = torch.where(kind == 0, codes + 0.5, torch.where(kind == 1, codes,
                                                         noise))
    return (x * 2.0 ** -3).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [4096, 4099])      # vector / scalar path
def test_fake_quant_kernel_bit_identical(cuda, dtype, bits, n):
    g = torch.Generator(device=cuda).manual_seed(bits + n)
    x = _fq_data(n, bits, dtype, g, cuda)
    step = torch.tensor(-3.0, device=cuda)
    y = CB.fake_quant_scalar(x, step, bits)
    ref = CB.fake_quant_plain(x, step, bits)
    assert y.dtype == dtype
    assert torch.equal(y.view(torch.int16) if dtype == torch.bfloat16
                       else y.view(torch.int32),
                       ref.view(torch.int16) if dtype == torch.bfloat16
                       else ref.view(torch.int32))
    q = ref.float() * 8
    assert q.max().item() >= 2 ** (bits - 1) - 1 and \
        q.min().item() == -2 ** (bits - 1)
    # through the codec API: same values, and the clipped STE gradient
    xr = x.clone().requires_grad_()
    yc = TN.fake_quant(xr, TN.QuantSpec("pow2", bits), step, backend="cuda")
    assert torch.equal(yc, y)
    yc.sum().backward()
    assert torch.equal(xr.grad, codecs.pow2_inside(x, step, bits).to(dtype))


def test_fake_quant_row_scale_refused(cuda):
    """A scale that is not one per leading index is refused (the Pallas
    backend falls back to the reference there, the port does not); one per
    leading index launches the row fake-quant kernel."""
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(NotImplementedError):
        TN.fake_quant(x, TN.QuantSpec("pow2", 8), torch.zeros(2, device=cuda),
                      backend="cuda")
    B.reset_launches()
    TN.fake_quant(x, TN.QuantSpec("pow2", 8), torch.zeros(4, device=cuda),
                  backend="cuda")
    assert dict(B.LAUNCHES) == {"p2_fq_rows": 1}


def _step_pe_calls():
    from repro_torch.core.ttm import pe_shapes
    d = MLP.make_mlp()
    return [c for s in (d.spec1, d.spec2) for sp in (s, s.transposed())
            for c in pe_shapes(sp, 64)]


PE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
          torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _close(a, b, dtype):
    np.testing.assert_allclose(a.float().cpu().numpy(),
                               b.float().cpu().numpy(), **PE_TOL[dtype])


# PE2 edge cases of the streamed kernel (csrc/ttm_pe2.cu): c not a multiple
# of 4 (4-byte / plain copies), d = 1 with b split across threads (b = 512,
# 2048), d = 2, a = 1, and G larger than one stage (b-chunks through the
# ring).
PE2_ODD = [((19, 7, 33), (7, 21)), ((1, 4, 16), (4, 130)),
           ((5, 9, 13), (9, 6)), ((64, 2048, 16), (2048, 1)),
           ((3, 2048, 5), (2048, 1)), ((1, 300, 96), (300, 64)),
           ((4, 2048, 40), (2048, 48)), ((3, 4096, 33), (4096, 5)),
           ((6, 33, 20), (33, 2))]
# PE3 (b, j, i): the step's, odd widths, and b = 2100 over two stages of
# 336 (f32) / 672 (bf16) rows, no multiple of either
PE3_ODD = [(64, 512, 896), (64, 16, 512), (130, 47, 65), (8, 1, 300),
           (2100, 96, 200)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pe_kernels_match_plain_at_step_and_odd_shapes(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=cuda) * scale).to(dtype)
    calls = _step_pe_calls() + [("pe1", (37, 5, 48), (5, 18, 48)),
                                ("pe1", (8, 7, 130), (7, 8, 130))] + [
        ("pe2", zs, gs) for zs, gs in PE2_ODD]
    for kind, zs, gs in calls:
        z, w = rnd(*zs), rnd(*gs, scale=0.2)
        mod = ttm_pe1 if kind == "pe1" else ttm_pe2
        out = getattr(mod, f"{kind}_cuda")(z, w)
        ref = getattr(mod, f"{kind}_torch")(z, w)
        assert out.dtype == dtype and out.shape == ref.shape
        _close(out, ref, dtype)
    for b, j, i in PE3_ODD:
        y, x = rnd(b, j, scale=0.1), rnd(b, i)
        _close(ttm_pe3.pe3_cuda(y, x), ttm_pe3.pe3_torch(y, x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pe2_pe3_take_unaligned_and_sliced_operands(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    flat = torch.randn(1 + 64 * 112 * 128, generator=g, device=cuda).to(dtype)
    z = flat[1:].view(64, 112, 128)       # contiguous, one element off 16 B
    assert z.is_contiguous() and z.data_ptr() % 16 != 0
    w = (torch.randn((112, 4), generator=g, device=cuda) * 0.2).to(dtype)
    _close(ttm_pe2.pe2_cuda(z, w), ttm_pe2.pe2_torch(z, w), dtype)
    zs = torch.randn((9, 40, 37), generator=g, device=cuda).to(dtype)[:, 3:,
                                                                     1:34]
    assert not zs.is_contiguous()         # the wrapper makes it contiguous
    w = (torch.randn((37, 7), generator=g, device=cuda) * 0.2).to(dtype)
    _close(ttm_pe2.pe2_cuda(zs, w), ttm_pe2.pe2_torch(zs, w), dtype)
    y = flat[3:3 + 64 * 16].view(64, 16)
    x = torch.randn((64, 520), generator=g, device=cuda).to(dtype)[:, 5:517]
    _close(ttm_pe3.pe3_cuda(y, x), ttm_pe3.pe3_torch(y, x), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pe2_pe3_launches_repeat_bit_for_bit(cuda, dtype):
    """No atomics: the b-split partials are added in a fixed order."""
    g = torch.Generator(device=cuda).manual_seed(2)
    iv = torch.int32 if dtype == torch.float32 else torch.int16
    for zs, gs in [((64, 512, 16), (512, 1)), ((64, 112, 128), (112, 4)),
                   ((64, 2048, 16), (2048, 1)), ((1792, 32, 16), (32, 32))]:
        z = torch.randn(zs, generator=g, device=cuda).to(dtype)
        w = torch.randn(gs, generator=g, device=cuda).to(dtype)
        assert torch.equal(ttm_pe2.pe2_cuda(z, w).view(iv),
                           ttm_pe2.pe2_cuda(z, w).view(iv))
    for b, j, i in [(64, 16, 512), (64, 512, 896), (2100, 96, 200)]:
        y = torch.randn((b, j), generator=g, device=cuda).to(dtype)
        x = torch.randn((b, i), generator=g, device=cuda).to(dtype)
        assert torch.equal(ttm_pe3.pe3_cuda(y, x).view(iv),
                           ttm_pe3.pe3_cuda(y, x).view(iv))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(3584, 1, 16, 256), (37, 5, 48, 18),
                                   (256, 16, 256, 128)])
def test_pe1_epilogue_bit_identical_to_encode_decode_on_card(cuda, bits,
                                                             shape):
    a, b, c, d = shape
    g = torch.Generator(device=cuda).manual_seed(bits)
    z = torch.randn((a, b, c), generator=g, device=cuda)
    w = torch.randn((b, d, c), generator=g, device=cuda)
    acc = ttm_pe1.pe1_cuda(z, w)
    hi = 2 ** (bits - 1) - 1
    tail = float(min(acc.max(), -acc.min()))
    step = torch.tensor(float(np.floor(np.log2(0.5 * tail / hi))),
                        device=cuda)
    fused = ttm_pe1.pe1_cuda(z, w, step, bits)
    spec = TN.QuantSpec("pow2", bits)
    unfused = TN.decode(TN.encode(acc, spec, step, backend="cuda"),
                        torch.float32, backend="cuda")
    assert torch.equal(fused, unfused)
    q = fused / 2.0 ** float(step)
    assert q.max() == hi and q.min() == -hi - 1


def test_train_step_on_card_matches_cpu_and_counts_launches(cuda):
    d = MLP.make_mlp()
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=0.0)
    p_cpu = MLP.init_mlp(torch.Generator().manual_seed(0), d, device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    xs, ys = TF.fashion_like(256, seed=1)
    batch_c = {"x": torch.from_numpy(xs[:64]), "y": torch.from_numpy(ys[:64])}
    batch_g = {k: v.to(cuda) for k, v in batch_c.items()}
    step = TF.make_step(d, tcfg)
    o_cpu, o_gpu = A.init_adam(p_cpu, tcfg), A.init_adam(p_gpu, tcfg)
    B.reset_launches()
    p_gpu, o_gpu, l_gpu = step(p_gpu, o_gpu, batch_g)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == TF.launches_per_step(d)
    p_cpu, o_cpu, l_cpu = step(p_cpu, o_cpu, batch_c)
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    for a, b in zip(leaves(p_gpu), leaves(p_cpu)):
        if a.is_floating_point():
            # Adam's first step moves each element by at most lr
            assert (a.cpu() - b).abs().max() <= 2 * tcfg.learning_rate + 1e-6
        else:
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("shape,block", [((512,), 256), ((16, 16, 16, 1), 256),
                                         ((16, 4, 4, 16), 256), ((), 256),
                                         ((4096,), 1024), ((14273,), 1024),
                                         ((3, 1000), 256), ((5, 33), 16)])
def test_blockwise_kernels_bit_identical(cuda, shape, block):
    g = torch.Generator(device=cuda).manual_seed(block + len(shape))
    x = torch.randn(shape, generator=g, device=cuda) * 0.05
    if x.dim() and x.shape[-1] > block:
        x[..., :block] = 0.0                       # an all-zero block
    spec = TN.QuantSpec("blockwise", 8, block, "int8", "per_tensor_max")
    last = x.shape[-1] if x.dim() else 1
    x2d = x.reshape(-1, last)
    codes, sc = CB.bw_encode(x2d, block)
    rc, rs = CB.bw_encode_plain(x2d, block)
    assert torch.equal(codes, rc)
    assert torch.equal(sc.view(torch.int32), rs.view(torch.int32))
    assert torch.equal(CB.bw_decode(codes, sc, last),
                       CB.bw_decode_plain(codes, sc, last))
    qt = TN.encode(x, spec, backend="cuda")
    ref = TN.encode(x.cpu(), spec)
    assert torch.equal(qt.codes.cpu(), ref.codes) and qt.shape == ref.shape
    assert torch.equal(TN.decode(qt, backend="cuda").cpu(), TN.decode(ref))


def _packed_case_data(cuda):
    d = MLP.make_mlp()
    p = MLP.init_mlp(torch.Generator(device=cuda).manual_seed(0), d,
                     device=cuda)
    out = [(p[l][f"core_{n}"].reshape(-1), p[l]["wscale_log2"][n].float())
           for l, spec in (("l1", d.spec1), ("l2", d.spec2))
           for n in range(spec.d)]
    g = torch.Generator(device=cuda).manual_seed(5)
    out.append((torch.randn((3, 5, 7), generator=g, device=cuda) * 0.3,
                torch.tensor([-3.0, -2.0, -4.0], device=cuda)))
    out.append((torch.randn((2, 3, 9), generator=g, device=cuda),
                torch.randint(-4, 0, (2, 3), generator=g,
                              device=cuda).float()))
    return out


def test_packed_kernels_bit_identical(cuda):
    spec = TN.QuantSpec("pow2", 4, 0, "int4x2", "fixed")
    for x, s in _packed_case_data(cuda):
        qt = TN.encode(x, spec, s, backend="cuda")
        ref = TN.encode(x.cpu(), spec, s.cpu())
        assert torch.equal(qt.codes.cpu(), ref.codes)
        assert torch.equal(TN.decode(qt, backend="cuda").cpu(),
                           TN.decode(ref))
        x2d, srow = CB._rowwise_lastdim(x, s)
        assert torch.equal(CB.encode_packed(x2d, srow, 4),
                           CB.encode_packed_plain(x2d, srow, 4))


def test_wire_step_on_card_matches_cpu_and_counts_launches(cuda):
    d = MLP.make_mlp()
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=0.0,
                       opt_state_dtype="int8")
    p_cpu = MLP.init_mlp(torch.Generator().manual_seed(0), d, device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda), p_cpu)
    xs, ys = TF.fashion_like(256, seed=1)
    batch_c = {"x": torch.from_numpy(xs[:64]), "y": torch.from_numpy(ys[:64])}
    batch_g = {k: v.to(cuda) for k, v in batch_c.items()}
    step = TF.make_step(d, tcfg, compress=True)
    B.reset_launches()
    p_gpu, o_gpu, l_gpu, _, r_gpu = step(p_gpu, A.init_adam(p_gpu, tcfg),
                                         batch_g, None)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == TF.launches_per_step(d, tcfg, compress=True)
    p_cpu, o_cpu, l_cpu, _, r_cpu = step(p_cpu, A.init_adam(p_cpu, tcfg),
                                         batch_c, None)
    assert abs(l_gpu.item() - l_cpu.item()) <= 1e-5 * abs(l_cpu.item())
    for a, b in zip(leaves(p_gpu), leaves(p_cpu)):
        if a.is_floating_point():
            assert (a.cpu() - b).abs().max() <= 2 * tcfg.learning_rate + 1e-6
        else:
            assert torch.equal(a.cpu(), b)
    assert sum(r is not None for r in r_gpu) == 21


# ---------------------------------------------------------------------------
# (i)-(j) the chunked-prefill slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n,off", [(131072, 0), (1001, 0), (4096, 1), (3, 0)])
def test_scalar_codec_kernels_bit_identical(cuda, dtype, n, off):
    g = torch.Generator(device=cuda).manual_seed(n + off)
    base = (torch.randn(n + off, generator=g, device=cuda) * 50).to(dtype)
    x = base[off:]                          # off = 1: an unaligned view
    codes = torch.randint(-128, 128, (n + off,), generator=g, device=cuda
                          ).to(torch.int8)[off:]
    for s_val in range(-8, 3):
        s = torch.tensor(float(s_val), device=cuda)
        q = CB.encode_scalar(x, s, 8)
        assert torch.equal(q, CB.encode_scalar_plain(x, s, 8))
        y, ref = CB.decode_scalar(codes, s, dtype), \
            CB.decode_scalar_plain(codes, s, dtype)
        iv = torch.int16 if dtype != torch.float32 else torch.int32
        assert torch.equal(y.view(iv), ref.view(iv))


def test_one_element_scale_dispatches_to_the_scalar_kernels(cuda):
    spec = TN.QuantSpec("pow2", 8, 0, "int8", "per_tensor_max")
    x = torch.randn((1, 9, 2, 8), device=cuda) * 4
    for s in (torch.tensor(-3.0, device=cuda),
              torch.full((1,), -3.0, device=cuda),
              torch.full((1, 1), -3.0, device=cuda)):
        B.reset_launches()
        qt = TN.encode(x, spec, s, backend="cuda")
        y = TN.decode(qt, torch.bfloat16, backend="cuda")
        assert dict(B.LAUNCHES) == {"p2_enc": 1, "p2_dec": 1}
        ref = TN.encode(x.cpu(), spec, s.cpu())
        assert torch.equal(qt.codes.cpu(), ref.codes)
        assert torch.equal(y.cpu(), TN.decode(ref, torch.bfloat16))
    B.reset_launches()
    TN.encode(x.reshape(3, 3, 2, 8), spec, torch.zeros((3, 1), device=cuda),
              backend="cuda")
    assert dict(B.LAUNCHES) == {"p2_enc_rows": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("shape,sshape", [((4, 6, 8), (4, 1)),
                                          ((5, 7, 3), (5,)),
                                          ((24, 8, 128), (24,))])
def test_row_fake_quant_kernel_bit_identical(cuda, dtype, bits, shape,
                                             sshape):
    g = torch.Generator(device=cuda).manual_seed(bits + len(shape))
    s = torch.randint(-6, 2, sshape, generator=g, device=cuda).float()
    sb = s.reshape(sshape + (1,) * (len(shape) - len(sshape)))
    x = (_fq_data(math.prod(shape), bits, torch.float32, g, cuda)
         .reshape(shape) * torch.exp2(sb) * 8).to(dtype)
    spec = TN.QuantSpec("pow2", bits)
    xk = x.clone().requires_grad_()
    yk = TN.fake_quant(xk, spec, s, backend="cuda")
    yk.float().sum().backward()
    xr = x.cpu().clone().requires_grad_()
    yr = TN.fake_quant(xr, spec, s.cpu())
    yr.float().sum().backward()
    iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(yk.detach().cpu().view(iv), yr.detach().view(iv))
    assert torch.equal(xk.grad.cpu().view(iv), xr.grad.view(iv))
    assert 0 < int((xr.grad == 0).sum()) < x.numel()


def test_engine_chunked_prefix_on_card(cuda):
    cfg = C.get_reduced("internlm2-1.8b").replace(dtype="float32")
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device=cuda).manual_seed(0), lm,
                     device=cuda)
    rng = np.random.RandomState(7)
    v = cfg.vocab_size
    base = rng.randint(0, v, 20).tolist()
    sfx = [rng.randint(0, v, 6).tolist() for _ in range(3)]
    prompts = [base + sfx[0], base + sfx[1], base[:18] + sfx[2],
               base + sfx[0][:3] + sfx[1][:3]]
    outs = []
    for prefix in (False, True):
        B.reset_launches()
        eng = Engine(lm, params, EngineConfig(
            pool=PoolConfig(num_slots=2, page_size=8, pages_per_slot=4,
                            quantized=True), prefill_chunk=8,
            prefix_cache=prefix, fused_attention=True), device=cuda)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        res = eng.run()
        outs.append([res[r].tokens for r in rids])
        steps = sum(-(-(n - h) // 8) if h else -(-n // 8) - 1
                    for n, h in eng.metrics.prefills)
        per = 2 * cfg.num_layers
        assert B.LAUNCHES["p2_enc"] == B.LAUNCHES["p2_dec"] == per * steps
    assert outs[0] == outs[1]
    assert eng.summary()["cow_forks"] > 0
