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
    fp32 on the card, and each path launches its kernels; greedy
    speculative decoding (an independent draft and a self-draft, fused
    and gather) emits the non-spec tokens with its launches as counted;
(d) the scalar pow-2 fake-quant kernel is BIT-identical to its plain
    version at bits 4/8/16, f32 and bf16, on the vector and scalar paths;
(e) the PE1/PE2/PE3 kernels match their plain versions (f32 1e-4, bf16
    2e-2, the JAX kernel tests' tolerances) at odd shapes and at every
    shape of the FMNIST training step; PE2 and PE3 also on unaligned and
    sliced operands, over the b-split and two-stage paths, and repeat bit
    for bit; PE2 and PE3 in bf16 on the tensor cores (every tiling at
    ragged shapes, the LM's calls cut down) match and repeat bit for bit,
    one ``pe2`` launch a call; PE1's fused epilogue is bit-identical to its
    own unfused output through encode -> decode; PE1 in bf16 on the tensor
    cores (ragged a, c = 8 / 16 / 32 and K fills, d in one, two and four
    warpgroups) matches and repeats bit for bit, one ``pe1`` launch a call,
    and its epilogue on exact sums is the plain version's bit for bit;
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
    in fp32, one paged write and one paged read a layer a chunk step and
    no scalar codec launch;
(k) the codec kernels in int16, int32 and float32 storage bit for bit
    (the 32-bit grid's saturating top, bf16's 16-bit top code); PE1's own
    kernel at odd granules, unaligned, repeating bit for bit; the split
    and combine attention kernels each against its plain mirror, over
    span sizes 1, 2, 3 and 8 pages, a span where a row has no unmasked
    key, model-dtype pages and 4-byte-granule head dims;
(l) the grouped launches: the fake-quant group (f32, bf16; bits 4/8/16)
    and the blockwise encode group (int8, int16, int32, float32 codes) on
    the step's leaf sets bit for bit with their twins and over two
    launches, one launch per group and two just above the cap, and the
    int8 moments of a grouped step saved byte for byte as the per-leaf
    path's;
(m) the decode group on the step's leaf sets (every code type, mixed in
    one launch) and on unaligned leaves bit for bit with its twin, one
    launch per set and two just above the cap; the paged KV append
    (``p2_append_paged``) bit for bit with its twin on the whole pool,
    trash page included, for f32/bf16 tokens, 8/4-bit codes and V as a
    strided view, and an engine's decode steps launching it once a layer
    and ``p2_enc_rows`` only for prefills;
(n) the chunk step's paged write (``p2_append_paged`` at S > 1) and the
    paged read (``p2_read_paged``) bit for bit with their twins and over
    two launches at the chunk and gather shapes, strided V, an odd and an
    unaligned feature layout, and int8, int16, int32 and float32 codes;
    ``impl="torch"`` and mixed devices refused;
(o) the whole-prompt prefill write (``p2_prefill_paged``) bit for bit with
    its twin on the whole pool and the scales, over two launches: S from
    1 to 1,024, bucket padding, the clamp past the slot's last page,
    f32/bf16 caches, V a strided view, 8/4-bit codes in every storage
    type, an all-zero layer, a max at ``qmax * 2^k`` and its f32
    neighbours, odd and unaligned rows; the BinaryConnect export's grouped round trip
    (``p2_fq_group`` in its round-trip mode) bit for bit with the codec's
    per-leaf round trip, zeros' sign included, one launch a bit width;
(p) the packed int4 encode and decode groups (``p2_enc_packed`` /
    ``p2_dec_packed``) bit for bit with their twins over two launches, and
    with the CPU at integer steps: the export's six cores, a stacked tensor with a step per
    row, odd ``last``, a non-integer step, a scalar and misaligned views
    in one group, one launch each way; more entries than the cap in two; a
    group of one; the deploy export and load one launch each, the file
    byte for byte the CPU export's and the cores the CPU load's;
(q) the stream routes: the fake-quant group's wide units beside narrow
    ones (f32, bf16; bits 4/8/16; an odd length and a view one element in,
    steps at 2^-127 / 2^127 and a non-integer step) and the round trip on
    wide units, bit for bit with their twins (integer steps against the
    twin on the CPU: the card's ``torch.exp2(-127)`` is an ulp off 2^-127),
    the narrow units and a second launch; the blockwise encode group's
    stream tasks at b = 256, 512 and 1,024 (ragged row ends, rows of one
    block, a long row, a view one float in, all-zero blocks; int8, int16,
    int32 and float32 codes) bit for bit with the twin, the previous tasks
    and a second launch;
(r) the decode step's state groups (``st_dec_group`` / ``st_enc_group``)
    bit for bit with their twins, with the per-layer route (``read_layer``
    / ``write_layer``) and over two launches: large rows (clusters) and
    small rows (a CTA each) in one launch, f32, bf16 and f16 states, a
    strided view (the Mamba conv state), rows that are no multiple of 16
    and an unaligned view (the element paths), a mixed ``active`` whose
    inactive slot keeps its codes and scales, an all-zero row and maxima
    at ``127 * 2^k`` and their neighbours, the re-read second pass, one
    launch each way and more past the caps; the wrappers refuse what the
    kernels do not take; an int8 rwkv6 engine's decode step launches one
    of each and no row codec kernel.
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
from repro_torch.kernels import kv_append as KA  # noqa: E402
from repro_torch.kernels import kv_read as KR  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import ttm_pe1, ttm_pe2, ttm_pe3  # noqa: E402
from repro_torch.launch import train_fmnist as TF  # noqa: E402
from repro_torch.models import build_lm, init_lm  # noqa: E402
from repro_torch.models import mlp_tt as MLP  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.optim import adam as A  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, tree_map  # noqa: E402

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
    with pytest.raises(TypeError):      # codes in no storage type
        CB.decode_rows(torch.zeros((2, 4), device=cuda, dtype=torch.float16),
                       sc, torch.float32)


def test_engine_fused_equals_gather_fp32_on_card(cuda):
    cfg = C.get_reduced("internlm2-1.8b").replace(dtype="float32")
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device=cuda).manual_seed(0), lm,
                     device=cuda)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, int(rng.randint(5, 16))
                           ).tolist() for _ in range(4)]
    outs, launches, summaries = [], [], []
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
        summaries.append((fused, len(eng.metrics.prefills)))
    assert outs[0] == outs[1]
    (fl, steps), (gl, gsteps) = launches
    assert fl["paged_attention"] == steps * cfg.num_layers
    assert fl["p2_append_paged"] == steps * cfg.num_layers
    assert gl["p2_append_paged"] == gsteps * cfg.num_layers
    # a whole-prompt prefill is one p2_prefill_paged for K and V of every
    # layer; no row-scale encode runs
    for launch, (_, summ) in zip((fl, gl), summaries):
        assert launch["p2_prefill_paged"] == summ and summ >= len(prompts)
        assert "p2_enc_rows" not in launch
    # the gather path reads every slot's view off the pages: one paged
    # read a layer a decode step, no row decode
    assert gl["p2_read_paged"] == gsteps * cfg.num_layers
    assert "p2_dec_rows" not in gl and "p2_read_paged" not in fl


def test_engine_spec_equals_nonspec_fp32_on_card(cuda):
    """A 2-layer greedy speculative run (an independent draft of the same
    config, fused and gather; a self-draft) emits the non-spec run's
    tokens, with the verify and the draft steps launching the paged
    kernels as counted, and returns every page."""
    cfg = C.get_reduced("internlm2-1.8b").replace(dtype="float32")
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device=cuda).manual_seed(0), lm,
                     device=cuda)
    dparams = init_lm(torch.Generator(device=cuda).manual_seed(1), lm,
                      device=cuda)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, int(rng.randint(5, 16))
                           ).tolist() for _ in range(4)]
    pool = PoolConfig(num_slots=2, page_size=4, pages_per_slot=8,
                      quantized=True)

    def serve(fused, spec_k=0, draft=None):
        B.reset_launches()
        eng = Engine(lm, params, EngineConfig(pool=pool, spec_k=spec_k,
                                              fused_attention=fused),
                     device=cuda, draft=draft)
        rids = [eng.submit(p, max_new_tokens=9) for p in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids], eng, dict(B.LAUNCHES)

    k, layers = 3, cfg.num_layers
    for fused in (True, False):
        ref, _, _ = serve(fused)
        for draft in ((lm, dparams), (lm, params)):
            out, eng, launches = serve(fused, k, draft)
            assert out == ref
            rounds = eng.summary()["spec"]["steps"]
            assert rounds == eng.summary()["decode_steps"] > 0
            assert launches["p2_append_paged"] == rounds * (layers
                                                            + (k + 1) * layers)
            assert launches["p2_read_paged"] == rounds * (
                (k + 1) * layers + (0 if fused else layers))
            assert launches.get("paged_attention", 0) == (
                rounds * layers if fused else 0)
            assert launches["p2_prefill_paged"] == 2 * len(
                eng.metrics.prefills)
            assert eng.sched.alloc.free_pages == pool.total_pages
            if draft[1] is params and not fused:
                # the self-draft canary on the gather path
                assert eng.summary()["spec"]["acceptance_rate"] == 1.0


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


# PE2 / PE3 on the tensor cores (csrc/tt_mma.cuh, bf16 with 16-byte rows):
# every tiling (stacked at c = 16 and 32, thin, wide) at ragged a, b, c and
# d, and the LM step's calls with a (PE2) or j and i (PE3) cut down
PE_MMA = [(19, 7, 40, 24), (9, 100, 16, 256), (13, 256, 32, 128),
          (3, 128, 256, 16), (2, 200, 136, 8), (1, 130, 520, 200),
          (2, 64, 264, 72), (64, 256, 16, 256), (64, 256, 32, 256),
          (64, 128, 512, 16), (64, 256, 256, 8), (1, 2048, 128, 512),
          (1, 2048, 512, 128)]


def test_pe_tensor_core_route_matches_plain_and_repeats(cuda):
    from repro_torch.kernels import tt_mma
    g = torch.Generator(device=cuda).manual_seed(5)
    iv = torch.int16
    for a, b, c, d in PE_MMA:
        z = torch.randn((a, b, c), generator=g, device=cuda).to(torch.bfloat16)
        w = (torch.randn((b, d), generator=g, device=cuda) * 0.2).to(
            torch.bfloat16)
        assert tt_mma.plan_for(z, w) is not None
        B.reset_launches()
        out = ttm_pe2.pe2_cuda(z, w)
        assert B.LAUNCHES == {"pe2": 1}
        _close(out, ttm_pe2.pe2_torch(z, w), torch.bfloat16)
        assert torch.equal(out.view(iv), ttm_pe2.pe2_cuda(z, w).view(iv))
        if a == 1:          # the same product as PE3: Ybar = w, X = z[0]
            what = ttm_pe3.pe3_cuda(w, z[0])
            _close(what, ttm_pe3.pe3_torch(w, z[0]), torch.bfloat16)
            assert torch.equal(what.view(iv), out[0].view(iv))


# PE1 on the tensor cores (csrc/ttm_pe1.cu pe1_mma_kernel, bf16, b = 1):
# ragged a, c = 8 / 16 / 32 and the K fills past them (24, 40, 64), d in one
# warpgroup (24, 64, 136, 256), two along d (512) and two tiles of d (1024)
PE1_MMA = [(37, 8, 24), (1000, 16, 256), (129, 32, 256), (300, 16, 512),
           (5, 40, 136), (77, 64, 64), (200, 24, 1024), (4097, 32, 256),
           (1, 16, 8)]


def test_pe1_tensor_core_route_matches_plain_and_repeats(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    for a, c, d in PE1_MMA:
        z = torch.randn((a, 1, c), generator=g, device=cuda).to(torch.bfloat16)
        w = (torch.randn((1, d, c), generator=g, device=cuda) * 0.2).to(
            torch.bfloat16)
        assert ttm_pe1.plan_pe1_for(z, w) is not None
        B.reset_launches()
        out = ttm_pe1.pe1_cuda(z, w)
        assert B.LAUNCHES == {"pe1": 1}
        _close(out, ttm_pe1.pe1_torch(z, w), torch.bfloat16)
        assert torch.equal(out.view(torch.int16),
                           ttm_pe1.pe1_cuda(z, w).view(torch.int16))


@pytest.mark.parametrize("bits,step", [(4, 3.0), (8, 1.0)])
@pytest.mark.parametrize("shape", [(5000, 16, 256), (77, 32, 512),
                                   (37, 8, 24)])
def test_pe1_tensor_core_epilogue_bit_for_bit(cuda, bits, step, shape):
    """Integer operands: every sum is exact in f32 in any order, so the
    fused output is the plain version's (einsum + the codec's epilogue) bit
    for bit and encode -> decode of the plain sum value for value."""
    a, c, d = shape
    g = torch.Generator(device=cuda).manual_seed(bits)
    z = torch.randint(-8, 9, (a, 1, c), generator=g, device=cuda).to(
        torch.bfloat16)
    w = torch.randint(-8, 9, (1, d, c), generator=g, device=cuda).to(
        torch.bfloat16)
    assert ttm_pe1.plan_pe1_for(z, w) is not None
    s = torch.tensor(step, device=cuda)
    fused = ttm_pe1.pe1_cuda(z, w, s, bits)
    assert torch.equal(fused.view(torch.int16),
                       ttm_pe1.pe1_torch(z, w, s, bits).view(torch.int16))
    unfused = TN.decode(TN.encode(ttm_pe1.pe1_torch(z.float(), w.float()),
                                  TN.QuantSpec("pow2", bits), s,
                                  backend="cuda"), torch.float32,
                        backend="cuda")
    assert torch.equal(fused.float(), unfused)
    assert torch.equal(fused.view(torch.int16),
                       ttm_pe1.pe1_cuda(z, w, s, bits).view(torch.int16))


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
        # one paged write and one paged read a layer a chunk step, the
        # write also once a layer a decode step; no scalar codec launch
        layers = cfg.num_layers
        decode = eng.summary()["decode_steps"]
        assert steps > 0
        assert B.LAUNCHES["p2_read_paged"] == layers * steps
        assert B.LAUNCHES["p2_append_paged"] == layers * (steps + decode)
        assert "p2_enc" not in B.LAUNCHES and "p2_dec" not in B.LAUNCHES
    assert outs[0] == outs[1]
    assert eng.summary()["cow_forks"] > 0


# ---------------------------------------------------------------------------
# (k) codes in every storage type, the redesigned PE1 and paged attention
# ---------------------------------------------------------------------------

STORAGES = [(torch.int16, 16), (torch.int16, 12), (torch.int32, 32),
            (torch.int32, 20), (torch.float32, 16), (torch.int8, 8)]


def _bits_eq(a, b):
    iv = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(iv), b.view(iv))


@pytest.mark.parametrize("storage,bits", STORAGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_kernels_wider_storage_bit_identical(cuda, storage, bits,
                                                   dtype):
    """The row and scalar pow-2 kernels in every storage type, vector and
    scalar paths (cols % 4, an unaligned view), against their twins bit
    for bit, including the 32-bit grid's saturating top."""
    g = torch.Generator(device=cuda).manual_seed(bits)
    hi = 2.0 ** (bits - 1)
    for rows, cols, off in ((8, 1024, 0), (5, 37, 0), (3, 4096, 1)):
        base = torch.randn(rows * cols + off, generator=g, device=cuda) * hi
        x = base[off:].reshape(rows, cols).to(dtype)
        x.view(-1)[:4] = torch.tensor([4 * hi, -4 * hi, 2.5, -1.5])
        s = torch.randint(-3, 2, (rows,), generator=g, device=cuda).float()
        q = CB.encode_rows(x, s, bits, storage)
        assert q.dtype == storage
        assert _bits_eq(q, CB.encode_rows_plain(x, s, bits, storage))
        for dt in (torch.float32, torch.bfloat16):
            assert _bits_eq(CB.decode_rows(q, s, dt),
                            CB.decode_rows_plain(q, s, dt))
        s1 = s[:1]
        q1 = CB.encode_scalar(x, s1, bits, storage)
        assert _bits_eq(q1, CB.encode_scalar_plain(x, s1, bits, storage))
        assert _bits_eq(CB.decode_scalar(q1, s1, dtype),
                        CB.decode_scalar_plain(q1, s1, dtype))
    with pytest.raises(ValueError, match="holds 2.."):
        CB.encode_rows(x, s, 33 if storage != torch.int8 else 9, storage)


def test_codec_api_int16_top_code_on_card(cuda):
    """A bf16 tensor at 16 bits in int16: the kernels store 32767 where a
    plain cast of bf16's 32768 would wrap."""
    x = torch.tensor([40000.0, 32767.0, -40000.0, 1e10, 3.0],
                     device=cuda).to(torch.bfloat16)
    spec = TN.QuantSpec("pow2", 16, 0, "int16")
    for scale in (torch.tensor(0.0, device=cuda),
                  torch.zeros((5, 1), device=cuda)):
        qt = TN.encode(x.reshape(5, 1), spec, scale, backend="cuda")
        assert qt.codes.dtype == torch.int16
        assert qt.codes.reshape(-1).tolist() == [32767, 32767, -32768,
                                                 32767, 3]


@pytest.mark.parametrize("storage,bits", [(torch.int16, 16),
                                          (torch.int32, 24),
                                          (torch.float32, 16)])
@pytest.mark.parametrize("shape,block", [((512,), 256), ((16, 4, 4, 16), 256),
                                         ((14273,), 1024), ((5, 33), 16)])
def test_blockwise_kernels_wider_storage(cuda, storage, bits, shape, block):
    g = torch.Generator(device=cuda).manual_seed(block + bits)
    x = torch.randn(shape, generator=g, device=cuda) * 3
    x2d = x.reshape(-1, shape[-1])
    codes, sc = CB.bw_encode(x2d, block, bits, storage)
    rc, rs = CB.bw_encode_plain(x2d, block, bits, storage)
    assert codes.dtype == storage and _bits_eq(codes, rc)
    assert _bits_eq(sc, rs)
    assert _bits_eq(CB.bw_decode(codes, sc, shape[-1]),
                    CB.bw_decode_plain(codes, sc, shape[-1]))
    name = {torch.int16: "int16", torch.int32: "int32",
            torch.float32: "float32"}[storage]
    spec = TN.QuantSpec("blockwise", bits, block, name, "per_tensor_max")
    qt = TN.encode(x, spec, backend="cuda")
    ref = TN.encode(x.cpu(), spec)
    assert _bits_eq(qt.codes.cpu(), ref.codes)
    assert _bits_eq(TN.decode(qt, backend="cuda").cpu(), TN.decode(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pe1_kernel_odd_granules_unaligned_and_repeat(cuda, dtype):
    """PE1 with c = 7 (4-byte f32 / 2-byte bf16 granules), an unaligned
    Z view, b = 3, d = 9 (no float4 store), and the step's shape twice
    over, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(9)
    flat = torch.randn(1 + 40 * 3 * 7, generator=g, device=cuda).to(dtype)
    z = flat[1:].view(40, 3, 7)
    w = (torch.randn((3, 9, 7), generator=g, device=cuda) * 0.2).to(dtype)
    _close(ttm_pe1.pe1_cuda(z, w), ttm_pe1.pe1_torch(z, w), dtype)
    for a in (3584, 64, 1):
        z = torch.randn((a, 1, 16), generator=g, device=cuda).to(dtype)
        w = (torch.randn((1, 256, 16), generator=g, device=cuda) * 0.2
             ).to(dtype)
        out = ttm_pe1.pe1_cuda(z, w)
        _close(out, ttm_pe1.pe1_torch(z, w), dtype)
        assert _bits_eq(out, ttm_pe1.pe1_cuda(z, w))


def _pa_case(cuda, seed, *, b, pp, page, hkv, hq, dh, s_rows, quantized,
             dtype=torch.float32):
    g = torch.Generator(device=cuda).manual_seed(seed)
    total = b * pp
    if quantized:
        kd = torch.randint(-128, 128, (total + 1, page, hkv, dh),
                           generator=g, device=cuda).to(torch.int8)
        vd = torch.randint(-128, 128, (total + 1, page, hkv, dh),
                           generator=g, device=cuda).to(torch.int8)
        ks = torch.randint(-9, -4, (b,), generator=g, device=cuda).float()
        vs = torch.randint(-9, -4, (b,), generator=g, device=cuda).float()
    else:
        kd = torch.randn((total + 1, page, hkv, dh), generator=g,
                         device=cuda).to(dtype)
        vd = torch.randn((total + 1, page, hkv, dh), generator=g,
                         device=cuda).to(dtype)
        ks = vs = torch.zeros(b, device=cuda)
    table = torch.randperm(total, generator=g, device=cuda).reshape(
        b, pp).int()
    q = torch.randn((b, s_rows, hq, dh), generator=g, device=cuda).to(dtype)
    return q, kd, vd, ks, vs, table


def _split_combine(q, kd, vd, ks, vs, table, lens, page, quantized,
                   pages_per_split):
    """The two attention kernels with spans of ``pages_per_split`` pages:
    (output, partials (m, l, acc), plan, checked lens)."""
    q4, kd4, vd4, ks4, vs4, t4, l4, squeeze, p = PA._checked(
        q, kd, vd, ks, vs, table, lens, page, quantized)
    mis = (kd4.data_ptr() % 16) | (vd4.data_ptr() % 16)
    p = PA.plan(p.B, p.S, p.Hq, p.Hkv, p.Dh, page, p.pps,
                kd4.element_size(), mis, pages_per_split)
    m, l, acc = PA.pa_split_cuda(q4, kd4, vd4, ks4, vs4, t4, l4, p,
                                 quantized)
    out = PA.pa_combine_cuda(m, l, acc, l4, p, q4.dtype)
    return out, (m, l, acc), p, l4


@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2), (3, 1)])
@pytest.mark.parametrize("s_rows", [1, 4])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 8])
def test_paged_attention_splits_and_combine(cuda, hq, hkv, s_rows,
                                            pages_per_split):
    """Split kernel == its mirror partial for partial on the spans each
    slot needs; combine kernel == its mirror; split + combine == the page
    walk within 1e-5 and bit-identical over two launches. Slot 1's row 0
    sees up to the last key of a span, its rows 1.. the next span: a span
    where a row has no unmasked key."""
    b, pp, page, dh = 4, 7, 8, 16
    q, kd, vd, ks, vs, table = _pa_case(
        cuda, hq + s_rows + pages_per_split, b=b, pp=pp, page=page, hkv=hkv,
        hq=hq, dh=dh, s_rows=s_rows, quantized=True)
    edge = min(min(pages_per_split, pp) * page - 1, pp * page - s_rows)
    lens = torch.tensor([0, edge, page, pp * page - s_rows], device=cuda,
                        dtype=torch.int32)
    kw = dict(page_size=page, quantized=True)
    ref = PA.paged_attention_torch(q, kd, vd, ks, vs, table, lens, **kw)
    args = (q, kd, vd, ks, vs, table, lens, page, True, pages_per_split)
    out, (m, l, acc), p, l4 = _split_combine(*args)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert _bits_eq(out, _split_combine(*args)[0])
    if pages_per_split == PA.PAGES_PER_SPLIT:     # the entry point's spans
        assert _bits_eq(out, PA.paged_attention_cuda(
            q, kd, vd, ks, vs, table, lens, **kw))
    mm, ml, macc = PA.pa_split_torch(q, kd, vd, ks, vs, table, lens,
                                     pages_per_split=pages_per_split, **kw)
    need = PA.spans_needed(lens, s_rows, page, pp, p.pps_split)
    for bi in range(b):
        n = int(need[bi])
        np.testing.assert_allclose(m[bi, :, :n].cpu(), mm[bi, :, :n].cpu(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(l[bi, :, :n].cpu(), ml[bi, :, :n].cpu(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(acc[bi, :, :n].cpu(),
                                   macc[bi, :, :n].cpu(), rtol=1e-5,
                                   atol=1e-5)
    if s_rows > 1 and pp > p.pps_split:       # the all-masked span exists
        neg = torch.tensor(PA.NEG_INF, device=cuda)
        assert torch.equal(m[1, :, 1, 0], neg.expand(hkv))
        n_pages = min(pp, (edge + s_rows - 1) // page + 1)
        keys = min(p.pps_split, n_pages - p.pps_split) * page
        assert bool((l[1, :, 1, 0] == keys).all())   # l counts masked keys
    comb = PA.pa_combine_cuda(m, l, acc, l4, p, torch.float32)
    want = PA.pa_combine_torch(m, l, acc, lens, s=s_rows, page_size=page,
                               pps=pp, pages_per_split=pages_per_split,
                               dtype=torch.float32)
    np.testing.assert_allclose(comb.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("dh", [16, 12, 128])
def test_paged_attention_model_dtype_pages_and_odd_head_dims(cuda, dtype,
                                                             dh):
    """Pages in the model dtype and head dims whose rows take 4-byte
    copies (12 int8 = 12 bytes): within 1e-5 (fp32) / 2 ulp + 1e-5 of the
    page walk."""
    b, pp, page = 3, 9, 8
    for quantized in (True, False):
        q, kd, vd, ks, vs, table = _pa_case(
            cuda, dh, b=b, pp=pp, page=page, hkv=2, hq=4, dh=dh, s_rows=2,
            quantized=quantized, dtype=dtype)
        lens = torch.tensor([5, 31, pp * page - 2], device=cuda,
                            dtype=torch.int32)
        kw = dict(page_size=page, quantized=quantized)
        out = _split_combine(q, kd, vd, ks, vs, table, lens, page, quantized,
                             2)[0]
        ref = PA.paged_attention_torch(q, kd, vd, ks, vs, table, lens, **kw)
        diff = (out.float() - ref.float()).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= 1e-5
        else:
            r = ref.float().abs()
            ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(
                r, min=1e-30))) - (7 if dtype == torch.bfloat16 else 10))
            assert bool((diff <= 2 * ulp + 1e-5).all())


# ---------------------------------------------------------------------------
# (l) grouped launches: a layer's cores in one fake-quant launch, a moment
#     or wire set in one blockwise encode launch
# ---------------------------------------------------------------------------

def _bits_of(t):
    return t.view(torch.int16) if t.element_size() == 2 else \
        t.view(torch.int32) if t.element_size() == 4 else t


def _group_fq_case(cuda, bits, dtype, seed):
    """Layer 1's four core shapes, an odd length (the scalar path), an
    unaligned view and an empty tensor, each on the grid of its own step."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    sizes = [448, 4096, 1024, 4096, 4099, 0]
    xs = [_fq_data(n, bits, dtype, g, cuda) for n in sizes]
    xs.append(_fq_data(1025, bits, dtype, g, cuda)[1:])    # unaligned
    steps = torch.tensor([-3.0, -4.0, -2.0, -3.0, -3.0, -1.0, -3.0],
                         device=cuda)
    return xs, steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_grouped_fake_quant_bit_identical_in_one_launch(cuda, dtype, bits):
    xs, steps = _group_fq_case(cuda, bits, dtype, bits)
    B.reset_launches()
    ys = CB.fake_quant_scalar_many(xs, steps, bits)
    torch.cuda.synchronize()
    assert B.LAUNCHES == {"p2_fake_quant": 1}
    again = CB.fake_quant_scalar_many(xs, steps, bits)
    for y, r, a, x in zip(ys, CB.fake_quant_many_plain(xs, steps, bits),
                          again, xs):
        assert y.dtype == dtype and y.shape == x.shape
        assert torch.equal(_bits_of(y), _bits_of(r))
        assert torch.equal(_bits_of(a), _bits_of(y))
    # through the codec API, with the clipped STE per tensor
    live = [x.clone().requires_grad_() for x in xs]
    out = TN.fake_quant_many(live, TN.QuantSpec("pow2", bits), steps,
                             backend="cuda")
    torch.autograd.backward(out, [torch.ones_like(o) for o in out])
    for n, (x, o, y) in enumerate(zip(xs, out, ys)):
        assert torch.equal(o, y)
        assert torch.equal(live[n].grad,
                           codecs.pow2_inside(x, steps[n], bits).to(dtype))


def _moment_and_wire_sets(cuda, seed):
    """The step's 34 moments ((rows, last) views, block 256) and 21 wire
    leaves (flattened, block 1024), random, each with an all-zero first
    quarter."""
    d = MLP.make_mlp()
    p = MLP.init_mlp(torch.Generator(device=cuda).manual_seed(0), d,
                     device=cuda)
    flat = dict(flatten_with_path(p))
    g = torch.Generator(device=cuda).manual_seed(seed)

    def data(shape):
        x = torch.randn(shape, generator=g, device=cuda) * 0.05
        x.view(-1)[:x.numel() // 4] = 0.0
        return x
    moments = [data(flat[k].shape) for k in A.adam_leaf_paths(p)] * 2
    moments = [m.reshape(-1, m.shape[-1] if m.dim() else 1) for m in moments]
    wire = [data((leaf.numel(),)).reshape(1, -1) for leaf in flat.values()
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    assert (len(moments), len(wire)) == (34, 21)
    return moments, wire


@pytest.mark.parametrize("storage,bits", [(torch.int8, 8), (torch.int16, 16),
                                          (torch.int32, 24),
                                          (torch.float32, 16)])
def test_grouped_blockwise_encode_bit_identical_in_one_launch(cuda, storage,
                                                              bits):
    moments, wire = _moment_and_wire_sets(cuda, bits)
    for xs, block in ((moments, 256), (wire, 1024)):
        B.reset_launches()
        got = CB.bw_encode_many(xs, block, bits, storage)
        torch.cuda.synchronize()
        assert B.LAUNCHES == {"bw_enc": 1}
        again = CB.bw_encode_many(xs, block, bits, storage)
        plain = CB.bw_encode_many_plain(xs, block, bits, storage)
        for x, (c, s), (rc, rs), (ac, as_) in zip(xs, got, plain, again):
            assert c.dtype == storage and c.shape == rc.shape
            assert torch.equal(c, rc) and torch.equal(ac, c)
            assert torch.equal(_bits_of(s), _bits_of(rs))
            assert torch.equal(_bits_of(as_), _bits_of(s))
            one_c, one_s = CB.bw_encode(x, block, bits, storage)
            assert torch.equal(one_c, c) and torch.equal(_bits_of(one_s),
                                                         _bits_of(s))
        assert any((s == 0).any().item() for _, s in got)   # zero blocks


def test_group_launches_one_per_cap(cuda):
    """A group of exactly the cap is one launch, one more is two, and the
    result is the twin's either way."""
    from repro_torch.kernels import grouped as G
    g = torch.Generator(device=cuda).manual_seed(9)
    for cap, launches in ((G.FQ_CAP, 1), (G.FQ_CAP + 1, 2)):
        xs = [torch.randn((37 * (i % 5) + 3,), generator=g, device=cuda)
              for i in range(cap)]
        steps = torch.full((cap,), -4.0, device=cuda)
        B.reset_launches()
        ys = CB.fake_quant_scalar_many(xs, steps, 4)
        assert B.LAUNCHES == {"p2_fake_quant": launches}
        for y, r in zip(ys, CB.fake_quant_many_plain(xs, steps, 4)):
            assert torch.equal(_bits_of(y), _bits_of(r))
    for cap, launches in ((G.BW_CAP, 1), (G.BW_CAP + 1, 2)):
        xs = [torch.randn((i % 3 + 1, 40 * (i % 7) + 1), generator=g,
                          device=cuda) for i in range(cap)]
        B.reset_launches()
        got = CB.bw_encode_many(xs, 16)
        assert B.LAUNCHES == {"bw_enc": launches}
        for (c, s), (rc, rs) in zip(got, CB.bw_encode_many_plain(xs, 16)):
            assert torch.equal(c, rc) and torch.equal(_bits_of(s),
                                                      _bits_of(rs))


def test_int8_moments_of_a_grouped_step_save_as_the_per_leaf_path(
        cuda, tmp_path, monkeypatch):
    """After one int8-moment step the moments are views into one codes and
    one scales buffer; saved through ckpt, the file is byte for byte the
    one a step that encodes each moment alone writes."""
    from repro_torch import ckpt as TCK
    d = MLP.make_mlp()
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=0.0,
                       opt_state_dtype="int8")
    p0 = MLP.init_mlp(torch.Generator(device=cuda).manual_seed(0), d,
                      device=cuda)
    xs, ys = TF.fashion_like(256, seed=1)
    batch = {"x": torch.from_numpy(xs[:64]).to(cuda),
             "y": torch.from_numpy(ys[:64]).to(cuda)}
    step = TF.make_step(d, tcfg)
    paths = []
    for grouped in (True, False):
        if not grouped:
            monkeypatch.setattr(A, "encode_many", lambda vs, spec, backend: [
                TN.encode(v, spec, backend=backend) for v in vs])
        B.reset_launches()
        p, o, _ = step(p0, A.init_adam(p0, tcfg), batch)
        torch.cuda.synchronize()
        assert B.LAUNCHES["bw_enc"] == (1 if grouped else 22)
        if grouped:      # every moment the step moved, in one buffer
            names = [k for k, _ in flatten_with_path(p0)] * 2
            bases = {m.codes.untyped_storage().data_ptr()
                     for k, m in zip(names, o.m + o.v)
                     if m is not None and "mean_abs" not in k}
            assert len(bases) == 1
        paths.append(str(tmp_path / f"{grouped}.ckpt"))
        TCK.save(paths[-1], {"params": p, "opt": o}, {"step": 1})
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# (m) the blockwise decode group and the paged KV append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage,bits", [(torch.int8, 8), (torch.int16, 16),
                                          (torch.int32, 24),
                                          (torch.float32, 16)])
def test_grouped_blockwise_decode_bit_identical_in_one_launch(cuda, storage,
                                                              bits):
    moments, wire = _moment_and_wire_sets(cuda, bits + 1)
    for xs, block in ((moments, 256), (wire, 1024)):
        pairs = CB.bw_encode_many(xs, block, bits, storage)
        codes, scales = [c for c, _ in pairs], [s for _, s in pairs]
        lasts = [x.shape[1] for x in xs]
        B.reset_launches()
        got = CB.bw_decode_many(codes, scales, lasts)
        torch.cuda.synchronize()
        assert B.LAUNCHES == {"bw_dec": 1}
        again = CB.bw_decode_many(codes, scales, lasts)
        plain = CB.bw_decode_many_plain(codes, scales, lasts)
        bases = {y.untyped_storage().data_ptr() for y in got if y.numel()}
        assert len(bases) == 1                  # one output buffer
        for c, s, last, y, r, a in zip(codes, scales, lasts, got, plain,
                                       again):
            assert y.shape == (c.shape[0], last) and y.dtype == torch.float32
            assert _bits_eq(y, r) and _bits_eq(a, y)
            assert _bits_eq(CB.bw_decode(c, s, last), y)    # a group of one


def test_grouped_blockwise_decode_mixed_codes_and_unaligned(cuda):
    """One launch over leaves of every code type, with codes that start
    off 4-code alignment, odd lengths, b = 1 and an empty leaf: the scalar
    path beside the vector path, bit for bit with the twin."""
    g = torch.Generator(device=cuda).manual_seed(17)
    cases = [((5, 33), 16, torch.int8), ((3, 1000), 256, torch.int16),
             ((4096, 1), 256, torch.int32), ((1, 4099), 1024, torch.float32),
             ((2, 448), 256, torch.int8), ((0, 7), 256, torch.int8)]
    codes, scales, lasts = [], [], []
    for shape, block, storage in cases:
        x = torch.randn(shape, generator=g, device=cuda)
        c, s = CB.bw_encode(x, block, 8, storage)
        if shape == (2, 448):                   # codes off 4-code alignment
            buf = torch.zeros(c.numel() + 1, dtype=c.dtype, device=cuda)
            buf[1:] = c.reshape(-1)
            c = buf[1:].view(c.shape)
        codes.append(c)
        scales.append(s)
        lasts.append(shape[1])
    B.reset_launches()
    got = CB.bw_decode_many(codes, scales, lasts)
    torch.cuda.synchronize()
    assert B.LAUNCHES == {"bw_dec": 1}
    for y, r in zip(got, CB.bw_decode_many_plain(codes, scales, lasts)):
        assert _bits_eq(y, r)


def test_grouped_blockwise_decode_one_launch_per_cap(cuda):
    from repro_torch.kernels import grouped as G
    g = torch.Generator(device=cuda).manual_seed(19)
    for n, launches in ((G.BW_CAP, 1), (G.BW_CAP + 1, 2)):
        xs = [torch.randn((i % 3 + 1, 40 * (i % 7) + 1), generator=g,
                          device=cuda) for i in range(n)]
        pairs = CB.bw_encode_many(xs, 16)
        codes, scales = [c for c, _ in pairs], [s for _, s in pairs]
        lasts = [x.shape[1] for x in xs]
        B.reset_launches()
        got = CB.bw_decode_many(codes, scales, lasts)
        assert B.LAUNCHES == {"bw_dec": launches}
        for y, r in zip(got, CB.bw_decode_many_plain(codes, scales, lasts)):
            assert _bits_eq(y, r)


def _append_case(cuda, dtype, bits, seed, slots=8, hkv=8, dh=128, page=16,
                 pps=4):
    """A pool of random codes and a decode step's K/V: V the strided half
    of a fused (B, 1, 2, Hkv, Dh) projection; slots at the first and the
    last offset of a page and of their last page, two inactive slots at
    distinct trash offsets, one past its last page."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    total = slots * pps
    kd = torch.randint(-128, 128, (total + 1, page, hkv, dh), generator=g,
                       device=cuda).to(torch.int8)
    vd = torch.randint(-128, 128, kd.shape, generator=g, device=cuda
                       ).to(torch.int8)
    table = torch.randperm(total, generator=g, device=cuda).reshape(
        slots, pps).to(torch.int32)
    lens = torch.tensor([0, 15, 63, 5, 20, 33, 64, 7][:slots],
                        dtype=torch.int32, device=cuda)
    active = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0][:slots], dtype=torch.bool,
                          device=cuda)
    ks = torch.randint(-8, 0, (slots,), generator=g, device=cuda).float()
    vs = torch.randint(-8, 0, (slots,), generator=g, device=cuda).float()
    step = torch.exp2(torch.stack([ks, vs], 1))[:, None, :, None, None]
    kv = torch.randn((slots, 1, 2, hkv, dh), generator=g, device=cuda) \
        * step * 2 ** (bits - 1)
    kv = kv.to(dtype)
    return KA, (kd, vd, ks, vs, kv[:, :, 0], kv[:, :, 1], table, lens,
                active), dict(page_size=page, bits=bits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_paged_append_bit_identical_on_the_pool(cuda, dtype, bits):
    KA, args, kw = _append_case(cuda, dtype, bits, seed=bits)
    assert not args[5].is_contiguous()
    orig = args[0].clone()
    want = [t.clone() for t in args[:2]]
    KA.append_paged_torch(*want, *args[2:], **kw)
    B.reset_launches()
    KA.append_paged_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert B.LAUNCHES == {"p2_append_paged": 1}
    assert torch.equal(args[0], want[0]) and torch.equal(args[1], want[1])
    # the trash page took the inactive slots (offsets 5, 7) and the slot
    # past its last page (offset 0)
    assert (args[0][-1, [0, 5, 7]] != orig[-1, [0, 5, 7]]).flatten(1).any(1
                                                                       ).all()
    again = [t.clone() for t in args[:2]]
    KA.append_paged_cuda(*again, *args[2:], **kw)
    assert torch.equal(again[0], args[0]) and torch.equal(again[1], args[1])


def test_paged_append_contiguous_and_one_slot(cuda):
    """The scalar path (a head dim that is no multiple of 8 bf16 elements)
    and a batch of one slot, each bit for bit with the twin."""
    for slots, dh in ((8, 12), (1, 128)):
        KA, args, kw = _append_case(cuda, torch.bfloat16, 8, seed=slots,
                                    slots=slots, dh=dh)
        args = args[:4] + (args[4].contiguous(), args[5].contiguous()) \
            + args[6:]
        want = [t.clone() for t in args[:2]]
        KA.append_paged_torch(*want, *args[2:], **kw)
        KA.append_paged_cuda(*args, **kw)
        assert torch.equal(args[0], want[0]) and torch.equal(args[1], want[1])


# ---------------------------------------------------------------------------
# (n) the chunk step's paged write and the paged read
# ---------------------------------------------------------------------------

CODE_TYPES = [(torch.int8, 8), (torch.int8, 4), (torch.int16, 16),
              (torch.int32, 32), (torch.float32, 16)]


def _codes(shape, storage, bits, g, cuda):
    hi = 2 ** (bits - 1)
    q = torch.randint(-min(hi, 2 ** 30), min(hi, 2 ** 30), shape,
                      generator=g, device=cuda)
    return q.to(storage)


def _chunk_write_case(cuda, dtype, storage, bits, seed, *, slots=1, s=128,
                      hkv=8, dh=128, page=16, pps=16, unaligned=False):
    """A pool of random codes, slot tables, and S rows a slot of fused
    K/V (V the strided half of a (B, S, 2, Hkv, Dh) projection; with
    ``unaligned`` K a view one element into its buffer), scaled so the
    codes reach both clip ends."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    total = slots * pps
    kd = _codes((total + 1, page, hkv, dh), storage, min(bits, 8), g, cuda)
    vd = _codes(kd.shape, storage, min(bits, 8), g, cuda)
    table = torch.randperm(total, generator=g, device=cuda).reshape(
        slots, pps).to(torch.int32)
    ks = torch.randint(-8, 0, (slots,), generator=g, device=cuda).float()
    vs = torch.randint(-8, 0, (slots,), generator=g, device=cuda).float()
    step = torch.exp2(torch.stack([ks, vs], 1))[:, None, :, None, None]
    kv = (torch.randn((slots, s, 2, hkv, dh), generator=g, device=cuda)
          * step * 2 ** (bits - 1)).to(dtype)
    k = kv[:, :, 0].contiguous()
    if unaligned:
        buf = torch.empty(k.numel() + 1, dtype=dtype, device=cuda)
        buf[1:] = k.reshape(-1)
        k = buf[1:].view(k.shape)
    return kd, vd, ks, vs, k, kv[:, :, 1], table


def _write_both(args, kw):
    """The kernel and its twin on copies of the pools: (kernel's, twin's)
    (K, V) pools."""
    kd, vd = args[0], args[1]
    got = [kd.clone(), vd.clone()]
    want = [kd.clone(), vd.clone()]
    KA.append_paged_cuda(*got, *args[2:], **kw)
    KA.append_paged_torch(*want, *args[2:], **kw)
    return got, want


@pytest.mark.parametrize("storage,bits", CODE_TYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start,valid", [(256, 128), (200, 77), (450, 128)])
def test_paged_chunk_write_bit_identical(cuda, dtype, storage, bits, start,
                                         valid):
    """The chunk write (B = 1, S = 128, 8 x 128, pages of 16, 32 pages a
    slot): a page-aligned chunk, one crossing pages with pad rows, and one
    whose valid rows run past the slot's last page (clamped into it, the
    later of two rows in one cell kept). Real pages bit for bit with the
    twin and over two launches; one launch."""
    kd, vd, ks, vs, k, v, table = _chunk_write_case(
        cuda, dtype, storage, bits, seed=start + valid, pps=32)
    assert not v.is_contiguous()
    lens = torch.tensor([start], dtype=torch.int32, device=cuda)
    kw = dict(page_size=16, bits=bits, clamp_last=True,
              n_valid=torch.tensor([valid], dtype=torch.int32, device=cuda))
    args = (kd, vd, ks, vs, k, v, table, lens, None)
    B.reset_launches()
    got, want = _write_both(args, kw)
    torch.cuda.synchronize()
    assert B.LAUNCHES == {"p2_append_paged": 1}
    for a, b, orig in zip(got, want, (kd, vd)):
        assert _bits_eq(a[:-1], b[:-1])             # the trash page aside
        assert not torch.equal(a[:-1], orig[:-1])
    again, _ = _write_both(args, kw)
    assert all(_bits_eq(a[:-1], b[:-1]) for a, b in zip(again, got))


@pytest.mark.parametrize("layout", ["odd width", "unaligned", "slots"])
def test_paged_write_odd_unaligned_and_many_slots(cuda, layout):
    """The element loop (Hkv 3 x Dh 12: 36 bf16 a row, no multiple of 8),
    an unaligned K, and 4 slots x 5 rows under the drop rule with an
    inactive slot and one running past its pages; bit for bit with the
    twin on the real pages."""
    kw = dict(page_size=16, bits=8)
    if layout == "odd width":
        args = _chunk_write_case(cuda, torch.bfloat16, torch.int8, 8, 1,
                                 hkv=3, dh=12)
    elif layout == "unaligned":
        args = _chunk_write_case(cuda, torch.bfloat16, torch.int8, 8, 2,
                                 unaligned=True)
        assert args[4].data_ptr() % 16 != 0
    else:
        args = _chunk_write_case(cuda, torch.float32, torch.int16, 12, 3,
                                 slots=4, s=5, pps=4)
        kw["bits"] = 12
    b = args[4].shape[0]
    lens = torch.tensor([30, 60, 3, 17][:b], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, False, True][:b], device=cuda)
    if layout != "slots":
        kw.update(clamp_last=True, n_valid=torch.tensor(
            [100], dtype=torch.int32, device=cuda))
    got, want = _write_both(args[:7] + (lens, active), kw)
    for a, w in zip(got, want):
        assert _bits_eq(a[:-1], w[:-1])


def _read_case(cuda, storage, bits, seed, *, slots, hkv=8, dh=128, page=16,
               pps=64, unaligned=False):
    g = torch.Generator(device=cuda).manual_seed(seed)
    total = slots * pps
    shape = (total + 1, page, hkv, dh)
    pools = []
    for _ in range(2):
        q = _codes(shape, storage, bits, g, cuda)
        if unaligned:
            buf = torch.empty(q.numel() + 1, dtype=storage, device=cuda)
            buf[1:] = q.reshape(-1)
            q = buf[1:].view(shape)
        pools.append(q)
    table = torch.randperm(total, generator=g, device=cuda).reshape(
        slots, pps).to(torch.int32)
    table[0, 1] = total                      # the trash page
    table[-1, -1] = total + 7                # outside the pool: trash
    ks = torch.randint(-9, 3, (slots,), generator=g, device=cuda).float()
    vs = torch.randint(-9, 3, (slots,), generator=g, device=cuda).float()
    return pools[0], pools[1], ks, vs, table


@pytest.mark.parametrize("storage,bits", CODE_TYPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("slots", [1, 8])
def test_paged_read_bit_identical(cuda, slots, dtype, storage, bits):
    """The chunk step's read (B = 1) and the gather engine's (B = 8), 64
    pages of 16 x 8 x 128 a slot; every position bit for bit with the twin
    and over two launches; one launch."""
    args = _read_case(cuda, storage, bits, seed=slots + bits, slots=slots)
    B.reset_launches()
    got = KR.read_paged_cuda(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert B.LAUNCHES == {"p2_read_paged": 1}
    want = KR.read_paged_torch(*args, dtype=dtype)
    again = KR.read_paged_cuda(*args, dtype=dtype)
    for a, w, r in zip(got, want, again):
        assert a.shape == (slots, 64 * 16, 8, 128) and a.dtype == dtype
        assert _bits_eq(a, w) and _bits_eq(a, r)


@pytest.mark.parametrize("layout", ["odd width", "unaligned"])
def test_paged_read_odd_and_unaligned(cuda, layout):
    """The element loop: pages of 5 x 3 x 12 codes (180, no multiple of
    16) and a pool one element into its buffer; bit for bit with the
    twin."""
    if layout == "odd width":
        args = _read_case(cuda, torch.int8, 8, 1, slots=3, hkv=3, dh=12,
                          page=5, pps=4)
    else:
        args = _read_case(cuda, torch.int16, 16, 2, slots=2, pps=4,
                          unaligned=True)
        assert args[0].data_ptr() % 16 != 0
    for dtype in (torch.bfloat16, torch.float32):
        for a, w in zip(KR.read_paged_cuda(*args, dtype=dtype),
                        KR.read_paged_torch(*args, dtype=dtype)):
            assert _bits_eq(a, w)


def test_paged_kv_wrappers_refuse_on_card(cuda):
    """``impl="torch"`` takes CPU tensors only, and a CPU table beside CUDA
    pools is refused, for the write and the read."""
    kd, vd, ks, vs, k, v, table = _chunk_write_case(
        cuda, torch.bfloat16, torch.int8, 8, 5, s=4)
    lens = torch.tensor([3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.append_paged(kd, vd, ks, vs, k, v, table, lens, None,
                         page_size=16, bits=8, impl="torch")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.append_paged(kd, vd, ks, vs, k, v, table.cpu(), lens, None,
                         page_size=16, bits=8)
    with pytest.raises(ValueError):
        ops.read_paged(kd, vd, ks, vs, table, dtype=torch.float32,
                       impl="torch")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.read_paged(kd, vd, ks, vs, table.cpu(), dtype=torch.float32)


# ---------------------------------------------------------------------------
# (o) the whole-prompt prefill write and the export's grouped round trip
# ---------------------------------------------------------------------------

def _prefill_case(cuda, dtype, storage, bits, s, layers=3, hkv=2, dh=64,
                  seed=0, page=16, pps=4, slots=3):
    """Pools of random codes (layers, slots * pps + 1, page, hkv, dh), the
    scales, slot 1's table row, and K/V (layers, s, hkv, dh) with V the
    strided half of a fused projection; each layer's values on its own
    scale, pad rows (past row 2s/3) far larger."""
    from repro_torch.kernels import kv_prefill as KP
    g = torch.Generator(device=cuda).manual_seed(seed)
    total = slots * pps
    shape = (layers, total + 1, page, hkv, dh)
    lo, hi = (-128, 128) if storage == torch.int8 else (-2 ** 15, 2 ** 15)
    kd, vd = (torch.randint(lo, hi, shape, generator=g, device=cuda).to(
        storage) for _ in range(2))
    ks, vs = (torch.randint(-6, 0, (layers, slots), generator=g,
                            device=cuda).float() for _ in range(2))
    table = torch.randperm(total, generator=g, device=cuda).reshape(
        slots, pps).to(torch.int32)
    mag = torch.exp2(torch.randint(-6, 4, (layers, 1, 1, 1, 1), generator=g,
                                   device=cuda).float())
    kv = torch.randn((layers, s, 2, hkv, dh), generator=g, device=cuda) * mag
    kv[:, (2 * s) // 3 + 1:] *= 1e3
    kv = kv.to(dtype)
    return KP, [kd, vd, ks, vs, kv[:, :, 0].contiguous(), kv[:, :, 1],
                table[1], 1], dict(page_size=page, bits=bits)


def _prefill_check(KP, args, kw, length):
    """The kernel against its twin on every real page and every scale, one
    launch, and a second launch the same."""
    n = torch.tensor([length], dtype=torch.int32, device=args[0].device)
    want = [t.clone() for t in args[:4]]
    KP.prefill_paged_torch(*want, *args[4:], n, **kw)
    got = [t.clone() for t in args[:4]]
    B.reset_launches()
    KP.prefill_paged_cuda(*got, *args[4:], n, **kw)
    torch.cuda.synchronize()
    assert B.LAUNCHES == {"p2_prefill_paged": 1}
    for a, w in zip(got[:2], want[:2]):
        assert torch.equal(a[:, :-1], w[:, :-1])
    for a, w in zip(got[2:], want[2:]):
        assert torch.equal(a, w)
    again = [t.clone() for t in args[:4]]
    KP.prefill_paged_cuda(*again, *args[4:], n, **kw)
    for a, w in zip(again, got):
        assert torch.equal(a[:, :-1] if a.dim() > 2 else a,
                           w[:, :-1] if w.dim() > 2 else w)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,length", [(1, 1), (1, 0), (7, 5), (17, 17),
                                      (64, 50), (65, 65), (100, 80),
                                      (128, 128), (512, 400)])
def test_prefill_paged_bit_identical(cuda, dtype, s, length):
    pps = max(4, -(-s // 16))
    KP, args, kw = _prefill_case(cuda, dtype, torch.int8, 8, s, pps=pps,
                                 seed=s + length)
    assert not args[5].is_contiguous()
    got = _prefill_check(KP, args, kw, length)
    if length:
        assert not torch.equal(got[0][:, :-1], args[0][:, :-1])


@pytest.mark.parametrize("storage,bits", [(torch.int8, 8), (torch.int8, 4),
                                          (torch.int16, 16), (torch.int32, 8),
                                          (torch.float32, 8)])
def test_prefill_paged_code_types(cuda, storage, bits):
    KP, args, kw = _prefill_case(cuda, torch.bfloat16, storage, bits, 48,
                                 seed=bits)
    _prefill_check(KP, args, kw, 40)


@pytest.mark.parametrize("s", [1024, 700])
def test_prefill_paged_long_prompts(cuda, s):
    """Full width (8 x 128) up to the engine's longest prompt, 128 rows a
    CTA at S = 1,024."""
    from repro_torch.kernels import kv_prefill as KP
    _, args, kw = _prefill_case(cuda, torch.bfloat16, torch.int8, 8, s,
                                layers=2, hkv=8, dh=128, pps=64, seed=s)
    _prefill_check(KP, args, kw, s - 3)


def test_prefill_paged_clamp_zero_layer_and_edges(cuda):
    """Rows past the slot's last page (the clamp; the later of two rows in
    one cell kept), an all-zero layer, and layers whose max sits at
    127 * 2^k and its f32 neighbours: the scale as PyTorch forms it on the
    card (a multiply by the reciprocal of qmax)."""
    KP, args, kw = _prefill_case(cuda, torch.float32, torch.int8, 8, 80,
                                 layers=8, pps=4, seed=3)
    args[4][1] = 0.0
    for i, (k, d) in enumerate([(-5, 1), (-5, 2), (3, 1), (-11, 3), (0, 0),
                                (-2, -1)]):
        m = np.float32(127 * 2.0 ** k)
        for _ in range(abs(d)):
            m = np.nextafter(m, np.float32(np.inf if d > 0 else -np.inf))
        x = args[4][i + 2]
        x.copy_(torch.rand_like(x) * float(m) / 3)
        x[3, 1, 5] = -float(m)
    _prefill_check(KP, args, kw, 80)


@pytest.mark.parametrize("layout", ["odd width", "unaligned"])
def test_prefill_paged_odd_and_unaligned(cuda, layout):
    from repro_torch.kernels import kv_prefill as KP
    if layout == "odd width":
        _, args, kw = _prefill_case(cuda, torch.bfloat16, torch.int8, 8, 33,
                                    hkv=1, dh=12, seed=1)
    else:
        _, args, kw = _prefill_case(cuda, torch.bfloat16, torch.int8, 8, 33,
                                    seed=2)
        buf = torch.empty(args[4].numel() + 1, dtype=args[4].dtype,
                          device=cuda)
        args[4] = buf[1:].view(args[4].shape).copy_(args[4])
    _prefill_check(KP, args, kw, 30)


def test_prefill_paged_wrappers_refuse_on_card(cuda):
    KP, args, kw = _prefill_case(cuda, torch.bfloat16, torch.int8, 8, 9)
    with pytest.raises(ValueError):
        ops.prefill_paged(*args, 9, **kw, impl="torch")
    bad = list(args)
    bad[6] = bad[6].cpu()
    with pytest.raises(ValueError, match="CUDA device"):
        KP.prefill_paged_cuda(*bad, 9, **kw)


def test_export_round_trip_group_bit_identical(cuda):
    """The BinaryConnect export of the FMNIST MLP on the card: one grouped
    round trip a bit width, bit for bit (zeros' sign included) with the
    codec's per-leaf ``roundtrip`` on the card and with the CPU export, at
    zeros, small negatives and saturating values."""
    from repro_torch.optim.binaryconnect import quantize_for_deploy
    d = MLP.make_mlp()
    params = MLP.init_mlp(torch.Generator(device=cuda).manual_seed(2), d,
                          device=cuda)
    for layer in ("l1", "l2"):
        for k, v in params[layer].items():
            if k.startswith("core_") or k == "bias":
                flat = v.view(-1)
                flat[:6] = torch.tensor([0.0, -1e-6, -1e-9, 1e3, -1e3, 0.0],
                                        device=cuda)
    B.reset_launches()
    got = quantize_for_deploy(params, d.qc)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"p2_rt_group": 2}
    cpu = quantize_for_deploy(tree_map(lambda t: t.cpu(), params), d.qc)
    spec4 = TN.QuantSpec("pow2", d.qc.weight_bits)
    for (p, a), (_, c) in zip(flatten_with_path(got), flatten_with_path(cpu)):
        if a.dtype == torch.float32:
            assert torch.equal(a.cpu().view(torch.int32), c.view(torch.int32)
                               ), p
    steps = params["l1"]["wscale_log2"].float()
    one = codecs.roundtrip(params["l1"]["core_1"], spec4, steps[1], "cuda")
    assert torch.equal(got["l1"]["core_1"].view(torch.int32),
                       one.view(torch.int32))
    assert not torch.signbit(got["l1"]["core_0"][got["l1"]["core_0"] == 0]
                             ).any()


# ---------------------------------------------------------------------------
# (p) the packed int4 groups of the deploy export and load
# ---------------------------------------------------------------------------

def _pk_entries(cuda, seed):
    """(rows, last) values and their row steps on the card: the export's six
    cores at their wscale_log2, a stacked (3, 5, 7) with a step per row,
    an odd last, a non-integer step, a scalar, and two views that start off
    16 bytes (an aligned width and an odd one)."""
    d = MLP.make_mlp()
    p = MLP.init_mlp(torch.Generator(device=cuda).manual_seed(seed), d,
                     device=cuda)
    out = [(p[l][f"core_{n}"].reshape(1, -1),
            p[l]["wscale_log2"][n].float().reshape(1))
           for l, spec in (("l1", d.spec1), ("l2", d.spec2))
           for n in range(spec.d)]
    g = torch.Generator(device=cuda).manual_seed(seed + 1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    out.append(CB._rowwise_lastdim(randn(3, 5, 7) * .3,
                                   torch.tensor([-3.0, -2.0, -4.0],
                                                device=cuda)))
    out.append((randn(5, 13), torch.tensor([-2.0], device=cuda)))
    out.append((randn(4, 32), torch.tensor([-2.5], device=cuda)))
    out.append((torch.tensor([[0.7]], device=cuda),
                torch.tensor([-2.0], device=cuda)))
    out.append((randn(4 * 32 + 1)[1:].view(4, 32),
                torch.tensor([-1.0, -2.0, -3.0, -4.0], device=cuda)))
    out.append((randn(3 * 17 + 3)[3:].view(3, 17),
                torch.tensor([-3.0], device=cuda)))
    return [x for x, _ in out], [s for _, s in out], \
        [x.shape[1] for x, _ in out]


def _misaligned_bytes(p2d):
    """A copy of ``p2d`` that starts one byte past a 16-byte boundary."""
    raw = torch.empty(p2d.numel() + 1, dtype=torch.int8, device=p2d.device)
    v = raw[1:].view(p2d.shape)
    v.copy_(p2d)
    return v


def test_packed_groups_bit_identical_in_one_launch(cuda):
    xs, ss, lasts = _pk_entries(cuda, 0)
    assert xs[-2].data_ptr() % 16 and xs[-1].data_ptr() % 16
    B.reset_launches()
    ps = CB.encode_packed_many(xs, ss, 4)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"p2_enc_packed": 1}
    # the decode also takes bytes that start off 16 (the scalar path)
    ins = ps[:-2] + [_misaligned_bytes(p) for p in ps[-2:]]
    B.reset_launches()
    ys = CB.decode_packed_many(ins, ss, lasts)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"p2_dec_packed": 1}
    assert len({p.untyped_storage().data_ptr() for p in ps}) == 1
    assert len({y.untyped_storage().data_ptr() for y in ys}) == 1
    cpu_p = CB.encode_packed_many([x.cpu() for x in xs],
                                  [s.cpu() for s in ss], 4)
    again_p = CB.encode_packed_many(xs, ss, 4)
    again_y = CB.decode_packed_many(ins, ss, lasts)
    for i, (p, y, tp, ty, cp, ap, ay) in enumerate(zip(
            ps, ys, CB.encode_packed_many_plain(xs, ss, 4),
            CB.decode_packed_many_plain(ins, ss, lasts), cpu_p, again_p,
            again_y)):
        assert torch.equal(p, tp) and torch.equal(ap, p), i
        assert torch.equal(y.view(torch.int32), ty.view(torch.int32)), i
        assert torch.equal(ay.view(torch.int32), y.view(torch.int32)), i
        # the CPU's too where 2^s is exact (an integer step): exp2f of the
        # non-integer step is within 2 ulp of the CPU's exp2, not equal
        if torch.equal(ss[i], ss[i].round()):
            assert torch.equal(p.cpu(), cp), i
            want = CB.decode_packed_plain(cp, ss[i].cpu(), lasts[i])
            assert torch.equal(y.cpu().view(torch.int32),
                               want.view(torch.int32)), i


def test_packed_groups_one_launch_per_cap_and_a_group_of_one(cuda):
    from repro_torch.kernels import grouped as G
    g = torch.Generator(device=cuda).manual_seed(9)
    xs = [torch.randn((2, 16 + 3 * i), generator=g, device=cuda)
          for i in range(G.PK_CAP + 1)]
    ss = [torch.tensor([-float(i % 4 + 1)], device=cuda) for i in range(
        len(xs))]
    lasts = [x.shape[1] for x in xs]
    B.reset_launches()
    ps = CB.encode_packed_many(xs, ss, 4)
    ys = CB.decode_packed_many(ps, ss, lasts)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"p2_enc_packed": 2, "p2_dec_packed": 2}
    for p, y, tp, ty in zip(ps, ys, CB.encode_packed_many_plain(xs, ss, 4),
                            CB.decode_packed_many_plain(ps, ss, lasts)):
        assert torch.equal(p, tp)
        assert torch.equal(y.view(torch.int32), ty.view(torch.int32))
    B.reset_launches()
    one = CB.encode_packed(xs[3], ss[3], 4)
    back = CB.decode_packed(one, ss[3], lasts[3])
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"p2_enc_packed": 1, "p2_dec_packed": 1}
    assert torch.equal(one, ps[3])
    assert torch.equal(back.view(torch.int32), ys[3].view(torch.int32))
    with pytest.raises(TypeError, match="int8"):
        CB.decode_packed(one.to(torch.int16), ss[3], lasts[3])
    with pytest.raises(ValueError, match="one device"):
        CB.encode_packed_many([xs[0], xs[1].cpu()], [ss[0], ss[1].cpu()], 4)


def _cpu_copy(tree):
    """``tree`` on the CPU in its own key order (``tree_map`` sorts dict
    keys, and the deploy file keeps the tree's order)."""
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*map(_cpu_copy, tree))
    return tree.cpu()


def test_deploy_export_and_load_one_launch_each(cuda, tmp_path):
    from repro_torch.ckpt import export_tt_deploy, load_tt_deploy
    d = MLP.make_mlp()
    params = MLP.init_mlp(torch.Generator(device=cuda).manual_seed(4), d,
                          device=cuda)
    gpu, cpu = str(tmp_path / "g"), str(tmp_path / "c")
    B.reset_launches()
    stats = export_tt_deploy(gpu, params)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"p2_enc_packed": 1}
    assert stats == export_tt_deploy(cpu, _cpu_copy(params))
    assert stats["packed_bytes"] == 7160
    with open(gpu, "rb") as f, open(cpu, "rb") as g:
        assert f.read() == g.read()
    B.reset_launches()
    back, _ = load_tt_deploy(gpu, device=cuda)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"p2_dec_packed": 1}
    host, _ = load_tt_deploy(gpu, device="cpu")
    for layer in ("l1", "l2"):
        for k, v in host[layer].items():
            got = back[layer][k]
            assert got.is_cuda and torch.equal(got.cpu(), v), (layer, k)


# ---------------------------------------------------------------------------
# (q) the stream routes: the fake-quant group's wide units and the
#     blockwise encode group's stream tasks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fq_group_wide_units_bit_identical(cuda, dtype, bits):
    """Wide units beside narrow ones in one launch, bit for bit with the
    twin (zeros' sign included), the narrow units throughout and a second
    launch: an aligned tensor of a ragged unit count, an odd length and a
    view one element in (the element loop), steps at 2^-127 / 2^127 and a
    non-integer step (the division), and a small tensor."""
    from repro_torch.kernels import grouped as G
    g = torch.Generator(device=cuda).manual_seed(bits)
    n = G.STREAM_MIN
    base = torch.randn(n + 4099, generator=g, device=cuda) * 0.3
    base[:64] = torch.tensor([0.0, -0.0, -1e-30, 1e-30] * 16, device=cuda)
    xs = [base[:n + 4096].to(dtype), base[1:n + 1].to(dtype),
          (base[:n + 3] * 2.0 ** -120).to(dtype), (base[:n] * 1e30).to(dtype),
          base[:n].to(dtype), base[:777].to(dtype)]
    steps = torch.tensor([-3.0, -2.0, -127.0, 127.0, -2.5, -4.0],
                         device=cuda)
    (launch,) = G.fq_plan([x.numel() for x in xs], xs[0].element_size())
    assert launch.wide == (True,) * 5 + (False,)
    B.reset_launches()
    ys = CB.fake_quant_scalar_many(xs, steps, bits)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"p2_fake_quant": 1}
    ptrs = [steps.data_ptr() + 4 * i for i in range(len(xs))]
    # the plain version: on the CPU at integer steps (the card's torch.exp2
    # gives 2^-127 an ulp off, the kernel's ldexpf and the CPU's exp2 give it
    # exactly), on the card at the non-integer step (there the kernel's
    # exp2f is the card's)
    card = CB.fake_quant_many_plain(xs, steps, bits)
    host = CB.fake_quant_many_plain([x.cpu() for x in xs], steps.cpu(), bits)
    for i, (y, r, h, p, a) in enumerate(zip(
            ys, card, host, CB._fq_group(xs, ptrs, bits, stream=False),
            CB.fake_quant_scalar_many(xs, steps, bits))):
        integer = float(steps[i]) == int(steps[i])
        assert _bits_eq(y.cpu(), h) if integer else _bits_eq(y, r), i
        assert _bits_eq(y, p) and _bits_eq(y, a), i


@pytest.mark.parametrize("storage", [torch.int8, torch.int16, torch.float32])
def test_rt_group_wide_units_bit_identical(cuda, storage):
    """The round trip on wide units (a leaf over ``STREAM_MIN``) bit for
    bit with its twin, +0.0 zeros through integer codes."""
    from repro_torch.kernels import grouped as G
    g = torch.Generator(device=cuda).manual_seed(5)
    xs = [torch.randn(G.STREAM_MIN + 8, generator=g, device=cuda) * 0.4,
          torch.randn(300, generator=g, device=cuda)]
    xs[0][:4] = torch.tensor([0.0, -0.0, -0.01, 0.01], device=cuda)
    steps = [torch.tensor(-3.0, device=cuda), torch.tensor(-2.0, device=cuda)]
    ys = CB.roundtrip_many(xs, steps, 8, storage)
    for y, r in zip(ys, CB.roundtrip_many_plain(xs, steps, 8, storage)):
        assert _bits_eq(y, r)
    if storage != torch.float32:             # an f32 code keeps -0.0
        assert not torch.signbit(ys[0][ys[0] == 0]).any()


@pytest.mark.parametrize("storage,bits", [(torch.int8, 8), (torch.int16, 12),
                                          (torch.int32, 20),
                                          (torch.float32, 16)])
@pytest.mark.parametrize("block", [256, 512, 1024])
def test_bw_group_stream_tasks_bit_identical(cuda, block, storage, bits):
    """Stream tasks beside the previous tasks in one launch, bit for bit
    with the twin (codes and scales), the previous tasks throughout and a
    second launch: rows whose last block is ragged, rows of one block,
    one long row (the wire's view) with a ragged end, a view one float in
    (the strided fallback), all-zero blocks, and small leaves."""
    from repro_torch.kernels import grouped as G
    g = torch.Generator(device=cuda).manual_seed(block + bits)
    m = G.STREAM_MIN
    flat = torch.randn(m + 4 * block + 8, generator=g, device=cuda) * 0.05
    flat[:2 * block] = 0.0
    last = 3 * block + 4 * (block // 8)          # ragged last block a row
    xs = [flat[:m - m % last + last].view(-1, last),
          flat[:m].view(-1, block),
          flat[:m + 2 * block + 4].view(1, -1),
          flat[1:m + 1].view(-1, 1024),
          flat[:5 * block].view(5, block), flat[:300].view(10, 30)]
    (launch,) = G.bw_plan([tuple(x.shape) for x in xs], block, storage)
    assert [lf.stream for lf in launch.leaves] == [True] * 4 + [False] * 2
    B.reset_launches()
    got = CB.bw_encode_many(xs, block, bits, storage)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"bw_enc": 1}
    prev = CB._bw_group(xs, block, bits, storage, stream=False)
    again = CB.bw_encode_many(xs, block, bits, storage)
    for x, (c, sc), (pc, ps), (ac, asc) in zip(xs, got, prev, again):
        rc, rs = CB.bw_encode_plain(x, block, bits, storage)
        for other, osc in ((rc, rs), (pc, ps), (ac, asc)):
            assert _bits_eq(c, other) and _bits_eq(sc, osc)
    assert (got[0][1][0, :2] == 0).all() and not got[0][0][0, :2 * block].any()


# ---------------------------------------------------------------------------
# (r) the decode step's state groups
# ---------------------------------------------------------------------------

def _st_case(cuda, seed, entries, slots=4):
    """A state pool of ``entries`` ((layers, feat shape, dtype, strided)),
    random codes and scales, and new states each row at its own magnitude
    (``strided``: a view of whole rows with a gap between slots, as the
    Mamba conv state); the first f32 tensor's rows hold maxima at
    ``127 * 2^k`` and neighbours, its last row zero."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    codes, scales, news, dts = [], [], [], []
    for layers, feat, dt, strided in entries:
        codes.append(torch.randint(-128, 128, (layers, slots) + feat,
                                   generator=g, device=cuda,
                                   dtype=torch.int8))
        scales.append(torch.randint(-9, 3, (layers, slots), generator=g,
                                    device=cuda).float())
        lay = []
        for _ in range(layers):
            mag = torch.exp2(torch.randint(-6, 7, (slots,) + (1,) * len(feat),
                                           generator=g, device=cuda).float())
            full = (slots, feat[0] + (1 if strided else 0)) + feat[1:]
            x = (torch.randn(full, generator=g, device=cuda)
                 * mag).to(dt)
            lay.append(x[:, 1:] if strided else x)
        news.append(lay)
        dts.append(dt)
    e = next(i for i, d in enumerate(dts) if d == torch.float32)
    base = torch.tensor([127.0 * 2.0 ** -2]).view(torch.int32)
    for b in range(slots):
        for lay, x in enumerate(news[e]):
            v = float((base + (lay * slots + b) % 7 - 3).view(torch.float32))
            row = x[b].reshape(-1)
            row.copy_(row / row.abs().max() * (v / 2))
            row[0] = v
    news[e][-1][-1].zero_()
    return codes, scales, news, dts


ST_ENTRIES = [(3, (2, 4096), torch.float32, False),     # clusters, staged
              (3, (1, 96), torch.bfloat16, False),      # a CTA a row
              (2, (3, 12000), torch.bfloat16, True),    # strided, clusters
              (2, (5, 7), torch.float16, False),        # the element path
              (3, (64, 64), torch.float32, False)]


@pytest.mark.parametrize("active", [[True, False, True, True],
                                    [True] * 4])
def test_state_groups_bit_identical(cuda, active):
    from repro_torch.serve import state_cache as SC
    scfg = SC.StateCacheConfig(quantized=True)
    codes, scales, news, dts = _st_case(cuda, 1, ST_ENTRIES)
    act = torch.tensor(active, device=cuda)
    B.reset_launches()
    ys = CB.state_decode_many(codes, scales, dts)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"st_dec_group": 1}
    again = CB.state_decode_many(codes, scales, dts)
    for y, a, t, q, s, dt in zip(ys, again, CB.state_decode_many_plain(
            codes, scales, dts), codes, scales, dts):
        per = torch.stack([SC.read_layer(q[lay], s[lay], dt, scfg)
                           for lay in range(q.shape[0])])
        for other in (a, t, per):
            assert _bits_eq(y, other)
    pools = [([q.clone() for q in codes], [s.clone() for s in scales])
             for _ in range(4)]
    B.reset_launches()
    CB.state_encode_many(*pools[0], news, act, 8)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"st_enc_group": 1}
    CB.state_encode_many_plain(*pools[1], news, act, 8)
    for q, s, layers in zip(*pools[2], news):
        for lay, x in enumerate(layers):
            SC.write_layer(q[lay], s[lay], x, act, scfg)
    CB._st_encode(*pools[3], news, act, 8, reread=True)
    for qs, ss in pools[1:]:
        for a, b in zip(pools[0][0] + pools[0][1], qs + ss):
            assert _bits_eq(a, b)
    off = ~act
    for a, b in zip(pools[0][0] + pools[0][1], codes + scales):
        assert torch.equal(a[:, off], b[:, off])
    CB.state_encode_many(*pools[0], news, act, 8)       # a second launch
    for a, b in zip(pools[0][0] + pools[0][1], pools[1][0] + pools[1][1]):
        assert _bits_eq(a, b)
    assert not pools[0][0][0][-1, -1].any() or not act[-1]


def test_state_groups_past_their_caps(cuda):
    from repro_torch.kernels import grouped as G
    ents = [(1, (40,), torch.float32, False)] * (G.ST_CAP + 3)
    codes, scales, news, dts = _st_case(cuda, 2, ents, slots=2)
    act = torch.tensor([True, True], device=cuda)
    want = CB.state_decode_many_plain(codes, scales, dts)
    ref = ([q.clone() for q in codes], [s.clone() for s in scales])
    B.reset_launches()
    ys = CB.state_decode_many(codes, scales, dts)
    CB.state_encode_many(codes, scales, news, act, 8)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"st_dec_group": 2, "st_enc_group": 2}
    for y, t in zip(ys, want):
        assert _bits_eq(y, t)
    CB.state_encode_many_plain(*ref, news, act, 8)
    for a, b in zip(codes + scales, ref[0] + ref[1]):
        assert _bits_eq(a, b)
    deep = [(G.ST_PTR_CAP + 5, (2, 64), torch.float32, False)]
    codes, scales, news, dts = _st_case(cuda, 3, deep, slots=2)
    ref = ([q.clone() for q in codes], [s.clone() for s in scales])
    B.reset_launches()
    CB.state_encode_many(codes, scales, news, act, 4)
    torch.cuda.synchronize()
    assert dict(B.LAUNCHES) == {"st_enc_group": 2}
    CB.state_encode_many_plain(*ref, news, act, 4)
    for a, b in zip(codes + scales, ref[0] + ref[1]):
        assert _bits_eq(a, b)


def test_state_group_wrappers_refuse_on_card(cuda):
    codes, scales, news, dts = _st_case(cuda, 4, [(2, (2, 32), torch.float32,
                                                   False)])
    act = torch.ones(4, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        CB.state_decode_many([codes[0].to(torch.int16)], scales, dts)
    with pytest.raises(ValueError, match="contiguous"):
        CB.state_decode_many([codes[0].transpose(0, 1)],
                             [scales[0].transpose(0, 1)], dts)
    with pytest.raises(ValueError, match="2..8 bits"):
        CB.state_encode_many(codes, scales, news, act, 9)
    with pytest.raises(TypeError, match="share"):
        CB.state_encode_many(codes, scales, [[news[0][0],
                                              news[0][1].half()]], act, 8)
    with pytest.raises(ValueError, match="contiguous"):
        CB.state_encode_many(codes, scales, [[x.transpose(1, 2).contiguous()
                                              .transpose(1, 2)
                                              for x in news[0]]], act, 8)
    with pytest.raises(TypeError, match="bool"):
        CB.state_encode_many(codes, scales, news, act.int(), 8)
    with pytest.raises(ValueError, match="one device"):
        CB.state_encode_many(codes, scales, news, act.cpu(), 8)


def test_engine_decode_step_launches_the_state_groups(cuda):
    """An int8 rwkv6 engine (reduced, f32) on the card: each decode step one
    ``st_dec_group`` and one ``st_enc_group`` and no row codec kernel; the
    prefill writes each tensor's layer stack with ``p2_enc_rows``."""
    lm = build_lm(C.get_reduced("rwkv6-1.6b").replace(dtype="float32"))
    params = init_lm(torch.Generator(device=cuda).manual_seed(0), lm,
                     device=cuda)
    eng = Engine(lm, params, EngineConfig(pool=PoolConfig(
        num_slots=2, quantized=True)), device=cuda)
    eng.submit([5, 3, 9, 1], max_new_tokens=5)
    eng.submit([2, 7], max_new_tokens=3)
    B.reset_launches()
    eng.run()
    steps = eng.summary()["decode_steps"]
    assert lm.n_periods > 1 and steps >= 4
    assert dict(B.LAUNCHES) == {"st_dec_group": steps,
                                "st_enc_group": steps,
                                "p2_enc_rows": 2 * 3}
