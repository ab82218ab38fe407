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
    fp32 on the card, and each path launches its kernels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as C  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models import build_lm, init_lm  # noqa: E402
from repro_torch.numerics import cuda_backend as CB  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PoolConfig  # noqa: E402

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
