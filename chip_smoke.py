#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py [--out report.json]

Phases (any failure raises and the script exits non-zero):

1. build   — compile every kernel of the serving and training paths
             from ``src/repro_torch/kernels/csrc`` (one nvcc per source, all
             in parallel) and print each kernel's register/spill report.
2. kernels — each serving kernel against its plain PyTorch version at the
             serving path's shapes: the row-scale pow-2 encode (prefill rows 24 x
             S*1024, decode rows 8 x 1024) and decode (gather rows 8 x
             1024*1024) bit-exact; paged attention over an int8 pool
             (513, 16, 8, 128) with B=8, S in {1, 4}, ragged contexts up to
             1024, within 1e-5 in fp32 and 2 bf16 ulp (+1e-5) with bf16 q,
             bit-identical over two launches, and each of its two kernels
             (the split pass, the combine pass) against its plain mirror on
             the same inputs. Times each kernel (CUDA events, L2 flushed
             between launches), its plain version and a library yardstick
             (per-channel quantize / dequantize for the codec where its
             codes match; gather + dequant + scaled_dot_product_attention).
   train kernels — the training kernels at the step's shapes: the scalar
             fake-quant bit-exact at 4/8/16 bits in f32 and bf16, every
             PE1/PE2/PE3 call of a step within 1e-4 (f32) / 2e-2 (bf16),
             PE1, PE2 and PE3 bit-identical over two launches, PE1's requant
             epilogue bit-identical to its own output through encode ->
             decode; timed beside the plain version and a library
             yardstick (fake_quantize_per_tensor_affine, torch.matmul), and
             beside the strided pe_gemm they replaced (``previous_ms``,
             launched for timing only).
3. engine  — the main path: internlm2-1.8b at full width and depth, bf16,
             random weights from a seeded generator on the card, an int8
             paged pool (8 slots x 64 pages of 16) and fused paged
             attention, serving 16 requests (seeded prompts of 128..512
             tokens, 64 new tokens each). Launch counts are zeroed just
             before and read just after: every pool write went through the
             encode kernel and each decode step launched paged attention
             once per layer. The gather engine (the default path) then
             serves the same requests with its counts zeroed, which is
             where the decode kernel runs. Last, a steady window of decode
             steps is timed on the host and profiled on the device: step
             time, device time per kernel, busy share.
   serve chunked prefix — the fourth main path, on the same model:
             chunked prefill (128) with the radix prefix cache, 16 requests
             (12 behind a shared 256-token preamble, 4 of them diverging
             mid-page for a COW fork; 4 random), 64 new tokens each; counts
             zeroed just before and read just after: 48 p2_enc and 48
             p2_dec per chunk step (the chunk steps counted from the
             prefills and their hits), paged attention once per layer per
             decode step; hits, forks and saved pages must be non-zero.
             Then one chunk step's host and device time, profiled.
4. identity — the same requests in float32 at full width with 4 layers:
             fused and gather engines must emit identical greedy tokens.
   chunked identity — float32, 4 layers: an int8 prefix hit (a 16-page
             donor, 8 followers) must equal the cache-off run with a chunk
             boundary at the resume position on every completion, with no
             COW fork; prefix on vs off on the slice's requests is reported.
5. train   — the second main path: the paper's FMNIST TT MLP at its
             published widths, random params from a seeded generator on
             the card, 300 steps of ``launch/train_fmnist.py``'s step on
             ``fashion_like(8192, seed=1)`` in the example's batch order,
             launch counts zeroed just before and read just after (each
             must equal 300 x ``launches_per_step``); the loss must fall
             and test accuracy on ``fashion_like(2048, seed=2)`` beat
             chance; the BinaryConnect export (one p2_enc and one p2_dec
             per core and bias) bit for bit with the CPU. Then a profiled
             window of steps: step time, device time per kernel, busy
             share, and the PE kernels by name (pe1_kernel 6 launches a
             step, pe2_kernel 12, pe3_kernel 2; asserted).
6. train identity — one step from the same initial params on the card and
             on the CPU (plain versions): loss, gradients and the stepped
             params within the CPU parity tests' tolerances.
   wire kernels — the blockwise encode/decode kernels against their plain
             versions bit for bit (codes, scales, values) at every Adam
             moment shape (block 256) and every flattened gradient-leaf
             length of the wire (block 1024) of the step, a padded
             multi-block (3, 1000) at block 256 and an all-zero block; the
             packed int4x2 encode/decode kernels on the six FMNIST cores
             at their wscale_log2, a stacked tensor with a step per row and
             an odd trailing dim, and a scalar. Each timed beside its bound,
             its plain version and a library call where one computes the
             same function.
   scalar kernels — the scalar-scale encode/decode kernels bit for bit
             against their plain versions at the chunk step's full-width
             shapes ((128, 8, 128) bf16/f32 -> int8, (1, 1024, 8, 128)
             int8 -> bf16/f32), an odd length and an unaligned view, scales
             -8..2, and both scalar and row kernels with int16, int32 and
             float32 codes; the row-scale fake-quant kernel bit for bit in
             values
             and STE gradient at (4, 6, 8) and (24, 8, 16384), 4/8/16 bits;
             each timed beside its bound, its plain version and a library
             call (quantize_per_tensor, a per-tensor dequantize,
             fake_quantize_per_channel_affine); then the codec API's
             per-row fake_quant with its launch count.
7. train wire — the third main path: the same MLP stepped 300 times with
             the paper's full Table-1 wire (``make_step(..., compress=True)``
             with int8 Adam moments and the int8 gradient wire), counts
             zeroed just before and read just after (each must equal 300 x
             ``launches_per_step``); the loss and accuracy locks of phase
             5; then, counts zeroed again, the per-site byte table from the
             card's live tensors (``launch/train_wire.py::site_table``:
             7,160 / 91,148 / 98,290 / 14,993 B against 7,844,096 B fp32,
             37.07x) with the packed deploy export of the trained params,
             loaded back by ``load_tt_deploy`` on the card, its cores equal
             to encode -> decode of the params bit for bit; a profiled
             window of wire steps.
8. train wire identity — one wire step from the same state on the card and
             on the CPU, under the CPU parity tests' tolerances.

Output: human-readable lines, then one JSON line describing every kernel,
then the card's name and power limit (nvidia-smi), then the last line
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available or when the repository's
``src/repro_torch`` is not beside this script.

``python3 chip_smoke.py --pe-anatomy [--out report.json]`` runs only the
build and a diagnostic of the PE1/PE2/PE3 kernels: each rebuilt with its FMA
loop, its copies or its stores cut out and timed at the step's shapes, so
the time of each phase reads as a difference (no profiler of kernel
internals works on the card's machine). ``--pa-anatomy`` does the same for
the attention split pass (K/V staging, query load, scores, softmax, P @ V)
beside its combine pass. Neither prints a result line.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
FP32_OPS_PER_S = 67e12             # fp32 peak outside the tensor cores
ARCH = "internlm2-1.8b"
SOURCES = ["pow2_rows", "paged_attention", "pow2_fq", "ttm_pe", "ttm_pe1",
           "ttm_pe2", "ttm_pe3", "blockwise", "pow2_packed", "pow2_scalar"]
TRAIN_STEPS = 300


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Mean device time of a callable in ms, from CUDA events around each
    call. Before each call a 64 MB write leaves the 50 MB L2 cold, as the
    serving loop does (24 layers apart), and a spin kernel holds the device
    for about four times the call's host enqueue time plus 0.5 ms, so the
    events time the device work and not the Python and launch overhead
    between them. ``timer(lambda: None)`` reads the floor under it all."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        spin = int(min(host_s * 8e9, 4e9)) + 1_000_000   # cycles at ~2 GHz
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in pairs:
            self.flush.zero_()
            torch.cuda._sleep(spin)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound_ms(nbytes: float, ops: float = 0.0,
             ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """The least time for the work: bytes at the HBM rate or operations at
    ``ops_per_s`` (the bf16 tensor-core peak, or ``FP32_OPS_PER_S`` for
    kernels that run on the CUDA cores), whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    logs = B.build(SOURCES, verbose=True)
    dt = time.perf_counter() - t0
    ptxas = {}
    for name in SOURCES:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", logs[name])]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                              logs[name]))
        check(bool(regs), f"no ptxas report for {name}")
        check(spill == 0, f"ptxas spilled {spill} bytes in {name}")
        ptxas[name] = {"max_registers": max(regs), "spill_bytes": spill,
                       "instances": len(regs)}
        log(f"  ptxas {name}: {len(regs)} kernel instances, at most "
            f"{max(regs)} registers, {spill} bytes spilled")
    log(f"build: {len(SOURCES)} libraries in {dt:.1f} s")
    return {"build_s": dt, "ptxas": ptxas}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _bf16_excess(diff, ref) -> tuple[float, float]:
    """(max error in bf16 ulps of the reference value, max excess over the
    tolerance 2 ulp + 1e-5). The 1e-5 is the fp32 check's allowance: near
    zero, where outputs are sums that cancel, the two summation orders
    differ by more than a bf16 ulp of the (tiny) result."""
    import torch
    r = ref.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp(r, min=1e-30))) - 7)
    return ((diff / ulp).max().item(),
            (diff - 2 * ulp - 1e-5).max().item())


def phase_kernels(torch, timer: Timer) -> dict:
    from repro_torch.kernels import build as B
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.numerics import cuda_backend as CB

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}

    # --- row-scale encode: decode-append rows (8 x 1024) and prefill rows
    enc_shapes = []
    for rows, cols, what in ((8, 8 * 128, "decode append"),
                             (24, 512 * 8 * 128, "prefill S=512"),
                             (24, 128 * 8 * 128, "prefill S=128")):
        x = (torch.randn((rows, cols), generator=gen, device="cuda") * 3
             ).to(torch.bfloat16)
        # the pool's scales: smallest pow-2 step covering each row's max
        s = torch.ceil(torch.log2(x.float().abs().amax(1) / 127))
        s[0] -= 1                       # one row clips at both ends
        q = CB.encode_rows(x, s, 8)
        ref = CB.encode_rows_plain(x, s, 8)
        err = (q.int() - ref.int()).abs().max().item()
        check(err == 0, f"p2_enc_rows codes differ ({what}): {err}")
        check(q.min().item() == -128 and q.max().item() == 127,
              "encode data did not reach both clip ends")
        ms = timer(lambda: CB.encode_rows(x, s, 8))
        pms = timer(lambda: CB.encode_rows_plain(x, s, 8), iters=10)
        lms, lnote = _library_yardstick(
            timer, lambda: _library_encode(torch, x, s),
            lambda r: torch.equal(r.int_repr(), q))
        bms, by = bound_ms(rows * cols * 3 + rows * 4)
        enc_shapes.append(dict(shape=[rows, cols], what=what, ms=ms,
                               plain_ms=pms, library_ms=lms,
                               library_note=lnote, bound_ms=bms,
                               bound_by=by, max_abs_err=err))
        log(f"p2_enc_rows {what} ({rows}x{cols}): {ms*1e3:.1f} us "
            f"(plain {pms*1e3:.1f} us, library {lnote}, bound "
            f"{bms*1e3:.2f} us), codes exact")
    out["p2_enc_rows"] = enc_shapes

    # --- row-scale decode: the gather path's view (8 x 1024*1024) -> bf16
    dec_shapes = []
    for rows, cols, dt, what in ((8, 1024 * 8 * 128, torch.bfloat16,
                                  "gather T=1024 bf16"),
                                 (8, 1024 * 8 * 128, torch.float32,
                                  "gather T=1024 f32")):
        q = torch.randint(-128, 128, (rows, cols), generator=gen,
                          device="cuda").to(torch.int8)
        s = torch.randint(-9, -2, (rows,), generator=gen, device="cuda"
                          ).float()
        y = CB.decode_rows(q, s, dt)
        ref = CB.decode_rows_plain(q, s, dt)
        check(torch.equal(y, ref), f"p2_dec_rows values differ ({what})")
        ms = timer(lambda: CB.decode_rows(q, s, dt))
        pms = timer(lambda: CB.decode_rows_plain(q, s, dt), iters=10)
        lms, lnote = _library_yardstick(
            timer, lambda: _library_decode(torch, q, s, dt),
            lambda r: torch.equal(r, y))
        bms, by = bound_ms(rows * cols * (1 + y.element_size()) + rows * 4)
        dec_shapes.append(dict(shape=[rows, cols], what=what, ms=ms,
                               plain_ms=pms, library_ms=lms,
                               library_note=lnote, bound_ms=bms,
                               bound_by=by, max_abs_err=0.0))
        log(f"p2_dec_rows {what}: {ms*1e3:.1f} us (plain {pms*1e3:.1f} us, "
            f"library {lnote}, bound {bms*1e3:.2f} us), values exact")
    out["p2_dec_rows"] = dec_shapes

    # --- paged attention: B=8, Hq=16, Hkv=8, Dh=128, page 16, 64 pages/slot
    b, hq, hkv, dh, page, pps = PA_SHAPE
    kd, vd, ks, vs, table = _pa_pool(torch, gen)
    kw = dict(page_size=page, quantized=True)
    att_shapes, comb_shapes = [], []
    for s_rows in (1, 4):
        lens = _pa_lens(torch, s_rows)
        q32 = torch.randn((b, s_rows, hq, dh), generator=gen, device="cuda")
        o32 = PA.paged_attention_cuda(q32, kd, vd, ks, vs, table, lens, **kw)
        r32 = PA.paged_attention_torch(q32, kd, vd, ks, vs, table, lens, **kw)
        err32 = (o32 - r32).abs().max().item()
        check(err32 <= 1e-5, f"paged_attention fp32 S={s_rows}: max abs "
              f"err {err32} > 1e-5")
        check(_bits_equal(torch, o32, PA.paged_attention_cuda(
            q32, kd, vd, ks, vs, table, lens, **kw)),
            f"paged_attention S={s_rows}: two launches differ")
        qb = q32.to(torch.bfloat16)
        ob = PA.paged_attention_cuda(qb, kd, vd, ks, vs, table, lens, **kw)
        rb = PA.paged_attention_torch(qb, kd, vd, ks, vs, table, lens, **kw)
        diff = (ob.float() - rb.float()).abs()
        ulps, over = _bf16_excess(diff, rb)
        check(over <= 0, f"paged_attention bf16 S={s_rows}: error exceeds "
              f"2 bf16 ulp + 1e-5 by {over}")
        errb = diff.max().item()
        comb = _pa_kernels_vs_mirrors(torch, timer, qb, kd, vd, ks, vs,
                                      table, lens, page, s_rows)
        comb_shapes.append(comb)
        # pages this run's data needs: those holding a position <= lens+S-1
        npg = torch.clamp((lens + s_rows - 1) // page + 1, max=pps)
        # keys attended: row j of slot b sees lens[b] + j + 1 positions
        keys = sum(l + j + 1 for l in lens.tolist() for j in range(s_rows))
        nbytes = (int(npg.sum()) * 2 * page * hkv * dh   # int8 K and V
                  + 2 * qb.numel() * 2 + b * (pps + 3) * 4)
        bms, by = bound_ms(nbytes, ops=4.0 * dh * hq * keys)
        ms = timer(lambda: PA.paged_attention_cuda(qb, kd, vd, ks, vs, table,
                                                   lens, **kw))
        pms = timer(lambda: PA.paged_attention_torch(qb, kd, vd, ks, vs,
                                                     table, lens, **kw),
                    iters=5)
        lms = timer(lambda: _library_attention(torch, qb, kd, vd, ks, vs,
                                               table, lens, page))
        lib = _library_attention(torch, qb, kd, vd, ks, vs, table, lens, page)
        lerr = (lib.float() - rb.float()).abs().max().item()
        att_shapes.append(dict(S=s_rows, ms=ms, plain_ms=pms, library_ms=lms,
                               bound_ms=bms, bound_by=by, max_abs_err=errb,
                               max_abs_err_fp32=err32, max_ulp_bf16=ulps,
                               library_max_abs_err=lerr,
                               split_ms=comb["split_ms"]))
        log(f"paged_attention S={s_rows}: {ms*1e3:.1f} us (split "
            f"{comb['split_ms']*1e3:.1f} + combine {comb['ms']*1e3:.1f}; "
            f"plain {pms*1e3:.1f} us, library "
            f"{lms*1e3:.1f} us, bound {bms*1e3:.2f} us); fp32 err "
            f"{err32:.2e}, bf16 {ulps:.2f} ulp, two launches bit-identical")
    # the model-dtype page template (unquantized pool), S=1
    kb = (kd.float() * 2.0 ** -6).to(torch.bfloat16)
    vb = (vd.float() * 2.0 ** -6).to(torch.bfloat16)
    qb = torch.randn((b, hq, dh), generator=gen, device="cuda"
                     ).to(torch.bfloat16)
    ob = PA.paged_attention_cuda(qb, kb, vb, ks, vs, table, lens,
                                 page_size=page, quantized=False)
    rb = PA.paged_attention_torch(qb, kb, vb, ks, vs, table, lens,
                                  page_size=page, quantized=False)
    ulps, over = _bf16_excess((ob.float() - rb.float()).abs(), rb)
    check(over <= 0, f"paged_attention bf16 pages: error exceeds 2 bf16 ulp "
          f"+ 1e-5 by {over}")
    log(f"paged_attention bf16 pages S=1: {ulps:.2f} ulp")
    out["paged_attention"] = att_shapes
    out["paged_attention_combine"] = comb_shapes
    # what the timer reads with no work between its events: the floor
    # under every time above (event and launch latency on this card)
    out["timer_floor_ms"] = timer(lambda: None)
    log(f"timer floor (no work between events): "
        f"{out['timer_floor_ms']*1e3:.1f} us")
    torch.cuda.synchronize()
    B.reset_launches()
    return out


PA_SHAPE = (8, 16, 8, 128, 16, 64)     # B, Hq, Hkv, Dh, page, pages/slot


def _pa_pool(torch, gen):
    """The attention timing case's int8 pool (B * pps pages and the trash
    page), pow-2 scales and a shuffled page table."""
    b, hq, hkv, dh, page, pps = PA_SHAPE
    total = b * pps
    kd = torch.randint(-128, 128, (total + 1, page, hkv, dh), generator=gen,
                       device="cuda").to(torch.int8)
    vd = torch.randint(-128, 128, (total + 1, page, hkv, dh), generator=gen,
                       device="cuda").to(torch.int8)
    ks = torch.randint(-9, -4, (b,), generator=gen, device="cuda").float()
    vs = torch.randint(-9, -4, (b,), generator=gen, device="cuda").float()
    table = torch.randperm(total, generator=gen, device="cuda").reshape(
        b, pps).to(torch.int32)
    return kd, vd, ks, vs, table


def _pa_lens(torch, s_rows):
    """Ragged contexts up to the last position: slot 1's row 0 sees to the
    last key of the first span and its rows 1.. the next, a span where a
    row has no unmasked key."""
    from repro_torch.kernels import paged_attention as PA
    b, hq, hkv, dh, page, pps = PA_SHAPE
    edge = PA.PAGES_PER_SPLIT * page - 1
    return torch.tensor([0, edge, page, 100, 333, 517, 800,
                         pps * page - s_rows], dtype=torch.int32,
                        device="cuda")


def _pa_kernels_vs_mirrors(torch, timer, q, kd, vd, ks, vs, table, lens,
                           page, s_rows) -> dict:
    """Each attention kernel against its plain mirror on the same inputs:
    the split pass's partials on the spans each slot needs — m and l
    within 1e-5 relative, and the span's weighted mean of V, acc / l,
    within 1e-5 absolute (the output's scale, as the fp32 end-to-end
    check: acc itself is a sum of up to 128 terms of |e v| <= 4 whose
    roundoff in two summation orders reaches 1e-5 of its terms, not of
    its value) — and a span with an all-masked row holding m = -1e30; the
    combine pass on those partials within 1e-6 relative (f32 out). Times
    both kernels; returns the combine's row for the kernels line."""
    from repro_torch.kernels import paged_attention as PA
    kw = dict(page_size=page, quantized=True)
    q4, kd4, vd4, ks4, vs4, t4, l4, _, p = PA._checked(
        q, kd, vd, ks, vs, table, lens, page, True)
    m, l, acc = PA.pa_split_cuda(q4, kd4, vd4, ks4, vs4, t4, l4, p, True)
    mm, ml, macc = PA.pa_split_torch(q, kd, vd, ks, vs, table, lens,
                                     pages_per_split=p.pps_split, **kw)
    need = PA.spans_needed(lens, s_rows, page, p.pps, p.pps_split)
    on = torch.arange(p.n_split, device=m.device)[None] < need[:, None]
    sel = on[:, None, :, None].expand(m.shape)
    err = 0.0
    for what, d in (
            ("m", (m - mm).abs() / (1 + mm.abs())),
            ("l", (l - ml).abs() / (1 + ml.abs())),
            ("acc / l", (acc / l[..., None] - macc / ml[..., None]).abs())):
        d = d[sel].max().item()
        check(d <= 1e-5, f"pa split S={s_rows}: partial {what} differs from "
              f"the mirror by {d:.2e}")
        err = max(err, d)
    if s_rows > 1:
        check(m[1, :, 1, 0].eq(PA.NEG_INF).all().item(),
              "pa split: the all-masked span's row is not at -1e30")
    c32 = PA.pa_combine_cuda(m, l, acc, l4, p, torch.float32)
    want = PA.pa_combine_torch(m, l, acc, lens, s=s_rows, page_size=page,
                               pps=p.pps, pages_per_split=p.pps_split,
                               dtype=torch.float32)
    cerr = ((c32 - want).abs() / (1 + want.abs())).max().item()
    check(cerr <= 1e-6, f"pa combine S={s_rows}: differs from its mirror by "
          f"{cerr:.2e}")
    n_read = int(need.sum()) * p.Hkv * p.R * (p.Dh + 2) * 4
    bms, by = bound_ms(n_read + q.numel() * q.element_size() + p.B * 4,
                       3.0 * int(need.sum()) * p.Hkv * p.R * p.Dh,
                       FP32_OPS_PER_S)
    row = dict(S=s_rows, max_abs_err=cerr, split_max_rel_err=err,
               spans=int(need.sum()), n_split=p.n_split,
               ms=timer(lambda: PA.pa_combine_cuda(m, l, acc, l4, p, q.dtype)),
               plain_ms=timer(lambda: PA.pa_combine_torch(
                   m, l, acc, lens, s=s_rows, page_size=page, pps=p.pps,
                   pages_per_split=p.pps_split, dtype=q.dtype), iters=10),
               split_ms=timer(lambda: PA.pa_split_cuda(
                   q4, kd4, vd4, ks4, vs4, t4, l4, p, True)),
               bound_ms=bms, bound_by=by, library_ms=None,
               library_note="none: no PyTorch call merges softmax partials")
    log(f"pa split S={s_rows}: {row['split_ms']*1e3:.1f} us, {row['spans']} "
        f"spans x {p.Hkv} heads of {p.B * p.n_split * p.Hkv} CTAs; partials "
        f"within {err:.1e} of the mirror. combine: {row['ms']*1e3:.1f} us "
        f"(plain {row['plain_ms']*1e3:.1f} us, bound {bms*1e3:.3f} us); "
        f"within {cerr:.1e}")
    return row


def _library_yardstick(timer, fn, same) -> tuple[float | None, str]:
    """Time a library call that should compute what a kernel does, if it
    runs here and its output passes ``same`` bit for bit: ``(ms, note)``,
    or ``(None, why not)``."""
    try:
        out = fn()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"not run ({type(e).__name__}: {str(e)[:80]})"
    if not same(out):
        return None, "not bit-identical"
    ms = timer(fn)
    return ms, f"{ms*1e3:.1f} us"


def _library_encode(torch, x, s):
    """Yardstick only: per-row int8 codes of x at scale 2^s, zero point 0
    (the f32 cast, then torch.quantize_per_channel)."""
    return torch.quantize_per_channel(
        x.float(), torch.exp2(s).double(),
        torch.zeros(s.shape, dtype=torch.long, device=s.device), 0,
        torch.qint8)


def _library_decode(torch, q, s, dt):
    """Yardstick only: codes x 2^s per row (a per-channel quantized tensor
    over the codes, dequantize, cast)."""
    qt = torch._make_per_channel_quantized_tensor(
        q, torch.exp2(s).double(),
        torch.zeros(s.shape, dtype=torch.long, device=s.device), 0)
    return qt.dequantize().to(dt)


def _library_attention(torch, q, kd, vd, ks, vs, table, lens, page):
    """Yardstick only (the port never calls it): gather every slot's pages,
    dequantize, and one scaled_dot_product_attention call."""
    b, s, hq, dh = q.shape
    hkv = kd.shape[2]
    t = table.shape[1] * page
    k = (kd[table.long()].reshape(b, t, hkv, dh).float()
         * torch.exp2(ks)[:, None, None, None]).to(q.dtype)
    v = (vd[table.long()].reshape(b, t, hkv, dh).float()
         * torch.exp2(vs)[:, None, None, None]).to(q.dtype)
    k = k.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    v = v.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    pos = lens.long()[:, None] + torch.arange(s, device=q.device)[None]
    mask = torch.arange(t, device=q.device)[None, None] <= pos[:, :, None]
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:, None])
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# phases 3-4: the engine
# ---------------------------------------------------------------------------

def _requests(vocab: int, n: int = 16, seed: int = 0):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, int(rng.randint(128, 513))).tolist()
            for _ in range(n)]


def _serve_engine(torch, lm, params, prompts, gen_len: int, **ekw):
    """Serve ``prompts`` on a fresh engine over the int8 pool (8 slots x 64
    pages of 16); every completion must have ``gen_len`` in-vocabulary
    tokens. Returns (engine, completions in submission order)."""
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    pool = PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                      quantized=True)
    eng = Engine(lm, params, EngineConfig(pool=pool, **ekw), device="cuda")
    torch.cuda.synchronize()
    rids = [eng.submit(p, max_new_tokens=gen_len) for p in prompts]
    res = eng.run()
    torch.cuda.synchronize()
    toks = [res[r].tokens for r in rids]
    for t in toks:
        check(len(t) == gen_len, f"completion of {len(t)} tokens, want "
              f"{gen_len}")
        check(all(0 <= x < lm.cfg.vocab_size for x in t),
              "token id outside the vocabulary")
    return eng, toks


def _serve(torch, lm, params, fused: bool, prompts, gen_len: int):
    eng, toks = _serve_engine(torch, lm, params, prompts, gen_len,
                              fused_attention=fused)
    return toks, eng.summary()


def full_model(torch):
    """internlm2-1.8b at full width and depth, bf16, random weights from a
    seeded generator on the card (shared by the serving phases)."""
    import repro_torch.configs as C
    from repro_torch.models import build_lm, init_lm
    cfg = C.get_config(ARCH)
    lm = build_lm(cfg)
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), lm,
                     device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"engine: {ARCH} {cfg.num_layers} layers d_model {cfg.d_model}, "
        f"{n_params/1e9:.3f} B params {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f} s")
    return lm, params


def phase_engine(torch, lm, params) -> dict:
    from repro_torch.kernels import build as B

    cfg = lm.cfg
    prompts = _requests(cfg.vocab_size)
    _serve(torch, lm, params, True, prompts[:2], 4)          # warm-up
    torch.cuda.reset_peak_memory_stats()

    B.reset_launches()
    fused_toks, fs = _serve(torch, lm, params, True, prompts, 64)
    main = dict(B.LAUNCHES)
    check(main.get("p2_enc_rows", 0) > 0, "fused path: no encode launch")
    check(main.get("paged_attention", 0) ==
          fs["decode_steps"] * cfg.num_layers,
          f"fused path: {main.get('paged_attention', 0)} attention launches "
          f"for {fs['decode_steps']} decode steps x {cfg.num_layers} layers")
    check(main.get("paged_attention_combine", 0) == main["paged_attention"],
          "fused path: combine launches differ from split launches")
    check(fs["requests_completed"] == len(prompts), "requests lost")
    peak = torch.cuda.max_memory_allocated()

    B.reset_launches()
    gather_toks, gs = _serve(torch, lm, params, False, prompts, 64)
    gather = dict(B.LAUNCHES)
    check(gather.get("p2_dec_rows", 0) > 0, "gather path: no decode launch")
    check(gather.get("paged_attention", 0) == 0
          and gather.get("paged_attention_combine", 0) == 0,
          "gather path launched paged attention")
    agree = sum(a == b for fa, ga in zip(fused_toks, gather_toks)
                for a, b in zip(fa, ga)) / (len(prompts) * 64)
    for name, s in (("fused", fs), ("gather", gs)):
        log(f"engine {name}: {s['requests_completed']} requests, "
            f"{s['generated_tokens']} tokens, {s['decode_steps']} decode "
            f"steps, {s['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{s['ttft_p50_s']*1e3:.1f} ms, p95 {s['ttft_p95_s']*1e3:.1f} "
            f"ms, preemptions {s['preemptions']}")
    log(f"engine: cache_bytes {fs['cache_bytes']} "
        f"({fs['cache_reduction']:.3f}x vs fp32 {fs['cache_bytes_fp32']}), "
        f"peak device memory {peak/2**30:.2f} GiB, bf16 fused/gather token "
        f"agreement {agree:.3f}, launches {main}")
    out = {"fused": fs, "gather": gs, "launches_main": main,
           "launches_gather": gather, "peak_bytes": peak,
           "bf16_token_agreement": agree}
    out["decode_profile"] = _profile_decode(torch, lm, params, prompts)
    return out


def _profile_decode(torch, lm, params, prompts, steps: int = 20) -> dict:
    """Where a steady decode step's time goes: the host wall time of
    ``steps`` unprofiled decode steps of the fused engine with all 8 slots
    busy, then one profiled window of as many steps for
    the device time per kernel. busy_share = device time / wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    eng = Engine(lm, params, EngineConfig(
        pool=PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                        quantized=True), fused_attention=True), device="cuda")
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=3 * steps + 2)
    eng.step()                          # admits + prefills all 8, 1 decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    total, rows = _device_summary(torch, prof, steps)
    log(f"decode profile: {wall*1e3:.2f} ms per step (host wall), device "
        f"{total:.2f} ms busy, busy share {total / (wall*1e3):.3f}")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows}


def phase_identity(torch) -> dict:
    import repro_torch.configs as C
    from repro_torch.models import build_lm, init_lm

    cfg = C.get_config(ARCH).replace(num_layers=4, dtype="float32")
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), lm,
                     device="cuda")
    prompts = _requests(cfg.vocab_size)
    fused, _ = _serve(torch, lm, params, True, prompts, 64)
    gather, _ = _serve(torch, lm, params, False, prompts, 64)
    same = sum(f == g for f, g in zip(fused, gather))
    check(fused == gather, f"fp32 fused vs gather: {same}/{len(prompts)} "
          "completions identical")
    log(f"identity: fp32 {cfg.num_layers} layers, fused == gather on all "
        f"{len(prompts)} completions")
    del params
    torch.cuda.empty_cache()
    return {"identical_completions": same}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phases 5-7: the training slice (the paper's FMNIST TT MLP)
# ---------------------------------------------------------------------------

def _bits_equal(torch, a, b) -> bool:
    """Bit equality of two float tensors (NaN patterns included)."""
    iv = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(iv), b.view(iv))


def _step_pe_calls():
    """(kind, Z shape, G shape) of every PE1/PE2 call of one training step
    (each layer's forward chain and its transposed dx chain; the scale
    manager's forward repeats the forward shapes), and the PE3 calls."""
    from repro_torch.core.ttm import pe_shapes
    from repro_torch.models import mlp_tt as MLP
    d = MLP.make_mlp()
    chains = [c for s in (d.spec1, d.spec2) for sp in (s, s.transposed())
              for c in pe_shapes(sp, 64)]
    pe3 = [("pe3", (64, s.out_dim), (64, s.in_dim))
           for s in (d.spec1, d.spec2)]
    return chains + pe3


def _pe_fns(kind):
    from repro_torch.kernels import ttm_pe1, ttm_pe2, ttm_pe3
    mod = {"pe1": ttm_pe1, "pe2": ttm_pe2, "pe3": ttm_pe3}[kind]
    return getattr(mod, f"{kind}_cuda"), getattr(mod, f"{kind}_torch")


def _pe_library(torch, kind, z, g):
    """Yardstick only: one torch.matmul computing the same contraction on
    the same tensors (cuBLAS, full fp32: TF32 is off)."""
    if kind == "pe1":                     # (a, 1, c) x (1, d, c): b = 1
        check(z.shape[1] == 1, "pe1 yardstick takes b = 1 (the step's)")
        return torch.matmul(z[:, 0, :], g[0].t())
    if kind == "pe2":                     # (b, d)^T @ (a, b, c)
        return torch.matmul(g.t(), z)
    return torch.matmul(z.t(), g)         # PE3: Ybar^T X


def _pe_previous(kind, z, g):
    """Yardstick only: a PE call on the design it replaced, the strided
    ``pe_gemm``, launched with the strides its wrappers gave it
    then (PE1 with (b, c) as a split contraction index, PE2 batched over a
    with G shared, PE3 as one product). Never on a path."""
    from repro_torch.kernels import pe_gemm
    if kind == "pe1":
        a, b, c = z.shape
        d = g.shape[1]
        out = z.new_empty((a, d))
        pe_gemm.launch("pe_gemm_previous", z, g, out, dict(
            batch=1, M=a, N=d, K1=b, K2=c, a_z=0, a_m=b * c, a_k1=c, a_k2=1,
            b_z=0, b_n=c, b_k1=d * c, b_k2=1, c_z=0, c_m=d, c_n=1))
        return out
    if kind == "pe2":
        a, b, c = z.shape
        d = g.shape[1]
        out = z.new_empty((a, d, c))
        pe_gemm.launch("pe_gemm_previous", g, z, out, dict(
            batch=a, M=d, N=c, K1=b, K2=1, a_z=0, a_m=1, a_k1=d, a_k2=0,
            b_z=b * c, b_n=1, b_k1=c, b_k2=0, c_z=d * c, c_m=c, c_n=1))
        return out
    b, j = z.shape
    i = g.shape[1]
    out = z.new_empty((j, i))
    pe_gemm.launch("pe_gemm_previous", z, g, out, dict(
        batch=1, M=j, N=i, K1=b, K2=1, a_z=0, a_m=1, a_k1=j, a_k2=0,
        b_z=0, b_n=1, b_k1=i, b_k2=0, c_z=0, c_m=i, c_n=1))
    return out


# --pe-anatomy: the PE kernels' bodies with one phase cut out at a time, text
# replacements of the lines that run it, by file (csrc/tt_contract.cuh for
# PE2 and PE3, csrc/ttm_pe1.cu for PE1; a store is kept behind a test that
# never holds, so the sums are still computed)
PE_PHASES = {
    "fma": {"tt_contract.cuh": [
        ("fma_row<T, RD>(zr + r * p.zp, gr + r * p.gp, acc);", ";")],
        "ttm_pe1.cu": [("      if (active) {\n        const T* zr = Zs",
                        "      if (false) {\n        const T* zr = Zs")]},
    "copy": {"tt_contract.cuh": [
        ("++i) issue(i, i);", "++i) {}"),
        ("if (ch + p.stages < nch) issue(ch + p.stages, st);", "")],
        "ttm_pe1.cu": [
            ("      tt_contract::copy_any<T>(p.gz, Zs,",
             "      if (false) tt_contract::copy_any<T>(p.gz, Zs,"),
            ("      stage_g_any<T>(p.gg, Gs,",
             "      if (false) stage_g_any<T>(p.gg, Gs,")]},
    "store": {"tt_contract.cuh": [
        ("if (dgi * RD + i < nrows_d) store4(",
         "if (acc[i][0] == 1.5e38f) store4(")],
        "ttm_pe1.cu": [
            ("    tt_contract::store4(Y + (a0 + m) * p.d",
             "    if (acc[i][0] == 1.5e38f) tt_contract::store4(Y + (a0 + m) "
             "* p.d")]},
}
ANATOMY_SOURCES = {"pe1": "ttm_pe1", "pe2": "ttm_pe2", "pe3": "ttm_pe3"}


def _anatomy_libs(table: dict, cuts: dict, files: tuple, sources: tuple,
                  tag: str) -> dict:
    """``sources`` built once per cut under ``kernels/_build/anatomy/
    <tag>_<cut>``, from copies of ``files`` with the cut's phases' lines
    replaced (``table``: phase -> file -> [(old, new)]); every nvcc at
    once. Returns ``{(cut, source): CDLL}``."""
    import ctypes
    import shutil
    from repro_torch.kernels import build as B
    procs, libs = [], {}
    for cut, phases in cuts.items():
        out = B.BUILD_DIR / "anatomy" / f"{tag}_{cut.replace(' ', '_')}"
        out.mkdir(parents=True, exist_ok=True)
        for name in files:
            text = (B.CSRC / name).read_text()
            for ph in phases:
                for old, new in table[ph].get(name, []):
                    check(old in text, f"anatomy: '{old}' not in {name}")
                    text = text.replace(old, new)
            (out / name).write_text(text)
        for src in sources:
            if f"{src}.cu" not in files:
                shutil.copy(B.CSRC / f"{src}.cu", out / f"{src}.cu")
            so = out / f"lib{src}.so"
            cmd = [B.nvcc(), *B.NVCC_FLAGS, "-o", str(so),
                   str(out / f"{src}.cu")]
            procs.append(((cut, src), so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for (cut, src), so, proc in procs:
        msg = proc.communicate()[0]
        check(proc.returncode == 0, f"anatomy build {cut} {src}:\n{msg}")
        libs[(cut, src)] = ctypes.CDLL(str(so))
    return libs


def phase_pe_anatomy(torch, timer: Timer) -> dict:
    """Where a PE launch spends its time, without a profiler: the kernels
    rebuilt with their FMA loop, their copies into shared memory, their
    stores, or all three cut out (``PE_PHASES``), each timed at the step's
    f32 shapes beside the full kernel and ``torch.matmul``. A phase's cost
    is the full time less the time without it. Builds under
    ``kernels/_build/anatomy``."""
    from repro_torch.kernels import tt_contract as TC, ttm_pe1
    cuts = {"full": [], **{f"no {k}": [k] for k in PE_PHASES},
            "none": list(PE_PHASES)}
    libs = {key: (ttm_pe1.typed(lib) if key[1] == "ttm_pe1"
                  else TC.typed(lib, key[1][4:]))
            for key, lib in _anatomy_libs(
                PE_PHASES, cuts, ("tt_contract.cuh", "ttm_pe1.cu"),
                ("ttm_pe1", "ttm_pe2", "ttm_pe3"), "pe").items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for kind, zs, gs in _step_pe_calls():
        z = torch.randn(zs, generator=gen, device="cuda")
        g = torch.randn(gs, generator=gen, device="cuda") * 0.2
        src = ANATOMY_SOURCES[kind]
        if kind == "pe1":
            def run(lib):
                return ttm_pe1.launch(z, g, z.new_empty((zs[0], gs[1])),
                                      lib=lib)
        else:
            if kind == "pe2":
                args = (z, g, z.new_empty((zs[0], gs[1], zs[2])))
            else:   # PE3 is PE2 at a = 1 with Z = X, G = Ybar
                args = (g.view(1, *gs), z, z.new_empty((1, zs[1], gs[1])))

            def run(lib):
                return TC.launch(kind, src, *args, lib=lib)
        row = {"kind": kind, "z": list(zs), "g": list(gs),
               "library_ms": timer(lambda: _pe_library(torch, kind, z, g))}
        for cut in cuts:
            lib = libs[(cut, src)]
            row[cut] = timer(lambda: run(lib))
        for ph in PE_PHASES:
            row[f"{ph}_ms"] = row["full"] - row[f"no {ph}"]
        rows.append(row)
        log(f"anatomy {kind} {zs} x {gs}: full {row['full']*1e3:.1f} us, "
            f"matmul {row['library_ms']*1e3:.1f}; FMA loop "
            f"{row['fma_ms']*1e3:.1f}, copies {row['copy_ms']*1e3:.1f}, "
            f"stores {row['store_ms']*1e3:.1f}; with all three cut out "
            f"{row['none']*1e3:.1f} us (the timer's floor, the launch, the "
            f"prologue, syncs and any b-split reduction)")
    return {"rows": rows}


# --pa-anatomy: the attention split pass with one phase cut out at a time,
# text replacements in csrc/paged_attention.cu (the stores of m, l and acc
# stay, so the work before them is not dropped); "exit" returns at once
PA_PHASES = {p: {"paged_attention.cu": r} for p, r in {
    "stage": [("  stage<GB>(Ks,", "  if (false) stage<GB>(Ks,"),
              ("  stage<GB>(Vs,", "  if (false) stage<GB>(Vs,")],
    "query": [("for (int e = tid; e < R * Dh;",
               "for (int e = tid; false && e < R * Dh;")],
    "scores": [("for (int pr = tid; pr < R * nk;",
                "for (int pr = tid; false && pr < R * nk;")],
    "softmax": [("    for (int t = lane; t < nk; t += 32) mx = fmaxf(",
                 "    for (int t = lane; false && t < nk; t += 32) mx = "
                 "fmaxf("),
                ("    for (int t = lane; t < nk; t += 32) {\n      const "
                 "float e = expf(", "    for (int t = lane; false && t < nk;"
                 " t += 32) {\n      const float e = expf(")],
    "pv": [("    if (on) {\n      const float* pr = Ps + r * KS;",
            "    if (false) {\n      const float* pr = Ps + r * KS;")],
    "exit": [("  if (p0 >= n_pages) return;", "  return;")],
}.items()}
PA_CUT = ("stage", "query", "scores", "softmax", "pv")


def phase_pa_anatomy(torch, timer: Timer) -> dict:
    """Where the attention split pass spends its time, as the PE anatomy
    does it: the kernel rebuilt with its K/V staging, its query load, its
    scores, its softmax or its P @ V cut out (``PA_PHASES``), with all five
    cut out, and returning at once, each timed on the timing case of phase
    2 (bf16 q, int8 pool, S = 1 and 4) beside the full split pass, the
    combine pass and the whole call. A phase's cost is the full time less
    the time without it."""
    from repro_torch.kernels import paged_attention as PA
    cuts = {"full": [], **{f"no {k}": [k] for k in PA_CUT},
            "none": list(PA_CUT), "exit": ["exit"]}
    libs = {k[0]: PA.typed(lib) for k, lib in _anatomy_libs(
        PA_PHASES, cuts, ("paged_attention.cu",), ("paged_attention",),
        "pa").items()}
    b, hq, hkv, dh, page, pps = PA_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    kd, vd, ks, vs, table = _pa_pool(torch, gen)
    rows = []
    for s_rows in (1, 4):
        lens = _pa_lens(torch, s_rows)
        q = torch.randn((b, s_rows, hq, dh), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        ops = PA._checked(q, kd, vd, ks, vs, table, lens, page, True)
        q4, kd4, vd4, ks4, vs4, t4, l4, _, p = ops
        m, l, acc = PA.pa_split_cuda(*ops[:7], p, True)
        row = {"S": s_rows, "call": timer(lambda: PA.paged_attention_cuda(
                   q, kd, vd, ks, vs, table, lens, page_size=page,
                   quantized=True)),
               "combine": timer(lambda: PA.pa_combine_cuda(
                   m, l, acc, l4, p, q.dtype)),
               "timer_floor": timer(lambda: None)}
        for cut in cuts:
            row[cut] = timer(lambda: PA.pa_split_cuda(
                *ops[:7], p, True, lib=libs[cut]))
        for ph in PA_CUT:
            row[f"{ph}_ms"] = row["full"] - row[f"no {ph}"]
        rows.append(row)
        log(f"anatomy paged_attention S={s_rows}: call {row['call']*1e3:.1f}"
            f" us = split {row['full']*1e3:.1f} + combine "
            f"{row['combine']*1e3:.1f}; split phases: staging "
            f"{row['stage_ms']*1e3:.1f}, query {row['query_ms']*1e3:.1f}, "
            f"scores {row['scores_ms']*1e3:.1f}, softmax "
            f"{row['softmax_ms']*1e3:.1f}, P@V {row['pv_ms']*1e3:.1f}; all "
            f"five cut out {row['none']*1e3:.1f}, immediate exit "
            f"{row['exit']*1e3:.1f}, timer floor "
            f"{row['timer_floor']*1e3:.1f} us")
    return {"rows": rows}


def _pe_work(kind, zs, gs, elsize) -> tuple[int, int]:
    """(bytes each input read once and the output written once, flops)."""
    import math
    if kind == "pe1":
        a, b, c = zs
        m, n, k = a, gs[1], b * c
    elif kind == "pe2":
        a, b, c = zs
        m, n, k = a * gs[1], c, b
    else:
        m, n, k = zs[1], gs[1], zs[0]
    return (math.prod(zs) + math.prod(gs) + m * n) * elsize, 2 * m * n * k


PE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def phase_train_kernels(torch, timer: Timer, device: str = "cuda") -> dict:
    """The training slice's kernels against their plain versions at the
    step's shapes: fake-quant bit-exact at bits 4/8/16 in f32 and bf16
    (the steps the step uses: cores ~2^-4, activations 2^-7, gradients
    2^-15), every PE call of the step within 1e-4 (f32) / 2e-2 (bf16)
    relative and absolute, PE2 and PE3 bit-identical over two launches
    (no atomics) and timed beside the strided design they replaced
    (``previous_ms``), and PE1's fused epilogue bit-identical to its
    unfused output through the codec's encode -> decode."""
    from repro_torch import numerics as TN
    from repro_torch.kernels import build as B
    from repro_torch.numerics import cuda_backend as CB
    gen = torch.Generator(device=device).manual_seed(2)
    out = {}

    # --- fake-quant: the edges' and cores' shapes
    fq = []
    for shape, bits, step, what in (((64, 896), 8, -7.0, "edge q_in"),
                                    ((64, 512), 16, -15.0, "edge q_h bwd"),
                                    ((16, 4, 4, 16), 4, -4.0, "l1 core_1"),
                                    ((64, 16), 8, -7.0, "edge q_out")):
        hi = 2 ** (bits - 1)
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device=device) * 0.6 * hi
                 * 2.0 ** step).to(dt)
            x.view(-1)[:4] = torch.tensor([0.5, 2.5, -1.5, 4 * hi],
                                          device=device) * 2.0 ** step
            s = torch.tensor(step, device=device)
            y = CB.fake_quant_scalar(x, s, bits)
            ref = CB.fake_quant_plain(x, s, bits)
            check(_bits_equal(torch, y, ref),
                  f"p2_fake_quant {what} bits {bits} {dt}: not bit-exact")
            row = dict(shape=list(shape), bits=bits, dtype=str(dt)[6:],
                       what=what, max_abs_err=0.0)
            if dt == torch.float32:
                n = x.numel()
                row["ms"] = timer(lambda: CB.fake_quant_scalar(x, s, bits))
                row["plain_ms"] = timer(
                    lambda: CB.fake_quant_plain(x, s, bits), iters=10)
                row["library_ms"], row["library_note"] = _library_yardstick(
                    timer, lambda: torch.fake_quantize_per_tensor_affine(
                        x, 2.0 ** step, 0, -hi, hi - 1),
                    lambda r: torch.equal(r, y))   # -0.0 == 0.0
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2 * n * 4 + 4, 4 * n, FP32_OPS_PER_S)
                log(f"p2_fake_quant {what} {tuple(shape)} {bits}-bit: "
                    f"{row['ms']*1e3:.1f} us (plain "
                    f"{row['plain_ms']*1e3:.1f} us, library "
                    f"{row['library_note']}, bound "
                    f"{row['bound_ms']*1e3:.3f} us); f32 and bf16 exact")
            fq.append(row)
    out["p2_fake_quant"] = [r for r in fq if "ms" in r]

    # --- PE1/PE2/PE3: every call of the step, f32 (the step's) and bf16
    rows = {"pe1": [], "pe2": [], "pe3": []}
    for kind, zs, gs in _step_pe_calls():
        kern, plain = _pe_fns(kind)
        row = dict(z=list(zs), g=list(gs))
        for dt, name in ((torch.float32, "float32"),
                         (torch.bfloat16, "bfloat16")):
            z = torch.randn(zs, generator=gen, device=device).to(dt)
            g = (torch.randn(gs, generator=gen, device=device) * 0.2).to(dt)
            o, r = kern(z, g), plain(z, g)
            check(o.shape == r.shape and o.dtype == dt,
                  f"{kind} {zs}x{gs}: shape/dtype")
            err = (o.float() - r.float()).abs()
            tol = PE_TOL[name]
            check(bool((err <= tol + tol * r.float().abs()).all()),
                  f"{kind} {zs}x{gs} {name}: max err {err.max().item()}")
            row[f"max_abs_err_{name}"] = err.max().item()
            check(_bits_equal(torch, kern(z, g), o),
                  f"{kind} {zs}x{gs} {name}: two launches differ")
            if dt == torch.float32:
                lib = _pe_library(torch, kind, z, g)
                check((lib - r).abs().max().item() <= 1e-4 * (
                    1 + r.abs().max().item()), f"{kind} yardstick differs")
                row["ms"] = timer(lambda: kern(z, g))
                row["plain_ms"] = timer(lambda: plain(z, g), iters=10)
                row["library_ms"] = timer(
                    lambda: _pe_library(torch, kind, z, g))
                prev = _pe_previous(kind, z, g)
                check((prev - r).abs().max().item() <= 1e-4 * (
                    1 + r.abs().max().item()), f"{kind} previous differs")
                row["previous_ms"] = timer(lambda: _pe_previous(kind, z, g))
                nbytes, flops = _pe_work(kind, zs, gs, 4)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, flops, FP32_OPS_PER_S)
        row["max_abs_err"] = row["max_abs_err_float32"]
        rows[kind].append(row)
        was = f", previous {row['previous_ms']*1e3:.1f} us"
        log(f"{kind} {zs} x {gs}: {row['ms']*1e3:.1f} us (plain "
            f"{row['plain_ms']*1e3:.1f} us{was}, library "
            f"{row['library_ms']*1e3:.1f} us, bound "
            f"{row['bound_ms']*1e3:.3f} us {row['bound_by']}); err f32 "
            f"{row['max_abs_err_float32']:.1e}, bf16 "
            f"{row['max_abs_err_bfloat16']:.1e}")

    # --- PE1's requant epilogue == its own output through the codec
    from repro_torch.kernels import ttm_pe1
    z = torch.randn((3584, 1, 16), generator=gen, device=device)
    g = torch.randn((1, 256, 16), generator=gen, device=device)
    acc = ttm_pe1.pe1_cuda(z, g)
    for bits in (4, 8):
        hi = 2 ** (bits - 1) - 1
        tail = min(acc.max().item(), -acc.min().item())
        step = torch.tensor(float(math.floor(math.log2(0.5 * tail / hi))),
                            device=device)
        fused = ttm_pe1.pe1_cuda(z, g, step, bits)
        spec = TN.QuantSpec("pow2", bits)
        unfused = TN.decode(TN.encode(acc, spec, step, backend="cuda"),
                            torch.float32, backend="cuda")
        check(torch.equal(fused, unfused),
              f"pe1 epilogue {bits}-bit differs from encode -> decode")
        q = fused / 2.0 ** step.item()
        check(q.max().item() == hi and q.min().item() == -hi - 1,
              "pe1 epilogue data did not clip at both ends")
    log("pe1 epilogue: 4- and 8-bit fused output == encode -> decode of the "
        "unfused output, bit for bit")
    out.update(rows)
    _sync(torch, device)
    B.reset_launches()
    return out


def _sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _tensor_tree(torch, tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def phase_train(torch, device: str = "cuda", steps: int = TRAIN_STEPS
                ) -> dict:
    """The main training path: the FMNIST TT MLP at its published widths,
    random seeded params on the card, ``steps`` steps of the example's
    batches (fashion_like(8192, seed=1), 64 a step), launch counts zeroed
    just before and read just after; then test accuracy on
    fashion_like(2048, seed=2), the Table-1 accounting, and a profiled
    window of steps."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import fashion_like
    from repro_torch.kernels import build as B
    from repro_torch.launch import train_fmnist as TF
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.optim import adam as A

    d = MLP.make_mlp()
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=0.0)
    params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0), d,
                          device=device)
    opt = A.init_adam(params, tcfg)
    xs, ys = (torch.from_numpy(a).to(device)
              for a in fashion_like(8192, seed=1))
    xt, yt = (torch.from_numpy(a).to(device)
              for a in fashion_like(2048, seed=2))
    step = TF.make_step(d, tcfg)
    full = MLP.param_counts(d)
    check(full["tt_params"] == 14794 and full["fixed_bits"] == 61264
          and round(full["dense_bits"] / full["fixed_bits"]) == 243,
          f"Table-1 accounting at full rank: {full}")
    acc0 = TF.accuracy(params, xt, yt, d)
    _sync(torch, device)

    B.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        params, opt, loss = step(params, opt, TF.batch_at(xs, ys, i))
        losses.append(loss)
    _sync(torch, device)
    wall = (time.perf_counter() - t0) / steps
    launches = dict(B.LAUNCHES)
    want = {k: v * steps for k, v in TF.launches_per_step(d).items()}
    check(launches == want, f"train launches {launches}, want {want} "
          f"({TF.launches_per_step(d)} a step)")

    loss = torch.stack(losses).cpu()
    check(bool(torch.isfinite(loss).all()), "non-finite loss")
    first, last = loss[:20].mean().item(), loss[-20:].mean().item()
    check(last < 0.5 * first, f"loss did not fall: first 20 steps "
          f"{first:.4f}, last 20 {last:.4f}")
    acc = TF.accuracy(params, xt, yt, d)
    check(acc > 0.5, f"test accuracy {acc:.3f} not above chance (0.1)")
    # the BinaryConnect export: 4-bit cores, 8-bit biases, one step each,
    # through the scalar-scale codec kernels, bit for bit with their plain
    # versions on the CPU; one p2_enc and one p2_dec per leaf
    from repro_torch.optim.binaryconnect import quantize_for_deploy
    from repro_torch.tree import flatten_with_path
    _sync(torch, device)
    B.reset_launches()
    deploy = quantize_for_deploy(params, d.qc)
    _sync(torch, device)
    export_launches = dict(B.LAUNCHES)
    n_leaves = sum(1 for k, _ in flatten_with_path(params)
                   if k.split("/")[-1].startswith("core_")
                   or k.endswith("/bias"))
    if device == "cuda":
        check(export_launches == {"p2_enc": n_leaves, "p2_dec": n_leaves},
              f"BinaryConnect export launches {export_launches}, want "
              f"{n_leaves} p2_enc and p2_dec")
    plain = quantize_for_deploy(_tensor_tree(torch, params, "cpu"), d.qc)
    for (path, a), (_, b) in zip(flatten_with_path(deploy),
                                 flatten_with_path(plain)):
        check(torch.equal(a.cpu(), b), f"deploy export: {path} differs")
    check(deploy["l1"]["core_0"].unique().numel() <= 16,
          "deploy export: more than 16 levels in a 4-bit core")
    eff1, eff2 = MLP.effective_ranks(params, d)
    c = MLP.param_counts(d, eff1, eff2)
    for name, st in (("q_in", params["q_in"]), ("q_h", params["q_h"]),
                     ("q_out", params["q_out"])):
        log(f"  scale {name}: act 2^{int(st.act.log2)}, grad "
            f"2^{int(st.grad.log2)}")
    log(f"train: {steps} steps, loss {loss[0].item():.4f} -> "
        f"{loss[-1].item():.4f} (mean of first/last 20: {first:.4f} / "
        f"{last:.4f}), test acc {acc0:.3f} -> {acc:.3f}, {wall*1e3:.2f} ms "
        f"per step (host wall), launches per step "
        f"{TF.launches_per_step(d)}")
    log(f"train: BinaryConnect export of {n_leaves} leaves bit for bit "
        f"with the CPU, launches {export_launches}")
    log(f"train: effective ranks L1 {eff1} L2 {eff2}, params "
        f"{c['tt_params']:,}, memory {c['fixed_bits']:,} bits, reduction "
        f"{c['dense_bits'] / c['fixed_bits']:.0f}x vs dense (full rank: "
        f"{full['tt_params']:,} params, "
        f"{full['dense_bits'] / full['fixed_bits']:.0f}x)")
    state = {"params": params, "opt": opt}

    def one(i):
        state["params"], state["opt"], _ = step(
            state["params"], state["opt"], TF.batch_at(xs, ys, i))
    prof = _profile_train(torch, one) if device == "cuda" else None
    return {"steps": steps, "step_ms": wall * 1e3,
            "loss_first": loss[0].item(), "loss_last": loss[-1].item(),
            "loss_first20": first, "loss_last20": last,
            "test_acc_init": acc0, "test_acc": acc,
            "effective_ranks": [eff1, eff2], "param_counts": c,
            "launches": launches, "export_launches": export_launches,
            "profile": prof}


def _device_summary(torch, prof, steps: int) -> tuple[float, list]:
    """(device ms per step, top kernels) from a profiler window: device-side
    events only (kernels, memcpy/memset); the CPU-side op events carry the
    same device time again."""
    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == cuda and dev(e) > 0]
    total = sum(dev(e) for e in evs) / steps / 1e3
    top = sorted(evs, key=dev, reverse=True)[:12]
    return total, [{"name": e.key[:80], "calls_per_step": e.count / steps,
                    "ms_per_step": dev(e) / steps / 1e3} for e in top]


def _profile_train(torch, one, steps: int = 20):
    """Host wall of ``steps`` unprofiled training steps (``one(i)`` runs
    step i), then one profiled window of as many for the device time per
    kernel. busy_share = device time / wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        one(i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            one(steps + i)
        torch.cuda.synchronize()
    total, rows = _device_summary(torch, prof, steps)
    log(f"train profile: {wall*1e3:.2f} ms per step (host wall), device "
        f"{total:.3f} ms busy, busy share {total / (wall*1e3):.3f}")
    for r in rows:
        log(f"  {r['ms_per_step']*1e3:8.1f} us  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    pe = _pe_profile(torch, prof, steps)
    for name, r in pe.items():
        log(f"  PE {name}: {r['calls_per_step']:.1f} launches, "
            f"{r['ms_per_step']*1e3:.1f} us a step")
    want = {"pe1_kernel": 6.0, "pe2_kernel": 12.0, "pe3_kernel": 2.0}
    check({k: r["calls_per_step"] for k, r in pe.items()} == want,
          f"train profile PE kernels {pe}, want launches {want} a step")
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows, "pe": pe}


def _pe_profile(torch, prof, steps: int) -> dict:
    """Launches and device ms per step of the PE kernels, by kernel name:
    ``pe1_kernel``, ``pe2_kernel``, ``pe3_kernel``."""
    cuda = torch.autograd.DeviceType.CUDA
    calls, us = {}, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != cuda:
            continue
        for name in ("pe1_kernel", "pe2_kernel", "pe3_kernel"):
            if f"{name}<" in e.key:
                calls[name] = calls.get(name, 0) + e.count
                us[name] = us.get(name, 0.0) + getattr(
                    e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
    return {name: {"calls_per_step": n / steps,
                   "ms_per_step": us[name] / steps / 1e3}
            for name, n in calls.items()}


def phase_train_identity(torch) -> dict:
    """One training step from the same initial params on the card (the
    kernels) and on the CPU (their plain versions), under the CPU parity
    tests' tolerances: loss within 1e-5 relative, every gradient leaf
    within 1e-3 of its largest |g|; after the full step the same scale
    exponents and effective ranks, and every element within 2 lr (Adam's
    first step moves an element by at most lr)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import fashion_like
    from repro_torch.launch import train_fmnist as TF
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.optim import adam as A
    from repro_torch.tree import flatten_with_path

    d = MLP.make_mlp()
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=0.0)
    p_cpu = MLP.init_mlp(torch.Generator().manual_seed(0), d, device="cpu")
    p_gpu = _tensor_tree(torch, p_cpu, "cuda")
    xs, ys = fashion_like(8192, seed=1)
    b_cpu = {"x": torch.from_numpy(xs[:64]), "y": torch.from_numpy(ys[:64])}
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    l_gpu, g_gpu = TF.loss_and_grads(p_gpu, b_gpu, d)
    l_cpu, g_cpu = TF.loss_and_grads(p_cpu, b_cpu, d)
    rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
    check(rel <= 1e-5, f"train identity: loss rel diff {rel:.2e} > 1e-5")
    worst = 0.0
    for (path, a), (_, b) in zip(flatten_with_path(g_gpu),
                                 flatten_with_path(g_cpu)):
        if b is None:
            check(a is None, f"{path}: gradient on one side only")
            continue
        m = b.abs().max().item()
        e = (a.cpu() - b).abs().max().item()
        check(e <= 1e-3 * m, f"train identity: {path} grad err {e:.3e} > "
              f"1e-3 x {m:.3e}")
        worst = max(worst, e / m if m else 0.0)
    step = TF.make_step(d, tcfg)
    p_gpu, _, _ = step(p_gpu, A.init_adam(p_gpu, tcfg), b_gpu)
    p_cpu, _, _ = step(p_cpu, A.init_adam(p_cpu, tcfg), b_cpu)
    move = 0.0
    for (path, a), (_, b) in zip(flatten_with_path(p_gpu),
                                 flatten_with_path(p_cpu)):
        if not a.is_floating_point():
            check(torch.equal(a.cpu(), b), f"train identity: {path} differs")
            continue
        e = (a.cpu() - b).abs().max().item()
        check(e <= 2 * tcfg.learning_rate + 1e-6,
              f"train identity: {path} after the step differs by {e:.3e}")
        move = max(move, e)
    check(MLP.effective_ranks(p_gpu, d) == MLP.effective_ranks(p_cpu, d),
          "train identity: effective ranks differ")
    log(f"train identity: card vs CPU loss rel diff {rel:.2e}, worst "
        f"gradient leaf {worst:.2e} of its max, params after one step within "
        f"{move:.2e}; scale exponents and effective ranks equal")
    return {"loss_rel_diff": rel, "grad_worst_rel": worst,
            "param_max_diff": move}


# ---------------------------------------------------------------------------
# wire kernels and phases 7-8: the full Table-1 wire (int8 moments, int8
# gradient wire, packed int4 deploy export)
# ---------------------------------------------------------------------------

MOMENT_SHAPES = [(16, 16, 16, 1), (16, 4, 4, 16), (16, 2, 2, 16),
                 (1, 4, 7, 16), (1, 1, 32, 16), (512,), (16,), ()]
WIRE_LENGTHS = [4096, 1024, 512, 448, 16, 1]
PACKED_NONE = ("none: no PyTorch call packs signed int4 pairs (quint4x2 "
               "is unsigned with a zero point and has no CUDA kernel)")
BW_ENC_NONE = ("none: no PyTorch call derives per-block absmax scales "
               "(quantize_per_channel takes the scales as input)")


def _bw_row(torch, timer, shape, block, gen, what) -> dict:
    """One blockwise shape: encode and decode kernels against their plain
    versions bit for bit, then timed with bounds and the library decode."""
    from repro_torch import numerics as TN
    from repro_torch.numerics import cuda_backend as CB
    x = torch.randn(shape, generator=gen, device=gen.device) * 0.05
    last = x.shape[-1] if x.dim() else 1
    if last > block:
        x[..., :block] = 0.0                         # an all-zero block
    x2d = x.reshape(-1, last)
    rows = x2d.shape[0]
    b, nb, _ = TN.blockwise_geometry(TN.QuantSpec("blockwise", 8, block),
                                     last)
    codes, sc = CB.bw_encode(x2d, block)
    rc, rs = CB.bw_encode_plain(x2d, block)
    check(torch.equal(codes, rc), f"bw_enc codes differ ({what})")
    check(_bits_equal(torch, sc, rs), f"bw_enc scales differ ({what})")
    if last > block:
        check(sc[0, 0].item() == 0.0 and not codes[0, :b].any().item(),
              f"bw_enc: all-zero block not coded as zeros ({what})")
    y = CB.bw_decode(codes, sc, last)
    check(_bits_equal(torch, y, CB.bw_decode_plain(codes, sc, last)),
          f"bw_dec values differ ({what})")
    n = rows * last
    enc = dict(shape=list(shape), block=block, b=b, what=what,
               max_abs_err=0.0,
               ms=timer(lambda: CB.bw_encode(x2d, block)),
               plain_ms=timer(lambda: CB.bw_encode_plain(x2d, block),
                              iters=10),
               library_ms=None, library_note=BW_ENC_NONE)
    enc["bound_ms"], enc["bound_by"] = bound_ms(
        n * 4 + rows * nb * (b + 4), 4 * n, FP32_OPS_PER_S)
    dec = dict(shape=list(shape), block=block, b=b, what=what,
               max_abs_err=0.0,
               ms=timer(lambda: CB.bw_decode(codes, sc, last)),
               plain_ms=timer(lambda: CB.bw_decode_plain(codes, sc, last),
                              iters=10))
    dec["library_ms"], dec["library_note"] = _library_yardstick(
        timer, lambda: _library_bw_decode(torch, codes, sc, b, last),
        lambda r: _bits_equal(torch, r, y))
    dec["bound_ms"], dec["bound_by"] = bound_ms(
        rows * nb * (b + 4) + n * 4, n, FP32_OPS_PER_S)
    log(f"bw {what} {tuple(shape)} b={b}: enc {enc['ms']*1e3:.1f} us "
        f"(plain {enc['plain_ms']*1e3:.1f}, bound "
        f"{enc['bound_ms']*1e3:.3f}), dec {dec['ms']*1e3:.1f} us (plain "
        f"{dec['plain_ms']*1e3:.1f}, library {dec['library_note']}, bound "
        f"{dec['bound_ms']*1e3:.3f}); bit-exact")
    return enc, dec


def _library_bw_decode(torch, codes, sc, b, last):
    """Yardstick only: a per-channel quantized tensor over the codes, one
    channel per block, dequantized, the pad sliced away."""
    rows, nb = sc.shape
    qt = torch._make_per_channel_quantized_tensor(
        codes.reshape(rows * nb, b), sc.reshape(-1).double(),
        torch.zeros(rows * nb, dtype=torch.long, device=codes.device), 0)
    return qt.dequantize().reshape(rows, nb * b)[:, :last]


def _packed_row(torch, timer, x, s, what) -> tuple[dict, dict]:
    from repro_torch import numerics as TN
    from repro_torch.numerics import cuda_backend as CB
    spec = TN.QuantSpec("pow2", 4, 0, "int4x2", "fixed")
    x2d, srow = CB._rowwise_lastdim(x, s)
    rows, last = x2d.shape
    p = CB.encode_packed(x2d, srow, 4)
    check(torch.equal(p, CB.encode_packed_plain(x2d, srow, 4)),
          f"p2_enc_packed bytes differ ({what})")
    y = CB.decode_packed(p, srow, last)
    check(_bits_equal(torch, y, CB.decode_packed_plain(p, srow, last)),
          f"p2_dec_packed values differ ({what})")
    qt = TN.encode(x, spec, s, backend="cuda")      # the codec's view
    ref = TN.encode(x.cpu(), spec, s.cpu())
    check(torch.equal(qt.codes.cpu(), ref.codes),
          f"packed codec differs from the reference ({what})")
    n, pk = rows * last, p.shape[1]
    enc = dict(shape=list(x.shape), what=what, max_abs_err=0.0,
               ms=timer(lambda: CB.encode_packed(x2d, srow, 4)),
               plain_ms=timer(lambda: CB.encode_packed_plain(x2d, srow, 4),
                              iters=10),
               library_ms=None, library_note=PACKED_NONE)
    enc["bound_ms"], enc["bound_by"] = bound_ms(
        n * 4 + rows * pk + srow.numel() * 4, 4 * n, FP32_OPS_PER_S)
    dec = dict(shape=list(x.shape), what=what, max_abs_err=0.0,
               ms=timer(lambda: CB.decode_packed(p, srow, last)),
               plain_ms=timer(lambda: CB.decode_packed_plain(p, srow, last),
                              iters=10),
               library_ms=None, library_note=PACKED_NONE)
    dec["bound_ms"], dec["bound_by"] = bound_ms(
        rows * pk + n * 4 + srow.numel() * 4, 2 * n, FP32_OPS_PER_S)
    log(f"packed {what} {tuple(x.shape)}: enc {enc['ms']*1e3:.1f} us "
        f"(plain {enc['plain_ms']*1e3:.1f}, bound "
        f"{enc['bound_ms']*1e3:.4f}), dec {dec['ms']*1e3:.1f} us (plain "
        f"{dec['plain_ms']*1e3:.1f}, bound {dec['bound_ms']*1e3:.4f}); "
        f"bit-exact")
    return enc, dec


def phase_wire_kernels(torch, timer: Timer, device: str = "cuda") -> dict:
    """The wire's codec kernels against their plain versions, bit for bit,
    at the shapes of the step: every Adam moment shape at block 256 and
    every flattened gradient length of the wire at block 1024, a padded
    (3, 1000) at 256 with an all-zero block; the packed codec on the six
    cores at their wscale_log2, a stacked (3, 5, 7) with a step per row,
    and a scalar."""
    from repro_torch.kernels import build as B
    from repro_torch.models import mlp_tt as MLP
    gen = torch.Generator(device=device).manual_seed(3)
    enc, dec = [], []
    cases = [(s, 256, "moment") for s in MOMENT_SHAPES]
    cases += [((n,), 1024, "wire") for n in WIRE_LENGTHS]
    cases += [((3, 1000), 256, "padded")]
    for shape, block, what in cases:
        e, d_ = _bw_row(torch, timer, shape, block, gen, what)
        enc.append(e)
        dec.append(d_)
    d = MLP.make_mlp()
    params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0), d,
                          device=device)
    penc, pdec = [], []
    cores = [(f"{layer}/core_{n}", params[layer][f"core_{n}"].reshape(-1),
              params[layer]["wscale_log2"][n].float())
             for layer, spec in (("l1", d.spec1), ("l2", d.spec2))
             for n in range(spec.d)]
    cores.sort(key=lambda c: -c[1].numel())
    cases = cores + [
        ("stacked per-row", torch.randn((3, 5, 7), generator=gen,
                                        device=device) * 0.3,
         torch.tensor([-3.0, -2.0, -4.0], device=device)),
        ("scalar", torch.tensor(0.7, device=device),
         torch.tensor(-2.0, device=device))]
    for what, x, s in cases:
        e, d_ = _packed_row(torch, timer, x, s, what)
        penc.append(e)
        pdec.append(d_)
    _sync(torch, device)
    B.reset_launches()
    return {"bw_enc": enc, "bw_dec": dec, "p2_enc_packed": penc,
            "p2_dec_packed": pdec}


EXPECT_SITES = {"tt_factor": 7160, "activation": 91148,
                "optimizer_moment": 98290, "dp_wire": 14993}


def phase_train_wire(torch, device: str = "cuda",
                     steps: int = TRAIN_STEPS) -> dict:
    """The full-wire training path on the card: ``steps`` steps of
    ``make_step(d, tcfg, compress=True)`` with int8 moments from seeded
    random params, launch counts per step asserted; the loss and accuracy
    locks; then the per-site byte table from the live tensors with the
    deploy export, loaded back on the card and held to encode -> decode of
    the params; a profiled window of wire steps."""
    import tempfile
    from repro_torch import numerics as TN
    from repro_torch.ckpt import load_tt_deploy
    from repro_torch.data import fashion_like
    from repro_torch.kernels import build as B
    from repro_torch.launch import train_fmnist as TF
    from repro_torch.launch import train_wire as TW
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.optim import adam as A
    from repro_torch.tree import leaves

    d = MLP.make_mlp()
    tcfg = TW.wire_config()
    params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0), d,
                          device=device)
    opt = A.init_adam(params, tcfg)
    xs, ys = (torch.from_numpy(a).to(device)
              for a in fashion_like(8192, seed=1))
    xt, yt = (torch.from_numpy(a).to(device)
              for a in fashion_like(2048, seed=2))
    step = TF.make_step(d, tcfg, compress=True)
    acc0 = TF.accuracy(params, xt, yt, d)
    residual = grads = None
    _sync(torch, device)

    B.reset_launches()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        params, opt, loss, grads, residual = step(
            params, opt, TF.batch_at(xs, ys, i), residual)
        losses.append(loss)
    _sync(torch, device)
    wall = (time.perf_counter() - t0) / steps
    launches = dict(B.LAUNCHES)
    per = TF.launches_per_step(d, tcfg, compress=True)
    want = {k: v * steps for k, v in per.items()}
    if device == "cuda":
        check(launches == want, f"wire launches {launches}, want {want} "
              f"({per} a step)")
    loss = torch.stack(losses).cpu()
    check(bool(torch.isfinite(loss).all()), "wire: non-finite loss")
    first, last = loss[:20].mean().item(), loss[-20:].mean().item()
    check(last < 0.5 * first, f"wire: loss did not fall: first 20 steps "
          f"{first:.4f}, last 20 {last:.4f}")
    acc = TF.accuracy(params, xt, yt, d)
    check(acc > 0.5, f"wire: test accuracy {acc:.3f} not above chance")
    eff1, eff2 = MLP.effective_ranks(params, d)
    c = MLP.param_counts(d, eff1, eff2)
    log(f"train wire: {steps} steps, loss {loss[0].item():.4f} -> "
        f"{loss[-1].item():.4f} (mean of first/last 20: {first:.4f} / "
        f"{last:.4f}), test acc {acc0:.3f} -> {acc:.3f}, {wall*1e3:.2f} ms "
        f"per step (host wall), launches per step {per}")
    log(f"train wire: effective ranks L1 {eff1} L2 {eff2}, params "
        f"{c['tt_params']:,}, reduction "
        f"{c['dense_bits'] / c['fixed_bits']:.0f}x vs dense")

    # the byte table and the deploy export, from the card's live tensors
    result = {"new_params": params, "opt": opt, "grads": grads,
              "policy": d.qc.policy(), "batch": TF.BATCH}
    _sync(torch, device)
    B.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        sites, baseline, deploy = TW.site_table(result,
                                                f"{tmp}/deploy.ckpt")
        back, _ = load_tt_deploy(f"{tmp}/deploy.ckpt", device=device)
    _sync(torch, device)
    export_launches = dict(B.LAUNCHES)
    n_cores = d.spec1.d + d.spec2.d
    n_wire = sum(1 for g in leaves(grads) if g is not None
                 and g.is_floating_point())
    if device == "cuda":
        check(export_launches == {"p2_enc_packed": n_cores,
                                  "p2_dec_packed": n_cores,
                                  "bw_enc": n_wire},
              f"export launches {export_launches}")
    check(sites == EXPECT_SITES, f"site table {sites}, want {EXPECT_SITES}")
    low, base = sum(sites.values()), sum(baseline.values())
    check(low == 211591 and base == 7844096
          and round(base / low, 2) == 37.07,
          f"Table-1 total {low} vs {base}")
    check(round(deploy["reduction_x"], 2) == 7.97, f"deploy {deploy}")
    spec = TN.QuantSpec("pow2", 4, 0, "int4x2", "fixed")
    for layer, sp in (("l1", d.spec1), ("l2", d.spec2)):
        for n in range(sp.d):
            core = params[layer][f"core_{n}"].cpu()
            want_core = TN.roundtrip(
                core.reshape(-1), spec,
                params[layer]["wscale_log2"][n].float().cpu()).reshape(
                    core.shape)
            got = back[layer][f"core_{n}"]
            check(got.device.type == torch.device(device).type
                  and _bits_equal(torch, got.cpu(), want_core),
                  f"deploy {layer}/core_{n} differs from encode -> decode")
    log(f"train wire: sites {sites} -> {low:,} B vs fp32 {base:,} B "
        f"({base / low:.2f}x); deploy {deploy['packed_bytes']:,} B "
        f"({deploy['reduction_x']:.2f}x), loaded back on the card equal to "
        f"encode -> decode; export launches {export_launches}")
    for k, v in export_launches.items():
        launches[k] = launches.get(k, 0) + v

    state = {"params": params, "opt": opt, "res": residual}

    def one(i):
        state["params"], state["opt"], _, _, state["res"] = step(
            state["params"], state["opt"], TF.batch_at(xs, ys, i),
            state["res"])
    prof = _profile_train(torch, one) if device == "cuda" else None
    return {"steps": steps, "step_ms": wall * 1e3,
            "loss_first": loss[0].item(), "loss_last": loss[-1].item(),
            "loss_first20": first, "loss_last20": last,
            "test_acc_init": acc0, "test_acc": acc,
            "effective_ranks": [eff1, eff2], "param_counts": c,
            "launches_per_step": per, "export_launches": export_launches,
            "launches": launches, "sites": sites, "baseline": baseline,
            "deploy": deploy, "profile": prof}


def phase_train_wire_identity(torch, device: str = "cuda") -> dict:
    """One wire step from the same state on the card and on the CPU: the
    loss within 1e-5 relative; every compressed gradient and residual
    element within one wire step of its leaf (a value within roundoff of a
    rounding boundary may take the neighbouring code) + 1e-5 of the leaf's
    largest |g|, and at least 99.5% of them within 1e-5; params within 2
    lr; scale exponents and effective ranks equal."""
    from repro_torch.data import fashion_like
    from repro_torch.launch import train_fmnist as TF
    from repro_torch.launch import train_wire as TW
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.optim import adam as A
    from repro_torch.tree import flatten_with_path

    d = MLP.make_mlp()
    tcfg = TW.wire_config()
    p_cpu = MLP.init_mlp(torch.Generator().manual_seed(0), d, device="cpu")
    p_gpu = _tensor_tree(torch, p_cpu, device)
    xs, ys = fashion_like(8192, seed=1)
    b_cpu = {"x": torch.from_numpy(xs[:64]), "y": torch.from_numpy(ys[:64])}
    b_gpu = {k: v.to(device) for k, v in b_cpu.items()}
    step = TF.make_step(d, tcfg, compress=True)
    pg, _, lg, gg, rg = step(p_gpu, A.init_adam(p_gpu, tcfg), b_gpu, None)
    pc, _, lc, gc, rc = step(p_cpu, A.init_adam(p_cpu, tcfg), b_cpu, None)
    rel = abs(lg.item() - lc.item()) / abs(lc.item())
    check(rel <= 1e-5, f"wire identity: loss rel diff {rel:.2e}")
    close = total = 0
    worst = 0.0
    paths = [p for p, _ in flatten_with_path(gc)]
    gmax = {}
    for (p, a), (_, b) in zip(flatten_with_path(gg), flatten_with_path(gc)):
        if b is None:
            check(a is None, f"{p}: gradient on one side only")
            continue
        m = gmax[p] = b.abs().max().item()
        e = (a.cpu() - b).abs()
        check(e.max().item() <= m / 127 + 1e-5 * m + 1e-12,
              f"wire identity: {p} compressed grad err {e.max().item():.3e}")
        close += int((e <= 1e-5 * m).sum())
        total += e.numel()
        worst = max(worst, e.max().item() / m if m else 0.0)
    check(close >= 0.995 * total, f"wire identity: {close}/{total} close")
    for p, a, b in zip(paths, rg, rc):
        check((a is None) == (b is None), f"{p}: residual on one side only")
        if b is not None:
            e = (a.cpu() - b).abs().max().item()
            check(e <= gmax[p] / 127 + 1e-5 * gmax[p] + 1e-12,
                  f"wire identity: {p} residual err {e:.3e}")
    move = 0.0
    for (p, a), (_, b) in zip(flatten_with_path(pg), flatten_with_path(pc)):
        if not a.is_floating_point():
            check(torch.equal(a.cpu(), b), f"wire identity: {p} differs")
            continue
        e = (a.cpu() - b).abs().max().item()
        check(e <= 2 * tcfg.learning_rate + 1e-6,
              f"wire identity: {p} after the step differs by {e:.3e}")
        move = max(move, e)
    check(MLP.effective_ranks(pg, d) == MLP.effective_ranks(pc, d),
          "wire identity: effective ranks differ")
    log(f"train wire identity: card vs CPU loss rel diff {rel:.2e}, "
        f"compressed grads {close}/{total} within 1e-5 of their leaf max "
        f"(worst {worst:.2e}), params within {move:.2e}")
    return {"loss_rel_diff": rel, "grads_close": close, "grads_total": total,
            "grad_worst_rel": worst, "param_max_diff": move}


# ---------------------------------------------------------------------------
# the chunked-prefill slice: scalar-scale codec kernels, row fake-quant,
# chunked prefill with the radix prefix cache
# ---------------------------------------------------------------------------

def _library_encode_scalar(torch, x, s):
    """Yardstick only: int8 codes of x at scale 2^s, zero point 0 (the f32
    cast, then torch.quantize_per_tensor, its int_repr)."""
    return torch.quantize_per_tensor(x.float(), 2.0 ** s.item(), 0,
                                     torch.qint8).int_repr()


def _library_decode_scalar(torch, q, s, dt):
    """Yardstick only: codes x 2^s (a per-tensor quantized tensor over the
    codes, dequantize, cast)."""
    return torch._make_per_tensor_quantized_tensor(
        q, 2.0 ** s.item(), 0).dequantize().to(dt)


def _library_fq_rows(torch, x, srow, bits):
    """Yardstick only: fake_quantize_per_channel_affine along dim 0."""
    hi = 2 ** (bits - 1)
    return torch.fake_quantize_per_channel_affine(
        x, torch.exp2(srow), torch.zeros(srow.shape, dtype=torch.int32,
                                         device=x.device), 0, -hi, hi - 1)


def phase_scalar_kernels(torch, timer: Timer, device: str = "cuda") -> dict:
    """The scalar-scale encode/decode kernels against their plain versions
    bit for bit at the chunk step's full-width shapes ((128, 8, 128) bf16
    and f32 -> int8; (1, 1024, 8, 128) int8 -> bf16 and f32), an odd length
    (1,001 elements), an unaligned view and scales -8..2; the row-scale
    fake-quant kernel bit for bit in values and in the clipped STE's
    gradient at (4, 6, 8) with (4, 1) scales and (24, 8, 16384) with (24,)
    scales in f32 and bf16 at 4/8/16 bits. Then the codec API's per-row
    fake_quant as a caller uses it, counts zeroed just before and read
    just after."""
    from repro_torch import numerics as TN
    from repro_torch.kernels import build as B
    from repro_torch.numerics import cuda_backend as CB
    gen = torch.Generator(device=device).manual_seed(4)
    out = {"p2_enc": [], "p2_dec": [], "p2_fq_rows": []}

    def scale_for(x):
        return torch.ceil(torch.log2(x.float().abs().amax() / 127)) - 1

    # --- p2_enc: the chunk write (S_chunk, Hkv, Dh), odd and unaligned
    base = torch.randn(128 * 8 * 128 + 1, generator=gen, device=device) * 3
    cases = [((128, 8, 128), torch.bfloat16, "chunk write bf16", None),
             ((128, 8, 128), torch.float32, "chunk write f32", None),
             ((1001,), torch.float32, "odd length", None),
             ((1001,), torch.bfloat16, "odd length bf16", None),
             ((4096,), torch.float32, "unaligned view", 1)]
    for shape, dt, what, off in cases:
        n = math.prod(shape)
        x = base.to(dt)[off or 0:(off or 0) + n].reshape(shape)
        for s_val in range(-8, 3):
            s = torch.tensor(float(s_val), device=device)
            xs = x * 2.0 ** (s_val + 5)
            q = CB.encode_scalar(xs, s, 8)
            check(torch.equal(q, CB.encode_scalar_plain(xs, s, 8)),
                  f"p2_enc codes differ ({what}, scale {s_val})")
        s = scale_for(x)
        q = CB.encode_scalar(x, s, 8)
        check(torch.equal(q, CB.encode_scalar_plain(x, s, 8)),
              f"p2_enc codes differ ({what})")
        check(q.min().item() == -128 and q.max().item() == 127,
              "p2_enc data did not reach both clip ends")
        row = dict(shape=list(shape), dtype=str(dt)[6:], what=what,
                   max_abs_err=0, aligned=x.data_ptr() % 16 == 0,
                   ms=timer(lambda: CB.encode_scalar(x, s, 8)),
                   plain_ms=timer(lambda: CB.encode_scalar_plain(x, s, 8),
                                  iters=10))
        row["library_ms"], row["library_note"] = _library_yardstick(
            timer, lambda: _library_encode_scalar(torch, x, s),
            lambda r: torch.equal(r, q))
        row["bound_ms"], row["bound_by"] = bound_ms(
            n * (x.element_size() + 1) + 4)
        out["p2_enc"].append(row)
        log(f"p2_enc {what} {tuple(shape)}: {row['ms']*1e3:.1f} us (plain "
            f"{row['plain_ms']*1e3:.1f} us, library {row['library_note']}, "
            f"bound {row['bound_ms']*1e3:.3f} us), codes exact at scales "
            "-8..2")

    # --- p2_dec: one slot's history (1, max_len, Hkv, Dh), odd, unaligned
    codes = torch.randint(-128, 128, (1024 * 8 * 128 + 1,), generator=gen,
                          device=device).to(torch.int8)
    cases = [((1, 1024, 8, 128), torch.bfloat16, "slot history bf16", 0),
             ((1, 1024, 8, 128), torch.float32, "slot history f32", 0),
             ((1001,), torch.float32, "odd length", 0),
             ((4096,), torch.bfloat16, "unaligned view", 1)]
    for shape, dt, what, off in cases:
        n = math.prod(shape)
        q = codes[off:off + n].reshape(shape)
        for s_val in range(-8, 3):
            s = torch.tensor(float(s_val), device=device)
            check(_bits_equal(torch, CB.decode_scalar(q, s, dt),
                              CB.decode_scalar_plain(q, s, dt)),
                  f"p2_dec values differ ({what}, scale {s_val})")
        s = torch.tensor(-6.0, device=device)
        y = CB.decode_scalar(q, s, dt)
        row = dict(shape=list(shape), dtype=str(dt)[6:], what=what,
                   max_abs_err=0, aligned=q.data_ptr() % 4 == 0,
                   ms=timer(lambda: CB.decode_scalar(q, s, dt)),
                   plain_ms=timer(lambda: CB.decode_scalar_plain(q, s, dt),
                                  iters=10))
        row["library_ms"], row["library_note"] = _library_yardstick(
            timer, lambda: _library_decode_scalar(torch, q, s, dt),
            lambda r: _bits_equal(torch, r, y))
        row["bound_ms"], row["bound_by"] = bound_ms(
            n * (1 + y.element_size()) + 4)
        out["p2_dec"].append(row)
        log(f"p2_dec {what} {tuple(shape)}: {row['ms']*1e3:.1f} us (plain "
            f"{row['plain_ms']*1e3:.1f} us, library {row['library_note']}, "
            f"bound {row['bound_ms']*1e3:.3f} us), values exact at scales "
            "-8..2")

    # --- codes in every storage type the spec names: the scalar and row
    # kernels (and the blockwise ones) at the chunk write's shape, bit for
    # bit with their twins, both clip ends and the saturating 32-bit top
    out["storage"] = []
    big = base[:128 * 8 * 128].reshape(128, 8, 128) * 2.0 ** 14
    big.view(-1)[:2] = torch.tensor([1e10, -1e10], device=device)
    for storage, bits in ((torch.int16, 16), (torch.int32, 32),
                          (torch.float32, 16)):
        for dt in (torch.bfloat16, torch.float32):
            x = big.to(dt)
            s = torch.tensor(0.0, device=device)
            q = CB.encode_scalar(x, s, bits, storage)
            check(q.dtype == storage and _bits_equal(
                torch, q, CB.encode_scalar_plain(x, s, bits, storage)),
                f"p2_enc {storage} codes differ")
            lo, hi = TN.qrange(bits)
            check(q.min().item() <= lo and q.max().item() >= min(
                hi, 2 ** 31 - 1), f"p2_enc {storage}: clip ends not reached")
            check(_bits_equal(torch, CB.decode_scalar(q, s, dt),
                              CB.decode_scalar_plain(q, s, dt)),
                  f"p2_dec {storage} values differ")
            x2d = x.reshape(128, -1)
            srow = torch.randint(-2, 2, (128,), generator=gen,
                                 device=device).float()
            qr = CB.encode_rows(x2d, srow, bits, storage)
            check(_bits_equal(torch, qr, CB.encode_rows_plain(
                x2d, srow, bits, storage)), f"p2_enc_rows {storage} differ")
            check(_bits_equal(torch, CB.decode_rows(qr, srow, dt),
                              CB.decode_rows_plain(qr, srow, dt)),
                  f"p2_dec_rows {storage} values differ")
        x2d = big.float().reshape(-1)[:64 * 1000].reshape(64, 1000) * 2e-4
        codes, sc = CB.bw_encode(x2d, 256, bits, storage)
        rc, rs = CB.bw_encode_plain(x2d, 256, bits, storage)
        check(_bits_equal(torch, codes, rc) and _bits_equal(torch, sc, rs)
              and _bits_equal(torch, CB.bw_decode(codes, sc, 1000),
                              CB.bw_decode_plain(codes, sc, 1000)),
              f"bw {storage} differs from its twin")
        x = big.to(torch.bfloat16)
        s = torch.tensor(0.0, device=device)
        row = dict(shape=[128, 8, 128], dtype="bfloat16",
                   storage=str(storage)[6:], bits=bits, max_abs_err=0,
                   ms=timer(lambda: CB.encode_scalar(x, s, bits, storage)),
                   plain_ms=timer(lambda: CB.encode_scalar_plain(
                       x, s, bits, storage), iters=10))
        row["bound_ms"], row["bound_by"] = bound_ms(
            x.numel() * (2 + q.element_size()) + 4)
        out["storage"].append(row)
        log(f"p2_enc / p2_dec / p2_enc_rows / p2_dec_rows / bw with "
            f"{row['storage']} codes ({bits} bits): bit for bit with their "
            f"twins; p2_enc (128, 8, 128) bf16 -> {row['storage']} "
            f"{row['ms']*1e3:.1f} us (plain {row['plain_ms']*1e3:.1f} us, "
            f"bound {row['bound_ms']*1e3:.3f} us)")

    # --- p2_fq_rows: values and the clipped STE gradient, bit for bit
    for shape, sshape, what in (((24, 8, 16384), (24,), "per-layer rows"),
                                ((4, 6, 8), (4, 1), "small")):
        for bits in (4, 8, 16):
            hi = 2 ** (bits - 1)
            s = torch.randint(-8, 3, sshape, generator=gen,
                              device=device).float()
            sb = s.reshape(sshape + (1,) * (len(shape) - len(sshape)))
            for dt in (torch.float32, torch.bfloat16):
                x = (torch.randn(shape, generator=gen, device=device) * 0.6
                     * hi * torch.exp2(sb)).to(dt)
                x.view(-1)[:4] = (torch.tensor([0.5, 2.5, -1.5, 4 * hi],
                                               device=device)
                                  * 2.0 ** s.view(-1)[0].item()).to(dt)
                spec = TN.QuantSpec("pow2", bits)
                xk = x.clone().requires_grad_()
                yk = TN.fake_quant(xk, spec, s, backend="cuda")
                yk.float().sum().backward()
                xr = x.clone().requires_grad_()
                yr = TN.fake_quant(xr, spec, s)        # the plain path
                yr.float().sum().backward()
                check(_bits_equal(torch, yk.detach(), yr.detach())
                      and _bits_equal(torch, xk.grad, xr.grad),
                      f"p2_fq_rows {what} {bits}-bit {dt}: values or STE "
                      "gradient differ")
                check(0 < int((xk.grad == 0).sum()) < x.numel(),
                      "p2_fq_rows data did not clip")
                if what != "per-layer rows" or (bits != 8
                                                and dt == torch.bfloat16):
                    continue
                x2d, srow = CB._rowwise(x, s)
                n = x.numel()
                row = dict(shape=list(shape), scales=list(sshape), bits=bits,
                           dtype=str(dt)[6:], what=what, max_abs_err=0,
                           ms=timer(lambda: CB.fake_quant_rows(x, s, bits)),
                           plain_ms=timer(lambda: CB.fake_quant_rows_plain(
                               x2d, srow, bits), iters=10))
                y = yk.detach()
                row["library_ms"], row["library_note"] = _library_yardstick(
                    timer, lambda: _library_fq_rows(torch, x, srow, bits),
                    lambda r: torch.equal(r, y))   # -0.0 == 0.0
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2 * n * x.element_size() + srow.numel() * 4, 4 * n,
                    FP32_OPS_PER_S)
                out["p2_fq_rows"].append(row)
                log(f"p2_fq_rows {what} {tuple(shape)} {bits}-bit "
                    f"{row['dtype']}: {row['ms']*1e3:.1f} us (plain "
                    f"{row['plain_ms']*1e3:.1f} us, library "
                    f"{row['library_note']}, bound "
                    f"{row['bound_ms']*1e3:.3f} us); values and STE "
                    "gradient exact")
    # put the 8-bit f32 row first: the kernel line's head shape
    out["p2_fq_rows"].sort(key=lambda r: (r["bits"] != 8,
                                          r["dtype"] != "float32"))

    # --- the codec API path: a per-layer fake-quant forward and backward
    x = (torch.randn((24, 8, 16384), generator=gen, device=device) * 0.05
         ).requires_grad_()
    s = torch.full((24,), -9.0, device=device)
    _sync(torch, device)
    B.reset_launches()
    y = TN.fake_quant(x, TN.QuantSpec("pow2", 8), s, backend="cuda")
    y.sum().backward()
    _sync(torch, device)
    api = dict(B.LAUNCHES)
    check(api == {"p2_fq_rows": 1}, f"codec API launches {api}")
    out["api_launches"] = api
    log(f"codec API fake_quant, (24,) scales: launches {api}")
    B.reset_launches()
    return out


def _chunked_prefix_requests(vocab: int, seed: int = 5):
    """The slice's request set: 12 prompts share a 256-token preamble (16
    whole pages) followed by a random 32..128-token suffix, 4 of them
    repeat the first 8..24 tokens (never exactly one page) of an earlier
    request's suffix and then diverge mid-page (a COW fork); 4 random
    prompts of 128..512 tokens are mixed in. Returns the prompts in
    submission order."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pre = rng.randint(0, vocab, 256).tolist()

    def rand(lo, hi):
        return rng.randint(0, vocab, int(rng.randint(lo, hi + 1))).tolist()

    donors, prompts = [], []
    for kind in "RDDDCRDDCDRCDDCR":
        if kind == "R":
            prompts.append(rand(128, 512))
        elif kind == "D":
            sfx = rand(32, 128)
            donors.append(sfx)
            prompts.append(pre + sfx)
        else:
            src = donors[int(rng.randint(len(donors)))]
            k = int(rng.choice([k for k in range(8, 25) if k != 16]))
            tail = rand(max(32 - k, 8), 128 - k)
            prompts.append(pre + src[:k] + tail)
    return prompts


def _chunk_steps(prefills, chunk: int) -> int:
    """Chunk steps the engine runs for these (prompt_len, hit) prefills: a
    hit computes its suffix in chunks; a miss computes its first chunk with
    the model's forward and the rest in chunk steps."""
    n = 0
    for plen, hit in prefills:
        n += (-(-(plen - hit) // chunk) if hit
              else max(-(-plen // chunk), 1) - 1)
    return n


CHUNK = 128


def phase_serve_chunked(torch, lm, params) -> dict:
    """The slice's main path at full width: chunked prefill (128) with the
    prefix cache over the int8 pool, fused decode, 16 requests x 64 new
    tokens; launch counts zeroed just before and read just after. Then the
    chunk step's host and device time, profiled."""
    from repro_torch.kernels import build as B
    from repro_torch.serve import kv_cache as KC
    cfg = lm.cfg
    prompts = _chunked_prefix_requests(cfg.vocab_size)
    kw = dict(fused_attention=True, prefill_chunk=CHUNK, prefix_cache=True)
    _serve_engine(torch, lm, params, prompts[:3], 2, **kw)        # warm-up
    B.reset_launches()
    eng, _ = _serve_engine(torch, lm, params, prompts, 64, **kw)
    launches = dict(B.LAUNCHES)
    s = eng.summary()
    steps = _chunk_steps(eng.metrics.prefills, CHUNK)
    per = 2 * cfg.num_layers
    check(s["requests_completed"] == len(prompts), "requests lost")
    check(s["prefix_hit_tokens"] > 0 and s["cow_forks"] > 0
          and s["pages_saved"] > 0, f"prefix cache: {s}")
    check(steps > 0 and launches.get("p2_enc", 0) == per * steps
          and launches.get("p2_dec", 0) == per * steps,
          f"chunk steps {steps}: launches {launches}, want {per} p2_enc and "
          f"p2_dec per step")
    check(launches.get("paged_attention", 0)
          == s["decode_steps"] * cfg.num_layers
          == launches.get("paged_attention_combine", 0),
          f"{launches.get('paged_attention', 0)} attention launches for "
          f"{s['decode_steps']} decode steps")
    tree = eng.sched.prefix.bytes_stats(KC.page_nbytes(eng.pool, eng.pcfg))
    savings = s["prompt_tokens"] / s["prefill_tokens"]
    log(f"serve chunked prefix: {s['requests_completed']} requests, "
        f"{s['generated_tokens']} tokens, {s['tokens_per_s']:.1f} tok/s, "
        f"TTFT p50 {s['ttft_p50_s']*1e3:.1f} ms, p95 "
        f"{s['ttft_p95_s']*1e3:.1f} ms; {steps} chunk steps; hits "
        f"{s['prefix_hit_tokens']} of {s['prompt_tokens']} prompt tokens "
        f"(rate {s['prefix_hit_rate']:.3f}), cow forks {s['cow_forks']}, "
        f"pages saved {s['pages_saved']}, evictions "
        f"{s['prefix_evictions']}; prefill compute savings "
        f"{savings:.3f}x (prompt / computed tokens); tree {tree['pages']} "
        f"pages, {tree['bytes']/2**20:.1f} MiB of the pool; launches "
        f"{launches}")
    return {"summary": s, "launches": launches, "chunk_steps": steps,
            "prefill_compute_savings": savings, "tree": tree,
            "chunk_profile": _profile_chunk(torch, lm, params, prompts)}


def _profile_chunk(torch, lm, params, prompts, reps: int = 10) -> dict:
    """One chunk step at full width (128 tokens at position 256 of a slot
    whose history holds 384 prompt tokens), repeated: host wall per step
    (synchronised), then one profiled window for the device time per
    kernel. The step rewrites the same positions with the same values."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    eng = Engine(lm, params, EngineConfig(
        pool=PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                        quantized=True), fused_attention=True,
        prefill_chunk=CHUNK), device="cuda")
    prompt = (prompts[1] + prompts[0])[:384]
    eng.submit(prompt, max_new_tokens=8)
    eng.step()                      # prefills 0..383 in 3 chunks, 1 decode
    table_row = eng._tensor(eng.sched.page_table[0])
    toks = prompt[256:384]
    eng._chunk(toks, table_row, 0, 256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng._chunk(toks, table_row, 0, 256)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            eng._chunk(toks, table_row, 0, 256)
        torch.cuda.synchronize()
    total, rows = _device_summary(torch, prof, reps)
    log(f"chunk step profile: {wall*1e3:.2f} ms per step (host wall), "
        f"device {total:.2f} ms busy, busy share {total / (wall*1e3):.3f}")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows}


def phase_chunked_identity(torch) -> dict:
    """fp32, 4 layers. Hard lock: an int8 prefix hit equals a cache-off run
    with a chunk boundary at the resume position — a cache-on engine serves
    a 256-token donor (16 whole pages), then 8 followers (the donor plus a
    random 7..100-token suffix); a cache-off engine serves the followers;
    both with prefill_chunk 256. Completions must be identical, with no
    COW fork. Report only: prefix on against off on the slice's request
    set (chunk 128), the fraction of completions that agree."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.models import build_lm, init_lm
    cfg = C.get_config(ARCH).replace(num_layers=4, dtype="float32")
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), lm,
                     device="cuda")
    rng = np.random.RandomState(17)
    donor = rng.randint(0, cfg.vocab_size, 256).tolist()
    followers = [donor + rng.randint(0, cfg.vocab_size,
                                     int(rng.randint(7, 101))).tolist()
                 for _ in range(8)]
    kw = dict(fused_attention=True, prefill_chunk=256)
    eng, _ = _serve_engine(torch, lm, params, [donor], 1, prefix_cache=True,
                           **kw)
    rids = [eng.submit(p, max_new_tokens=16) for p in followers]
    res = eng.run()
    on = [res[r].tokens for r in rids]
    s = eng.summary()
    _, off = _serve_engine(torch, lm, params, followers, 16, **kw)
    same = sum(a == b for a, b in zip(on, off))
    check(on == off, f"int8 hit vs chunk-boundary recompute: {same}/8 "
          "completions identical")
    check(s["cow_forks"] == 0 and s["prefix_hit_tokens"] == 8 * 256,
          f"chunked identity: {s['cow_forks']} forks, "
          f"{s['prefix_hit_tokens']} hit tokens")
    prompts = _chunked_prefix_requests(cfg.vocab_size)
    _, a = _serve_engine(torch, lm, params, prompts, 32, fused_attention=True,
                         prefill_chunk=CHUNK, prefix_cache=True)
    _, b = _serve_engine(torch, lm, params, prompts, 32, fused_attention=True,
                         prefill_chunk=CHUNK)
    agree = sum(x == y for x, y in zip(a, b)) / len(prompts)
    log(f"chunked identity: fp32 {cfg.num_layers} layers, int8 hit == "
        f"chunk-boundary recompute on all 8 completions (no fork); prefix "
        f"on vs off on the slice's requests: {agree:.3f} of completions "
        "identical (report only)")
    del params
    torch.cuda.empty_cache()
    return {"identical_completions": same, "on_off_agreement": agree}


# ---------------------------------------------------------------------------

KERNELS = {
    "p2_enc_rows": ("src/repro_torch/kernels/csrc/pow2_rows.cu",
                    "src/repro/numerics/pallas_backend.py:189"),
    "p2_dec_rows": ("src/repro_torch/kernels/csrc/pow2_rows.cu",
                    "src/repro/numerics/pallas_backend.py:196"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:134"),
    "paged_attention_combine": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:134"),
}
WIRE_KERNELS = {
    "bw_enc": ("src/repro_torch/kernels/csrc/blockwise.cu",
               "src/repro/numerics/pallas_backend.py:450"),
    "bw_dec": ("src/repro_torch/kernels/csrc/blockwise.cu",
               "src/repro/numerics/pallas_backend.py:458"),
    "p2_enc_packed": ("src/repro_torch/kernels/csrc/pow2_packed.cu",
                      "src/repro/numerics/pallas_backend.py:229"),
    "p2_dec_packed": ("src/repro_torch/kernels/csrc/pow2_packed.cu",
                      "src/repro/numerics/pallas_backend.py:245"),
}
SCALAR_KERNELS = {
    "p2_enc": ("src/repro_torch/kernels/csrc/pow2_scalar.cu",
               "src/repro/numerics/pallas_backend.py:120"),
    "p2_dec": ("src/repro_torch/kernels/csrc/pow2_scalar.cu",
               "src/repro/numerics/pallas_backend.py:127"),
    "p2_fq_rows": ("src/repro_torch/kernels/csrc/pow2_fq.cu",
                   "src/repro/numerics/pallas_backend.py:332"),
}
TRAIN_KERNELS = {
    "p2_fake_quant": ("src/repro_torch/kernels/csrc/pow2_fq.cu",
                      "src/repro/numerics/pallas_backend.py:112"),
    "pe1": ("src/repro_torch/kernels/csrc/ttm_pe1.cu",
            "src/repro/kernels/ttm_pe1.py:34"),
    "pe2": ("src/repro_torch/kernels/csrc/ttm_pe2.cu",
            "src/repro/kernels/ttm_pe2.py:25"),
    "pe3": ("src/repro_torch/kernels/csrc/ttm_pe3.cu",
            "src/repro/kernels/ttm_pe3.py:23"),
}


def _kernel_row(name, src, replaces, shapes, launches, path) -> dict:
    head = shapes[0]            # the main path's first (largest) shape
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches, "path": path,
           "max_abs_err": max(s["max_abs_err"] for s in shapes),
           "ms": head["ms"], "plain_ms": head["plain_ms"],
           "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
           "library_ms": head.get("library_ms"), "shapes": shapes}
    if "previous_ms" in head:
        row["previous_ms"] = head["previous_ms"]
    return row


def kernels_line(kern: dict, eng: dict, tkern: dict, train: dict,
                 wkern: dict, wire: dict, skern: dict, chunked: dict
                 ) -> dict:
    rows = []
    for name, (src, replaces) in KERNELS.items():
        on_main = eng["launches_main"].get(name, 0)
        path = "main (fused)" if on_main else "gather (engine default)"
        launches = on_main or eng["launches_gather"].get(name, 0)
        rows.append(_kernel_row(name, src, replaces, kern[name], launches,
                                path))
    for name, (src, replaces) in TRAIN_KERNELS.items():
        rows.append(_kernel_row(name, src, replaces, tkern[name],
                                train["launches"].get(name, 0),
                                f"train ({train['steps']} steps)"))
    for name, (src, replaces) in WIRE_KERNELS.items():
        rows.append(_kernel_row(name, src, replaces, wkern[name],
                                wire["launches"].get(name, 0),
                                f"train wire ({wire['steps']} steps, site "
                                "table and deploy export)"))
    for name, (src, replaces) in SCALAR_KERNELS.items():
        if name == "p2_fq_rows":
            launches = skern["api_launches"].get(name, 0)
            path = ("codec API (numerics.fake_quant with a scale per leading "
                    "index; no serving or training path)")
        else:
            launches = chunked["launches"].get(name, 0)
            path = (f"serve chunked prefix ({chunked['chunk_steps']} chunk "
                    "steps)")
        rows.append(_kernel_row(name, src, replaces, skern[name], launches,
                                path))
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    ap.add_argument("--pe-anatomy", action="store_true",
                    help="only build and time the PE1/PE2/PE3 kernels with "
                    "one phase cut out at a time (no result line)")
    ap.add_argument("--pa-anatomy", action="store_true",
                    help="only build and time the attention split pass with "
                    "one phase cut out at a time (no result line)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    report = {"device": smi}
    report["build"] = phase_build()
    timer = Timer(torch)
    if args.pe_anatomy or args.pa_anatomy:
        if args.pe_anatomy:
            report["pe_anatomy"] = phase_pe_anatomy(torch, timer)
        if args.pa_anatomy:
            report["pa_anatomy"] = phase_pa_anatomy(torch, timer)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
        return 0
    report["kernels"] = phase_kernels(torch, timer)
    report["train_kernels"] = phase_train_kernels(torch, timer)
    report["wire_kernels"] = phase_wire_kernels(torch, timer)
    report["scalar_kernels"] = phase_scalar_kernels(torch, timer)
    del timer
    lm, params = full_model(torch)
    report["engine"] = phase_engine(torch, lm, params)
    report["serve_chunked"] = phase_serve_chunked(torch, lm, params)
    del params
    torch.cuda.empty_cache()
    report["identity"] = phase_identity(torch)
    report["chunked_identity"] = phase_chunked_identity(torch)
    report["train"] = phase_train(torch)
    report["train_identity"] = phase_train_identity(torch)
    report["train_wire"] = phase_train_wire(torch)
    report["train_wire_identity"] = phase_train_wire_identity(torch)
    report["seconds"] = time.perf_counter() - t0
    line = kernels_line(report["kernels"], report["engine"],
                        report["train_kernels"], report["train"],
                        report["wire_kernels"], report["train_wire"],
                        report["scalar_kernels"], report["serve_chunked"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log(f"all phases passed in {report['seconds']:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
