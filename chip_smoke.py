#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py [--out report.json]

Phases (any failure raises and the script exits non-zero):

1. build   — compile every kernel of the serving path from
             ``src/repro_torch/kernels/csrc`` (one nvcc per source, all in
             parallel) and print each kernel's register/spill report.
2. kernels — each kernel against its plain PyTorch version at the serving
             path's shapes: the row-scale pow-2 encode (prefill rows 24 x
             S*1024, decode rows 8 x 1024) and decode (gather rows 8 x
             1024*1024) bit-exact; paged attention over an int8 pool
             (513, 16, 8, 128) with B=8, S in {1, 4}, ragged contexts up to
             1024, within 1e-5 in fp32 and 2 bf16 ulp (+1e-5) with bf16 q. Times
             each kernel (CUDA events, L2 flushed between launches), its
             plain version and, for attention, a library yardstick
             (gather + dequant + scaled_dot_product_attention).
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
4. identity — the same requests in float32 at full width with 4 layers:
             fused and gather engines must emit identical greedy tokens.

Output: human-readable lines, then one JSON line describing every kernel,
then the card's name and power limit (nvidia-smi), then the last line
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available or when the repository's
``src/repro_torch`` is not beside this script.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
ARCH = "internlm2-1.8b"
SOURCES = ["pow2_rows", "paged_attention"]


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


def bound_ms(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / BF16_OPS_PER_S * 1e3
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
        bms, by = bound_ms(rows * cols * 3 + rows * 4)
        enc_shapes.append(dict(shape=[rows, cols], what=what, ms=ms,
                               plain_ms=pms, bound_ms=bms, bound_by=by,
                               max_abs_err=err))
        log(f"p2_enc_rows {what} ({rows}x{cols}): {ms*1e3:.1f} us "
            f"(plain {pms*1e3:.1f} us, bound {bms*1e3:.2f} us), codes exact")
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
        bms, by = bound_ms(rows * cols * (1 + y.element_size()) + rows * 4)
        dec_shapes.append(dict(shape=[rows, cols], what=what, ms=ms,
                               plain_ms=pms, bound_ms=bms, bound_by=by,
                               max_abs_err=0.0))
        log(f"p2_dec_rows {what}: {ms*1e3:.1f} us (plain {pms*1e3:.1f} us, "
            f"bound {bms*1e3:.2f} us), values exact")
    out["p2_dec_rows"] = dec_shapes

    # --- paged attention: B=8, Hq=16, Hkv=8, Dh=128, page 16, 64 pages/slot
    b, hq, hkv, dh, page, pps = 8, 16, 8, 128, 16, 64
    total = b * pps
    kd = torch.randint(-128, 128, (total + 1, page, hkv, dh), generator=gen,
                       device="cuda").to(torch.int8)
    vd = torch.randint(-128, 128, (total + 1, page, hkv, dh), generator=gen,
                       device="cuda").to(torch.int8)
    ks = torch.randint(-9, -4, (b,), generator=gen, device="cuda").float()
    vs = torch.randint(-9, -4, (b,), generator=gen, device="cuda").float()
    table = torch.randperm(total, generator=gen, device="cuda").reshape(
        b, pps).to(torch.int32)
    kw = dict(page_size=page, quantized=True)
    att_shapes = []
    for s_rows in (1, 4):
        hi = pps * page - s_rows
        lens = torch.tensor([0, page - 1, page, 100, 333, 517, 800, hi],
                            dtype=torch.int32, device="cuda")
        q32 = torch.randn((b, s_rows, hq, dh), generator=gen, device="cuda")
        o32 = PA.paged_attention_cuda(q32, kd, vd, ks, vs, table, lens, **kw)
        r32 = PA.paged_attention_torch(q32, kd, vd, ks, vs, table, lens, **kw)
        err32 = (o32 - r32).abs().max().item()
        check(err32 <= 1e-5, f"paged_attention fp32 S={s_rows}: max abs "
              f"err {err32} > 1e-5")
        qb = q32.to(torch.bfloat16)
        ob = PA.paged_attention_cuda(qb, kd, vd, ks, vs, table, lens, **kw)
        rb = PA.paged_attention_torch(qb, kd, vd, ks, vs, table, lens, **kw)
        diff = (ob.float() - rb.float()).abs()
        ulps, over = _bf16_excess(diff, rb)
        check(over <= 0, f"paged_attention bf16 S={s_rows}: error exceeds "
              f"2 bf16 ulp + 1e-5 by {over}")
        errb = diff.max().item()
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
                               library_max_abs_err=lerr))
        log(f"paged_attention S={s_rows}: {ms*1e3:.1f} us (plain "
            f"{pms*1e3:.1f} us, library {lms*1e3:.1f} us, bound "
            f"{bms*1e3:.2f} us); fp32 err {err32:.2e}, bf16 {ulps:.2f} ulp")
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
    # what the timer reads with no work between its events: the floor
    # under every time above (event and launch latency on this card)
    out["timer_floor_ms"] = timer(lambda: None)
    log(f"timer floor (no work between events): "
        f"{out['timer_floor_ms']*1e3:.1f} us")
    torch.cuda.synchronize()
    B.reset_launches()
    return out


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


def _serve(torch, lm, params, fused: bool, prompts, gen_len: int):
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    pool = PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                      quantized=True)
    eng = Engine(lm, params, EngineConfig(pool=pool, fused_attention=fused),
                 device="cuda")
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
    return toks, eng.summary()


def phase_engine(torch) -> dict:
    import repro_torch.configs as C
    from repro_torch.kernels import build as B
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
    check(fs["requests_completed"] == len(prompts), "requests lost")
    peak = torch.cuda.max_memory_allocated()

    B.reset_launches()
    gather_toks, gs = _serve(torch, lm, params, False, prompts, 64)
    gather = dict(B.LAUNCHES)
    check(gather.get("p2_dec_rows", 0) > 0, "gather path: no decode launch")
    check(gather.get("paged_attention", 0) == 0,
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
    del params
    torch.cuda.empty_cache()
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

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, memcpy/memset): the CPU-side op
    # events carry the same device time again
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == cuda and dev(e) > 0]
    total = sum(dev(e) for e in evs) / steps / 1e3            # ms per step
    top = sorted(evs, key=dev, reverse=True)[:12]
    rows = [{"name": e.key[:80], "calls_per_step": e.count / steps,
             "ms_per_step": dev(e) / steps / 1e3} for e in top]
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

KERNELS = {
    "p2_enc_rows": ("src/repro_torch/kernels/csrc/pow2_rows.cu",
                    "src/repro/numerics/pallas_backend.py:189"),
    "p2_dec_rows": ("src/repro_torch/kernels/csrc/pow2_rows.cu",
                    "src/repro/numerics/pallas_backend.py:196"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:134"),
}


def kernels_line(kern: dict, eng: dict) -> dict:
    rows = []
    for name, (src, replaces) in KERNELS.items():
        head = kern[name][0]            # the decode-step shape
        on_main = eng["launches_main"].get(name, 0)
        path = "main (fused)" if on_main else "gather (engine default)"
        launches = on_main or eng["launches_gather"].get(name, 0)
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": max(s["max_abs_err"] for s in kern[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head.get("library_ms"), "shapes": kern[name]})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
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
    report["kernels"] = phase_kernels(torch, timer)
    del timer
    report["engine"] = phase_engine(torch)
    report["identity"] = phase_identity(torch)
    report["seconds"] = time.perf_counter() - t0
    line = kernels_line(report["kernels"], report["engine"])
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
