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
             S*1024; the 8 x 1024 decode rows of the previous append) and
             decode (gather rows 8 x 1024*1024) bit-exact; the paged KV
             append (K and V of 8 slots x 8 heads x 128, bf16, into an int8
             pool (513, 16, 8, 128), V a strided view, inactive slots and a
             slot past its pages to the trash page) bit for bit with its
             twin on the whole pool and over two launches, timed beside the
             design it replaced (page arithmetic, p2_enc_rows and
             index_put_ for K and for V: ``previous_ms``); the chunk step's
             paged write (the same kernel at S = 128: one slot's 128 rows,
             a page-aligned chunk and one whose pad rows and valid rows run
             past the slot's last page; and the speculative verify's write,
             8 slots x S = 4 at per-slot lengths, one slot overhanging the
             horizon and one inactive, bit for bit with its twin on the
             whole pool and with the reference's route) and the paged read
             (p2_read_paged:
             one slot and 8 slots of 64 pages -> bf16 and f32), bit for bit
             with their twins, with the parent's route and over two
             launches, each timed beside the parent's route (page
             arithmetic + p2_enc + index_put_; page gather + p2_dec or
             p2_dec_rows: ``previous_ms``); the whole-prompt prefill write
             (p2_prefill_paged: K and V of 24 layers x S x 8 x 128 bf16
             into an int8 pool (24, 513, 16, 8, 128), S = 512 and 128, and
             512 with 400 valid rows) bit for bit with its twin and the
             parent's route on every real page and every scale, over two
             launches, timed beside that route (2 x choose_scale_log2 +
             p2_enc_rows + index_put_: ``previous_ms``); paged attention
             over an int8 pool
             (513, 16, 8, 128) with B=8, S in {1, 4}, ragged contexts up to
             1024 (and S = 4 with one slot's block overhanging the
             horizon, the speculative verify's shape: rows inside it held
             to the twin), within 1e-5 in fp32 and 2 bf16 ulp (+1e-5) with bf16 q,
             bit-identical over two launches, and each of its two kernels
             (the split pass, the combine pass) against its plain mirror on
             the same inputs. Times each kernel (CUDA events, L2 flushed
             between launches), its plain version and a library yardstick
             (per-channel quantize / dequantize for the codec where its
             codes match; gather + dequant + scaled_dot_product_attention).
   state kernels — the state path's codec kernels at rwkv6-1.6b's state
             shapes, bit for bit with their plain versions: p2_enc_rows
             and p2_dec_rows at the decode step's 8 slots (wkv 8 x 32 x 64
             x 64 f32, shift 8 x 2,048 bf16) and p2_enc_rows at the
             24-layer prefill write, p2_enc and p2_dec at the chunk step's
             one slot; each timed beside its plain version, its bound and
             a library call.
   state group — the decode step's two state launches at rwkv6-1.6b's
             pool (24 layers x shift, wkv, shift_ffn; 8 slots) and
             jamba's period (7 Mamba layers x conv, h): st_dec_group and
             st_enc_group bit for bit with their plain twins and with the
             per-layer route they replaced (read_layer / write_layer:
             p2_dec_rows, the scale's eager ops, p2_enc_rows, the masked
             copies), codes, scales and values, an inactive slot left
             untouched, maxima at 127 * 2^k and their f32 / bf16
             neighbours and an all-zero row; one launch each way (the
             plan's count); each timed beside the per-layer route
             (``previous_ms``), its plain twin and its byte bound, the
             encode also re-reading its values (``reread_ms``).
   train kernels — the training kernels at the step's shapes: the scalar
             fake-quant bit-exact at 4/8/16 bits in f32 and bf16, each
             layer's cores in one grouped fake-quant launch (layer 1's 4,
             layer 2's 2) bit for bit with its twin and over two launches,
             timed beside the loop of one-entry launches it replaced
             (``previous_ms``) and a library loop; the export's grouped
             round trips (p2_fq_group in its round-trip mode: the 6 cores,
             the 2 biases) bit for bit with the twin and the per-leaf
             p2_enc + p2_dec route, +0.0 zeros, timed beside that route;
             every
             PE1/PE2/PE3 call of a step within 1e-4 (f32) / 2e-2 (bf16; PE1
             on the tensor cores there),
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
             before and read just after: each decode step launched the
             paged KV append and paged attention once per layer, and each
             whole-prompt prefill p2_prefill_paged once (no p2_enc_rows).
             The gather engine (the default path) then serves the
             same requests with its counts zeroed: it reads every slot's
             view once a layer a decode step through p2_read_paged and
             never launches p2_dec_rows. Last, a steady window of decode
             steps of each engine is timed on the host and profiled on the
             device: step time, device time per kernel, busy share, and the
             KV kernels by name (p2_append_paged_kernel 24 a step, and
             p2_read_paged_kernel 24 on the gather engine; no other;
             asserted); then one whole-prompt prefill of 512 tokens, timed
             and profiled the same way (p2_prefill_paged_kernel once; no
             other KV kernel; asserted).
   serve chunked prefix — the fourth main path, on the same model:
             chunked prefill (128) with the radix prefix cache, 16 requests
             (12 behind a shared 256-token preamble, 4 of them diverging
             mid-page for a COW fork; 4 random), 64 new tokens each; counts
             zeroed just before and read just after: p2_read_paged and
             p2_append_paged once per layer per chunk step (the chunk steps
             counted from the prefills and their hits) and no p2_enc or
             p2_dec, paged attention and the KV append once per layer per
             decode step, p2_prefill_paged once per whole-prompt prefill
             and no p2_enc_rows; hits,
             forks and saved pages must be non-zero.
             Then one chunk step's host and device time, profiled
             (p2_append_paged_kernel and p2_read_paged_kernel 24 a step;
             no other KV kernel; asserted).
   serve spec — the sixth main path, on the same model: speculative
             decoding (k = 3, fused attention) of the engine phase's 16
             requests, 64 new tokens each, with (a) an independent 2-layer
             draft of the same config (its own seeded weights) and (b) a
             self-draft; counts zeroed just before and read just after
             each: per round 24 + 4 x L_draft p2_append_paged, 24 split and
             24 combine, 4 x L_draft p2_read_paged, 2 p2_prefill_paged per
             admission and no other kernel of the kernels line; every page
             back on the free list; the acceptance, tokens per round and
             greedy agreement with the engine phase's fused tokens
             reported. Then a steady round of (a), timed on the host and
             profiled (p2_append_paged_kernel 32, p2_read_paged_kernel 8,
             pa_split_kernel and pa_combine_kernel 24 a round; no other KV
             kernel; asserted by name).
4. identity — the same requests in float32 at full width with 4 layers:
             fused and gather engines must emit identical greedy tokens;
             speculative decoding (k = 3) with a 2-layer fp32 draft, fused
             and gather, must emit them too, and a self-draft on the gather
             path with acceptance 1.0; an fp pool config under
             NumericsPolicy(enable=True) must serve from an int8 pool with
             the int8 engine's tokens.
   chunked identity — float32, 4 layers: an int8 prefix hit (a 16-page
             donor, 8 followers) must equal the cache-off run with a chunk
             boundary at the resume position on every completion, with no
             COW fork; prefix on vs off on the slice's requests is reported.
   serve rwkv6 — the seventh main path: rwkv6-1.6b at full size (24
             layers, d_model 2048, 32 heads x 64, d_ff 7168, vocab 65,536,
             bf16, ~1.58 B seeded parameters) serving 16 requests of the
             engine phase's lengths (128..512 tokens, 64 new, 8 slots)
             from an int8 state pool, an fp pool and, chunked (128), the
             int8 pool; counts zeroed just before and read just after
             each run, exact: 1 st_dec_group + 1 st_enc_group a decode
             step (the plans' counts; no p2_dec_rows or p2_enc_rows), 3
             p2_enc_rows a whole-prompt prefill, 72 p2_dec + 72 p2_enc a
             chunk step, no kernel on the fp pool; no KV kernel,
             cache_bytes 0, every slot free at the end, state_reduction
             >= 3.5; a replay of 3 int8 decode steps (7 of 8 slots busy)
             through the engine and again, from the same pool, through
             the per-layer route: logits and every pool byte equal; the
             int8-vs-fp greedy agreement (bf16) reported; the decode
             step, a 512-token prefill and a chunk step timed and
             profiled, the state kernels asserted by name.
   serve hybrid — jamba-1.5-large with dense FFNs at full width for one
             period (8 layers: 7 Mamba, 1 attention; ~9.0 B parameters),
             8 requests x 64 new tokens over an int8 KV pool and an int8
             state pool, fused attention: a decode step 1 st_dec_group +
             1 st_enc_group, 1 p2_append_paged, 1 split + 1 combine; a
             prefill 14 p2_enc (a one-layer stack has one scale) and 1
             p2_prefill_paged; by counter and by profile name.
   ssm identity — fp32: rwkv6 with 4 layers at full width and the reduced
             jamba with dense FFNs: the engine (slots recycling) equals
             static decode (lm_forward with its cache, then lm_decode_step
             at B = 1), chunked prefill (128) equals it, a forced
             preemption resumes identically, and an fp pool under
             NumericsPolicy(enable=True) serves from an int8 state pool
             with the int8 engine's tokens, token for token; a failed
             check lists which products differ between M = 1 and M = 8.
5. train   — the second main path: the paper's FMNIST TT MLP at its
             published widths, random params from a seeded generator on
             the card, 300 steps of ``launch/train_fmnist.py``'s step on
             ``fashion_like(8192, seed=1)`` in the example's batch order,
             launch counts zeroed just before and read just after (each
             must equal 300 x ``launches_per_step``); the loss must fall
             and test accuracy on ``fashion_like(2048, seed=2)`` beat
             chance; the BinaryConnect export (one p2_rt_group launch a bit
             width: the 4-bit cores, the 8-bit biases; no p2_enc or p2_dec)
             bit for bit with the CPU, zeros' sign included. Then a profiled
             window of steps: step time, device time per kernel, busy
             share, and the kernels by name as ``launches_per_step``
             counts them (pe1_kernel 6 launches a step, pe2_kernel 12,
             pe3_kernel 2, p2_fq_group_kernel 9; asserted).
6. train identity — one step from the same initial params on the card and
             on the CPU (plain versions): loss, gradients and the stepped
             params within the CPU parity tests' tolerances.
   wire kernels — the blockwise encode/decode kernels against their plain
             versions bit for bit (codes, scales, values) at every Adam
             moment shape (block 256) and every flattened gradient-leaf
             length of the wire (block 1024) of the step, a padded
             multi-block (3, 1000) at block 256 and an all-zero block; the
             step's two encode groups and two decode groups (its 34
             moments, its 21 wire leaves) each in one launch, bit for bit
             with the twin, the one-entry launches and a second launch,
             timed beside the loop of one-entry launches it replaced
             (``previous_ms``); the packed int4x2 encode and decode groups
             on the deploy export's six cores in one launch each, bit for
             bit with the twin, the one-entry launches and a second launch,
             timed beside the loop of one-entry launches; then each core
             at its wscale_log2, a stacked tensor with a step per row and
             an odd trailing dim, and a scalar, as groups of one. Each
             timed beside its bound,
             its plain version and a library call where one computes the
             same function.
   scalar kernels — the scalar-scale encode/decode kernels bit for bit
             against their plain versions at the full-width shapes the
             chunk step gave them before the paged write and read ((128,
             8, 128) bf16/f32 -> int8, (1, 1024, 8, 128) int8 ->
             bf16/f32), an odd length and an unaligned view, scales
             -8..2, and both scalar and row kernels with int16, int32 and
             float32 codes; the row-scale fake-quant kernel bit for bit in
             values
             and STE gradient at (4, 6, 8) and (24, 8, 16384), 4/8/16 bits;
             each timed beside its bound, its plain version and a library
             call (quantize_per_tensor, a per-tensor dequantize,
             fake_quantize_per_channel_affine); then the codec API's
             per-row fake_quant, per-row decode, per-row encode and a
             one-step round trip (``core.quant.quantize_store``) with their
             launch counts: the paths left to p2_fq_rows, p2_dec_rows,
             p2_enc_rows, p2_enc and p2_dec.
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
             to encode -> decode of the params bit for bit (the export and
             the load one p2_enc_packed and one p2_dec_packed launch,
             asserted); a profiled
             window of wire steps (bw_enc_group_kernel 2 launches a step,
             bw_dec_group_kernel 2, p2_fq_group_kernel 9; asserted).
8. train wire identity — one wire step from the same state on the card and
             on the CPU, under the CPU parity tests' tolerances.
   lm kernels — PE1/PE2/PE3 at every distinct shape of the zoo-LM step
             (with_tt(internlm2-1.8b) at 8 x 256 tokens: PE1 up to
             (524288, 1, 32), PE2 up to (32768, 256, 16) x (256, 256), PE3
             up to 2048 x 8192 x 2048), bf16, held to the plain version
             within 2e-2 and timed beside it, beside one torch.matmul of
             the same product and beside the bound (bytes at 3.35 TB/s or
             bf16 operations at 989 TFLOP/s). Each of the twelve calls
             (three PE1, six PE2, three PE3) takes the tensor-core route
             (ttm_pe1.plan_pe1, tt_mma.plan; asserted), repeats bit for bit
             over two launches, and is timed beside the CUDA-core body at
             the same shape (``previous_ms``, held to the plain version
             too); PE1's first call also runs with the requant epilogue on
             the tensor cores, 4- and 8-bit, bit for bit the plain version
             with the codec's epilogue and equal to encode -> decode of the
             plain sum (integer operands: exact sums in any order).
9. train lm — the fifth main path: with_tt(internlm2-1.8b, quantize=True)
             at full width and depth (24 layers, 144 TT sites at rank 16,
             bf16, remat full), int8 Adam moments and the int8 gradient
             wire, 8 steps of ``launch/train.py::train`` on
             ``lm_batch(step, batch=8, seq=256, seed=0)``, seeded weights
             on the card; counts zeroed just before and read just after
             (each 8 x ``steps.launches_per_step``, computed from the
             config); every loss finite and the last below the first
             (the cross-entropy is printed: with int8 moments it diverges
             at the third step, as the reference's numerics do); the
             scale manager's states moved; every λ the Eq. 4 update of
             its cores; the parameter counts, the state's bytes and the
             peak memory printed; the step's three kinds of grouped
             fake-quant launch (a site's cores, an activation edge, a
             grad-edge group) bit for bit with the plain version and over
             two launches, the edge and the grad-edge group's embedding
             and head on wide units (grouped.fq_plan; asserted), timed
             beside the plain version, the narrow units throughout
             (``previous_ms``) and a loop of
             fake_quantize_per_tensor_affine; the step's large blockwise
             encode launches (the moment group holding the embedding's m,
             block 256, on the trained state's decoded moments; the wire
             group, block 1,024, on seeded data of its shapes), their
             large leaves on stream tasks
             (grouped.bw_plan; asserted), codes and scales bit for bit
             with the plain version, with the previous tasks and over two
             launches, an all-zero block coded as zeros, timed beside the
             plain version and the previous tasks (``previous_ms``); then
             one profiled step (pe1_mma_kernel 432, pe2_mma_kernel 864,
             pe3_mma_kernel 144 and no pe1_kernel, pe2_kernel or
             pe3_kernel, p2_fq_group_kernel 375, bw_enc_group_kernel 22,
             bw_dec_group_kernel 22 launches; asserted by name; each
             codec launch's device time listed); then the same 8 steps
             with f32 moments, whose cross-entropy must fall.
10. train lm identity — one step of a small TT LM (2 layers, d_model 32,
             every projection TT, f32, int8 moments and the wire) from the
             same state on the card and on the CPU: loss, ce and prior
             within 1e-5, gnorm within 1e-4, scale exponents equal, params
             within 2 lr and 99.9% within 2e-5.

Output: human-readable lines, then one JSON line describing every kernel,
then the card's name and power limit (nvidia-smi), then the last line
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available or when the repository's
``src/repro_torch`` is not beside this script.

``python3 chip_smoke.py --pe-anatomy [--out report.json]`` runs only the
build and a diagnostic of the PE1/PE2/PE3 kernels: each rebuilt with its FMA
loop, its copies or its stores cut out and timed at the step's shapes, so
the time of each phase reads as a difference (no profiler of kernel
internals works on the card's machine). It covers the CUDA-core bodies
only, at the MLP's f32 shapes; the tensor-core routes (tt_mma.cuh,
pe1_mma_kernel) have no anatomy. ``--pa-anatomy`` does the same for
the attention split pass (K/V staging, query load, scores, softmax, P @ V)
beside its combine pass. ``--codec-anatomy`` times the LM step's large
fake-quant and blockwise-encode launches on their stream units and on
the previous units: the fake-quant group in full, with its arithmetic cut
out and as a table of one, beside a ``copy_`` loop; the blockwise encode
group in full, with its coding pass cut out and with loads only. None of
the three prints a result line.

``python3 chip_smoke.py --tokens PATH [--src DIR]`` serves the engine
phase's requests (fused and gather), the chunked-prefix run's and the int8
rwkv6-1.6b and jamba runs at full width with the port found under DIR
(default: this checkout's ``src``; another tree's ``src`` compares two
versions in one call) and writes their greedy tokens to PATH as JSON; no
result line. ``--steps PATH [--src DIR]`` likewise profiles a
whole-prompt prefill of 512 tokens, the chunk step, the fused and gather
decode steps and the int8 rwkv6-1.6b and jamba decode steps (host wall,
device time, the pool kernels' launches, peak memory) and writes them to
PATH, asserting nothing.
``--pe-repeat N`` launches each of the LM's PE2 calls on the tensor
cores N times into NaN-filled outputs and logs every launch whose bits
differ from the first; no result line. ``--deploy PATH [--src DIR]``
likewise times the deploy export's packed
encode and decode of the six FMNIST cores, core by core and (where the
port has them) as one group each, and the host wall of
``export_tt_deploy`` and ``load_tt_deploy`` with their launches, and
writes them to PATH, asserting nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
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
    logs = B.build(list(B.SOURCES), verbose=True)
    dt = time.perf_counter() - t0
    ptxas = {}
    for name in B.SOURCES:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", logs[name])]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                              logs[name]))
        check(bool(regs), f"no ptxas report for {name}")
        check(spill == 0, f"ptxas spilled {spill} bytes in {name}")
        ptxas[name] = {"max_registers": max(regs), "spill_bytes": spill,
                       "instances": len(regs)}
        log(f"  ptxas {name}: {len(regs)} kernel instances, at most "
            f"{max(regs)} registers, {spill} bytes spilled")
    log(f"build: {len(B.SOURCES)} libraries in {dt:.1f} s")
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


APPEND_NONE = ("none: no PyTorch call encodes tokens under per-slot scales "
               "into their pages")


def _append_inputs(torch, gen):
    """A decode step's append at full width: K and V of 8 slots x 8 heads x
    128 in bf16 (V the strided half of the fused kv projection, as
    ``gqa_qkv`` slices it) into an int8 pool (513, 16, 8, 128) of random
    codes, 64 pages a slot. Slots at the first and the last offset of a
    page and at the last of their last page, two inactive slots at distinct
    trash offsets, one slot past its pages (trash); scales cover each
    slot's max but one slot's, which clips at both ends."""
    b, hkv, dh, page, pps = 8, 8, 128, 16, 64
    total = b * pps
    pools = [torch.randint(-128, 128, (total + 1, page, hkv, dh),
                           generator=gen, device=gen.device).to(torch.int8)
             for _ in range(2)]
    table = torch.randperm(total, generator=gen, device=gen.device).reshape(
        b, pps).to(torch.int32)
    lens = torch.tensor([0, 15, page * pps - 1, 100, 16, 511, page * pps, 5],
                        dtype=torch.int32, device=gen.device)
    active = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0], dtype=torch.bool,
                          device=gen.device)
    kv = (torch.randn((b, 1, 2, hkv, dh), generator=gen, device=gen.device) * 3
          ).to(torch.bfloat16)
    k, v = kv[:, :, 0].contiguous(), kv[:, :, 1]
    scales = [torch.ceil(torch.log2(t.float().abs().amax((1, 2, 3)) / 127))
              for t in (k, v)]
    scales[0][0] -= 1
    return (pools[0], pools[1], scales[0], scales[1], k, v, table, lens,
            active), dict(page_size=page, bits=8)


def _tokens_previous(CB, KA, kd, vd, ks, vs, k, v, table, lens, active, *,
                     page_size, bits):
    """The reference's S-row write (``kv_cache.append_tokens``; at S = 1
    ``append_token``, the design the append replaced) run per tensor: the
    page arithmetic, the row-scale encode kernel and an ``index_put_``."""
    b, s = k.shape[:2]
    for data, sc, new in ((kd, ks, k), (vd, vs, v)):
        pages, offs = KA.token_pages(table, lens, active, s, page_size,
                                     data.shape[0] - 1)
        srow = sc.reshape(b, 1).expand(b, s).reshape(b * s)
        codes = CB.encode_rows(new.reshape(b * s, -1), srow, bits)
        data.index_put_((pages.reshape(-1), offs.reshape(-1)),
                        codes.reshape((b * s,) + tuple(data.shape[2:])))


def _append_row(torch, timer, gen) -> dict:
    """The paged KV append against its twin on the whole pool, bit for bit
    (trash page included), over two launches and against the previous
    design; timed beside the twin and that design (``previous_ms``)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import kv_append as KA
    from repro_torch.numerics import cuda_backend as CB
    args, kw = _append_inputs(torch, gen)
    kd, vd = args[0], args[1]
    check(not args[5].is_contiguous(), "append: V is not a strided view")
    orig = kd.clone()
    want = [kd.clone(), vd.clone()]
    KA.append_paged_torch(*want, *args[2:], **kw)
    prev = [kd.clone(), vd.clone()]
    _tokens_previous(CB, KA, *prev, *args[2:], **kw)
    _sync(torch, kd.device)
    B.reset_launches()
    KA.append_paged_cuda(*args, **kw)
    _sync(torch, kd.device)
    check(B.LAUNCHES == {"p2_append_paged": 1},
          f"p2_append_paged launches {B.LAUNCHES}")
    check(torch.equal(kd, want[0]) and torch.equal(vd, want[1]),
          "p2_append_paged pool differs from the twin")
    check(torch.equal(kd, prev[0]) and torch.equal(vd, prev[1]),
          "p2_append_paged pool differs from the previous design")
    written = (kd != orig).flatten(2).any(2)          # (pages, offsets)
    check(bool(written[-1, [0, 4, 5]].all()),
          "p2_append_paged: the trash page missed an inactive slot")
    codes = kd[KA.token_pages(*args[6:], 1, kw["page_size"],
                              kd.shape[0] - 1)]
    check(codes.min().item() == -128 and codes.max().item() == 127,
          "append data did not reach both clip ends")
    again = [kd.clone(), vd.clone()]
    KA.append_paged_cuda(*again, *args[2:], **kw)
    check(torch.equal(again[0], kd) and torch.equal(again[1], vd),
          "p2_append_paged: two launches differ")
    n = 2 * args[4].numel()                           # K and V elements
    b = args[4].shape[0]
    row = dict(shape=[list(args[4].shape), list(kd.shape)],
               what="decode append, 8 slots", max_abs_err=0.0,
               ms=timer(lambda: KA.append_paged_cuda(*args, **kw)),
               previous_ms=timer(lambda: _tokens_previous(CB, KA, *args,
                                                          **kw)),
               plain_ms=timer(lambda: KA.append_paged_torch(*args, **kw),
                              iters=10),
               library_ms=None, library_note=APPEND_NONE)
    # bf16 in, int8 codes out, and per slot two scales, a length, an
    # active flag and one table entry
    row["bound_ms"], row["bound_by"] = bound_ms(n * 3 + b * 17, 2 * n,
                                                FP32_OPS_PER_S)
    log(f"p2_append_paged (K and V, {b} slots x {args[4].shape[2]} x "
        f"{args[4].shape[3]} bf16): {row['ms']*1e3:.2f} us one launch "
        f"(previous design {row['previous_ms']*1e3:.2f} us, plain "
        f"{row['plain_ms']*1e3:.1f} us, library {APPEND_NONE[:4]}, bound "
        f"{row['bound_ms']*1e3:.4f} us); pool bit-exact with the twin and "
        "the previous design, trash page written, two launches equal")
    return row


PAGED_NONE = ("none: no PyTorch call writes or reads tokens through a page "
              "table under per-slot scales")


def _paged_pool(torch, gen):
    """The serving pool at full width: int8 K and V pages (513, 16, 8, 128)
    of random codes, 8 slots x 64 pages, each slot's pow-2 scales."""
    b, hkv, dh, page, pps = 8, 8, 128, 16, 64
    total = b * pps
    kd, vd = (torch.randint(-128, 128, (total + 1, page, hkv, dh),
                            generator=gen, device=gen.device).to(torch.int8)
              for _ in range(2))
    table = torch.randperm(total, generator=gen, device=gen.device).reshape(
        b, pps).to(torch.int32)
    ks, vs = (torch.randint(-9, -2, (b,), generator=gen, device=gen.device
                            ).float() for _ in range(2))
    return kd, vd, ks, vs, table


def _chunk_write_previous(CB, kd, vd, ks, vs, k, v, table_row, start, valid,
                          slot, page, bits=8):
    """The chunk write as the parent ran it, per tensor: the page
    arithmetic on the host stream, the scalar-scale encode kernel and an
    ``index_put_`` (``kv_cache.write_chunk`` before the paged write)."""
    import torch
    for data, scale, new in ((kd, ks, k), (vd, vs, v)):
        new = new[0]
        j = torch.arange(new.shape[0], device=new.device)
        pos = start + j
        idx = torch.clamp(pos // page, max=table_row.shape[0] - 1)
        pages = torch.where(j < valid, table_row.long()[idx],
                            data.shape[0] - 1)
        codes = CB.encode_scalar(new, scale[slot][None], bits)
        data.index_put_((pages, pos % page), codes)


def _read_previous(CB, kd, vd, ks, vs, table, dtype):
    """The read as the parent ran it, per tensor: the page gather, then the
    scalar-scale decode kernel for one slot or the row-scale one for
    several (``kv_cache.gather_slots``)."""
    b = table.shape[0]
    out = []
    for data, scale in ((kd, ks), (vd, vs)):
        g = data[table.long()].reshape(b, -1)
        out.append(CB.decode_scalar(g, scale, dtype) if b == 1
                   else CB.decode_rows(g, scale, dtype))
    return out


def _paged_write_row(torch, timer, gen, pool) -> dict:
    """The chunk step's write (128 rows of one slot, K and V 8 x 128 bf16,
    V the strided half of the fused projection) into the serving pool:
    bit for bit with the twin and with the parent's route on the real
    pages, over two launches, for a page-aligned chunk and one whose pad
    rows and valid rows run past the slot's last page; timed beside the
    twin and the parent's route (``previous_ms``)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import kv_append as KA
    from repro_torch.numerics import cuda_backend as CB
    kd0, vd0, ks, vs, table = pool
    slot, page, s = 3, 16, 128
    kv = (torch.randn((1, s, 2, 8, 128), generator=gen, device=gen.device)
          * 2 ** -3).to(torch.bfloat16)
    k, v = kv[:, :, 0].contiguous(), kv[:, :, 1]
    check(not v.is_contiguous(), "chunk write: V is not a strided view")
    row_t = table[slot][None]
    for start, valid in ((256, 128), (1000, 100)):
        lens = torch.tensor([start], dtype=torch.int32, device=gen.device)
        nv = torch.tensor([valid], dtype=torch.int32, device=gen.device)
        args = (ks[slot:slot + 1], vs[slot:slot + 1], k, v, row_t, lens, None)
        kw = dict(page_size=page, bits=8, n_valid=nv, clamp_last=True)
        got, want, prev = ([kd0.clone(), vd0.clone()] for _ in range(3))
        KA.append_paged_torch(*want, *args, **kw)
        _chunk_write_previous(CB, *prev, ks, vs, k, v, table[slot], start,
                              valid, slot, page)
        _sync(torch, "cuda")
        B.reset_launches()
        KA.append_paged_cuda(*got, *args, **kw)
        _sync(torch, "cuda")
        check(B.LAUNCHES == {"p2_append_paged": 1},
              f"chunk write launches {B.LAUNCHES}")
        for a, w, p_, o in zip(got, want, prev, (kd0, vd0)):
            # past the last page the parent's index_put_ met rows in one
            # cell, which CUDA resolves in no set order: the twin only
            check(torch.equal(a[:-1], w[:-1]) and (
                start + valid > 1024 or torch.equal(a[:-1], p_[:-1])),
                f"chunk write ({start}, {valid}): real pages differ from "
                "the twin or the parent's route")
            check(not torch.equal(a[:-1], o[:-1]), "chunk write wrote "
                  "nothing")
        again = [kd0.clone(), vd0.clone()]
        KA.append_paged_cuda(*again, *args, **kw)
        check(torch.equal(again[0][:-1], got[0][:-1])
              and torch.equal(again[1][:-1], got[1][:-1]),
              "chunk write: two launches differ")
    # time the engine's chunk (position 256, 128 valid rows) in place
    kd, vd = kd0.clone(), vd0.clone()
    lens = torch.tensor([256], dtype=torch.int32, device=gen.device)
    nv = torch.tensor([128], dtype=torch.int32, device=gen.device)
    args = (kd, vd, ks[slot:slot + 1], vs[slot:slot + 1], k, v, row_t, lens,
            None)
    kw = dict(page_size=page, bits=8, n_valid=nv, clamp_last=True)
    n = 2 * k.numel()
    row = dict(shape=[list(k.shape), list(kd.shape)],
               what="chunk write, S=128", max_abs_err=0.0,
               ms=timer(lambda: KA.append_paged_cuda(*args, **kw)),
               previous_ms=timer(lambda: _chunk_write_previous(
                   CB, kd, vd, ks, vs, k, v, table[slot], 256, 128, slot,
                   page)),
               plain_ms=timer(lambda: KA.append_paged_torch(*args, **kw),
                              iters=10),
               library_ms=None, library_note=PAGED_NONE)
    # bf16 in, int8 codes out; two scales, the start, the count, the pages
    row["bound_ms"], row["bound_by"] = bound_ms(n * 3 + 4 * 4 + 4 * 8,
                                                2 * n, FP32_OPS_PER_S)
    log(f"p2_append_paged chunk write (K and V, 128 rows x 8 x 128 bf16): "
        f"{row['ms']*1e3:.2f} us one launch (previous route "
        f"{row['previous_ms']*1e3:.2f} us, plain {row['plain_ms']*1e3:.1f} "
        f"us, bound {row['bound_ms']*1e3:.4f} us); real pages bit-exact "
        "with the twin and the parent's route, clamp rule and pad rows, two "
        "launches equal")
    return row


def _spec_write_row(torch, timer, gen, pool) -> dict:
    """The speculative verify's write: K and V of 8 slots x S = 4 rows x 8
    x 128 bf16 (V the strided half of the fused projection) at per-slot
    lengths into the serving pool, one launch with ``clamp_last=False``:
    slot 1 crosses a page, slot 3 overhangs the horizon (rows 1024 and
    1025 to the trash page), slot 6 is inactive. Bit for bit with the twin
    and with the reference's route on the whole pool (the trash page
    aside, where rows meet in one cell in no set order), over two
    launches; timed beside the twin and that route (``previous_ms``)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import kv_append as KA
    from repro_torch.numerics import cuda_backend as CB
    kd0, vd0, ks, vs, table = pool
    b, s, page, pps = 8, 4, 16, 64
    dev = gen.device
    kv = (torch.randn((b, s, 2, 8, 128), generator=gen, device=dev)
          * 2 ** -3).to(torch.bfloat16)
    k, v = kv[:, :, 0].contiguous(), kv[:, :, 1]
    check(not v.is_contiguous(), "spec write: V is not a strided view")
    lens = torch.tensor([0, 14, 100, page * pps - 2, 511, 300, 5, 700],
                        dtype=torch.int32, device=dev)
    active = torch.tensor([1, 1, 1, 1, 1, 1, 0, 1], dtype=torch.bool,
                          device=dev)
    args = (ks, vs, k, v, table, lens, active)
    kw = dict(page_size=page, bits=8)
    got, want, prev = ([kd0.clone(), vd0.clone()] for _ in range(3))
    KA.append_paged_torch(*want, *args, **kw)
    _tokens_previous(CB, KA, *prev, *args, **kw)
    _sync(torch, "cuda")
    B.reset_launches()
    KA.append_paged_cuda(*got, *args, **kw)
    _sync(torch, "cuda")
    check(B.LAUNCHES == {"p2_append_paged": 1},
          f"spec write launches {B.LAUNCHES}")
    for a, w, p_, o in zip(got, want, prev, (kd0, vd0)):
        check(torch.equal(a, w), "spec write: pool differs from the twin")
        check(torch.equal(a[:-1], p_[:-1]), "spec write: real pages differ "
              "from the reference's route")
        written = (a != o).flatten(2).any(2)            # (pages, offsets)
        check(not bool(written[table[6].long()].any()),
              "spec write touched the inactive slot's pages")
        last = table[3, -1].long()
        check(bool(written[last, 14:].all()) and bool(written[-1].any()),
              "spec write: the overhanging slot's rows missed their page "
              "or the trash page")
    again = [kd0.clone(), vd0.clone()]
    KA.append_paged_cuda(*again, *args, **kw)
    check(torch.equal(again[0], got[0]) and torch.equal(again[1], got[1]),
          "spec write: two launches differ")
    kd, vd = kd0.clone(), vd0.clone()
    n = 2 * k.numel()
    row = dict(shape=[list(k.shape), list(kd.shape)],
               what="spec verify write, 8 slots x S=4", max_abs_err=0.0,
               ms=timer(lambda: KA.append_paged_cuda(kd, vd, *args, **kw)),
               previous_ms=timer(lambda: _tokens_previous(
                   CB, KA, kd, vd, *args, **kw)),
               plain_ms=timer(lambda: KA.append_paged_torch(kd, vd, *args,
                                                            **kw), iters=10),
               library_ms=None, library_note=APPEND_NONE)
    # bf16 in, int8 codes out; per slot two scales, a length, an active
    # flag and the table entries the block may reach (two pages)
    row["bound_ms"], row["bound_by"] = bound_ms(n * 3 + b * (13 + 8), 2 * n,
                                                FP32_OPS_PER_S)
    log(f"p2_append_paged spec verify write (K and V, {b} slots x S={s} x 8 "
        f"x 128 bf16): {row['ms']*1e3:.2f} us one launch (the reference's "
        f"route {row['previous_ms']*1e3:.2f} us, plain "
        f"{row['plain_ms']*1e3:.1f} us, bound {row['bound_ms']*1e3:.4f} "
        "us); pool bit-exact with the twin and that route, overhang to the "
        "trash page, inactive slot untouched, two launches equal")
    return row


def _paged_read_rows(torch, timer, pool) -> list:
    """The history read: one slot (the chunk step) and all 8 (the gather
    engine's decode step), 64 pages of 16 x 8 x 128 a slot -> bf16 and
    f32, bit for bit with the twin, with the parent's route and over two
    launches, one launch each; timed beside the twin and the parent's
    route (``previous_ms``)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import kv_read as KR
    from repro_torch.numerics import cuda_backend as CB
    kd, vd, ks, vs, table = pool
    rows = []
    for b, dt, what in ((1, torch.bfloat16, "chunk step, one slot"),
                        (8, torch.bfloat16, "gather decode, 8 slots"),
                        (1, torch.float32, "one slot -> f32"),
                        (8, torch.float32, "8 slots -> f32")):
        sl = slice(3, 4) if b == 1 else slice(0, 8)     # slot 3, or all
        args = (kd, vd, ks[sl], vs[sl], table[sl])
        _sync(torch, "cuda")
        B.reset_launches()
        got = KR.read_paged_cuda(*args, dtype=dt)
        _sync(torch, "cuda")
        check(B.LAUNCHES == {"p2_read_paged": 1},
              f"read launches {B.LAUNCHES}")
        want = KR.read_paged_torch(*args, dtype=dt)
        prev = _read_previous(CB, *args, dt)
        again = KR.read_paged_cuda(*args, dtype=dt)
        for a, w, p_, r in zip(got, want, prev, again):
            check(_bits_equal(torch, a, w) and _bits_equal(
                torch, a, p_.reshape(a.shape)) and _bits_equal(torch, a, r),
                f"p2_read_paged ({what}) differs from the twin, the "
                "parent's route or its own second launch")
        n = 2 * got[0].numel()
        row = dict(shape=list(got[0].shape), dtype=str(dt)[6:], what=what,
                   max_abs_err=0.0,
                   ms=timer(lambda: KR.read_paged_cuda(*args, dtype=dt)),
                   previous_ms=timer(lambda: _read_previous(CB, *args, dt)),
                   plain_ms=timer(lambda: KR.read_paged_torch(*args,
                                                              dtype=dt),
                                  iters=10),
                   library_ms=None, library_note=PAGED_NONE)
        # int8 codes in, values out; two scales and the page list a slot
        row["bound_ms"], row["bound_by"] = bound_ms(
            n * (1 + got[0].element_size()) + b * (8 + 4 * table.shape[1]),
            n, FP32_OPS_PER_S)
        rows.append(row)
        log(f"p2_read_paged {what} {tuple(got[0].shape)} {row['dtype']}: "
            f"{row['ms']*1e3:.2f} us one launch (previous route "
            f"{row['previous_ms']*1e3:.2f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us, bound "
            f"{row['bound_ms']*1e3:.3f} us); bit-exact with the twin and "
            "the parent's route, two launches equal")
    return rows


def _prefill_previous(CB, kd, vd, ks, vs, k, v, table_row, slot, length,
                      page, bits=8):
    """The whole-prompt prefill write as the parent ran it: the page
    arithmetic once, then per tensor ``choose_scale_log2`` (an f32 cast,
    abs, mask, amax, clamp, divide, log2, ceil), the scale column's write,
    the row-scale encode kernel and an ``index_put_`` over L x S cells
    (``kv_cache.write_prefill`` before the paged prefill write)."""
    import torch
    from repro_torch.numerics import QuantSpec, per_tensor_max_scale_log2
    s = k.shape[1]
    pos = torch.arange(s, device=k.device)
    valid = pos < length
    idx = torch.clamp(pos // page, max=table_row.shape[0] - 1)
    pages = torch.where(valid, table_row.long()[idx], kd.shape[1] - 1)
    offs = pos % page
    spec = QuantSpec("pow2", bits, 0, "int8", "per_tensor_max")
    for data, scale, x in ((kd, ks, k), (vd, vs, v)):
        step = per_tensor_max_scale_log2(
            x, spec, valid=valid.reshape((1, -1) + (1,) * (x.dim() - 2)),
            reduce_axes=tuple(range(1, x.dim())))
        scale[:, slot] = step
        codes = CB.encode_rows(x.reshape(x.shape[0], -1), step, bits)
        data[:, pages, offs] = codes.reshape(x.shape)


def _prefill_rows(torch, timer, gen) -> list:
    """The whole-prompt prefill write at full width (24 layers, K and V of
    8 x 128 bf16 as ``lm_forward`` stacks them, into int8 pools (24, 513,
    16, 8, 128) of random codes, slot 3 of 8 x 64 pages) at S = 128 and
    512: pages and scales bit for bit with the twin and with the parent's
    route, and over two launches, one launch each; then S = 512 with 400
    valid rows (bucket padding). Timed beside the twin and the parent's
    route (``previous_ms``)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import kv_prefill as KP
    from repro_torch.numerics import cuda_backend as CB
    layers, b, hkv, dh, page, pps, slot = 24, 8, 8, 128, 16, 64, 3
    total = b * pps
    kd0, vd0 = (torch.randint(-128, 128, (layers, total + 1, page, hkv, dh),
                              generator=gen, device=gen.device
                              ).to(torch.int8) for _ in range(2))
    ks0, vs0 = (torch.randint(-9, -2, (layers, b), generator=gen,
                              device=gen.device).float() for _ in range(2))
    table = torch.randperm(total, generator=gen, device=gen.device).reshape(
        b, pps).to(torch.int32)
    rows = []
    for s, length in ((512, 512), (128, 128), (512, 400)):
        mag = torch.exp2(torch.randint(-4, 3, (layers, 1, 1, 1, 1),
                                       generator=gen, device=gen.device
                                       ).float())
        kv = (torch.randn((layers, s, 2, hkv, dh), generator=gen,
                          device=gen.device) * mag).to(torch.bfloat16)
        k, v = kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous()
        n = torch.tensor([length], dtype=torch.int32, device=gen.device)
        args = (k, v, table[slot], slot, n)
        kw = dict(page_size=page, bits=8)
        want = [kd0.clone(), vd0.clone(), ks0.clone(), vs0.clone()]
        KP.prefill_paged_torch(*want, *args, **kw)
        prev = [kd0.clone(), vd0.clone(), ks0.clone(), vs0.clone()]
        _prefill_previous(CB, *prev, k, v, table[slot], slot, length, page)
        got = [kd0.clone(), vd0.clone(), ks0.clone(), vs0.clone()]
        _sync(torch, "cuda")
        B.reset_launches()
        KP.prefill_paged_cuda(*got, *args, **kw)
        _sync(torch, "cuda")
        check(B.LAUNCHES == {"p2_prefill_paged": 1},
              f"prefill write launches {B.LAUNCHES}")
        again = [kd0.clone(), vd0.clone(), ks0.clone(), vs0.clone()]
        KP.prefill_paged_cuda(*again, *args, **kw)
        for i, (a, w, p_, r) in enumerate(zip(got, want, prev, again)):
            cut = slice(None) if i >= 2 else (slice(None), slice(0, -1))
            check(torch.equal(a[cut], w[cut]) and torch.equal(a[cut], p_[cut])
                  and torch.equal(a[cut], r[cut]),
                  f"p2_prefill_paged (S={s}, length {length}): "
                  f"{'pages scales'.split()[i // 2]} differ from the twin, "
                  "the parent's route or its own second launch")
        check(not torch.equal(got[0][:, :-1], kd0[:, :-1]),
              "prefill write wrote nothing")
        # time the write in place, as the engine does
        pool = [kd0.clone(), vd0.clone(), ks0.clone(), vs0.clone()]
        nbytes = 2 * k.numel() * (2 + 1) + 2 * layers * 4 + 4 * pps + 4
        row = dict(shape=[list(k.shape), list(kd0.shape)], S=s,
                   length=length, what=f"prefill S={s}, {length} valid",
                   max_abs_err=0.0,
                   ms=timer(lambda: KP.prefill_paged_cuda(*pool, *args,
                                                          **kw)),
                   previous_ms=timer(lambda: _prefill_previous(
                       CB, *pool, k, v, table[slot], slot, length, page)),
                   plain_ms=timer(lambda: KP.prefill_paged_torch(
                       *pool, *args, **kw), iters=10),
                   library_ms=None, library_note=PAGED_NONE)
        # bf16 in (every row is read: pad rows go to the trash page), int8
        # codes out, a scale a (tensor, layer), the table row, the length
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 4 * k.numel(),
                                                    FP32_OPS_PER_S)
        rows.append(row)
        log(f"p2_prefill_paged (K and V, 24 x {s} x 8 x 128 bf16, {length} "
            f"valid): {row['ms']*1e3:.2f} us one launch (previous route "
            f"{row['previous_ms']*1e3:.2f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us, bound "
            f"{row['bound_ms']*1e3:.2f} us); pages and scales bit-exact "
            "with the twin and the parent's route, two launches equal")
    return rows


def phase_kernels(torch, timer: Timer) -> dict:
    from repro_torch.kernels import build as B
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.numerics import cuda_backend as CB

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}

    # --- row-scale encode: decode-append rows (8 x 1024) and prefill rows
    enc_shapes = []
    for rows, cols, what in ((24, 512 * 8 * 128, "prefill S=512"),
                             (24, 128 * 8 * 128, "prefill S=128"),
                             (8, 8 * 128, "previous decode append")):
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
    pool = _paged_pool(torch, gen)
    out["p2_append_paged"] = [_append_row(torch, timer, gen),
                              _paged_write_row(torch, timer, gen, pool),
                              _spec_write_row(torch, timer, gen, pool)]
    out["p2_read_paged"] = _paged_read_rows(torch, timer, pool)
    del pool
    out["p2_prefill_paged"] = _prefill_rows(torch, timer, gen)

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
    # S = 1 (decode), S = 4 (a q-block), and S = 4 as the spec verify meets
    # it: slot 7's block overhangs the horizon (rows 1024 and 1025 are
    # never emitted, so only the rows inside it are held to the twin)
    for s_rows, overhang in ((1, False), (4, False), (4, True)):
        lens = _pa_lens(torch, s_rows)
        if overhang:
            lens[7] = pps * page - 2
        inside = (lens[:, None] + torch.arange(s_rows, device="cuda")
                  < pps * page)                              # (B, S)
        q32 = torch.randn((b, s_rows, hq, dh), generator=gen, device="cuda")
        o32 = PA.paged_attention_cuda(q32, kd, vd, ks, vs, table, lens, **kw)
        r32 = PA.paged_attention_torch(q32, kd, vd, ks, vs, table, lens, **kw)
        err32 = (o32 - r32).abs()[inside].max().item()
        check(err32 <= 1e-5, f"paged_attention fp32 S={s_rows}: max abs "
              f"err {err32} > 1e-5")
        check(_bits_equal(torch, o32, PA.paged_attention_cuda(
            q32, kd, vd, ks, vs, table, lens, **kw)),
            f"paged_attention S={s_rows}: two launches differ")
        qb = q32.to(torch.bfloat16)
        ob = PA.paged_attention_cuda(qb, kd, vd, ks, vs, table, lens, **kw)
        rb = PA.paged_attention_torch(qb, kd, vd, ks, vs, table, lens, **kw)
        check(bool(ob.float().isfinite().all()),
              f"paged_attention S={s_rows}: a non-finite output")
        diff = (ob.float() - rb.float()).abs()[inside]
        ulps, over = _bf16_excess(diff, rb[inside])
        check(over <= 0, f"paged_attention bf16 S={s_rows}: error exceeds "
              f"2 bf16 ulp + 1e-5 by {over}")
        errb = diff.max().item()
        comb = _pa_kernels_vs_mirrors(torch, timer, qb, kd, vd, ks, vs,
                                      table, lens, page, s_rows)
        if overhang:
            comb["what"] = "spec verify, slot 7 overhanging"
        comb_shapes.append(comb)
        # pages this run's data needs: those holding a position <= lens+S-1
        npg = torch.clamp((lens + s_rows - 1) // page + 1, max=pps)
        # keys attended: row j of slot b sees lens[b] + j + 1 positions,
        # at most the slot's pps * page
        keys = sum(min(l + j + 1, pps * page) for l in lens.tolist()
                   for j in range(s_rows))
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
        lerr = (lib.float() - rb.float()).abs()[inside].max().item()
        att_shapes.append(dict(S=s_rows, ms=ms, plain_ms=pms, library_ms=lms,
                               bound_ms=bms, bound_by=by, max_abs_err=errb,
                               max_abs_err_fp32=err32, max_ulp_bf16=ulps,
                               library_max_abs_err=lerr,
                               split_ms=comb["split_ms"],
                               what=comb.get("what", f"S={s_rows}")))
        log(f"paged_attention S={s_rows}{' overhanging' * overhang}: "
            f"{ms*1e3:.1f} us (split "
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


def _serve_engine(torch, lm, params, prompts, gen_len: int, draft=None,
                  quantized: bool = True, **ekw):
    """Serve ``prompts`` on a fresh engine over the int8 pool (8 slots x 64
    pages of 16; ``quantized=False`` asks for a model-dtype one, which a
    ``policy`` may override); every completion must have ``gen_len``
    in-vocabulary tokens. Returns (engine, completions in submission
    order)."""
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    pool = PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                      quantized=quantized)
    eng = Engine(lm, params, EngineConfig(pool=pool, **ekw), device="cuda",
                 draft=draft)
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


def _serve(torch, lm, params, fused: bool, prompts, gen_len: int, **kw):
    eng, toks = _serve_engine(torch, lm, params, prompts, gen_len,
                              fused_attention=fused, **kw)
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


def _check_appends(what, launches, summ, prefills, cfg,
                   chunk_steps: int = 0) -> None:
    """Each decode step and each of the ``chunk_steps`` chunk steps wrote K
    and V once a layer through p2_append_paged, each of the ``prefills``
    whole-prompt prefills wrote K and V of every layer through one
    p2_prefill_paged, and p2_enc_rows never ran."""
    want = (summ["decode_steps"] + chunk_steps) * cfg.num_layers
    check(summ["decode_steps"] > 0
          and launches.get("p2_append_paged", 0) == want,
          f"{what}: {launches.get('p2_append_paged', 0)} append launches for "
          f"{summ['decode_steps']} decode steps and {chunk_steps} chunk "
          f"steps x {cfg.num_layers} layers")
    check(prefills > 0 and launches.get("p2_prefill_paged", 0) == prefills
          and "p2_enc_rows" not in launches,
          f"{what}: {launches.get('p2_prefill_paged', 0)} p2_prefill_paged "
          f"and {launches.get('p2_enc_rows', 0)} p2_enc_rows launches for "
          f"{prefills} whole-prompt prefills")


def phase_engine(torch, lm, params) -> dict:
    from repro_torch.kernels import build as B

    cfg = lm.cfg
    prompts = _requests(cfg.vocab_size)
    _serve(torch, lm, params, True, prompts[:2], 4)          # warm-up
    torch.cuda.reset_peak_memory_stats()

    B.reset_launches()
    eng, fused_toks = _serve_engine(torch, lm, params, prompts, 64,
                                    fused_attention=True)
    main, fs = dict(B.LAUNCHES), eng.summary()
    _check_appends("fused path", main, fs, len(eng.metrics.prefills), cfg)
    check(main.get("paged_attention", 0) ==
          fs["decode_steps"] * cfg.num_layers,
          f"fused path: {main.get('paged_attention', 0)} attention launches "
          f"for {fs['decode_steps']} decode steps x {cfg.num_layers} layers")
    check(main.get("paged_attention_combine", 0) == main["paged_attention"],
          "fused path: combine launches differ from split launches")
    check(fs["requests_completed"] == len(prompts), "requests lost")
    peak = torch.cuda.max_memory_allocated()

    B.reset_launches()
    eng, gather_toks = _serve_engine(torch, lm, params, prompts, 64,
                                     fused_attention=False)
    gather, gs = dict(B.LAUNCHES), eng.summary()
    _check_appends("gather path", gather, gs, len(eng.metrics.prefills), cfg)
    check(gather.get("p2_read_paged", 0) == gs["decode_steps"] * cfg.num_layers
          and "p2_dec_rows" not in gather,
          f"gather path: {gather.get('p2_read_paged', 0)} paged reads for "
          f"{gs['decode_steps']} decode steps x {cfg.num_layers} layers, "
          f"{gather.get('p2_dec_rows', 0)} p2_dec_rows")
    check("p2_read_paged" not in main, "fused path launched a paged read")
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
           "bf16_token_agreement": agree, "fused_tokens": fused_toks}
    layers = cfg.num_layers
    out["decode_profile"] = _profile_decode(
        torch, lm, params, prompts, fused=True,
        want={"p2_append_paged_kernel": layers})
    out["gather_profile"] = _profile_decode(
        torch, lm, params, prompts, fused=False,
        want={"p2_append_paged_kernel": layers,
              "p2_read_paged_kernel": layers})
    out["prefill_profile"] = _profile_prefill(
        torch, lm, params, prompts, want={"p2_prefill_paged_kernel": 1})
    return out


# the paged KV kernels and the codec kernels they took over from, by the
# kernel function's name in a profile
KV_KERNEL_FNS = ["p2_append_paged_kernel", "p2_read_paged_kernel",
                 "p2_prefill_paged_kernel", "p2_enc_kernel", "p2_dec_kernel",
                 "p2_enc_rows_kernel", "p2_dec_rows_kernel"]


PROFILE_TRIES = 3


def _profile_window(torch, window, steps: int, names, want, what: str,
                    tries: int = PROFILE_TRIES, cpu: bool = True):
    """Profile ``window()`` (``steps`` steps, spin kernels at each edge):
    (profile, the named kernels' launches and device ms a step). With
    ``want`` (name -> launches a step) every window must count exactly
    that; a window that does not is logged and profiled again, and the
    check fails when ``tries`` windows all miss. The trace loses device
    events at a window's start (``_pad_window``), which the launch
    counters (``kernels.build.LAUNCHES``, asserted exactly on every path)
    never do: the leading pad is sized from the most any earlier window
    of the process lost (``_lead_spins``), and a window whose trace kept
    none of it may have lost real launches, so it is profiled again with
    a larger pad. A kernel launched too often or too rarely misses in
    every window. ``cpu=False`` records device activity only: a window of
    the recurrent scans holds ~100,000 launches, and the host-side op
    events would multiply the trace the profiler processes."""
    from torch.profiler import ProfilerActivity, profile
    kern = None
    acts = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    for attempt in range(tries):
        n = _lead_spins()
        with profile(activities=acts) as prof:
            _pad_window(torch, n, LEAD_CYCLES)
            window()
            _pad_window(torch, TRAIL_SPINS, TRAIL_CYCLES)
        cuda = torch.autograd.DeviceType.CUDA
        lead = sum(e.count for e in prof.key_averages()
                   if getattr(e, "device_type", None) == cuda
                   and "spin_kernel" in e.key) - TRAIL_SPINS
        LEAD_LOST[0] = max(LEAD_LOST[0], n - lead)
        log(f"  {what} profile window {attempt + 1}: the trace kept {lead} "
            f"of {n} leading pad spins")
        if lead <= 0:
            log(f"  {what} profile window {attempt + 1}: the trace may have "
                "lost the window's first launches; profiling another window")
            continue
        kern = _kernel_profile(torch, prof, steps, names)
        got = {k: r["calls_per_step"] for k, r in kern.items()}
        if want is None or got == want:
            return prof, kern
        log(f"  {what} profile window {attempt + 1}: launches a step "
            f"{got}, want {want}; profiling another window")
    check(False, f"{what} profile kernels {kern} in {tries} windows, want "
          f"launches {want} a step")


def _kv_want(want):
    return None if want is None else {k: float(v) for k, v in want.items()}


def _log_kernels(kern: dict) -> None:
    for name, r in kern.items():
        log(f"  kernel {name}: {r['calls_per_step']:.1f} launches, "
            f"{r['ms_per_step']*1e3:.1f} us a step")


def _profile_decode(torch, lm, params, prompts, steps: int = 20,
                    fused: bool = True, want=None, names=KV_KERNEL_FNS,
                    what: str | None = None, cpu: bool = True) -> dict:
    """Where a steady decode step's time goes: the host wall time of
    ``steps`` unprofiled decode steps of the fused (or gather) engine with
    all 8 slots busy, then one profiled window of as many steps for the
    device time per kernel (``names``, held to ``want``). busy_share =
    device time / wall time."""
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    eng = Engine(lm, params, EngineConfig(
        pool=PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                        quantized=True), fused_attention=fused),
        device="cuda")
    # enough tokens that every slot stays busy through each window
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=(2 + PROFILE_TRIES) * steps + 2)
    eng.step()                          # admits + prefills all 8, 1 decode
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated()
    what = what or ("decode" if fused else "gather decode")
    prof, kern = _profile_window(
        torch, lambda: [eng.step() for _ in range(steps)], steps,
        names, _kv_want(want), what, cpu=cpu)
    total, rows = _device_summary(torch, prof, steps)
    log(f"{what} profile: {wall*1e3:.2f} ms per step (host wall), device "
        f"{total:.2f} ms busy, busy share {total / (wall*1e3):.3f}; peak "
        f"memory over the steps {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**20:.1f} MiB above the engine's resident "
        "bytes)")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    _log_kernels(kern)
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows,
            "kernels": kern, "peak_bytes": peak, "step_bytes": peak - base}


def _profile_prefill(torch, lm, params, prompts, reps: int = 10,
                     want=None, names=KV_KERNEL_FNS,
                     what: str = "prefill", cpu: bool = True,
                     window_tokens: int = 512) -> dict:
    """One whole-prompt prefill at full width (512 tokens into slot 0 of
    the int8 pool: ``lm_forward`` and the pool writes), repeated: host wall
    per prefill (synchronised), then one profiled window for the device
    time per kernel and the pool kernels' launches, of prefills of the
    prompt's first ``window_tokens`` (a shorter window keeps a recurrent
    scan's trace small; its host wall is timed too). Each repeat rewrites
    the slot's pages and scales with the same values."""
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    eng = Engine(lm, params, EngineConfig(
        pool=PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                        quantized=True), fused_attention=True),
        device="cuda")
    prompt = sum(prompts[:4], [])[:512]       # four prompts of 128..512
    eng.submit(prompt, max_new_tokens=8)
    eng.step()                          # admits + prefills slot 0, 1 decode
    table_row = eng._tensor(eng.sched.page_table[0])
    eng._prefill(prompt, table_row, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng._prefill(prompt, table_row, 0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    short = prompt[:window_tokens]
    win_wall = wall
    if len(short) < len(prompt):
        t0 = time.perf_counter()
        for _ in range(reps):
            eng._prefill(short, table_row, 0)
        torch.cuda.synchronize()
        win_wall = (time.perf_counter() - t0) / reps
    prof, kern = _profile_window(
        torch, lambda: [eng._prefill(short, table_row, 0)
                        for _ in range(reps)], reps, names,
        _kv_want(want), what, cpu=cpu)
    total, rows = _device_summary(torch, prof, reps)
    log(f"{what} profile: S=512 {wall*1e3:.2f} ms per prefill (host wall); "
        f"profiled S={len(short)}: {win_wall*1e3:.2f} ms host, device "
        f"{total:.3f} ms busy, busy share {total / (win_wall*1e3):.3f}")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    _log_kernels(kern)
    return {"step_ms": wall * 1e3, "window_tokens": len(short),
            "window_ms": win_wall * 1e3, "device_ms": total,
            "busy_share": total / (win_wall * 1e3), "top": rows,
            "kernels": kern}


SPEC_K = 3                  # draft tokens a round
DRAFT_LAYERS = 2            # the independent draft: the target's config cut
                            # to 2 layers, its own seeded weights
PA_KERNEL_FNS = ["pa_split_kernel", "pa_combine_kernel"]


def _spec_want(layers: int, draft_layers: int) -> dict:
    """Launches of one speculative round: the verify writes the block
    once a layer and attends it once a layer (split + combine); each of
    the k + 1 draft steps writes and reads once a draft layer."""
    d = (SPEC_K + 1) * draft_layers
    return {"p2_append_paged": layers + d, "paged_attention": layers,
            "paged_attention_combine": layers, "p2_read_paged": d}


def phase_serve_spec(torch, lm, params, fused_toks) -> dict:
    """The sixth main path: speculative decoding (k = 3) on the shared
    full-width model with fused attention, the engine phase's 16 requests,
    64 new tokens each, twice: (a) an independent shallow draft (2 layers
    of the same config, its own seeded weights), (b) a self-draft. Counts
    zeroed just before and read just after each: per round 24 + 4 x L_d
    ``p2_append_paged``, 24 split + 24 combine, 4 x L_d ``p2_read_paged``;
    2 ``p2_prefill_paged`` per admission (the target's and the draft's);
    no other KV kernel. Every page back on the free list. Then a steady
    round of (a) timed and profiled, its kernels asserted by name."""
    from repro_torch.kernels import build as B
    import repro_torch.configs as C
    from repro_torch.models import build_lm, init_lm
    cfg = lm.cfg
    prompts = _requests(cfg.vocab_size)
    dlm = build_lm(C.get_config(ARCH).replace(num_layers=DRAFT_LAYERS))
    dparams = init_lm(torch.Generator(device="cuda").manual_seed(1), dlm,
                      device="cuda")
    _serve_engine(torch, lm, params, prompts[:2], 4, fused_attention=True,
                  spec_k=SPEC_K, draft=(dlm, dparams))           # warm-up
    out = {}
    for name, draft, dl in (("draft", (dlm, dparams), DRAFT_LAYERS),
                            ("self", (lm, params), cfg.num_layers)):
        B.reset_launches()
        t0 = time.perf_counter()
        eng, toks = _serve_engine(torch, lm, params, prompts, 64,
                                  fused_attention=True, spec_k=SPEC_K,
                                  draft=draft)
        wall = time.perf_counter() - t0
        launches, summ = dict(B.LAUNCHES), eng.summary()
        rounds, admits = summ["spec"]["steps"], len(eng.metrics.prefills)
        want = {k: rounds * v for k, v in _spec_want(cfg.num_layers,
                                                     dl).items()}
        want["p2_prefill_paged"] = 2 * admits
        got = {k: launches.get(k, 0) for k in want}
        check(rounds > 0 and rounds == summ["decode_steps"] and got == want,
              f"spec ({name}): launches {got} for {rounds} rounds and "
              f"{admits} admissions, want {want}")
        others = set(launches) - set(want)
        check(not others, f"spec ({name}): other launches {others}")
        check(summ["requests_completed"] == len(prompts), "requests lost")
        free = eng.sched.alloc.free_pages
        check(free == eng.pcfg.total_pages, f"spec ({name}): {free} pages "
              f"free of {eng.pcfg.total_pages} at the end")
        agree = sum(a == b for ft, st in zip(fused_toks, toks)
                    for a, b in zip(ft, st)) / (len(prompts) * 64)
        out[name] = {"spec": summ["spec"], "launches": launches,
                     "rounds": rounds, "admissions": admits,
                     "free_pages": free, "wall_s": wall,
                     "tokens_per_s": summ["tokens_per_s"],
                     "ttft_p50_s": summ["ttft_p50_s"],
                     "preemptions": summ["preemptions"],
                     "bf16_token_agreement_with_engine": agree}
        log(f"serve spec ({name}, k={SPEC_K}, {dl}-layer draft): "
            f"{summ['requests_completed']} requests in {wall:.2f} s, "
            f"{rounds} rounds, {summ['tokens_per_s']:.1f} tok/s, "
            f"spec {summ['spec']}, greedy agreement with the engine's fused "
            f"tokens {agree:.3f}, {free} pages free at the end; launches "
            f"{launches}")
        del eng
    out["profile"] = _profile_spec(torch, lm, params, prompts,
                                   (dlm, dparams), DRAFT_LAYERS)
    return out


def _profile_spec(torch, lm, params, prompts, draft, draft_layers: int,
                  steps: int = 10) -> dict:
    """Where a steady speculative round's time goes: the host wall time of
    ``steps`` unprofiled rounds with all 8 slots busy, then profiled
    windows of as many for the device time per kernel; the KV and
    attention kernels asserted by name at ``_spec_want``'s counts a round
    (up to three windows). busy_share = device time / wall time."""
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    eng = Engine(lm, params, EngineConfig(
        pool=PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                        quantized=True), fused_attention=True,
        spec_k=SPEC_K), device="cuda", draft=draft)
    # enough tokens that no slot retires within the windows, whatever is
    # accepted
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=(2 + PROFILE_TRIES) * steps
                   * (SPEC_K + 1) + 2)
    eng.step()                          # admits + prefills all 8, 1 round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    per = _spec_want(lm.cfg.num_layers, draft_layers)
    want = {"p2_append_paged_kernel": float(per["p2_append_paged"]),
            "p2_read_paged_kernel": float(per["p2_read_paged"]),
            "pa_split_kernel": float(per["paged_attention"]),
            "pa_combine_kernel": float(per["paged_attention_combine"])}
    prof, kern = _profile_window(
        torch, lambda: [eng.step() for _ in range(steps)], steps,
        KV_KERNEL_FNS + PA_KERNEL_FNS, want, "spec round")
    check(all(s is not None for s in eng.sched.slots),
          "spec profile: a slot retired inside the windows")
    total, rows = _device_summary(torch, prof, steps)
    log(f"spec round profile (k={SPEC_K}, {draft_layers}-layer draft): "
        f"{wall*1e3:.2f} ms per round (host wall), device {total:.2f} ms "
        f"busy, busy share {total / (wall*1e3):.3f}")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    _log_kernels(kern)
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows,
            "kernels": kern, "spec": eng.summary()["spec"]}


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
    # speculative decoding: greedy spec output is the non-spec output, with
    # an independent 2-layer draft on either path, and a self-draft on the
    # gather path accepts every proposal
    dlm = build_lm(cfg.replace(num_layers=DRAFT_LAYERS))
    dparams = init_lm(torch.Generator(device="cuda").manual_seed(1), dlm,
                      device="cuda")
    spec = {}
    for name, fz, draft, ref in (("draft fused", True, (dlm, dparams), fused),
                                 ("draft gather", False, (dlm, dparams),
                                  gather),
                                 ("self gather", False, (lm, params),
                                  gather)):
        toks, s = _serve(torch, lm, params, fz, prompts, 64, spec_k=SPEC_K,
                         draft=draft)
        n_same = sum(t == r for t, r in zip(toks, ref))
        check(toks == ref, f"fp32 spec ({name}) vs non-spec: "
              f"{n_same}/{len(prompts)} completions identical")
        spec[name] = s["spec"]
        log(f"identity: fp32 spec k={SPEC_K} ({name}) == non-spec on all "
            f"{len(prompts)} completions; {s['spec']}")
    check(spec["self gather"]["acceptance_rate"] == 1.0,
          f"fp32 self-draft acceptance {spec['self gather']}")
    # the policy owns the pool's numerics: an fp pool config under an
    # enabled policy serves from an int8 pool, the int8 engine's tokens
    from repro_torch.numerics import NumericsPolicy
    eng, pol = _serve_engine(torch, lm, params, prompts, 64, quantized=False,
                             fused_attention=True,
                             policy=NumericsPolicy(enable=True))
    leaf = eng.pool["data"]["sub_0"]["k"]
    check(eng.pcfg.quantized and leaf.dtype == torch.int8 and pol == fused,
          f"policy engine: pool {leaf.dtype}, "
          f"{sum(a == b for a, b in zip(pol, fused))}/{len(prompts)} "
          "completions equal to the int8 engine's")
    log("identity: an fp pool under NumericsPolicy(enable=True) serves from "
        "an int8 pool, tokens equal to the int8 engine's")
    del params, dparams, eng
    torch.cuda.empty_cache()
    return {"identical_completions": same, "spec": spec}


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
    ``kernels/_build/anatomy``. The CUDA-core bodies only (the f32 route);
    the bf16 tensor-core route is not cut here."""
    from repro_torch.kernels import tt_contract as TC, ttm_pe1
    cuts = {"full": [], **{f"no {k}": [k] for k in PE_PHASES},
            "none": list(PE_PHASES)}
    libs = {key: (ttm_pe1.typed(lib) if key[1] == "ttm_pe1"
                  else TC.typed(lib, key[1][4:]))
            for key, lib in _anatomy_libs(
                PE_PHASES, cuts, ("tt_contract.cuh", "tt_mma.cuh",
                                  "ttm_pe1.cu"),
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
    out["p2_fake_quant"] = [r for r in fq if "ms" in r] + \
        _fq_group_rows(torch, timer, device)
    out["p2_rt_group"] = _rt_group_rows(torch, timer, device)

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


def _fq_group_rows(torch, timer: Timer, device: str) -> list:
    """Each layer's cores in one grouped fake-quant launch at the step's
    ``wscale_log2`` (layer 1's 4 cores, layer 2's 2): bit for bit with the
    twin in f32 and bf16 and over two launches, timed beside the loop of
    one-entry launches it replaced (``previous_ms``) and the library loop
    of ``fake_quantize_per_tensor_affine``; the bound is the group's
    bytes."""
    from repro_torch.core import tt_layer as TL
    from repro_torch.kernels import build as B
    from repro_torch.kernels import grouped as G
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.numerics import cuda_backend as CB
    d = MLP.make_mlp()
    params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0), d,
                          device=device)
    rows = []
    for layer, spec in (("l1", d.spec1), ("l2", d.spec2)):
        cores = [c.detach() for c in TL.get_cores(params[layer], spec)]
        steps = params[layer]["wscale_log2"].float()
        for dt in (torch.float32, torch.bfloat16):
            xs = [c.to(dt) for c in cores]
            check(not any(any(launch.wide) for launch in G.fq_plan(
                [x.numel() for x in xs], xs[0].element_size())),
                  f"fake-quant group {layer}: a tensor planned for wide units")
            _sync(torch, device)
            B.reset_launches()
            ys = CB.fake_quant_scalar_many(xs, steps, 4)
            _sync(torch, device)
            check(B.LAUNCHES == {"p2_fake_quant": 1},
                  f"fake-quant group {layer}: launches {B.LAUNCHES}")
            again = CB.fake_quant_scalar_many(xs, steps, 4)
            for n, (y, r, a) in enumerate(zip(
                    ys, CB.fake_quant_many_plain(xs, steps, 4), again)):
                check(_bits_equal(torch, y, r) and _bits_equal(torch, a, y),
                      f"fake-quant group {layer} core_{n} {dt}: not "
                      "bit-exact or not repeatable")
        ys = CB.fake_quant_scalar_many(cores, steps, 4)
        scales = [2.0 ** v for v in steps.tolist()]
        n = sum(c.numel() for c in cores)
        row = dict(shape=[list(c.shape) for c in cores], bits=4,
                   dtype="float32", what=f"group {layer} cores",
                   entries=len(cores), max_abs_err=0.0)
        row["ms"] = timer(lambda: CB.fake_quant_scalar_many(cores, steps, 4))
        row["previous_ms"] = timer(lambda: [
            CB.fake_quant_scalar(c, steps[i], 4) for i, c in enumerate(cores)])
        row["plain_ms"] = timer(
            lambda: CB.fake_quant_many_plain(cores, steps, 4), iters=10)
        row["library_ms"], row["library_note"] = _library_yardstick(
            timer, lambda: [torch.fake_quantize_per_tensor_affine(
                c, scales[i], 0, -8, 7) for i, c in enumerate(cores)],
            lambda r: all(torch.equal(a, b) for a, b in zip(r, ys)))
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * n * 4 + 4 * len(cores), 4 * n, FP32_OPS_PER_S)
        log(f"p2_fake_quant group {layer} ({len(cores)} cores, {n} "
            f"elements): {row['ms']*1e3:.1f} us one launch (one-entry loop "
            f"{row['previous_ms']*1e3:.1f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us, library loop "
            f"{row['library_note']}, bound {row['bound_ms']*1e3:.3f} us); "
            f"f32 and bf16 exact, two launches equal")
        rows.append(row)
    return rows


def _rt_group_rows(torch, timer: Timer, device: str) -> list:
    """The BinaryConnect export's grouped round trips at the MLP's leaves
    (its six 4-bit cores on their ``wscale_log2``, its two 8-bit biases on
    2^-7), with zeros, small negatives and saturating values set in each:
    one launch a group, bit for bit (zeros' sign included) with the twin,
    with the per-leaf ``p2_enc`` + ``p2_dec`` route it replaced and over
    two launches; timed beside that route (``previous_ms``) and a library
    loop of ``fake_quantize_per_tensor_affine`` (the same values, zeros'
    sign aside)."""
    from repro_torch.kernels import build as B
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.numerics import QuantSpec, roundtrip
    from repro_torch.numerics import cuda_backend as CB
    from repro_torch.optim.binaryconnect import deploy_leaves
    d = MLP.make_mlp()
    params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0), d,
                          device=device)
    rows = []
    for (bits, _), leaves in sorted(deploy_leaves(params, d.qc).items(),
                                    key=lambda kv: kv[0][0]):
        xs = [v.detach().clone() for _, _, v, _ in leaves]
        steps = [st for _, _, _, st in leaves]
        for x, st in zip(xs, steps):
            step = 2.0 ** st.item()
            x.view(-1)[:6] = torch.tensor([0.0, -0.3, -0.5, 1e3, -1e3, 2.5],
                                          device=device) * step
        spec = QuantSpec("pow2", bits)
        _sync(torch, device)
        B.reset_launches()
        ys = CB.roundtrip_many(xs, steps, bits)
        _sync(torch, device)
        check(B.LAUNCHES == {"p2_rt_group": 1},
              f"round-trip group {bits}-bit: launches {B.LAUNCHES}")
        plain = CB.roundtrip_many_plain(xs, steps, bits)
        prev = [roundtrip(x, spec, st, "cuda") for x, st in zip(xs, steps)]
        again = CB.roundtrip_many(xs, steps, bits)
        for n, (y, r, p_, a) in enumerate(zip(ys, plain, prev, again)):
            check(_bits_equal(torch, y, r) and _bits_equal(torch, y, p_)
                  and _bits_equal(torch, y, a),
                  f"round-trip group {bits}-bit leaf {n}: not bit-exact "
                  "with the twin or the per-leaf route, or not repeatable")
            check(not torch.signbit(y[y == 0]).any(),
                  f"round-trip group {bits}-bit leaf {n}: a -0.0")
        qmax = 2 ** (bits - 1)
        scales = [2.0 ** st.item() for st in steps]
        n = sum(x.numel() for x in xs)
        row = dict(shape=[list(x.shape) for x in xs], bits=bits,
                   dtype="float32", what=f"export {bits}-bit group",
                   entries=len(xs), max_abs_err=0.0)
        row["ms"] = timer(lambda: CB.roundtrip_many(xs, steps, bits))
        row["previous_ms"] = timer(lambda: [
            roundtrip(x, spec, st, "cuda") for x, st in zip(xs, steps)])
        row["plain_ms"] = timer(
            lambda: CB.roundtrip_many_plain(xs, steps, bits), iters=10)
        row["library_ms"], row["library_note"] = _library_yardstick(
            timer, lambda: [torch.fake_quantize_per_tensor_affine(
                x, scales[i], 0, -qmax, qmax - 1) for i, x in enumerate(xs)],
            lambda r: all(torch.equal(a, b) for a, b in zip(r, ys)))
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * n * 4 + 4 * len(xs), 4 * n, FP32_OPS_PER_S)
        log(f"p2_rt_group export {bits}-bit ({len(xs)} leaves, {n} "
            f"elements): {row['ms']*1e3:.2f} us one launch (per-leaf "
            f"p2_enc + p2_dec {row['previous_ms']*1e3:.2f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us, library loop "
            f"{row['library_note']}, bound {row['bound_ms']*1e3:.4f} us); "
            "bit-exact with the twin and the per-leaf route, +0.0 zeros, "
            "two launches equal")
        rows.append(row)
    return rows


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
    # through the grouped round trip (one p2_rt_group launch a bit width),
    # bit for bit with the plain versions on the CPU, zeros' sign included
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
        check(export_launches == {"p2_rt_group": 2},
              f"BinaryConnect export launches {export_launches}, want 2 "
              f"p2_rt_group for its {n_leaves} leaves")
    plain = quantize_for_deploy(_tensor_tree(torch, params, "cpu"), d.qc)
    for (path, a), (_, b) in zip(flatten_with_path(deploy),
                                 flatten_with_path(plain)):
        check(_bits_equal(torch, a.cpu(), b), f"deploy export: {path} "
              "differs")
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
    prof = _profile_train(torch, one, TF.launches_per_step(d)) \
        if device == "cuda" else None
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
           if getattr(e, "device_type", None) == cuda and dev(e) > 0
           and "spin_kernel" not in e.key]
    total = sum(dev(e) for e in evs) / steps / 1e3
    top = sorted(evs, key=dev, reverse=True)[:12]
    return total, [{"name": e.key[:80], "calls_per_step": e.count / steps,
                    "ms_per_step": dev(e) / steps / 1e3} for e in top]


# launch-count name -> the kernel function's name in a profile (the
# MLP's f32 steps: PE2 and PE3 on the CUDA cores)
KERNEL_FN = {"pe1": "pe1_kernel", "pe2": "pe2_kernel", "pe3": "pe3_kernel",
             "p2_fake_quant": "p2_fq_group_kernel",
             "bw_enc": "bw_enc_group_kernel", "bw_dec": "bw_dec_group_kernel"}
# the LM's bf16 step: PE1, PE2 and PE3 on the tensor cores, and none of
# their launches on the CUDA-core kernels
LM_KERNEL_FN = {**KERNEL_FN, "pe1": "pe1_mma_kernel",
                "pe2": "pe2_mma_kernel", "pe3": "pe3_mma_kernel"}
LM_ABSENT_FN = ("pe1_kernel", "pe2_kernel", "pe3_kernel")


def _launch_times(torch, prof, names) -> dict:
    """Each launch's device µs of the named kernel functions in a profile,
    longest first (a profile key holds ``name<``, the template's start)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {name: [] for name in names}
    for e in prof.events():
        if getattr(e, "device_type", None) != cuda:
            continue
        for name in names:
            if f"{name}<" in e.name:
                out[name].append(e.time_range.elapsed_us())
    return {name: sorted(v, reverse=True) for name, v in out.items()}


def _profile_train(torch, one, per: dict, steps: int = 20, fn=KERNEL_FN,
                   absent=(), times=()):
    """Host wall of ``steps`` unprofiled training steps (``one(i)`` runs
    step i), then one profiled window of as many for the device time per
    kernel. busy_share = device time / wall time. Each kernel of ``per``
    (the step's ``launches_per_step``) must appear in the profile as often
    a step, by its function's name (``fn``), and the functions named in
    ``absent`` not at all. ``times``: kernel functions whose every
    launch's device time the result lists (``launch_us``)."""
    import itertools
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        one(i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    want = {fn[k]: float(v) for k, v in per.items()}
    batch = itertools.count(steps)              # the next batch's index
    prof, kern = _profile_window(
        torch, lambda: [one(next(batch)) for _ in range(steps)], steps,
        [*want, *absent], want, "train")
    total, rows = _device_summary(torch, prof, steps)
    log(f"train profile: {wall*1e3:.2f} ms per step (host wall), device "
        f"{total:.3f} ms busy, busy share {total / (wall*1e3):.3f}")
    for r in rows:
        log(f"  {r['ms_per_step']*1e3:8.1f} us  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    _log_kernels(kern)
    launch_us = _launch_times(torch, prof, times)
    for name, us in launch_us.items():
        log(f"  {name}: {len(us)} launches, {sum(us):.1f} us; longest "
            f"{[round(u, 1) for u in us[:8]]}, the other {len(us[8:])} "
            f"{sum(us[8:]):.1f} us")
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows,
            "kernels": kern, "launch_us": launch_us}


LEAD_MARGIN = 8             # leading spins beyond twice the most lost
LEAD_CYCLES = 2_000_000     # each ~1 ms on an H100
TRAIL_SPINS = 8             # spins after a window, each ~0.5 µs
TRAIL_CYCLES = 1000
LEAD_LOST = [0]             # the most leading spins a window of this
                            # process lost


def _lead_spins() -> int:
    """Leading spins for the next profiled window: twice the most any
    earlier window lost, plus ``LEAD_MARGIN``."""
    return 2 * LEAD_LOST[0] + LEAD_MARGIN


def _pad_window(torch, n: int, cycles: int) -> None:
    """``n`` spin kernels of ``cycles`` between synchronisations at an edge
    of a profiled window. The trace drops device events at a window's
    start, and the leading spins are the ones it may drop; the end pads
    stay whole. The cause is not known. How many it drops differs between
    windows and grows, though not steadily, over a process's profiler
    sessions (an H100 run of this script with 64 leading spins of ~1 ms:
    0, 0, 5, 0, 11, 14, 16 and 19 lost in its eight windows, in order).
    ``_profile_window`` logs what each window kept; ``_device_summary``
    leaves the spins out."""
    torch.cuda.synchronize()
    for _ in range(n):
        torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def _kernel_profile(torch, prof, steps: int, names) -> dict:
    """Launches and device ms per step of the named kernel functions (a
    profile key holds ``name<``, the template's start)."""
    cuda = torch.autograd.DeviceType.CUDA
    calls, us = {}, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != cuda:
            continue
        for name in names:
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
BW_DEC_GROUP_NONE = ("none: no one PyTorch call dequantizes a list of "
                     "tensors (one per-channel dequantize a leaf)")


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


def _bw_group_rows(torch, timer, gen, device) -> tuple[list, list]:
    """The step's two encode groups, each in one launch: the 34 moments (m
    and v of the 17 Adam leaves, block 256) and the 21 wire leaves
    (flattened, block 1024), random, each leaf's first quarter zero (all-
    zero blocks). Codes and scales bit for bit with the twin, with the
    loop of one-entry launches and over two launches; timed beside that
    loop (``previous_ms``); the bound is the group's bytes. Then the two
    decode groups of those codes, likewise. Returns (encode rows, decode
    rows)."""
    from repro_torch import numerics as TN
    from repro_torch.kernels import build as B
    from repro_torch.kernels import grouped as G
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.numerics import cuda_backend as CB
    from repro_torch.optim import adam as A
    from repro_torch.tree import flatten_with_path
    d = MLP.make_mlp()
    params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0), d,
                          device=device)
    flat = dict(flatten_with_path(params))

    def data(shape):
        x = torch.randn(shape, generator=gen, device=device) * 0.05
        x.view(-1)[:x.numel() // 4] = 0.0
        return x.reshape(-1, x.shape[-1] if x.dim() else 1)
    moments = [data(flat[k].shape) for _ in "mv"
               for k in A.adam_leaf_paths(params)]
    wire = [data((leaf.numel(),)) for leaf in flat.values()
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    check((len(moments), len(wire)) == (34, 21),
          f"leaf sets {len(moments)} / {len(wire)}, want 34 / 21")
    rows, dec_rows = [], []
    for what, xs, block in (("group moments", moments, 256),
                            ("group wire", wire, 1024)):
        check(not any(lf.stream for launch in G.bw_plan(
            [tuple(x.shape) for x in xs], block) for lf in launch.leaves),
              f"bw_enc {what}: a leaf planned for stream tasks")
        _sync(torch, device)
        B.reset_launches()
        got = CB.bw_encode_many(xs, block)
        _sync(torch, device)
        check(B.LAUNCHES == {"bw_enc": 1},
              f"bw_enc {what}: launches {B.LAUNCHES}")
        again = CB.bw_encode_many(xs, block)
        zero = 0
        for i, (x, (c, sc), (rc, rs), (ac, asc)) in enumerate(zip(
                xs, got, CB.bw_encode_many_plain(xs, block), again)):
            oc, osc = CB.bw_encode(x, block)
            check(torch.equal(c, rc) and _bits_equal(torch, sc, rs),
                  f"bw_enc {what} leaf {i}: differs from the twin")
            check(torch.equal(c, oc) and _bits_equal(torch, sc, osc),
                  f"bw_enc {what} leaf {i}: differs from a one-entry launch")
            check(torch.equal(ac, c) and _bits_equal(torch, asc, sc),
                  f"bw_enc {what} leaf {i}: two launches differ")
            zero += int((sc == 0).sum().item())
        check(zero > 0, f"bw_enc {what}: no all-zero block")
        nbytes = n = 0
        for x in xs:
            rws, last = x.shape
            b, nb, _ = TN.blockwise_geometry(
                TN.QuantSpec("blockwise", 8, block), last)
            nbytes += rws * last * 4 + rws * nb * (b + 4)
            n += rws * last
        row = dict(shape=[list(x.shape) for x in xs], block=block,
                   what=what, entries=len(xs), max_abs_err=0.0,
                   ms=timer(lambda: CB.bw_encode_many(xs, block)),
                   previous_ms=timer(lambda: [CB.bw_encode(x, block)
                                              for x in xs]),
                   plain_ms=timer(lambda: CB.bw_encode_many_plain(xs, block),
                                  iters=10),
                   library_ms=None, library_note=BW_ENC_NONE)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 4 * n,
                                                    FP32_OPS_PER_S)
        log(f"bw_enc {what} ({len(xs)} leaves, {n} elements): "
            f"{row['ms']*1e3:.1f} us one launch (one-entry loop "
            f"{row['previous_ms']*1e3:.1f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us, bound {row['bound_ms']*1e3:.3f}"
            f" us); bit-exact, {zero} all-zero blocks, two launches equal")
        rows.append(row)
        dec_rows.append(_bw_dec_group_row(torch, timer, got, xs, block,
                                          what, device))
    return rows, dec_rows


def _bw_dec_group_row(torch, timer, pairs, xs, block, what, device) -> dict:
    """One decode group (the codes and scales ``pairs`` of the leaves
    ``xs``) in one launch: values bit for bit with the twin, with the
    one-entry launches and over two launches, in one output buffer; timed
    beside the loop of one-entry launches (``previous_ms``)."""
    from repro_torch.kernels import build as B
    from repro_torch.numerics import cuda_backend as CB
    codes, scales = [c for c, _ in pairs], [sc for _, sc in pairs]
    lasts = [x.shape[1] for x in xs]
    _sync(torch, device)
    B.reset_launches()
    ys = CB.bw_decode_many(codes, scales, lasts)
    _sync(torch, device)
    check(B.LAUNCHES == {"bw_dec": 1},
          f"bw_dec {what}: launches {B.LAUNCHES}")
    check(len({y.untyped_storage().data_ptr() for y in ys}) == 1,
          f"bw_dec {what}: values not in one buffer")
    again = CB.bw_decode_many(codes, scales, lasts)
    for i, (c, sc, last, y, r, a) in enumerate(zip(
            codes, scales, lasts, ys,
            CB.bw_decode_many_plain(codes, scales, lasts), again)):
        check(_bits_equal(torch, y, r),
              f"bw_dec {what} leaf {i}: differs from the twin")
        check(_bits_equal(torch, y, CB.bw_decode(c, sc, last)),
              f"bw_dec {what} leaf {i}: differs from a one-entry launch")
        check(_bits_equal(torch, a, y),
              f"bw_dec {what} leaf {i}: two launches differ")
    n = sum(x.numel() for x in xs)
    nbytes = sum(c.numel() * c.element_size() + sc.numel() * 4
                 for c, sc in pairs) + 4 * n
    row = dict(shape=[list(x.shape) for x in xs], block=block, what=what,
               entries=len(xs), max_abs_err=0.0,
               ms=timer(lambda: CB.bw_decode_many(codes, scales, lasts)),
               previous_ms=timer(lambda: [
                   CB.bw_decode(c, sc, last)
                   for c, sc, last in zip(codes, scales, lasts)]),
               plain_ms=timer(lambda: CB.bw_decode_many_plain(
                   codes, scales, lasts), iters=10),
               library_ms=None, library_note=BW_DEC_GROUP_NONE)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, n, FP32_OPS_PER_S)
    log(f"bw_dec {what} ({len(xs)} leaves, {n} elements): "
        f"{row['ms']*1e3:.1f} us one launch (one-entry loop "
        f"{row['previous_ms']*1e3:.1f} us, plain {row['plain_ms']*1e3:.1f} "
        f"us, bound {row['bound_ms']*1e3:.3f} us); bit-exact, one output "
        "buffer, two launches equal")
    return row


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


def _export_cores(torch, device):
    """The deploy export's six cores of the seeded FMNIST MLP, each as the
    export views it: ((1, n) values, (1,) step), largest first."""
    from repro_torch.models import mlp_tt as MLP
    d = MLP.make_mlp()
    params = MLP.init_mlp(torch.Generator(device=device).manual_seed(0), d,
                          device=device)
    cores = [(f"{layer}/core_{n}", params[layer][f"core_{n}"].reshape(1, -1),
              params[layer]["wscale_log2"][n].float().reshape(1))
             for layer, spec in (("l1", d.spec1), ("l2", d.spec2))
             for n in range(spec.d)]
    return sorted(cores, key=lambda c: -c[1].numel())


def _packed_group_rows(torch, timer, device) -> tuple[dict, dict]:
    """The deploy export's six cores through the packed encode group and
    its bytes through the decode group, one launch each: bit for bit with
    the twin, with the one-entry launches and over two launches, in one
    buffer; timed beside the loop of one-entry launches (``previous_ms``),
    the twin and the byte bound. Returns (encode row, decode row)."""
    from repro_torch.kernels import build as B
    from repro_torch.numerics import cuda_backend as CB
    cores = _export_cores(torch, device)
    xs = [x for _, x, _ in cores]
    ss = [s for _, _, s in cores]
    lasts = [x.shape[1] for x in xs]
    _sync(torch, device)
    B.reset_launches()
    ps = CB.encode_packed_many(xs, ss, 4)
    ys = CB.decode_packed_many(ps, ss, lasts)
    _sync(torch, device)
    check(B.LAUNCHES == {"p2_enc_packed": 1, "p2_dec_packed": 1},
          f"packed groups: launches {B.LAUNCHES}")
    check(len({p.untyped_storage().data_ptr() for p in ps}) == 1
          and len({y.untyped_storage().data_ptr() for y in ys}) == 1,
          "packed groups: not one buffer each")
    again_p = CB.encode_packed_many(xs, ss, 4)
    again_y = CB.decode_packed_many(ps, ss, lasts)
    for i, (x, s, last, p, y, tp, ty, ap, ay) in enumerate(zip(
            xs, ss, lasts, ps, ys, CB.encode_packed_many_plain(xs, ss, 4),
            CB.decode_packed_many_plain(ps, ss, lasts), again_p, again_y)):
        check(torch.equal(p, tp) and _bits_equal(torch, y, ty),
              f"packed group core {i}: differs from the twin")
        check(torch.equal(p, CB.encode_packed(x, s, 4))
              and _bits_equal(torch, y, CB.decode_packed(p, s, last)),
              f"packed group core {i}: differs from a one-entry launch")
        check(torch.equal(ap, p) and _bits_equal(torch, ay, y),
              f"packed group core {i}: two launches differ")
    n = sum(lasts)
    nbytes = sum(p.numel() for p in ps) + 4 * n + 4 * len(ss)
    shape = [list(x.shape) for x in xs]
    enc = dict(shape=shape, what="group export cores", entries=len(xs),
               max_abs_err=0.0,
               ms=timer(lambda: CB.encode_packed_many(xs, ss, 4)),
               previous_ms=timer(lambda: [CB.encode_packed(x, s, 4)
                                          for x, s in zip(xs, ss)]),
               plain_ms=timer(lambda: CB.encode_packed_many_plain(xs, ss, 4),
                              iters=10),
               library_ms=None, library_note=PACKED_NONE)
    enc["bound_ms"], enc["bound_by"] = bound_ms(nbytes, 4 * n,
                                                FP32_OPS_PER_S)
    dec = dict(shape=shape, what="group export cores", entries=len(xs),
               max_abs_err=0.0,
               ms=timer(lambda: CB.decode_packed_many(ps, ss, lasts)),
               previous_ms=timer(lambda: [
                   CB.decode_packed(p, s, last)
                   for p, s, last in zip(ps, ss, lasts)]),
               plain_ms=timer(lambda: CB.decode_packed_many_plain(
                   ps, ss, lasts), iters=10),
               library_ms=None, library_note=PACKED_NONE)
    dec["bound_ms"], dec["bound_by"] = bound_ms(nbytes, 2 * n,
                                                FP32_OPS_PER_S)
    for what, row in (("p2_enc_packed", enc), ("p2_dec_packed", dec)):
        log(f"{what} group ({len(xs)} cores, {n} elements): "
            f"{row['ms']*1e3:.2f} us one launch (one-entry loop "
            f"{row['previous_ms']*1e3:.2f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us, bound {row['bound_ms']*1e3:.4f}"
            " us); bit-exact, one buffer, two launches equal")
    return enc, dec


def phase_wire_kernels(torch, timer: Timer, device: str = "cuda") -> dict:
    """The wire's codec kernels against their plain versions, bit for bit,
    at the shapes of the step: every Adam moment shape at block 256 and
    every flattened gradient length of the wire at block 1024, a padded
    (3, 1000) at 256 with an all-zero block; the packed codec on the six
    cores at their wscale_log2, a stacked (3, 5, 7) with a step per row,
    and a scalar (groups of one), after the export's six cores as one
    group each way."""
    from repro_torch.kernels import build as B
    gen = torch.Generator(device=device).manual_seed(3)
    cases = [(s, 256, "moment") for s in MOMENT_SHAPES]
    cases += [((n,), 1024, "wire") for n in WIRE_LENGTHS]
    cases += [((3, 1000), 256, "padded")]
    # the groups first: the main path launches them (the kernels line
    # reads each kernel's first row)
    enc, dec = _bw_group_rows(torch, timer, gen, device)
    for shape, block, what in cases:
        e, d_ = _bw_row(torch, timer, shape, block, gen, what)
        enc.append(e)
        dec.append(d_)
    e, d_ = _packed_group_rows(torch, timer, device)
    penc, pdec = [e], [d_]
    cores = [(what, x.reshape(-1), s.reshape(()))
             for what, x, s in _export_cores(torch, device)]
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
    n_wire = sum(1 for g in leaves(grads) if g is not None
                 and g.is_floating_point())
    if device == "cuda":
        check(export_launches == {"p2_enc_packed": 1, "p2_dec_packed": 1,
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
    prof = _profile_train(torch, one, per) if device == "cuda" else None
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
    from repro_torch.core import quant as TQ
    from repro_torch.kernels import build as B
    from repro_torch.numerics import cuda_backend as CB
    gen = torch.Generator(device=device).manual_seed(4)
    out = {"p2_enc": [], "p2_dec": [], "p2_fq_rows": []}

    def scale_for(x):
        return torch.ceil(torch.log2(x.float().abs().amax() / 127)) - 1

    # --- p2_enc: at the previous chunk write's (S_chunk, Hkv, Dh), odd and
    # unaligned
    base = torch.randn(128 * 8 * 128 + 1, generator=gen, device=device) * 3
    cases = [((128, 8, 128), torch.bfloat16, "previous chunk write bf16",
              None),
             ((128, 8, 128), torch.float32, "previous chunk write f32", None),
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

    # --- p2_dec: at the previous history read's (1, max_len, Hkv, Dh), odd,
    # unaligned
    codes = torch.randint(-128, 128, (1024 * 8 * 128 + 1,), generator=gen,
                          device=device).to(torch.int8)
    cases = [((1, 1024, 8, 128), torch.bfloat16,
              "previous slot history read bf16", 0),
             ((1, 1024, 8, 128), torch.float32,
              "previous slot history read f32", 0),
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
    log(f"codec API fake_quant, (24,) scales: launches {api}")
    # --- and a per-layer decode, the row decode's one caller since the
    # gather engine reads through p2_read_paged
    spec = TN.QuantSpec("pow2", 8)
    q = torch.randint(-128, 128, (24, 8, 16384), generator=gen,
                      device=device).to(torch.int8)
    _sync(torch, device)
    B.reset_launches()
    y = TN.get_codec(spec, "cuda").decode(TN.QTensor(q, s, spec),
                                          torch.bfloat16)
    _sync(torch, device)
    dec = dict(B.LAUNCHES)
    check(dec == {"p2_dec_rows": 1}, f"codec API decode launches {dec}")
    want = CB.decode_rows_plain(q.reshape(24, -1), s, torch.bfloat16)
    check(torch.equal(y, want.reshape(q.shape)),
          "codec API decode differs from the row decode's twin")
    log(f"codec API decode, (24,) scales: launches {dec}")
    # --- a per-layer encode, the row encode's one caller since the
    # prefill writes through p2_prefill_paged, and a one-step round trip
    # (core.quant.quantize_store), the scalar codec's since the export
    # runs one grouped round trip a bit width
    xe = (torch.randn((24, 8, 16384), generator=gen, device=device) * 0.05
          ).to(torch.bfloat16)
    w = torch.randn((16, 4, 4, 16), generator=gen, device=device) * 0.1
    _sync(torch, device)
    B.reset_launches()
    qt = TN.encode(xe, spec, s, backend="cuda")
    rt = TQ.quantize_store(w, torch.tensor(-5.0, device=device), 4)
    _sync(torch, device)
    enc = dict(B.LAUNCHES)
    check(enc == {"p2_enc_rows": 1, "p2_enc": 1, "p2_dec": 1},
          f"codec API encode and round trip launches {enc}")
    check(torch.equal(qt.codes, CB.encode_rows_plain(
        xe.reshape(24, -1), s, 8).reshape(xe.shape)) and _bits_equal(
        torch, rt, CB.roundtrip_many_plain(
            [w], [torch.tensor([-5.0], device=device)], 4)[0]),
        "codec API encode or round trip differs from its twin")
    log(f"codec API encode, (24,) scales, and a one-step round trip: "
        f"launches {enc}")
    out["api_launches"] = {**api, **dec, **enc}
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
    layers = cfg.num_layers
    check(s["requests_completed"] == len(prompts), "requests lost")
    check(s["prefix_hit_tokens"] > 0 and s["cow_forks"] > 0
          and s["pages_saved"] > 0, f"prefix cache: {s}")
    # a chunk step reads its history once a layer (p2_read_paged) and
    # writes its chunk once a layer (p2_append_paged, counted with the
    # decode appends below); the scalar codec no longer runs
    check(steps > 0 and launches.get("p2_read_paged", 0) == layers * steps
          and not {"p2_enc", "p2_dec", "p2_dec_rows"} & set(launches),
          f"chunk steps {steps}: launches {launches}, want {layers} "
          f"p2_read_paged and p2_append_paged per step and no p2_enc, "
          "p2_dec or p2_dec_rows")
    check(launches.get("paged_attention", 0)
          == s["decode_steps"] * cfg.num_layers
          == launches.get("paged_attention_combine", 0),
          f"{launches.get('paged_attention', 0)} attention launches for "
          f"{s['decode_steps']} decode steps")
    _check_appends("serve chunked prefix", launches, s,
                   sum(1 for _, hit in eng.metrics.prefills if not hit), cfg,
                   chunk_steps=steps)
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
            "chunk_profile": _profile_chunk(
                torch, lm, params, prompts,
                want={"p2_append_paged_kernel": layers,
                      "p2_read_paged_kernel": layers})}


def _profile_chunk(torch, lm, params, prompts, reps: int = 10,
                   want=None, names=KV_KERNEL_FNS,
                   what: str = "chunk step", cpu: bool = True) -> dict:
    """One chunk step at full width (128 tokens at position 256 of a slot
    whose history holds 384 prompt tokens), repeated: host wall per step
    (synchronised), then one profiled window for the device time per
    kernel. The step rewrites the same positions with the same values."""
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
    prof, kern = _profile_window(
        torch, lambda: [eng._chunk(toks, table_row, 0, 256)
                        for _ in range(reps)], reps, names,
        _kv_want(want), what, cpu=cpu)
    total, rows = _device_summary(torch, prof, reps)
    log(f"{what} profile: {wall*1e3:.2f} ms per step (host wall), "
        f"device {total:.2f} ms busy, busy share {total / (wall*1e3):.3f}")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    _log_kernels(kern)
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows,
            "kernels": kern}


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
# the recurrent slice: rwkv6-1.6b and jamba's Mamba layers served from the
# slot-indexed state pool (serve/state_cache.py), with static decode as the
# oracle
# ---------------------------------------------------------------------------

SSM_ARCH = "rwkv6-1.6b"
HYBRID_ARCH = "jamba-1.5-large"
PA_KV_FNS = KV_KERNEL_FNS + PA_KERNEL_FNS
ST_KERNEL_FNS = ["st_dec_group_kernel", "st_enc_group_kernel"]
STATE_FNS = PA_KV_FNS + ST_KERNEL_FNS


def _state_model(torch, arch: str, **over):
    """``arch`` at full width (``over`` replaces config fields), bf16,
    random weights from a seeded generator on the card."""
    import repro_torch.configs as C
    from repro_torch.models import build_lm, init_lm
    cfg = C.get_config(arch).replace(**over)
    lm = build_lm(cfg)
    t0 = time.perf_counter()
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), lm,
                     device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"{arch}: {cfg.num_layers} layers ({lm.n_periods} x "
        f"{len(lm.period)}: {[s.mixer_kind for s in lm.period]}), d_model "
        f"{cfg.d_model}, {n/1e9:.3f} B params {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f} s")
    return lm, params


def _state_inputs(torch, gen, rows: int, cols: int, dt):
    """A state-like (rows, cols) tensor, each row at its own magnitude, and
    the scales the state cache picks for it (``per_tensor_max`` per row)."""
    mag = torch.exp2(torch.randint(-6, 7, (rows, 1), generator=gen,
                                   device="cuda").float())
    x = (torch.randn((rows, cols), generator=gen, device="cuda") * mag
         ).to(dt)
    s = torch.ceil(torch.log2(torch.clamp(x.float().abs().amax(1), min=1e-8)
                              / 127))
    return x, s


def phase_state_kernels(torch, timer: Timer) -> dict:
    """The four codec kernels of the state path against their plain
    versions at the state shapes of both served models, codes and values
    bit for bit: the decode step's read and write of 8 slots
    (``p2_dec_rows`` / ``p2_enc_rows``; rwkv6-1.6b's ``wkv`` 8 x 32 x 64
    x 64 f32 and ``shift`` 8 x 2,048 bf16, jamba's Mamba ``h`` 8 x 16,384
    x 16 f32 and ``conv`` 8 x 3 x 16,384 bf16), rwkv6's whole-prompt
    prefill write of the 24-layer stack (``p2_enc_rows``, 24 x 131,072
    f32), and one slot (``p2_enc`` / ``p2_dec``: the chunk step's, and
    jamba's one-layer prefill write). Each timed beside its plain version,
    the byte bound and a library call (per-channel / per-tensor quantize
    and dequantize where their codes or values match)."""
    from repro_torch.numerics import cuda_backend as CB
    gen = torch.Generator(device="cuda").manual_seed(6)
    wkv, h, conv = 32 * 64 * 64, 16384 * 16, 3 * 16384
    out = {"p2_enc_rows": [], "p2_dec_rows": [], "p2_enc": [],
           "p2_dec": []}

    def row(name, what, shape, ms, pms, lib, nbytes, exact):
        check(exact, f"{name} {what}: differs from its plain version")
        bms, by = bound_ms(nbytes)
        r = dict(shape=list(shape), what=what, ms=ms, plain_ms=pms,
                 library_ms=lib[0], library_note=lib[1], bound_ms=bms,
                 bound_by=by, max_abs_err=0)
        out[name].append(r)
        log(f"{name} state {what} {tuple(shape)}: {ms*1e3:.2f} us (plain "
            f"{pms*1e3:.1f} us, library {lib[1]}, bound {bms*1e3:.3f} us), "
            "bit for bit")

    for rows, cols, dt, what in ((8, wkv, torch.float32, "decode wkv 8 slots"),
                                 (8, 2048, torch.bfloat16,
                                  "decode shift 8 slots"),
                                 (24, wkv, torch.float32,
                                  "prefill wkv 24 layers"),
                                 (8, h, torch.float32,
                                  "jamba decode h 8 slots"),
                                 (8, conv, torch.bfloat16,
                                  "jamba decode conv 8 slots")):
        x, s = _state_inputs(torch, gen, rows, cols, dt)
        q = CB.encode_rows(x, s, 8)
        row("p2_enc_rows", what, (rows, cols),
            timer(lambda: CB.encode_rows(x, s, 8)),
            timer(lambda: CB.encode_rows_plain(x, s, 8), iters=10),
            _library_yardstick(timer, lambda: _library_encode(torch, x, s),
                               lambda r: torch.equal(r.int_repr(), q)),
            rows * cols * (x.element_size() + 1) + rows * 4,
            torch.equal(q, CB.encode_rows_plain(x, s, 8)))
        if rows == 8:
            y = CB.decode_rows(q, s, dt)
            row("p2_dec_rows", what, (rows, cols),
                timer(lambda: CB.decode_rows(q, s, dt)),
                timer(lambda: CB.decode_rows_plain(q, s, dt), iters=10),
                _library_yardstick(
                    timer, lambda: _library_decode(torch, q, s, dt),
                    lambda r: _bits_equal(torch, r, y)),
                rows * cols * (1 + y.element_size()) + rows * 4,
                _bits_equal(torch, y, CB.decode_rows_plain(q, s, dt)))
    for cols, dt, what in ((wkv, torch.float32, "chunk wkv one slot"),
                           (2048, torch.bfloat16, "chunk shift one slot"),
                           (h, torch.float32,
                            "jamba prefill / chunk h one slot"),
                           (conv, torch.bfloat16,
                            "jamba prefill / chunk conv one slot")):
        x, s = _state_inputs(torch, gen, 1, cols, dt)
        x, s = x[0], s.reshape(1)
        q = CB.encode_scalar(x, s, 8)
        row("p2_enc", what, (cols,), timer(lambda: CB.encode_scalar(x, s, 8)),
            timer(lambda: CB.encode_scalar_plain(x, s, 8), iters=10),
            _library_yardstick(
                timer, lambda: _library_encode_scalar(torch, x, s),
                lambda r: torch.equal(r, q)),
            cols * (x.element_size() + 1) + 4,
            torch.equal(q, CB.encode_scalar_plain(x, s, 8)))
        y = CB.decode_scalar(q, s, dt)
        row("p2_dec", what, (cols,), timer(lambda: CB.decode_scalar(q, s, dt)),
            timer(lambda: CB.decode_scalar_plain(q, s, dt), iters=10),
            _library_yardstick(
                timer, lambda: _library_decode_scalar(torch, q, s, dt),
                lambda r: _bits_equal(torch, r, y)),
            cols * (1 + y.element_size()) + 4,
            _bits_equal(torch, y, CB.decode_scalar_plain(q, s, dt)))
    return out


# the decode step's state pool: (layers, feature shape, dtype) of each
# tensor, as state_cache lays them out for 8 slots
RWKV6_STEP = [(24, (1, 2048), "bfloat16"), (24, (32, 64, 64), "float32"),
              (24, (1, 2048), "bfloat16")]            # shift, wkv, shift_ffn
JAMBA_STEP = [(1, (3, 16384), "bfloat16"), (1, (16384, 16), "float32")] * 7
STATE_SLOTS = 8
INACTIVE_SLOT = 5
ST_NONE = ("none: no PyTorch call chooses pow-2 scales per row and codes a "
           "list of tensors")


def _edge_values(torch, dt, k: int) -> list:
    """``127 * 2^k`` in ``dt`` and the three values of ``dt`` either side."""
    iv = torch.int16 if dt == torch.bfloat16 else torch.int32
    base = torch.tensor([127.0 * 2.0 ** k], dtype=dt).view(iv)
    return [float((base + d).view(dt)) for d in range(-3, 4)]


def _state_step_case(torch, gen, entries, active):
    """A decode step's state pool at ``entries`` (random codes and scales)
    and its new states (each (layer, slot) row at its own magnitude); the
    first two tensors' first active rows hold a max at ``127 * 2^k`` and its
    neighbours (k = -3 and 2), and the third tensor's first row is all
    zero."""
    dts = [getattr(torch, d) for _, _, d in entries]
    codes, scales, news = [], [], []
    for (layers, feat, _), dt in zip(entries, dts):
        cols = math.prod(feat)
        codes.append(torch.randint(-128, 128, (layers, STATE_SLOTS) + feat,
                                   generator=gen, device="cuda",
                                   dtype=torch.int8))
        scales.append(torch.randint(-12, 4, (layers, STATE_SLOTS),
                                    generator=gen, device="cuda").float())
        news.append([_state_inputs(torch, gen, STATE_SLOTS, cols, dt)[0]
                     .reshape((STATE_SLOTS,) + feat)
                     for _ in range(layers)])
    for e, k in ((0, -3), (1, 2)):
        lay_rows = [(lay, b) for lay in range(entries[e][0])
                    for b in range(STATE_SLOTS) if bool(active[b])]
        for (lay, b), v in zip(lay_rows, _edge_values(torch, dts[e], k)):
            row = news[e][lay][b].reshape(-1)
            row.copy_((row.float() / row.float().abs().max() * (v / 2))
                      .to(dts[e]))
            row[0] = -v if b % 2 else v
    news[2][0][0].zero_()                   # slot 0 is active
    return codes, scales, news, dts


def _state_layer_read(torch, SC, scfg, codes, scales, dts):
    """The per-layer route's read (the previous design): ``read_layer`` a
    (layer, tensor), stacked."""
    return [torch.stack([SC.read_layer(q[lay], s[lay], dt, scfg)
                         for lay in range(q.shape[0])])
            for q, s, dt in zip(codes, scales, dts)]


def _state_layer_write(SC, scfg, codes, scales, news, active):
    """The per-layer route's write (the previous design): ``write_layer`` a
    (layer, tensor)."""
    for q, s, layers in zip(codes, scales, news):
        for lay, new in enumerate(layers):
            SC.write_layer(q[lay], s[lay], new, active, scfg)


def _state_bytes(codes, news, active_rows: int) -> int:
    """Bytes the step's decode (or encode) must move: every code read and
    every value written once (or the reverse), and the scales, for
    ``active_rows`` of each tensor's (layer, slot) rows."""
    total = 0
    for q, layers in zip(codes, news):
        rows = q.shape[0] * q.shape[1]
        per = math.prod(q.shape[2:]) * (1 + layers[0].element_size()) + 4
        total += per * rows * active_rows // q.shape[1]
    return total


def phase_state_group(torch, timer: Timer) -> dict:
    """The decode step's two state launches at full shapes: rwkv6-1.6b's
    pool (24 layers x shift, wkv, shift_ffn; 8 slots) and jamba's period (7
    Mamba layers x conv, h), slot 5 inactive, the scale edges and an
    all-zero row in it (``_state_step_case``). ``st_dec_group`` decodes the
    whole pool and ``st_enc_group`` encodes every new state, each bit for
    bit with its plain twin (run on the card) and with the per-layer route
    (``read_layer`` / ``write_layer``: p2_dec_rows, the scale's eager ops,
    p2_enc_rows, two masked copies), codes, scales and values, the
    inactive slot's codes and scales untouched; each one launch (the
    plan's count). Then, every slot active, each timed beside the
    per-layer route (``previous_ms``), its plain twin and the byte bound;
    the encode also re-reading its values in the second pass where the
    plan stages them in shared memory (``reread_ms``, held bit for bit
    too)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import grouped as G
    from repro_torch.numerics import cuda_backend as CB
    from repro_torch.serve import state_cache as SC
    scfg = SC.StateCacheConfig(quantized=True)
    gen = torch.Generator(device="cuda").manual_seed(28)
    out = {"st_dec_group": [], "st_enc_group": []}
    for what, entries in (("rwkv6-1.6b decode step", RWKV6_STEP),
                          ("jamba period decode step", JAMBA_STEP)):
        active = torch.ones(STATE_SLOTS, dtype=torch.bool, device="cuda")
        active[INACTIVE_SLOT] = False
        codes, scales, news, dts = _state_step_case(torch, gen, entries,
                                                    active)
        B.reset_launches()
        ys = CB.state_decode_many(codes, scales, dts)
        n_dec = dict(B.LAUNCHES)
        want_dec = len(G.st_dec_plan([(q.shape[0] * q.shape[1],
                                       math.prod(q.shape[2:]))
                                      for q in codes]))
        check(n_dec == {"st_dec_group": want_dec},
              f"st_dec_group {what}: launches {n_dec}, want {want_dec}")
        ok_plain = all(_bits_equal(torch, y, r) for y, r in zip(
            ys, CB.state_decode_many_plain(codes, scales, dts)))
        ok_prev = all(_bits_equal(torch, y, r) for y, r in zip(
            ys, _state_layer_read(torch, SC, scfg, codes, scales, dts)))
        check(ok_plain and ok_prev, f"st_dec_group {what}: differs from its "
              f"twin ({ok_plain}) or the per-layer route ({ok_prev})")
        pools = [([q.clone() for q in codes], [s.clone() for s in scales])
                 for _ in range(4)]
        B.reset_launches()
        CB.state_encode_many(*pools[0], news, active, 8)
        n_enc = dict(B.LAUNCHES)
        want_enc = len(G.st_enc_plan([
            (q.shape[0], STATE_SLOTS, math.prod(q.shape[2:]),
             dt.itemsize) for q, dt in zip(codes, dts)]))
        check(n_enc == {"st_enc_group": want_enc},
              f"st_enc_group {what}: launches {n_enc}, want {want_enc}")
        CB.state_encode_many_plain(*pools[1], news, active, 8)
        _state_layer_write(SC, scfg, *pools[2], news, active)
        CB._st_encode(*pools[3], news, active, 8, reread=True)
        for name, (qs, ss) in (("twin", pools[1]), ("per-layer", pools[2]),
                               ("re-read", pools[3])):
            check(all(torch.equal(a, b) for a, b in zip(pools[0][0], qs))
                  and all(_bits_equal(torch, a, b)
                          for a, b in zip(pools[0][1], ss)),
                  f"st_enc_group {what}: codes or scales differ from the "
                  f"{name} route")
        off = ~active
        check(all(torch.equal(a[:, off], b[:, off]) for a, b in
                  zip(pools[0][0] + pools[0][1], codes + scales)),
              f"st_enc_group {what}: the inactive slot was written")
        edges = [float(s) for s in pools[0][1][0].reshape(-1)[:8]]
        log(f"state group {what}: decode and encode bit for bit with the "
            f"twins and the per-layer route; {want_dec} + {want_enc} "
            f"launches; the first edge rows' scales {edges}")
        # timed with every slot active, the steady decode step
        active.fill_(True)
        qc, sc = pools[0]
        dec_ms = timer(lambda: CB.state_decode_many(codes, scales, dts))
        dec_prev = timer(lambda: _state_layer_read(torch, SC, scfg, codes,
                                                   scales, dts), iters=10)
        dec_plain = timer(lambda: CB.state_decode_many_plain(
            codes, scales, dts), iters=5)
        enc_ms = timer(lambda: CB.state_encode_many(qc, sc, news, active, 8))
        enc_reread = timer(lambda: CB._st_encode(qc, sc, news, active, 8,
                                                 reread=True))
        enc_prev = timer(lambda: _state_layer_write(SC, scfg, qc, sc, news,
                                                    active), iters=10)
        enc_plain = timer(lambda: CB.state_encode_many_plain(
            qc, sc, news, active, 8), iters=5)
        nbytes = _state_bytes(codes, news, STATE_SLOTS)
        bms, by = bound_ms(nbytes)
        shape = [[q.shape[0], STATE_SLOTS, *q.shape[2:]] for q in codes]
        for name, ms, prev, plain, extra in (
                ("st_dec_group", dec_ms, dec_prev, dec_plain, {}),
                ("st_enc_group", enc_ms, enc_prev, enc_plain,
                 {"reread_ms": enc_reread})):
            out[name].append(dict(
                what=what, shape=shape, ms=ms, previous_ms=prev,
                plain_ms=plain, bound_ms=bms, bound_by=by, bytes=nbytes,
                library_ms=None, library_note=ST_NONE, max_abs_err=0,
                launches=want_dec if name == "st_dec_group" else want_enc,
                previous_launches=sum(q.shape[0] for q in codes), **extra))
            log(f"{name} {what}: {ms*1e3:.2f} us (per-layer route "
                f"{prev*1e3:.1f} us, plain {plain*1e3:.1f} us, bound "
                f"{bms*1e3:.2f} us, {nbytes} B"
                + (f", re-reading its values {enc_reread*1e3:.2f} us"
                   if extra else "") + ")")
    return out


def _state_group_launches(lm, slots: int = STATE_SLOTS) -> tuple[int, int]:
    """The decode step's ``st_dec_group`` and ``st_enc_group`` launches on
    ``lm``'s int8 state pool: the plans' counts."""
    from repro_torch.kernels import grouped as G
    from repro_torch.serve import state_cache as SC
    ents = [(lm.n_periods, math.prod(f), SC.natural_dtype(kind, lm.cfg)
             .itemsize) for sub in lm.period
            for f, kind in SC.state_feature_shapes(sub, lm.cfg).values()]
    return (len(G.st_dec_plan([(n * slots, f) for n, f, _ in ents])),
            len(G.st_enc_plan([(n, slots, f, i) for n, f, i in ents])))


def _state_want(lm, decode_steps: int, prefills: int = 0,
                chunk_steps: int = 0) -> dict:
    """The state codec's launches on an int8 pool: each decode step reads
    the whole pool in one group launch and writes it in another (the
    plans' counts, ``_state_group_launches``; no row kernel), each chunk
    step reads and writes the one slot's state a (layer, tensor) (scalar
    kernels), and each whole-prompt prefill writes each tensor's layer
    stack once (a row kernel, or the scalar one for a one-period stack)."""
    from repro_torch.serve import state_cache as SC
    tensors = sum(len(SC.state_feature_shapes(s, lm.cfg)) for s in lm.period)
    per = lm.n_periods * tensors
    dec, enc = _state_group_launches(lm)
    want = {"st_dec_group": dec * decode_steps,
            "st_enc_group": enc * decode_steps,
            "p2_dec": per * chunk_steps, "p2_enc": per * chunk_steps,
            "p2_enc_rows": 0}
    want["p2_enc_rows" if lm.n_periods > 1 else "p2_enc"] += \
        tensors * prefills
    return {k: v for k, v in want.items() if v}


def _state_steps(lm) -> dict:
    """The state codec's launches a decode step, a whole-prompt prefill and
    a chunk step (``_state_want``), as the kernels line reports them."""
    return {"decode": _state_want(lm, 1), "prefill": _state_want(lm, 0, 1),
            "chunk": _state_want(lm, 0, 0, 1)}


def _wkv_error_by_decay(torch, lm, params, prompt) -> dict:
    """Where the int8 state pool loses rwkv6's ``wkv``: one prompt's
    post-prompt state (``lm_forward(return_cache=True)``), coded as the
    pool codes it (one scale a layer and slot), the share of nonzero
    entries that code to 0 and the relative L2 error per quarter of the
    key channels ordered by their decay base ``w0`` (the first quarter
    decays slowest), over every layer."""
    from repro_torch.models import lm_forward
    from repro_torch.serve import state_cache as SC
    with torch.no_grad():
        _, _, cache = lm_forward(params, lm, tokens=torch.tensor(
            [prompt], device="cuda"), return_cache=True)
    scfg = SC.StateCacheConfig(quantized=True)
    x = cache["sub_0"]["wkv"][:, 0].float()          # (L, H, Dk, Dv)
    codes, step = SC._encode(x, scfg)
    y = SC._decode(codes, step, torch.float32, scfg)
    w0 = torch.stack([pp["sub_0"]["mixer"]["w0"] for pp in params["layers"]])
    rank = torch.argsort(torch.argsort(w0, dim=-1), dim=-1)
    quarter = (rank * 4 // w0.shape[-1]).reshape(x.shape[:3] + (1,)
                                                 ).expand_as(x)
    out = {"zero_share": [], "rel_l2": [], "max_abs": [],
           "prompt_len": len(prompt)}
    for qi in range(4):
        m = quarter == qi
        xs, ys = x[m], y[m]
        out["zero_share"].append(float(((ys == 0) & (xs != 0)).sum()
                                       / (xs != 0).sum()))
        out["rel_l2"].append(float((ys - xs).norm() / xs.norm()))
        out["max_abs"].append(float(xs.abs().max()))
    log(f"rwkv6 wkv coded int8 (one scale a layer and slot) after a "
        f"{len(prompt)}-token prompt, by quarter of w0 (slowest decay "
        f"first): nonzero entries coded to 0 {out['zero_share']}, relative "
        f"L2 error {out['rel_l2']}, max |wkv| {out['max_abs']}")
    return out


def _check_state_run(what, eng, launches, want, n_req) -> dict:
    s = eng.summary()
    check(launches == want, f"{what}: launches {launches}, want {want}")
    check(s["requests_completed"] == n_req, f"{what}: requests lost")
    check(all(st is None for st in eng.sched.slots) and not eng.sched.queue,
          f"{what}: a slot or the queue is not empty at the end")
    return s


def _per_layer_decode(torch, eng, table, lens, active, tokens):
    """A decode step of ``eng`` (no attention sublayer) through the
    per-layer route, the previous design: ``read_layer``, the mixer's
    forward and ``write_layer`` a (layer, tensor), p2_dec_rows and
    p2_enc_rows each. Returns (B, V) logits; the pool is written in
    place."""
    from repro_torch.models.common import apply_site, rms_norm
    from repro_torch.models.lm import STATE_MIXERS, embed_tokens
    from repro_torch.serve import state_cache as SC
    lm, params, cfg = eng.lm, eng.params, eng.lm.cfg
    check(all(sub.mixer_kind in STATE_MIXERS for sub in lm.period),
          "the per-layer replay runs recurrent sublayers only")
    x = embed_tokens(params, tokens, lm)
    for layer, pp in enumerate(params["layers"]):
        for i, sub in enumerate(lm.period):
            key = f"sub_{i}"
            shapes = SC.state_feature_shapes(sub, cfg)
            data = {n: t[layer] for n, t in eng.spool["data"][key].items()}
            scale = {n: t[layer]
                     for n, t in eng.spool["scale_log2"][key].items()}
            state = {n: SC.read_layer(data[n], scale[n],
                                      SC.natural_dtype(kind, cfg), eng.scfg)
                     for n, (_, kind) in shapes.items()}
            x, new = eng._state_mix(pp[key], x, sub, state)
            for n in shapes:
                SC.write_layer(data[n], scale[n], new[n], active, eng.scfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return apply_site(params["head"], x, lm.head, cfg)[:, 0]


def _replay_state_steps(torch, lm, params, prompts, steps: int = 3) -> dict:
    """``steps`` decode steps of the int8 rwkv6 engine at full size (7 of 8
    slots busy after 32-token prompts: one inactive lane) through the
    engine, then again from the same pool through the per-layer route
    (``_per_layer_decode``), each feeding its own greedy tokens: logits and
    every pool byte equal, the engine's run ``steps`` x the plans' group
    launches and no row codec launch, the per-layer run 72 p2_dec_rows + 72
    p2_enc_rows a step."""
    from repro_torch.kernels import build as B
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    from repro_torch.serve import state_cache as SC
    eng = Engine(lm, params, EngineConfig(pool=PoolConfig(
        num_slots=STATE_SLOTS, quantized=True)), device="cuda")
    for p in prompts[:STATE_SLOTS - 1]:
        eng.submit(p[:32], max_new_tokens=steps + 4)
    eng.step()                          # admits and prefills, one decode
    sched = eng.sched
    table = eng._tensor(sched.page_table)
    lens = eng._tensor(sched.lens_vector())
    active = eng._tensor(sched.active_mask())
    tokens = eng._tensor(sched.tokens_vector())
    check(int(active.sum()) == STATE_SLOTS - 1, "replay: one lane idle")
    snap = [t.clone() for t in _leaves(eng.spool)]

    def run(step):
        for t, s in zip(_leaves(eng.spool), snap):
            t.copy_(s)
        torch.cuda.synchronize()
        B.reset_launches()
        logits, toks = [], tokens
        with torch.no_grad():
            for _ in range(steps):
                lg = step(table, lens, active, toks)
                logits.append(lg)
                toks = lg.argmax(-1, keepdim=True).to(tokens.dtype)
        torch.cuda.synchronize()
        return logits, [t.clone() for t in _leaves(eng.spool)], \
            dict(B.LAUNCHES)

    ga, pa, la = run(eng._decode)
    gb, pb, lb = run(lambda *a: _per_layer_decode(torch, eng, *a))
    check(all(_bits_equal(torch, a, b) for a, b in zip(ga, gb)),
          "replay: the engine's logits differ from the per-layer route's")
    check(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
              for a, b in zip(pa, pb)),
          "replay: the pool differs from the per-layer route's")
    dec, enc = _state_group_launches(lm)
    per = lm.n_periods * sum(len(SC.state_feature_shapes(sub, lm.cfg))
                             for sub in lm.period)
    check(la == {"st_dec_group": steps * dec, "st_enc_group": steps * enc},
          f"replay: engine launches {la}")
    check(lb == {"p2_dec_rows": steps * per, "p2_enc_rows": steps * per},
          f"replay: per-layer launches {lb}")
    log(f"replay rwkv6: {steps} int8 decode steps (7 of 8 slots) through "
        f"the engine ({la}) and the per-layer route ({lb}): logits and "
        f"{sum(t.numel() * t.element_size() for t in pa)} pool bytes equal")
    out = {"steps": steps, "launches": la, "per_layer_launches": lb}
    del eng
    return out


def phase_serve_rwkv6(torch, lm, params) -> dict:
    """The slice's main path: rwkv6-1.6b at full size serving the engine
    phase's 16 requests (64 new tokens, 8 slots) from an int8 state pool,
    an fp pool and, chunked (128), the int8 pool again; counts zeroed just
    before and read just after each run, exact (``_state_want``); no KV
    kernel, ``cache_bytes`` 0, every slot free at the end,
    ``state_reduction`` >= 3.5. Then the replay of 3 decode steps through
    the engine and the per-layer route (``_replay_state_steps``), and the
    decode step, a 512-token prefill and a chunk step, timed and
    profiled, the state kernels by name."""
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    cfg = lm.cfg
    prompts = _requests(cfg.vocab_size)
    _serve_engine(torch, lm, params, prompts[:2], 4)              # warm-up
    out, toks = {}, {}
    for name, kw in (("int8", {}), ("fp", dict(quantized=False)),
                     ("chunked", dict(prefill_chunk=CHUNK))):
        B.reset_launches()
        t1 = time.perf_counter()
        eng, toks[name] = _serve_engine(torch, lm, params, prompts, 64, **kw)
        wall = time.perf_counter() - t1
        launches = dict(B.LAUNCHES)
        summ = eng.summary()
        chunks = (_chunk_steps(eng.metrics.prefills, CHUNK)
                  if name == "chunked" else 0)
        want = ({} if name == "fp" else _state_want(
            lm, summ["decode_steps"], len(eng.metrics.prefills), chunks))
        s = _check_state_run(f"serve rwkv6 ({name})", eng, launches, want,
                             len(prompts))
        check(s["cache_bytes"] == 0 and not eng.sched.paged,
              f"serve rwkv6 ({name}): a KV pool of {s['cache_bytes']} B")
        if name != "fp":
            check(s["state_reduction"] >= 3.5,
                  f"state_reduction {s['state_reduction']}")
        out[name] = {"summary": s, "launches": launches, "wall_s": wall,
                     "chunk_steps": chunks}
        log(f"serve rwkv6 ({name}): {s['requests_completed']} requests in "
            f"{wall:.2f} s, {s['generated_tokens']} tokens, "
            f"{s['decode_steps']} decode steps, {chunks} chunk steps, "
            f"{s['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{s['ttft_p50_s']*1e3:.1f} ms, p95 {s['ttft_p95_s']*1e3:.1f} "
            f"ms; state_bytes {s['state_bytes']} ({s['state_reduction']:.4f}x "
            f"vs fp32 {s['state_bytes_fp32']}), cache_bytes "
            f"{s['cache_bytes']}; launches {launches}")
        del eng
    out["per_step"] = _state_steps(lm)
    out["replay"] = _replay_state_steps(torch, lm, params, prompts)
    out["wkv_error_by_decay"] = _wkv_error_by_decay(torch, lm, params,
                                                    prompts[0])
    out["bf16_agreement_int8_fp"] = sum(
        a == b for x, y in zip(toks["int8"], toks["fp"])
        for a, b in zip(x, y)) / (len(prompts) * 64)
    log(f"serve rwkv6: bf16 greedy agreement int8 vs fp pool "
        f"{out['bf16_agreement_int8_fp']:.3f}")
    out["runs_s"] = time.perf_counter() - t0
    # short windows of device activity only: a 512-token prefill's
    # per-token scan issues ~60,000 launches; the trace of a window that
    # large lost launches on the card, and its processing grows with them
    per = _state_want(lm, 1)
    out["decode_profile"] = _profile_decode(
        torch, lm, params, prompts, steps=6, fused=False, names=STATE_FNS,
        what="rwkv6 decode", cpu=False,
        want={f"{k}_kernel": v for k, v in per.items()})
    out["prefill_profile"] = _profile_prefill(
        torch, lm, params, prompts, reps=1, names=STATE_FNS,
        what="rwkv6 prefill", cpu=False, window_tokens=128,
        want={f"{k}_kernel": v for k, v in _state_want(lm, 0, 1).items()})
    out["chunk_profile"] = _profile_chunk(
        torch, lm, params, prompts, reps=1, names=STATE_FNS,
        what="rwkv6 chunk step", cpu=False,
        want={f"{k}_kernel": v for k, v in _state_want(
            lm, 0, 0, 1).items()})
    out["seconds"] = time.perf_counter() - t0
    log(f"serve rwkv6: {out['runs_s']:.1f} s for the three runs, "
        f"{out['seconds']:.1f} s with the profiles")
    return out


def phase_serve_hybrid(torch) -> dict:
    """jamba-1.5-large with dense FFNs at full width for one period (8
    layers: 7 Mamba, 1 attention), bf16, 8 requests x 64 new tokens over
    an int8 KV pool and an int8 state pool with fused attention, whole
    prompt and chunked (128: the chunks' remainders are unpadded widths);
    counts exact: a decode step one ``st_dec_group`` and one
    ``st_enc_group``, one paged append, one split and one combine; a
    prefill 14 ``p2_enc`` (a
    one-layer stack) and one ``p2_prefill_paged``; a chunk step 14
    ``p2_dec`` + 14 ``p2_enc`` (one slot), one paged append and one paged
    read. Then the decode step, a prefill and a chunk step, profiled, the
    kernels by name."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    lm, params = _state_model(torch, HYBRID_ARCH, num_layers=8,
                              moe=MoEConfig(num_experts=0))
    cfg = lm.cfg
    n_attn = sum(s.mixer_kind == "attn_gqa" for s in lm.period) * lm.n_periods
    prompts = _requests(cfg.vocab_size, n=8, seed=1)
    _serve_engine(torch, lm, params, prompts[:2], 4, fused_attention=True)
    out = {"per_step": _state_steps(lm)}
    for name, chunk in (("whole", 0), ("chunked", CHUNK)):
        B.reset_launches()
        t1 = time.perf_counter()
        eng, _ = _serve_engine(torch, lm, params, prompts, 64,
                               fused_attention=True, prefill_chunk=chunk)
        wall = time.perf_counter() - t1
        launches = dict(B.LAUNCHES)
        steps = eng.summary()["decode_steps"]
        admits = len(eng.metrics.prefills)
        chunks = _chunk_steps(eng.metrics.prefills, chunk) if chunk else 0
        check(bool(chunk) == (chunks > 0),
              f"serve hybrid ({name}): {chunks} chunk steps")
        want = _state_want(lm, steps, admits, chunks)
        want.update({"p2_append_paged": n_attn * (steps + chunks),
                     "paged_attention": n_attn * steps,
                     "paged_attention_combine": n_attn * steps,
                     "p2_prefill_paged": admits})
        if chunks:
            want["p2_read_paged"] = n_attn * chunks
        s = _check_state_run(f"serve hybrid ({name})", eng, launches, want,
                             len(prompts))
        check(eng.sched.alloc.free_pages == eng.pcfg.total_pages,
              f"serve hybrid ({name}): pages still mapped at the end")
        log(f"serve hybrid ({name}): {s['requests_completed']} requests in "
            f"{wall:.2f} s, {s['decode_steps']} decode steps, {chunks} chunk "
            f"steps, {s['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{s['ttft_p50_s']*1e3:.1f} ms; cache_bytes {s['cache_bytes']} "
            f"({s['cache_reduction']:.3f}x), state_bytes {s['state_bytes']} "
            f"({s['state_reduction']:.4f}x); launches {launches}")
        out[name] = {"summary": s, "launches": launches, "wall_s": wall,
                     "chunk_steps": chunks}
        del eng
    dec = {f"{k}_kernel": v for k, v in _state_want(lm, 1).items()}
    dec.update({"p2_append_paged_kernel": n_attn, "pa_split_kernel": n_attn,
                "pa_combine_kernel": n_attn})
    pre = {f"{k}_kernel": v for k, v in _state_want(lm, 0, 1).items()}
    pre["p2_prefill_paged_kernel"] = 1
    chk = {f"{k}_kernel": v for k, v in _state_want(lm, 0, 0, 1).items()}
    chk.update({"p2_append_paged_kernel": n_attn,
                "p2_read_paged_kernel": n_attn})
    out.update({
        "decode_profile": _profile_decode(
            torch, lm, params, prompts, steps=6, fused=True,
            names=STATE_FNS, what="hybrid decode", want=dec, cpu=False),
        "prefill_profile": _profile_prefill(
            torch, lm, params, prompts, reps=1, names=STATE_FNS,
            what="hybrid prefill", want=pre, cpu=False, window_tokens=128),
        "chunk_profile": _profile_chunk(
            torch, lm, params, prompts, reps=1, names=STATE_FNS,
            what="hybrid chunk step", want=chk, cpu=False)})
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"serve hybrid: {out['seconds']:.1f} s with the profiles")
    return out


def _static_greedy(torch, lm, params, prompt, gen_len: int, horizon: int):
    """The static reference of one request: whole-prompt ``lm_forward``
    with its cache, attention leaves padded to ``horizon``, then greedy
    ``lm_decode_step`` at B = 1 with a scalar length."""
    from repro_torch.models import lm_decode_step, lm_forward
    toks = torch.tensor([prompt], dtype=torch.long, device="cuda")
    with torch.no_grad():
        logits, _, cache = lm_forward(params, lm, tokens=toks,
                                      return_cache=True)
        n = len(prompt)
        cache = {key: {name: (torch.nn.functional.pad(
                     a, (0, 0, 0, 0, 0, horizon - n)) if name in ("k", "v")
                     else a) for name, a in kinds.items()}
                 for key, kinds in cache.items()}
        tok = int(logits[0, -1].argmax())
        out = [tok]
        for j in range(gen_len - 1):
            lg, cache = lm_decode_step(
                params, cache, torch.tensor([[tok]], device="cuda"), n + j,
                lm)
            tok = int(lg[0, -1].argmax())
            out.append(tok)
    return out


def _batch_probe(torch, lm, params) -> dict:
    """Whether a row of a product is the same bits at M = 1 and inside an
    M = 8 batch, for each dense weight of layer 0 and the head (the static
    reference runs at B = 1, the engine at 8): the products that could
    make the two disagree."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    tree = {"head": params["head"],
            **{f"{k}/{n}": v for k, sub in params["layers"][0].items()
               for n, v in sub["mixer"].items() if isinstance(v, dict)}}
    for name, site in tree.items():
        w = site.get("w")
        if w is None:
            continue
        x = torch.randn((8, w.shape[0]), generator=gen, device="cuda"
                        ).to(w.dtype)
        out[name] = bool(torch.equal((x @ w)[:1], x[:1] @ w))
    return out


def _identity_checks(torch, what, lm, params, prompts, gen_len: int,
                     slots: int, chunk: int) -> dict:
    """fp32: the engine (``slots`` slots, the requests recycling them) ≡
    static decode; chunked (``chunk``, shorter than the prompts: the run
    must take chunk steps) ≡ whole-prompt; a forced preemption
    resumes identically; an fp pool under ``NumericsPolicy(enable=True)``
    serves from an int8 state pool with the int8 engine's tokens."""
    from repro_torch.numerics import NumericsPolicy
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    pool = PoolConfig(num_slots=slots, page_size=16, pages_per_slot=64,
                      quantized=False)
    static = [_static_greedy(torch, lm, params, p, gen_len, pool.max_len)
              for p in prompts]

    def serve(preempt=False, **kw):
        pcfg = dataclasses.replace(pool, quantized=kw.pop("quantized",
                                                          False))
        eng = Engine(lm, params, EngineConfig(pool=pcfg, **kw),
                     device="cuda")
        rids = [eng.submit(p, max_new_tokens=gen_len) for p in prompts]
        if preempt:
            for _ in range(3):
                eng.step()
            check(eng.sched.preempt_youngest() is not None,
                  f"{what}: nothing to preempt")
            eng.metrics.preempted()
        res = eng.run()
        return eng, [res[r].tokens for r in rids]

    ceng, chunked = serve(prefill_chunk=chunk)
    chunks = _chunk_steps(ceng.metrics.prefills, chunk)
    check(chunks > 0, f"{what}: the chunked run took no chunk step")
    del ceng
    got = {"engine": serve()[1], "chunked": chunked,
           "preempted": serve(preempt=True)[1]}
    probe = None
    for name, toks in got.items():
        if toks != static:
            probe = probe or _batch_probe(torch, lm, params)
        check(toks == static, f"{what}: {name} vs static decode: "
              f"{sum(a == b for a, b in zip(toks, static))}/{len(prompts)} "
              f"completions identical; products equal at M = 1 and 8: "
              f"{probe}")
    eng, q = serve(quantized=True)
    peng, pol = serve(policy=NumericsPolicy(enable=True))
    leaf = next(t for k in peng._state_keys
                for t in peng.spool["data"][k].values())
    check(peng.scfg.quantized and leaf.dtype == torch.int8 and pol == q,
          f"{what}: policy engine's state pool {leaf.dtype}, "
          f"{sum(a == b for a, b in zip(pol, q))}/{len(prompts)} "
          "completions equal to the int8 engine's")
    agree = sum(a == b for x, y in zip(q, static) for a, b in zip(x, y)) \
        / (len(prompts) * gen_len)
    log(f"ssm identity ({what}): fp32 engine == static decode == chunked "
        f"({chunks} chunk steps of {chunk}) == preempted on all "
        f"{len(prompts)} completions; the policy engine serves from an int8 "
        f"state pool with the int8 engine's tokens (int8 vs fp32 greedy "
        f"agreement {agree:.3f})")
    return {"completions": len(prompts), "int8_fp_agreement": agree,
            "chunk": chunk, "chunk_steps": chunks}


def phase_ssm_identity(torch) -> dict:
    """fp32 at reduced depth: rwkv6-1.6b with 4 layers at full width (8
    requests of 128..512 tokens on 4 slots, 32 new tokens, chunks of 128)
    and the reduced jamba with dense FFNs (8 requests of 8..40 tokens on 3
    slots, 16 new tokens, chunks of 7): ``_identity_checks``."""
    import numpy as np
    import repro_torch.configs as C
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import build_lm, init_lm
    t0 = time.perf_counter()
    out = {}
    lm, params = _state_model(torch, SSM_ARCH, num_layers=4,
                              dtype="float32")
    out["rwkv6"] = _identity_checks(torch, "rwkv6 4 layers", lm, params,
                                    _requests(lm.cfg.vocab_size, n=8,
                                              seed=2), 32, 4, CHUNK)
    del params
    cfg = C.get_reduced(HYBRID_ARCH).replace(
        dtype="float32", moe=MoEConfig(num_experts=0))
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), lm,
                     device="cuda")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, int(rng.randint(8, 41))
                           ).tolist() for _ in range(8)]
    out["jamba"] = _identity_checks(torch, "reduced dense jamba", lm, params,
                                    prompts, 16, 3, 7)
    del params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"ssm identity: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the zoo-LM training slice: with_tt(internlm2-1.8b) with the low-precision
# step (TT weight sites, activation and gradient edges, int8 moments, the
# int8 gradient wire)
# ---------------------------------------------------------------------------

LM_BATCH, LM_SEQ, LM_STEPS = 8, 256, 8


def _lm_config():
    from repro_torch import configs as C
    return C.with_tt(C.get_config(ARCH), quantize=True)


def _lm_pe_calls():
    """(kind, Z shape, G shape) of every distinct PE call of the LM step:
    each TT site's forward and transposed chains at 8 x 256 rows, and each
    site's Ŵ (PE3: Ybar (rows, out), X (rows, in))."""
    from repro_torch.core.ttm import pe_shapes
    from repro_torch.models.lm import _walk_sites, build_lm
    lm = build_lm(_lm_config())
    rows = LM_BATCH * LM_SEQ
    seen = []
    for _, site in _walk_sites(lm):
        if not site.use_tt:
            continue
        s = site.spec
        calls = [c for sp in (s, s.transposed()) for c in pe_shapes(sp, rows)]
        calls.append(("pe3", (rows, s.out_dim), (rows, s.in_dim)))
        for c in calls:       # a site's two chains can share a shape
            if c not in seen:
                seen.append(c)
    return seen


def _pe_contraction(kind, z, g):
    """PE2's (Z, G) of a PE2 or PE3 call: PE3 (Ybar (b, j), X (b, i)) is
    PE2 at a = 1 with Z = X and G = Ybar."""
    return (z, g) if kind == "pe2" else (g.view(1, *g.shape), z)


def _pe_fma(kind, z, g):
    """A PE call on its CUDA-core body (``ttm_pe1.launch`` with the FMA
    plan; ``tt_contract`` for PE2 and PE3), whatever route its plan gives:
    the design the tensor-core route replaced at the LM's shapes, launched
    for timing only (``previous_ms``)."""
    from repro_torch.kernels import tt_contract, ttm_pe1
    if kind == "pe1":
        out = z.new_empty((z.shape[0], g.shape[1]))
        ttm_pe1.launch(z, g, out)
        return out
    zz, gg = _pe_contraction(kind, z, g)
    out = zz.new_empty((zz.shape[0], gg.shape[1], zz.shape[2]))
    tt_contract.launch(kind, f"ttm_{kind}", zz, gg, out)
    return out if kind == "pe2" else out[0]


def _lm_pe1_epilogue(torch, gen, zs, gs) -> list:
    """PE1 at an LM shape on the tensor-core route with the requant
    epilogue, 4- and 8-bit: integer operands in [-8, 8], whose sums f32
    holds exactly in any order, so the kernel's sums are the plain
    version's. Bit for bit with the plain version (einsum + the codec's
    epilogue, -0.0 where a sum rounds to 0 from below), value for value
    with the codec's encode -> decode of the plain f32 sum (+0.0 there),
    and clipped at both ends of the grid. Returns the bit widths held."""
    from repro_torch import numerics as TN
    from repro_torch.kernels import ttm_pe1
    z = torch.randint(-8, 9, zs, generator=gen, device="cuda").to(
        torch.bfloat16)
    g = torch.randint(-8, 9, gs, generator=gen, device="cuda").to(
        torch.bfloat16)
    check(ttm_pe1.plan_pe1_for(z, g) is not None,
          "lm pe1 epilogue: not on the tensor-core route")
    acc = ttm_pe1.pe1_torch(z.float(), g.float())
    held = []
    for bits, s in ((4, 3.0), (8, 1.0)):
        step = torch.tensor(s, device="cuda")
        fused = ttm_pe1.pe1_cuda(z, g, step, bits)
        plain = ttm_pe1.pe1_torch(z, g, step, bits)
        check(torch.equal(fused.view(torch.int16), plain.view(torch.int16)),
              f"lm pe1 epilogue {bits}-bit: not bit for bit the plain "
              "version")
        unfused = TN.decode(TN.encode(acc, TN.QuantSpec("pow2", bits), step,
                                      backend="cuda"), torch.float32,
                            backend="cuda")
        check(torch.equal(fused.float(), unfused),
              f"lm pe1 epilogue {bits}-bit differs from encode -> decode")
        q = fused.float() / 2.0 ** s
        check(q.max().item() == 2 ** (bits - 1) - 1
              and q.min().item() == -2 ** (bits - 1),
              f"lm pe1 epilogue {bits}-bit: data did not clip at both ends")
        held.append(bits)
    log(f"lm pe1 epilogue on the tensor cores {zs} x {gs}: 4- and 8-bit bit "
        "for bit the plain version, equal to encode -> decode")
    return held


def phase_lm_kernels(torch, timer: Timer, device: str = "cuda") -> dict:
    """PE1/PE2/PE3 at every distinct shape of the LM step, in bf16 (the
    LM's type): held to the plain version within 2e-2 relative and
    absolute, timed beside it, beside one ``torch.matmul`` of the same
    product on the same bf16 tensors (cuBLAS, tensor cores) and beside the
    bound (bytes at 3.35 TB/s or the bf16 operations at 989 TFLOP/s).
    Every PE1, PE2 and PE3 call takes the tensor-core route
    (``ttm_pe1.plan_pe1``, ``tt_mma.plan``; asserted), repeats bit for bit
    over two launches, and is timed beside the CUDA-core body at the same
    shape (``previous_ms``: the route the tensor cores replaced there),
    itself held to the plain version. PE1's first call also runs with the
    requant epilogue on the tensor-core route, held bit for bit to the
    plain version with the codec's epilogue and value for value to the
    codec's encode -> decode of the plain sum, on integer operands whose
    sums f32 holds exactly in any order."""
    from repro_torch.kernels import tt_mma, ttm_pe1
    gen = torch.Generator(device=device).manual_seed(4)
    rows = {"pe1": [], "pe2": [], "pe3": []}
    tol = PE_TOL["bfloat16"]

    def close(out, ref):
        return bool(((out.float() - ref.float()).abs()
                     <= tol + tol * ref.float().abs()).all())
    for kind, zs, gs in _lm_pe_calls():
        kern, plain = _pe_fns(kind)
        z = torch.randn(zs, generator=gen, device=device).to(torch.bfloat16)
        g = (torch.randn(gs, generator=gen, device=device) * 0.2).to(
            torch.bfloat16)
        o, r = kern(z, g), plain(z, g)
        err = (o.float() - r.float()).abs()
        check(close(o, r), f"lm {kind} {zs}x{gs}: max err {err.max().item()}")
        check(close(_pe_library(torch, kind, z, g), r),
              f"lm {kind} yardstick differs")
        row = dict(z=list(zs), g=list(gs), dtype="bfloat16",
                   max_abs_err=err.max().item())
        p = (ttm_pe1.plan_pe1_for(z, g) if kind == "pe1" else
             tt_mma.plan_for(*_pe_contraction(kind, z, g)))
        check(p is not None,
              f"lm {kind} {zs}x{gs}: not on the tensor-core route")
        check(_bits_equal(torch, kern(z, g), o),
              f"lm {kind} {zs}x{gs}: two launches differ")
        check(close(_pe_fma(kind, z, g), r),
              f"lm {kind} {zs}x{gs}: the CUDA-core body differs")
        row.update(route="tensor cores", tile=[p.bm, p.bn],
                   stages=p.stages, grid=p.grid, smem=p.smem)
        if kind == "pe1":
            row.update(orientation="K-major", staging=p.nbuf)
        else:
            row.update(orientation=p.orientation, resident=bool(p.resident))
        if kind == "pe1" and not rows["pe1"]:
            row["epilogue_bits"] = _lm_pe1_epilogue(torch, gen, zs, gs)
        del o, r, err
        row["ms"] = timer(lambda: kern(z, g), iters=10)
        row["previous_ms"] = timer(lambda: _pe_fma(kind, z, g), iters=5)
        row["plain_ms"] = timer(lambda: plain(z, g), iters=5)
        row["library_ms"] = timer(lambda: _pe_library(torch, kind, z, g),
                                  iters=10)
        nbytes, flops = _pe_work(kind, zs, gs, 2)
        row["flops"] = flops
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                    BF16_OPS_PER_S)
        row["tflops"] = flops / row["ms"] / 1e9
        rows[kind].append(row)
        was = (f"; {row['orientation']} {row['tile'][0]} x {row['tile'][1]}"
               f", CUDA-core body {row['previous_ms']*1e3:.1f} us, "
               f"{row['previous_ms'] / row['ms']:.1f}x")
        log(f"lm {kind} {zs} x {gs} bf16: {row['ms']*1e3:.1f} us "
            f"({row['tflops']:.1f} TFLOP/s; plain {row['plain_ms']*1e3:.1f}"
            f" us, torch.matmul {row['library_ms']*1e3:.1f} us, bound "
            f"{row['bound_ms']*1e3:.2f} us {row['bound_by']}{was}); err "
            f"{row['max_abs_err']:.1e}")
        del z, g
    torch.cuda.empty_cache()
    return rows


def _lm_state_checks(torch, lm, state) -> dict:
    """After a step: the scale manager's states moved off their init, and
    every λ is the closed-form Eq. 4 update of its cores (bit for bit:
    the step's last act)."""
    from repro_torch.models.lm import _site_params, _walk_sites
    from repro_torch.models.common import site_lambda_update
    for name in ("activation", "grad_edge"):
        st = state.scales[name]
        check(int(st.log2) != 0 or float(st.mean_abs) != 0.2,
              f"lm: the {name} scale state did not move")
    n = 0
    for path, site in _walk_sites(lm):
        if not site.use_tt:
            continue
        for full, p in _site_params(state.params, path):
            want = site_lambda_update(p, site, lm.cfg)
            for k in range(site.spec.d - 1):
                check(torch.equal(p[f"lambda_{k}"], want[f"lambda_{k}"]),
                      f"lm: {full} lambda_{k} is not Eq. 4 of its cores")
                n += 1
    return {name: {"log2": int(state.scales[name].log2),
                   "mean_abs": float(state.scales[name].mean_abs)}
            for name in ("activation", "grad_edge")} | {"lambdas": n}


def _lm_group_bounds(lm, state, per: dict) -> dict:
    """Byte bounds (ms at 3.35 TB/s) of one LM step's group launches, each
    input read once and each output written once: ``bw_enc`` and
    ``bw_dec`` move the moments (f32 one way, codes and scales the other)
    and the wire's flattened leaves likewise; ``p2_fake_quant`` reads and
    writes each TT core per forward (the remat recompute too), each
    activation edge's (B, S, d_model) stream and every gradient (the grad
    edge)."""
    from repro_torch.models.lm import _site_params, _walk_sites
    from repro_torch.optim.adam import moment_nbytes
    from repro_torch.optim.grad_compress import wire_nbytes
    from repro_torch.tree import flatten_with_path
    m_res, m_f32 = moment_nbytes(state.opt)
    w_enc, w_f32 = wire_nbytes(state.params)
    bw = m_res + m_f32 + w_enc + w_f32
    fwd = 2 if lm.cfg.remat == "full" else 1
    cores = sum(t.numel() * t.element_size()
                for path, site in _walk_sites(lm) if site.use_tt
                for _, p in _site_params(state.params, path)
                for k, t in p.items() if k.startswith("core_"))
    edges = 2 + lm.n_periods * (fwd + 1)
    stream = LM_BATCH * LM_SEQ * lm.cfg.d_model * 2        # bf16
    grads = sum(t.numel() * t.element_size()
                for _, t in flatten_with_path(state.params)
                if t.is_floating_point())
    fq = 2 * (fwd * cores + edges * stream + grads)
    out = {}
    for name, nbytes in (("bw_enc", bw), ("bw_dec", bw),
                         ("p2_fake_quant", fq)):
        if name in per:
            out[name] = {"bytes": nbytes,
                         "bound_ms": bound_ms(nbytes)[0]}
    return out


def _lm_fq_rows(torch, lm, params) -> list:
    """The LM step's three kinds of grouped fake-quant launch (row 4b), each
    one ``p2_fq_group`` launch (asserted) on the trained state's tensors:
    the first TT site's cores at their ``wscale_log2`` (4-bit), one
    activation edge (8 x 256 x d_model bf16, 8-bit at 2^-7) and one
    grad-edge group (the first 64 floating bf16 leaves, standing in for
    their gradients, 16-bit at each one's per-tensor-max step). The plan
    gives the edge and the grad-edge group's embedding and head wide units
    and the cores narrow ones (asserted). Bit for bit with the plain
    version and over two launches, timed beside it, beside the same call
    on narrow units throughout (``previous_ms``: the design the wide units
    replaced, itself bit for bit the plain version; a yardstick only),
    beside the loop of ``torch.fake_quantize_per_tensor_affine`` over the
    same tensors (the library yardstick) and beside the group's byte
    bound."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import grouped as G
    from repro_torch.models.lm import _site_params, _walk_sites
    from repro_torch.numerics import QuantSpec
    from repro_torch.numerics.codecs import per_tensor_max_scale_log2
    from repro_torch.numerics import cuda_backend as CB
    from repro_torch.tree import flatten_with_path
    timer = Timer(torch)
    q = lm.cfg.quant
    path = next(p for p, site in _walk_sites(lm) if site.use_tt)
    _, sp = _site_params(params, path)[0]
    cores = [sp[k].detach() for k in sorted(sp) if k.startswith("core_")]
    gen = torch.Generator(device="cuda").manual_seed(6)
    edge = (torch.randn((LM_BATCH, LM_SEQ, lm.cfg.d_model), generator=gen,
                        device="cuda") * 0.2).to(torch.bfloat16)
    grads = [t.detach() for _, t in flatten_with_path(params)
             if t.dtype == torch.bfloat16][:G.FQ_CAP]
    gspec = QuantSpec("pow2", q.grad_bits)
    sets = [("site cores " + "/".join(map(str, path)), cores,
             sp["wscale_log2"].float(), q.weight_bits, 0),
            ("activation edge", [edge],
             torch.full((1,), -7.0, device="cuda"), q.act_bits, 1),
            ("grad-edge group", grads, torch.stack([
                per_tensor_max_scale_log2(t, gspec) for t in grads]),
             q.grad_bits, 2)]
    rows = []
    for what, xs, steps, bits, wide in sets:
        (launch,) = G.fq_plan([x.numel() for x in xs], xs[0].element_size())
        check(sum(launch.wide) == wide,
              f"lm fake-quant {what}: {sum(launch.wide)} tensors on wide "
              f"units, want {wide}")
        ptrs = [steps.data_ptr() + 4 * i for i in range(len(xs))]
        torch.cuda.synchronize()
        B.reset_launches()
        ys = CB.fake_quant_scalar_many(xs, steps, bits)
        torch.cuda.synchronize()
        check(B.LAUNCHES == {"p2_fake_quant": 1},
              f"lm fake-quant {what}: launches {B.LAUNCHES}")
        plain = CB.fake_quant_many_plain(xs, steps, bits)
        check(all(_bits_equal(torch, y, r) for y, r in zip(ys, plain)),
              f"lm fake-quant {what}: not bit-exact")
        check(all(_bits_equal(torch, y, a) for y, a in zip(
            ys, CB.fake_quant_scalar_many(xs, steps, bits))),
              f"lm fake-quant {what}: two launches differ")
        check(all(_bits_equal(torch, y, a) for y, a in zip(
            ys, CB._fq_group(xs, ptrs, bits, stream=False))),
              f"lm fake-quant {what}: the narrow units differ")
        del plain
        n = sum(x.numel() for x in xs)
        hi = 2 ** (bits - 1)
        scales = [2.0 ** v for v in steps.tolist()]
        row = dict(what=what, shape=[list(x.shape) for x in xs], bits=bits,
                   dtype=sorted({str(x.dtype)[6:] for x in xs}),
                   entries=len(xs), elements=n, wide=wide, max_abs_err=0.0)
        row["ms"] = timer(lambda: CB.fake_quant_scalar_many(xs, steps, bits))
        row["previous_ms"] = timer(lambda: CB._fq_group(xs, ptrs, bits,
                                                        stream=False))
        row["plain_ms"] = timer(
            lambda: CB.fake_quant_many_plain(xs, steps, bits), iters=5)
        row["library_ms"], row["library_note"] = _library_yardstick(
            timer, lambda: [torch.fake_quantize_per_tensor_affine(
                x, scales[i], 0, -hi, hi - 1) for i, x in enumerate(xs)],
            lambda r: all(torch.equal(a, b) for a, b in zip(r, ys)))
        row["bound_ms"], row["bound_by"] = bound_ms(_fq_bytes(xs))
        log(f"lm p2_fake_quant {what} ({len(xs)} tensors, {n:,} elements, "
            f"{bits}-bit, {wide} on wide units): {row['ms']*1e3:.1f} us one "
            f"launch (narrow units {row['previous_ms']*1e3:.1f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us, library loop "
            f"{row['library_note']}, bound {row['bound_ms']*1e3:.2f} us, "
            f"{row['ms'] / row['bound_ms']:.2f}x); bit-exact, two launches "
            "equal")
        rows.append(row)
    del timer
    torch.cuda.empty_cache()
    return rows


def _lm_moments(torch, state) -> list:
    """m of the first ``BW_CAP`` Adam leaves of a trained LM state (the
    step's first moment group, the embedding's and the head's m among
    them), decoded to f32 (rows, last) views: the data the step encodes,
    most of it zeros (rows of tokens not in a batch)."""
    from repro_torch.kernels.grouped import BW_CAP
    from repro_torch.numerics import decode_many
    qts = [m for m in state.opt.m if m is not None][:BW_CAP]
    return [y.reshape(-1, y.shape[-1] if y.dim() else 1)
            for y in decode_many(qts, torch.float32, backend="cuda")]


def _lm_bw_rows(torch, sets) -> list:
    """The LM step's large blockwise encode launches (row 10b): the moment
    group that holds the embedding's m (block 256) and the wire group
    (block 1,024), each one ``bw_enc`` launch (asserted) whose embedding
    and head leaves the plan gives stream tasks (asserted). Codes equal and
    scales bit for bit with the plain version, with the same call on the
    previous tasks throughout and over two launches; a stream leaf's
    all-zero blocks code as zeros under a zero scale.
    Timed beside the plain version, beside the previous tasks
    (``previous_ms``: the design the stream tasks replaced, a yardstick
    only) and beside the group's byte bound."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import grouped as G
    from repro_torch.numerics import cuda_backend as CB
    timer = Timer(torch)
    rows = []
    for what, xs, block in sets["bw"]:
        (launch,) = G.bw_plan([tuple(x.shape) for x in xs], block)
        big = [x.numel() >= G.STREAM_MIN for x in xs]
        check([lf.stream for lf in launch.leaves] == big and sum(big) >= 2,
              f"lm bw_enc {what}: stream leaves "
              f"{[lf.stream for lf in launch.leaves]}, want {big}")
        torch.cuda.synchronize()
        B.reset_launches()
        got = CB.bw_encode_many(xs, block)
        torch.cuda.synchronize()
        check(B.LAUNCHES == {"bw_enc": 1},
              f"lm bw_enc {what}: launches {B.LAUNCHES}")
        for i, x in enumerate(xs):
            c, sc = got[i]
            rc, rs = CB.bw_encode_plain(x, block)
            check(torch.equal(c, rc) and _bits_equal(torch, sc, rs),
                  f"lm bw_enc {what} leaf {i}: differs from the plain version")
            del rc, rs
        for name, other in (("previous tasks", CB._bw_group(
                xs, block, 8, torch.int8, stream=False)),
                ("a second launch", CB.bw_encode_many(xs, block))):
            check(all(torch.equal(c, oc) and _bits_equal(torch, sc, osc)
                      for (c, sc), (oc, osc) in zip(got, other)),
                  f"lm bw_enc {what}: differs from {name}")
            del other
        c, sc = got[next(i for i, b in enumerate(big) if b)]
        zero = sc == 0
        check(bool(zero.any()) and not c.view(*sc.shape, -1)[zero].any(),
              f"lm bw_enc {what}: no all-zero block, or one not coded as "
              "zeros")
        del got, c, sc, zero
        n = sum(x.numel() for x in xs)
        row = dict(what=what, shape=[list(x.shape) for x in xs], block=block,
                   entries=len(xs), elements=n, stream=sum(big),
                   max_abs_err=0.0, library_ms=None,
                   library_note=BW_ENC_NONE)
        row["ms"] = timer(lambda: CB.bw_encode_many(xs, block))
        row["previous_ms"] = timer(lambda: CB._bw_group(
            xs, block, 8, torch.int8, stream=False))
        row["plain_ms"] = timer(lambda: CB.bw_encode_many_plain(xs, block),
                                iters=3)
        row["bound_ms"], row["bound_by"] = bound_ms(_bw_bytes(xs, block))
        log(f"lm bw_enc {what} ({len(xs)} leaves, {n:,} elements, block "
            f"{block}, {sum(big)} on stream tasks): {row['ms']*1e3:.1f} us "
            f"one launch (previous tasks {row['previous_ms']*1e3:.1f} us, "
            f"plain {row['plain_ms']*1e3:.1f} us, bound "
            f"{row['bound_ms']*1e3:.1f} us, {row['ms'] / row['bound_ms']:.2f}"
            "x); codes and scales bit-exact, the zero block zeros, two "
            "launches equal")
        rows.append(row)
    del timer
    torch.cuda.empty_cache()
    return rows


def _lm_codec_sets(torch, gen) -> dict:
    """The LM step's large codec launches on seeded data of their shapes
    (``init_lm`` on the meta device gives them): the grad-edge group (the
    first ``FQ_CAP`` bf16 leaves, standing in for their gradients, 16-bit
    at each one's per-tensor-max step), an activation edge (8 x 256 x
    d_model bf16, 8-bit at 2^-7), the first moment group (m of the first
    ``BW_CAP`` Adam leaves, the embedding's and the head's among them, f32
    as (rows, last) views, block 256) and the wire group (every reference
    leaf's gradient flattened, f32, block 1,024); and, as ``bw_small``, the
    second moment group (TT cores and norm scales: the step's 19 small
    moment groups). The first block of the embedding's m and of the wire's
    first large leaf is all zero."""
    from repro_torch.kernels.grouped import BW_CAP, FQ_CAP
    from repro_torch.models.lm import build_lm, init_lm
    from repro_torch.numerics import QuantSpec
    from repro_torch.numerics.codecs import per_tensor_max_scale_log2
    from repro_torch.optim.adam import _is_adam_leaf
    from repro_torch.tree import flatten_with_path, stacked_groups
    lm = build_lm(_lm_config())
    q = lm.cfg.quant
    flat = flatten_with_path(init_lm(None, lm, device="meta"))
    grads = [(torch.randn(t.shape, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16) for _, t in flat if t.dtype == torch.bfloat16][:FQ_CAP]
    gspec = QuantSpec("pow2", q.grad_bits)
    edge = (torch.randn((LM_BATCH, LM_SEQ, lm.cfg.d_model), generator=gen,
                        device="cuda") * 0.2).to(torch.bfloat16)
    adam = [(p, t.shape) for p, t in flat if _is_adam_leaf(p, t)]
    moments, cores = [], []
    for k, (p, shape) in enumerate(adam[:2 * BW_CAP]):
        m = torch.randn(shape, generator=gen, device="cuda") * 1e-3
        if p == "embed/w":
            m.view(-1)[:256] = 0.0
        (moments if k < BW_CAP else cores).append(
            m.reshape(-1, shape[-1] if len(shape) else 1))
    floats = [(p, t) for p, t in flat if t.is_floating_point()]
    wire = []
    for grp in stacked_groups([p for p, _ in floats]):
        n = sum(floats[i][1].numel() for i in grp)
        w = torch.randn((1, n), generator=gen, device="cuda") * 1e-2
        if n >= 1 << 20 and not any(x.numel() >= 1 << 20 for x in wire):
            w[0, :1024] = 0.0
        wire.append(w)
    return {"fq": [("grad-edge group", grads, torch.stack([
                        per_tensor_max_scale_log2(t, gspec) for t in grads]),
                    q.grad_bits),
                   ("activation edge", [edge],
                    torch.full((1,), -7.0, device="cuda"), q.act_bits)],
            "bw": [("moment group (the embedding's m)", moments, 256),
                   ("wire group", wire, 1024)],
            "bw_small": [("moment group (TT cores' m)", cores, 256)]}


def _fq_bytes(xs) -> int:
    """A fake-quant group's bytes: each tensor read and written once, its
    f32 step read once."""
    return sum(2 * x.numel() * x.element_size() + 4 for x in xs)


def _bw_bytes(xs, block: int, storage_bytes: int = 1) -> int:
    """A blockwise encode group's bytes: f32 values read once, codes (each
    row padded to whole blocks) and f32 scales written once."""
    from repro_torch.numerics import QuantSpec
    from repro_torch.numerics.codecs import blockwise_geometry
    total = 0
    for x in xs:
        rows, last = x.shape
        b, nb, _ = blockwise_geometry(QuantSpec("blockwise", 8, block), last)
        total += 4 * rows * last + rows * nb * (b * storage_bytes + 4)
    return total


# --codec-anatomy: the fake-quant group and the blockwise encode group with
# one part cut out at a time, text replacements in their sources (a store
# kept behind a test that never holds, so the values it needs are still
# computed)
FQ_PHASES = {"arith": {"pow2_fq.cu": [
    ("out.v[j] = one(in.v[j], step);", "out.v[j] = in.v[j];"),
    ("if (i < n) y[i] = one(x[i], step);", "if (i < n) y[i] = x[i];"),
    ("out.v[j] = wide_one<T, RT, MUL>(in[k].v[j], step, inv, lo, hi, lo_t, "
     "hi_t, int_codes);", "out.v[j] = in[k].v[j];"),
    ("if (i < n) y[i] = wide_one<T, RT, MUL>(x[i], step, inv, lo, hi, lo_t, "
     "hi_t, int_codes);", "if (i < n) y[i] = x[i];")]}}
BW_PHASES = {
    "code": {"blockwise.cu": [
        ("      if (k < b) {\n        Vec4<Q> out;",
         "      if (false && k < b) {\n        Vec4<Q> out;"),
        ("  for (int t = 0; t < n; ++t) qr[t] = bw_code<Q>(xr[t], d, qmax);\n"
         "  for (int t = n; t < b; ++t) qr[t] = Q(0);\n", ""),
        ("  for (int t = lane; t < b; t += 32) qb[t] = t < n ? "
         "bw_code<Q>(xb[t], d, qmax) : Q(0);\n", ""),
        ("    if (n > 0) {\n      Q* qb",
         "    if (false && n > 0) {\n      Q* qb")]},
    "reduce": {"blockwise.cu": [
        ("const float s = warp_max(amax) / qmax;", "const float s = amax;"),
        ("if (lane == 0) sc[u] = s;", "if (s == 1.5e38f) sc[u] = s;"),
        ("  sc[u] = s;\n}", "  if (s == 1.5e38f) sc[u] = s;\n}"),
        ("      amax[g] = fmaxf(amax[g], __shfl_xor_sync(0xffffffffu, amax[g], "
         "off));", "      ;"),
        ("const float s = amax[g] > 0.f ? amax[g] / qmax : 0.f;",
         "const float s = amax[g];"),
        ("  if (mine_real) sc[u + lane] = mine;",
         "  if (mine == 1.5e38f) sc[u + lane] = mine;")]},
}


def phase_codec_anatomy(torch, timer: Timer) -> dict:
    """Where the LM step's large fake-quant and blockwise-encode launches
    spend their time, without a profiler: at the step's calls
    (``_lm_codec_sets``), on the stream units the plan gives them and on
    the previous design's units throughout (``stream=False``), the
    fake-quant group timed in full, rebuilt with its arithmetic cut out (a
    copy with the same units), and as a table of one (the same elements as
    one tensor: no per-unit search), beside a loop of ``copy_`` over the
    same tensors and the byte bound; the blockwise encode group in full,
    with its coding pass cut out (absmax and scale only) and with loads
    only. Builds under ``kernels/_build/anatomy``."""
    from repro_torch.numerics import cuda_backend as CB
    fq_cuts = {"full": [], "no arithmetic": ["arith"]}
    bw_cuts = {"full": [], "no coding": ["code"],
               "loads only": ["code", "reduce"]}
    fq_libs = {k[0]: CB.fq_typed(lib) for k, lib in _anatomy_libs(
        FQ_PHASES, fq_cuts, ("pow2_fq.cu",), ("pow2_fq",), "fq").items()}
    bw_libs = {k[0]: CB.bw_typed(lib) for k, lib in _anatomy_libs(
        BW_PHASES, bw_cuts, ("blockwise.cu", "pow2_codes.cuh"),
        ("blockwise",), "bw").items()}
    sets = _lm_codec_sets(torch, torch.Generator(device="cuda").manual_seed(8))
    out = {"timer_floor_ms": timer(lambda: None), "fq": [], "bw": []}
    for what, xs, steps, bits in sets["fq"]:
        ptrs = [steps.data_ptr() + 4 * i for i in range(len(xs))]
        ys = [torch.empty_like(x) for x in xs]
        one = torch.cat([x.reshape(-1) for x in xs])
        base = {"what": what, "entries": len(xs),
                "elements": sum(x.numel() for x in xs),
                "bound_ms": bound_ms(_fq_bytes(xs))[0],
                "copy_ms": timer(lambda: [y.copy_(x) for x, y in zip(xs, ys)])}
        for route in (True, False):
            row = dict(base, units="stream" if route else "previous")
            for cut, lib in fq_libs.items():
                row[cut] = timer(lambda: CB._fq_group(
                    xs, ptrs, bits, lib=lib, stream=route))
            row["table of one"] = timer(lambda: CB._fq_group(
                [one], ptrs[:1], bits, stream=route))
            log(f"anatomy p2_fake_quant {what} ({row['entries']} tensors, "
                f"{row['elements']:,} elements), {row['units']} units: full "
                f"{row['full']*1e3:.1f} us, no arithmetic "
                f"{row['no arithmetic']*1e3:.1f}, table of one "
                f"{row['table of one']*1e3:.1f}; copy_ loop "
                f"{row['copy_ms']*1e3:.1f}, bound {row['bound_ms']*1e3:.1f} us")
            out["fq"].append(row)
        del one, ys
    for what, xs, block in sets["bw"] + sets["bw_small"]:
        base = {"what": what, "entries": len(xs),
                "elements": sum(x.numel() for x in xs), "block": block,
                "bound_ms": bound_ms(_bw_bytes(xs, block))[0]}
        for route in (True, False):
            row = dict(base, tasks="stream" if route else "previous")
            for cut, lib in bw_libs.items():
                row[cut] = timer(lambda: CB._bw_group(
                    xs, block, 8, torch.int8, lib=lib, stream=route))
            log(f"anatomy bw_enc {what} ({row['entries']} leaves, "
                f"{row['elements']:,} elements, block {block}), "
                f"{row['tasks']} tasks: full {row['full']*1e3:.1f} us, no "
                f"coding {row['no coding']*1e3:.1f}, loads only "
                f"{row['loads only']*1e3:.1f}, bound "
                f"{row['bound_ms']*1e3:.1f} us")
            out["bw"].append(row)
    log(f"anatomy: timer floor {out['timer_floor_ms']*1e3:.1f} us")
    del sets
    torch.cuda.empty_cache()
    return out


def phase_train_lm(torch, device: str = "cuda",
                   steps: int = LM_STEPS) -> dict:
    """The zoo-LM training path: ``with_tt(internlm2-1.8b, quantize=True)``
    at full width and depth (24 layers, 144 TT sites, bf16, remat full),
    int8 moments and the int8 gradient wire, ``steps`` steps of
    ``launch/train.py::train`` on ``lm_batch`` (8 x 256 tokens), seeded
    weights on the card. Counts zeroed just before and read just after:
    each kernel ``steps`` x ``launches_per_step``. Every loss finite and
    the last below the first; the scale states moved; every λ the Eq. 4
    update of its cores. Then one profiled step (host wall, device time,
    busy share, the kernels by name, exactly). Last, the same steps with
    f32 moments: their cross-entropy must fall."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import lm_batch
    from repro_torch.kernels import build as B
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import train
    from repro_torch.models.lm import build_lm, lm_param_counts

    cfg = _lm_config()
    lm = build_lm(cfg)
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=steps, warmup_steps=5, log_every=1)
    per = S.launches_per_step(lm, tcfg)
    n_tt = sum(site.use_tt for _, site in S._walk_sites(lm)) * lm.n_periods
    check(n_tt == 144 and lm.n_periods == 24 and cfg.d_model == 2048
          and cfg.dtype == "bfloat16" and cfg.remat == "full",
          f"lm config: {n_tt} TT sites, {lm.n_periods} layers")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ces = []
    B.reset_launches()
    t0 = time.perf_counter()
    state, losses = train(cfg, "tp", tcfg, batch=LM_BATCH, seq=LM_SEQ,
                          device=device,
                          on_step=lambda i, m: ces.append(float(m["ce"])))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    launches = dict(B.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * steps for k, v in per.items()}
    check(launches == want, f"lm launches {launches}, want {want} ({per} "
          "a step)")
    check(all(math.isfinite(x) for x in losses + ces),
          f"lm losses {losses}, ce {ces}")
    check(losses[-1] < losses[0], f"lm loss did not fall: {losses}")
    counts = lm_param_counts(state.params, lm)
    sites = S.train_state_sites(state)
    checks = _lm_state_checks(torch, lm, state)
    bounds = _lm_group_bounds(lm, state, per)
    log(f"train lm: {steps} steps of 8 x 256 tokens, losses "
        f"{[round(x, 4) for x in losses]}, cross-entropy "
        f"{[round(x, 4) for x in ces]}, {wall*1e3:.1f} ms a step (host "
        f"wall incl. init), peak memory {peak / 2**30:.2f} GiB")
    log(f"train lm: launches per step {per}")
    log(f"train lm: params dense-equiv {counts['dense']:,} TT "
        f"{counts['tt']:,} live {counts['live']:,} compression "
        f"{counts['compression']:.2f}x")
    log(f"train lm: state bytes " + ", ".join(
        f"{k} {v['bytes']:,} (fp32 {v['fp32_bytes']:,})"
        for k, v in sites.items()))
    log(f"train lm: scales {checks}")
    log(f"train lm: group launches' byte bounds a step {bounds}")
    fq_rows = _lm_fq_rows(torch, lm, state.params)
    sets = _lm_codec_sets(torch, torch.Generator(device="cuda").manual_seed(7))
    sets["bw"][0] = ("moment group (the embedding's m, the trained state's)",
                     _lm_moments(torch, state), 256)
    bw_rows = _lm_bw_rows(torch, sets)
    del sets

    step = S.make_train_step(lm, None, tcfg)
    box = {"state": state}
    del state

    def one(i):
        b = lm_batch(steps + i, batch=LM_BATCH, seq=LM_SEQ,
                     vocab=cfg.vocab_size, seed=tcfg.seed)
        box["state"], _ = step(box["state"], {
            k: torch.from_numpy(v).to(device) for k, v in b.items()})
    prof = _profile_train(torch, one, per, steps=1, fn=LM_KERNEL_FN,
                          absent=LM_ABSENT_FN, times=(
                              "p2_fq_group_kernel", "bw_enc_group_kernel",
                              "bw_dec_group_kernel"))
    del box
    torch.cuda.empty_cache()
    # The loss carries the rank prior, which the λ update drives down on
    # its own, so the cross-entropy says whether the model learns. With
    # int8 moments it does not here: the blockwise v of an element far
    # below its block's largest decodes to 0, and where the next gradient
    # is small (an embedding row whose token is not in the batch: 0) the
    # update is m / eps (the reference's numerics; its tiny TT LM does
    # the same at its third step). The same step with f32 moments must
    # lower the cross-entropy.
    f32 = dataclasses.replace(tcfg, opt_state_dtype="float32")
    ces_f32 = []
    done, _ = train(cfg, "tp", f32, batch=LM_BATCH, seq=LM_SEQ,
                    device=device, verbose=False,
                    on_step=lambda i, m: ces_f32.append(float(m["ce"])))
    del done
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in ces_f32) and ces_f32[-1] < ces_f32[0],
          f"lm cross-entropy with f32 moments did not fall: {ces_f32}")
    log(f"train lm: the same {steps} steps with f32 moments, cross-entropy "
        f"{[round(x, 4) for x in ces_f32]}")
    return {"steps": steps, "losses": losses, "ce": ces, "ce_f32": ces_f32,
            "step_wall_ms": wall * 1e3,
            "peak_bytes": peak, "launches": launches,
            "launches_per_step": per, "param_counts": counts,
            "state_bytes": sites, "state_checks": checks,
            "group_bounds": bounds, "fq_rows": fq_rows, "bw_rows": bw_rows,
            "tt_sites": n_tt, "profile": prof}


def phase_train_lm_identity(torch, device: str = "cuda") -> dict:
    """One LM step on the card equals the same step on the CPU from the
    same state: a small TT LM (2 layers, d_model 32, every projection TT,
    f32, int8 moments and the wire). Loss, ce, prior within 1e-5
    relative, gnorm within 1e-4 (a wire code may flip: see below); scale
    exponents equal, their statistics within 1e-5; params within 2 lr
    (Adam's first step moves an element by at most lr; a gradient value
    within roundoff of a wire code boundary can take the neighbouring
    code) and 99.9% of their elements within 2e-5."""
    from repro_torch.configs.base import (ModelConfig, QuantConfig,
                                          TrainConfig, TTConfig)
    from repro_torch.data import lm_batch
    from repro_torch.launch import steps as S
    from repro_torch.models.lm import build_lm, init_lm
    from repro_torch.tree import flatten_with_path

    cfg = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64, remat="full",
                      dtype="float32",
                      tt=TTConfig(enable=True, d=3, max_rank=4,
                                  min_elements=1024),
                      quant=QuantConfig(enable=True))
    lm = build_lm(cfg)
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=8, warmup_steps=5)
    p_cpu = init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    out = {}
    b = lm_batch(0, batch=2, seq=16, vocab=64, seed=0)
    for dev in ("cpu", device):
        params = _tensor_tree(torch, p_cpu, dev)
        state = S.init_train_state(params, tcfg, cfg.quant.policy())
        out[dev] = S.make_train_step(lm, None, tcfg)(
            state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    (sc, mc), (sg, mg) = out["cpu"], out[device]
    rels = {}
    for k in ("loss", "ce", "prior", "gnorm"):
        rels[k] = abs(mg[k].item() - mc[k].item()) / abs(mc[k].item())
        check(rels[k] <= (1e-4 if k == "gnorm" else 1e-5),
              f"lm identity: {k} rel diff {rels[k]:.2e}")
    for name in ("activation", "grad_edge"):
        check(int(sg.scales[name].log2) == int(sc.scales[name].log2),
              f"lm identity: {name} exponent differs")
        r = abs(sg.scales[name].mean_abs.item()
                - sc.scales[name].mean_abs.item()) \
            / sc.scales[name].mean_abs.item()
        check(r <= 1e-5, f"lm identity: {name} statistic rel diff {r:.2e}")
    close = total = 0
    move = 0.0
    for (p, a), (_, c) in zip(flatten_with_path(sg.params),
                              flatten_with_path(sc.params)):
        if not a.is_floating_point():
            check(torch.equal(a.cpu(), c), f"lm identity: {p} differs")
            continue
        e = (a.cpu() - c).abs()
        check(e.max().item() <= 2 * tcfg.learning_rate + 1e-6,
              f"lm identity: {p} differs by {e.max().item():.3e}")
        move = max(move, e.max().item())
        close += int((e <= 2e-5).sum())
        total += e.numel()
    check(close >= 0.999 * total, f"lm identity: {close}/{total} close")
    log(f"train lm identity: card vs CPU {rels}, params within {move:.2e} "
        f"({close}/{total} within 2e-5); scale exponents equal")
    return {"rel": rels, "param_max_diff": move, "params_close": close,
            "params_total": total}


# ---------------------------------------------------------------------------

KERNELS = {
    "p2_prefill_paged": ("src/repro_torch/kernels/csrc/kv_prefill.cu",
                         "src/repro/numerics/pallas_backend.py:189"),
    "p2_append_paged": ("src/repro_torch/kernels/csrc/kv_append.cu",
                        "src/repro/numerics/pallas_backend.py:189"),
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
# the tensor-core route of PE1 / PE2 / PE3 (the LM step's every launch of
# each)
LM_KERNELS = {
    "pe1_mma": ("src/repro_torch/kernels/csrc/ttm_pe1.cu",
                "src/repro/kernels/ttm_pe1.py:34", "pe1"),
    "pe2_mma": ("src/repro_torch/kernels/csrc/ttm_pe2.cu",
                "src/repro/kernels/ttm_pe2.py:25", "pe2"),
    "pe3_mma": ("src/repro_torch/kernels/csrc/ttm_pe3.cu",
                "src/repro/kernels/ttm_pe3.py:23", "pe3"),
}
READ = ("src/repro_torch/kernels/csrc/kv_read.cu",
        "src/repro/numerics/pallas_backend.py:127")
ENC_ROWS = ("src/repro_torch/kernels/csrc/pow2_rows.cu",
            "src/repro/numerics/pallas_backend.py:189")
DEC_ROWS = ("src/repro_torch/kernels/csrc/pow2_rows.cu",
            "src/repro/numerics/pallas_backend.py:196")
ST_DEC = ("src/repro_torch/kernels/csrc/state_codec.cu",
          "src/repro/numerics/pallas_backend.py:196")
ST_ENC = ("src/repro_torch/kernels/csrc/state_codec.cu",
          "src/repro/numerics/pallas_backend.py:189")
RT_GROUP = ("src/repro_torch/kernels/csrc/pow2_fq.cu",
            "src/repro/numerics/pallas_backend.py:120")


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


def _state_path(name: str, rwkv: dict, hybrid: dict, api: dict) -> str:
    """Where a codec kernel runs on the state path, with its launches a
    step (from ``_state_want``, which the runs and profiles asserted) and
    in each run."""
    def per(steps):
        return ", ".join(f"{steps[k][name]} a {w}" for k, w in
                         (("decode", "decode step"),
                          ("prefill", "whole-prompt prefill"),
                          ("chunk", "chunk step")) if name in steps[k])
    return (f"serve rwkv6 ({per(rwkv['per_step'])}): int8 run "
            f"{rwkv['int8']['launches'].get(name, 0)}, chunked run "
            f"{rwkv['chunked']['launches'].get(name, 0)}; serve hybrid "
            f"({per(hybrid['per_step'])}): whole-prompt run "
            f"{hybrid['whole']['launches'].get(name, 0)}, chunked run "
            f"{hybrid['chunked']['launches'].get(name, 0)}; codec API "
            f"{api.get(name, 0)}")


def kernels_line(kern: dict, eng: dict, tkern: dict, train: dict,
                 wkern: dict, wire: dict, skern: dict, chunked: dict,
                 lmkern: dict, lm: dict, spec: dict, state: dict,
                 rwkv: dict, hybrid: dict, sgroup: dict) -> dict:
    rows = []
    for name, (src, replaces) in KERNELS.items():
        rows.append(_kernel_row(name, src, replaces, kern[name],
                                eng["launches_main"].get(name, 0),
                                "main (fused)"))
    rows.append(_kernel_row(
        "p2_read_paged", *READ, kern["p2_read_paged"],
        chunked["launches"].get("p2_read_paged", 0),
        f"serve chunked prefix ({chunked['chunk_steps']} chunk steps); "
        f"gather engine {eng['launches_gather'].get('p2_read_paged', 0)}"))
    for row in rows:
        # the speculative path's launches, run (a): the shallow draft (the
        # rows so far are its five kernels; none below runs on it)
        row["spec_launches"] = spec["draft"]["launches"].get(row["name"], 0)
        row["path"] += (f"; serve spec ({spec['draft']['rounds']} rounds, "
                        f"{row['spec_launches']} launches)")
    # the state path's codec launches (the int8 rwkv6 run for the group
    # kernels and the prefill's row encode, the chunked run for the scalar
    # ones), its shapes first
    api = skern["api_launches"]
    for name, src in (("st_dec_group", ST_DEC), ("st_enc_group", ST_ENC)):
        rows.append(_kernel_row(
            name, *src, sgroup[name], rwkv["int8"]["launches"].get(name, 0),
            _state_path(name, rwkv, hybrid, api)))
    replay = rwkv["replay"]["per_layer_launches"]
    for name, src in (("p2_enc_rows", ENC_ROWS), ("p2_dec_rows", DEC_ROWS)):
        launches = rwkv["int8"]["launches"].get(name, 0)
        path = _state_path(name, rwkv, hybrid, api)
        if name == "p2_dec_rows":
            # no serving path reads rows since the decode step's group
            # read: its launches are the replay's per-layer route's, the
            # previous design run on the same engine
            launches = replay.get(name, 0)
            path = ("no serving path (the decode step reads through "
                    "st_dec_group); the replay's per-layer route "
                    f"{launches}; " + path)
        rows.append(_kernel_row(name, *src, state[name] + kern[name],
                                launches, path))
        rows[-1]["api_launches"] = api.get(name, 0)
    for name, (src, replaces) in TRAIN_KERNELS.items():
        rows.append(_kernel_row(name, src, replaces, tkern[name],
                                train["launches"].get(name, 0),
                                f"train ({train['steps']} steps)"))
    rows.append(_kernel_row(
        "p2_rt_group", *RT_GROUP, tkern["p2_rt_group"],
        train["export_launches"].get("p2_rt_group", 0),
        "BinaryConnect export (train phase; replaces :127 too)"))
    for name, (src, replaces) in WIRE_KERNELS.items():
        rows.append(_kernel_row(name, src, replaces, wkern[name],
                                wire["launches"].get(name, 0),
                                f"train wire ({wire['steps']} steps, site "
                                "table and deploy export)"))
    for row in rows:
        # the LM step's launches (its PE launches are the tensor-core rows
        # below)
        name = row["name"]
        if name in lm["launches"] and name not in ("pe1", "pe2", "pe3"):
            row["lm_launches"] = lm["launches"][name]
            row["path"] += (f"; train lm ({lm['steps']} steps, "
                            f"{lm['launches_per_step'][name]} a step)")
        if name == "p2_fake_quant":
            row["shapes"] = row["shapes"] + lm["fq_rows"]
        if name == "bw_enc":
            row["shapes"] = row["shapes"] + lm["bw_rows"]
    for name, (src, replaces, kind) in LM_KERNELS.items():
        rows.append(_kernel_row(
            name, src, replaces, lmkern[kind], lm["launches"].get(kind, 0),
            f"train lm ({lm['steps']} steps, "
            f"{lm['launches_per_step'][kind]} a step: every {kind} launch of "
            "the LM step, by route and by profile name)"))
    for name, (src, replaces) in SCALAR_KERNELS.items():
        if name == "p2_fq_rows":
            rows.append(_kernel_row(
                name, src, replaces, skern[name], api.get(name, 0),
                "codec API (numerics.fake_quant with a scale per leading "
                "index; no serving or training path)"))
            continue
        rows.append(_kernel_row(
            name, src, replaces, state[name] + skern[name],
            rwkv["chunked"]["launches"].get(name, 0),
            _state_path(name, rwkv, hybrid, api)))
        rows[-1]["api_launches"] = api.get(name, 0)
    return {"kernels": rows}


def phase_tokens(torch, path: str) -> None:
    """The greedy tokens of the serving runs at full width (engine fused
    and gather, chunked prefix; the int8 rwkv6-1.6b and jamba runs of
    ``_recurrent_cells``), written to ``path``."""
    lm, params = full_model(torch)
    prompts = _requests(lm.cfg.vocab_size)
    out = {}
    for name, kw in (("fused", dict(fused_attention=True)),
                     ("gather", dict(fused_attention=False)),
                     ("chunked_prefix", dict(fused_attention=True,
                                             prefill_chunk=CHUNK,
                                             prefix_cache=True))):
        reqs = (_chunked_prefix_requests(lm.cfg.vocab_size)
                if name == "chunked_prefix" else prompts)
        _, out[name] = _serve_engine(torch, lm, params, reqs, 64, **kw)
        log(f"tokens {name}: {len(out[name])} completions")
    del params
    for name, (lm, params), reqs, kw in _recurrent_cells(torch):
        _, out[name] = _serve_engine(torch, lm, params, reqs(lm), 64, **kw)
        log(f"tokens {name}: {len(out[name])} completions")
        del params
        torch.cuda.empty_cache()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out))


def _recurrent_cells(torch):
    """The int8 recurrent serving runs of ``--tokens`` and ``--steps``, one
    model at a time: (name, (lm, params), prompts of lm, engine options):
    rwkv6-1.6b at full size on the engine phase's 16 requests, and
    jamba-1.5-large's period (dense FFNs) on 8, fused attention."""
    from repro_torch.configs.base import MoEConfig
    yield ("rwkv6_int8", _state_model(torch, SSM_ARCH),
           lambda lm: _requests(lm.cfg.vocab_size), {})
    torch.cuda.empty_cache()
    yield ("hybrid_int8", _state_model(torch, HYBRID_ARCH, num_layers=8,
                                       moe=MoEConfig(num_experts=0)),
           lambda lm: _requests(lm.cfg.vocab_size, n=8, seed=1),
           {"fused_attention": True})


def phase_steps(torch, path: str) -> None:
    """The whole-prompt prefill's (S = 512), the chunk step's and the decode
    steps' (fused and gather) host wall and device time at full width,
    with the KV kernels' launches a step, then the int8 rwkv6-1.6b and
    jamba decode steps' (``_recurrent_cells``; 6 steps, the state kernels'
    launches a step, peak memory), written to ``path``; nothing asserted,
    so a parent tree's port can be measured beside this one in one
    call."""
    lm, params = full_model(torch)
    prompts = _requests(lm.cfg.vocab_size)
    out = {"prefill": _profile_prefill(torch, lm, params, prompts),
           "chunk": _profile_chunk(torch, lm, params, prompts),
           "decode": _profile_decode(torch, lm, params, prompts, fused=True),
           "gather_decode": _profile_decode(torch, lm, params, prompts,
                                            fused=False)}
    del params
    for name, (lm, params), reqs, kw in _recurrent_cells(torch):
        out[f"{name}_decode"] = _profile_decode(
            torch, lm, params, reqs(lm), steps=6,
            fused=kw.get("fused_attention", False), names=STATE_FNS,
            what=f"{name} decode", cpu=False)
        del params
        torch.cuda.empty_cache()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out))


def phase_pe_repeat(torch, reps: int) -> dict:
    """Each of the LM's PE2 calls on the tensor cores ``reps`` times into
    an output filled with NaN before every launch, held bit for bit to the
    first launch: a launch that differs is logged with how many elements,
    where (the a, d, c it touches) and how far from the plain version, and
    an element never written would show as NaN. Nothing asserted, no
    result line: a diagnostic of the ``lm kernels`` check "two launches
    differ" (ROADMAP queue 3)."""
    from repro_torch.kernels import tt_mma, ttm_pe2
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for kind, zs, gs in _lm_pe_calls():
        if kind != "pe2":
            continue
        z = torch.randn(zs, generator=gen, device="cuda").to(torch.bfloat16)
        g = (torch.randn(gs, generator=gen, device="cuda") * 0.2).to(
            torch.bfloat16)
        p = tt_mma.plan_for(z, g)
        ref = ttm_pe2.pe2_torch(z, g).float()
        first, differ, nan = None, [], 0
        for i in range(reps):
            o = torch.full((zs[0], gs[1], zs[2]), float("nan"),
                           dtype=torch.bfloat16, device="cuda")
            tt_mma.launch("pe2", "ttm_pe2", p, z, g, o)
            nan += int(o.isnan().sum())
            if first is None:
                first = o
                continue
            diff = o.view(torch.int16) != first.view(torch.int16)
            if diff.any():
                at = diff.nonzero()
                differ.append({
                    "launch": i, "elements": int(diff.sum()),
                    "a": sorted(set(at[:, 0].tolist()))[:8],
                    "d": sorted(set(at[:, 1].tolist()))[:8],
                    "c": sorted(set(at[:, 2].tolist()))[:8],
                    "err": float((o.float() - ref)[diff].abs().max()),
                    "first_err": float((first.float() - ref)[diff]
                                       .abs().max())})
        name = f"{zs}x{gs}"
        out[name] = {"orientation": p.orientation, "launches": reps,
                     "differ": differ, "nan": nan}
        log(f"pe repeat {name} ({p.orientation}): {len(differ)} of "
            f"{reps - 1} launches differ from the first, {nan} NaN "
            f"elements; {differ[:4]}")
    return out


def phase_deploy(torch, path: str, reps: int = 20) -> None:
    """The deploy export's packed encode and decode of the six FMNIST cores
    on the card, core by core and, where the port has the groups, as one
    group each way (CUDA-event means, ``Timer``); the host wall of
    ``export_tt_deploy`` and ``load_tt_deploy`` of the seeded MLP over
    ``reps`` calls each, synchronised, with their launches; written to
    ``path``. Nothing asserted, so a parent tree's port can be measured
    beside this one in one call."""
    import tempfile
    from repro_torch.ckpt import export_tt_deploy, load_tt_deploy
    from repro_torch.kernels import build as B
    from repro_torch.models import mlp_tt as MLP
    from repro_torch.numerics import cuda_backend as CB
    timer = Timer(torch)
    cores = _export_cores(torch, "cuda")
    xs = [x for _, x, _ in cores]
    ss = [s for _, _, s in cores]
    lasts = [x.shape[1] for x in xs]
    ps = [CB.encode_packed(x, s, 4) for x, s in zip(xs, ss)]
    out = {"per_core_enc_ms": timer(lambda: [
               CB.encode_packed(x, s, 4) for x, s in zip(xs, ss)]),
           "per_core_dec_ms": timer(lambda: [
               CB.decode_packed(p, s, last)
               for p, s, last in zip(ps, ss, lasts)])}
    if hasattr(CB, "encode_packed_many"):
        out["group_enc_ms"] = timer(lambda: CB.encode_packed_many(xs, ss, 4))
        out["group_dec_ms"] = timer(lambda: CB.decode_packed_many(
            ps, ss, lasts))
    params = MLP.init_mlp(torch.Generator(device="cuda").manual_seed(0),
                          MLP.make_mlp(), device="cuda")
    walls = {"export": [], "load": []}
    with tempfile.TemporaryDirectory() as tmp:
        f = f"{tmp}/deploy.ckpt"
        for i in range(reps + 1):               # the first call warms up
            for what, fn in (("export", lambda: export_tt_deploy(f, params)),
                             ("load", lambda: load_tt_deploy(f,
                                                             device="cuda"))):
                torch.cuda.synchronize()
                B.reset_launches()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i:
                    walls[what].append((time.perf_counter() - t0) * 1e3)
                out[f"{what}_launches"] = dict(B.LAUNCHES)
    for what, ms in walls.items():
        out[f"{what}_wall_ms"] = ms
        out[f"{what}_wall_ms_mean"] = sum(ms) / len(ms)
    log(f"deploy: {json.dumps(out)}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the full report as JSON here")
    ap.add_argument("--pe-anatomy", action="store_true",
                    help="only build and time the PE1/PE2/PE3 kernels with "
                    "one phase cut out at a time (no result line)")
    ap.add_argument("--pa-anatomy", action="store_true",
                    help="only build and time the attention split pass with "
                    "one phase cut out at a time (no result line)")
    ap.add_argument("--codec-anatomy", action="store_true",
                    help="only build and time the LM step's large fake-quant "
                    "and blockwise-encode launches with one part cut out at "
                    "a time (no result line)")
    ap.add_argument("--tokens", metavar="PATH",
                    help="only serve the engine, chunked-prefix and int8 "
                    "rwkv6 and jamba requests and write their tokens here "
                    "(no result line)")
    ap.add_argument("--steps", metavar="PATH",
                    help="only profile the whole-prompt prefill, the chunk "
                    "step, the fused and gather decode steps and the int8 "
                    "rwkv6 and jamba decode steps and write them here (no "
                    "result line)")
    ap.add_argument("--deploy", metavar="PATH",
                    help="only time the deploy export's packed encode and "
                    "decode, core by core and grouped, and the export's and "
                    "load's host wall, and write them here (no result line)")
    ap.add_argument("--pe-repeat", type=int, metavar="N",
                    help="only launch each of the LM's PE2 calls on the "
                    "tensor cores N times and log every launch whose bits "
                    "differ from the first (no result line)")
    ap.add_argument("--src", help="the directory holding repro_torch "
                    "(default: src beside this script)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = Path(args.src).resolve() if args.src else ROOT / "src"
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
    if args.tokens or args.steps or args.deploy or args.pe_repeat:
        if args.pe_repeat:
            phase_pe_repeat(torch, args.pe_repeat)
        if args.tokens:
            phase_tokens(torch, args.tokens)
        if args.steps:
            phase_steps(torch, args.steps)
        if args.deploy:
            phase_deploy(torch, args.deploy)
        return 0
    t0 = time.perf_counter()
    report = {"device": smi}
    report["build"] = phase_build()
    timer = Timer(torch)
    if args.pe_anatomy or args.pa_anatomy or args.codec_anatomy:
        if args.pe_anatomy:
            report["pe_anatomy"] = phase_pe_anatomy(torch, timer)
        if args.pa_anatomy:
            report["pa_anatomy"] = phase_pa_anatomy(torch, timer)
        if args.codec_anatomy:
            report["codec_anatomy"] = phase_codec_anatomy(torch, timer)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(report, indent=1))
        return 0
    report["kernels"] = phase_kernels(torch, timer)
    report["train_kernels"] = phase_train_kernels(torch, timer)
    report["wire_kernels"] = phase_wire_kernels(torch, timer)
    report["scalar_kernels"] = phase_scalar_kernels(torch, timer)
    report["state_kernels"] = phase_state_kernels(torch, timer)
    report["state_group"] = phase_state_group(torch, timer)
    del timer
    lm, params = full_model(torch)
    report["engine"] = phase_engine(torch, lm, params)
    report["serve_chunked"] = phase_serve_chunked(torch, lm, params)
    report["serve_spec"] = phase_serve_spec(
        torch, lm, params, report["engine"]["fused_tokens"])
    del params
    torch.cuda.empty_cache()
    report["identity"] = phase_identity(torch)
    report["chunked_identity"] = phase_chunked_identity(torch)
    t_state = time.perf_counter()
    lm, params = _state_model(torch, SSM_ARCH)
    report["serve_rwkv6"] = phase_serve_rwkv6(torch, lm, params)
    del params
    torch.cuda.empty_cache()
    report["serve_hybrid"] = phase_serve_hybrid(torch)
    report["ssm_identity"] = phase_ssm_identity(torch)
    report["state_phases_s"] = time.perf_counter() - t_state
    log(f"recurrent phases (serve rwkv6, serve hybrid, ssm identity) in "
        f"{report['state_phases_s']:.1f} s")
    report["train"] = phase_train(torch)
    report["train_identity"] = phase_train_identity(torch)
    report["train_wire"] = phase_train_wire(torch)
    report["train_wire_identity"] = phase_train_wire_identity(torch)
    report["lm_kernels"] = phase_lm_kernels(torch, Timer(torch))
    report["train_lm"] = phase_train_lm(torch)
    report["train_lm_identity"] = phase_train_lm_identity(torch)
    report["seconds"] = time.perf_counter() - t0
    line = kernels_line(report["kernels"], report["engine"],
                        report["train_kernels"], report["train"],
                        report["wire_kernels"], report["train_wire"],
                        report["scalar_kernels"], report["serve_chunked"],
                        report["lm_kernels"], report["train_lm"],
                        report["serve_spec"], report["state_kernels"],
                        report["serve_rwkv6"], report["serve_hybrid"],
                        report["state_group"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    idle = [r["name"] for r in line["kernels"] if r["launches"] < 1]
    check(not idle, f"kernels launched no time on their path: {idle}")
    log(f"all phases passed in {report['seconds']:.1f} s")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
