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
             encode also re-reading its values (``reread_ms``). Then the
             chunk step's and the prefill's one-slot launches at rwkv6's
             full slot (24 layers) and jamba's period in a pool of 8
             slots: st_dec_slot and st_enc_slot for the first, a middle
             and the last slot, one launch each (the plan's count), bit
             for bit with their twins and the per-layer route they
             replaced (read_layer / write_slot: p2_dec, p2_enc and the
             scale's eager ops a (layer, tensor)), scale edges and an
             all-zero row in them, no other slot written; the prefill
             write (write_prefill: the same launch) bit for bit with the
             previous prefill route (p2_enc_rows a tensor, p2_enc for a
             one-layer stack); each timed beside the per-layer route, its
             twin and its byte bound, the encode also re-reading its
             values and with a CTA a row, the prefill beside its previous
             route.
   health kernels — the three quant-health counters inside the encoding
             kernels at their paths' shapes: p2_append_paged (the decode
             step's append at 8 slots x 8 x 128 bf16, inactive slots, one
             past its pages, one clipping; and MLA's latent pair 512 +
             64), st_enc_group (rwkv6-1.6b's 24-layer pool, an inactive
             slot, scale edges, an all-zero row) and p2_fq_group (the LM
             grad edge's first bf16 group, 380,597,248 elements at 16
             bits, half the steps one below the tensor's max so codes
             saturate): counts equal to the plain twins' integer for
             integer, the codes bit for bit those of the counter-off
             launch, each timed with the counter on and off.
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
   serve obs — the port's observability on the card: the engine phase's
             16 requests on the same model with NumericsPolicy(health=True),
             a TraceRecorder and the memory ledger, the tokens and every
             launch count equal to the health-off fused run's, every
             request span closed and nested, one timeline row per decode
             step, the kv_cache total the steps' active slots x 24 x 2 x 8
             x 128, the ledger reconciled against torch.cuda.
             memory_allocated; rwkv6-1.6b (8 prompts of 32 tokens, 16 new)
             with and without health, tokens and launches equal, the
             ssm_state drift reported; one with_tt(internlm2-1.8b) step
             through launch/train.py's train with health, a trace and a
             ledger (launches as counted, the train_step event's health
             fields, the ledger's sites beside the step's peak, reconcile
             ok). Under 150 s.
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
             bf16, ~1.58 B seeded parameters) serving the first 4 of the
             engine phase's requests (128..512 tokens, 64 new, 8 slots)
             from an int8 state pool, an fp pool and, chunked (128), the
             int8 pool; counts zeroed just before and read just after
             each run, exact: 1 st_dec_group + 1 st_enc_group a decode
             step, 1 st_enc_slot a whole-prompt prefill, 1 st_dec_slot +
             1 st_enc_slot a chunk step (the plans' counts; no p2_dec_rows,
             p2_enc_rows, p2_dec or p2_enc), no kernel on the fp pool; no
             KV kernel,
             cache_bytes 0, every slot free at the end, state_reduction
             >= 3.5; a replay of 3 int8 decode steps (7 of 8 slots busy)
             through the engine and again, from the same pool, through
             the per-layer route: logits and every pool byte equal; a
             replay of a chunked prefill (a 300-token prompt in chunks of
             128 into the last slot) through the engine and the per-layer
             route (lm_forward + p2_enc_rows, then read_layer /
             write_slot a (layer, tensor)): logits and every pool byte
             equal; the int8-vs-fp greedy agreement (bf16) reported; the
             decode
             step, a 512-token prefill and a chunk step timed and
             profiled, the state kernels asserted by name.
   serve hybrid — jamba-1.5-large with dense FFNs at full width for one
             period (8 layers: 7 Mamba, 1 attention; ~9.0 B parameters),
             8 requests x 64 new tokens over an int8 KV pool and an int8
             state pool, fused attention, whole-prompt and chunked (128):
             a decode step 1 st_dec_group + 1 st_enc_group, 1
             p2_append_paged, 1 split + 1 combine; a prefill 1
             st_enc_slot and 1 p2_prefill_paged; a chunk step 1
             st_dec_slot + 1 st_enc_slot, 1 p2_append_paged and 1
             p2_read_paged; by counter and by profile name.
   ssm identity — fp32: rwkv6 with 4 layers at full width and the reduced
             jamba with dense FFNs: the engine (slots recycling) equals
             static decode (lm_forward with its cache, then lm_decode_step
             at B = 1), chunked prefill (128) equals it, a forced
             preemption resumes identically, and an fp pool under
             NumericsPolicy(enable=True) serves from an int8 state pool
             with the int8 engine's tokens, token for token; a failed
             check lists which products differ between M = 1 and M = 8.
   serve moe — the eighth main path: moonshot-v1-16b at full size (48
             layers, d_model 2048, 16 heads over 16 KV heads, 64 experts of
             d_ff 1408, top-6, vocab 163,840, untied head; bf16,
             28,057,995,264 seeded parameters, asserted), every earlier
             model freed first (under 2 GiB allocated, asserted), serving
             the first 4 of the engine phase's requests x 64 new tokens
             from the int8
             paged pool with fused attention, whole prompt and chunked
             (128); counts zeroed just before and read just after each
             run, exact: a decode step 48 p2_append_paged, 48 split and 48
             combine, a whole-prompt prefill 1 p2_prefill_paged, a chunk
             step 48 p2_append_paged and 48 p2_read_paged, no codec or
             state launch; the (expert, token) pairs the capacity dropped
             in each run; a decode step, a 512-token prefill and a chunk
             step profiled (the pool and attention kernels by name, the
             device time by kind of kernel), one MoE layer of the decode
             step timed by part; rows 1b, 5b, 6b, 1c (48 layers) and 3
             (S = 1, 16 query over 16 KV heads) at 16 KV heads, held to
             their twins and timed; then fp32 at full width with 2
             layers: at a drop-free capacity factor (64) the engine ==
             chunked == preempted == static decode token for token (and
             the policy engine's int8 KV pool serves the int8 engine's
             tokens), and at the config's 1.25 a 512-token prefill on the
             card against the CPU: the routed experts and the kept
             (expert, token) pairs equal per layer but for near ties
             under 1e-6 relative (listed), logits within 1e-4, pairs
             dropped. The phase's wall must stay under 150 s.
   serve mla — the ninth main path: deepseek-v2-236b at full width
             (d_model 5,120, 128 heads, MLA with kv_lora 512, q_lora
             1,536, nope/rope/v 128/64/128; 160 experts and 2 shared of
             d_ff 1,536, top-6; vocab 102,400; bf16) cut to 6 of its 60
             layers (24,881,280,000 seeded parameters, asserted), every
             earlier model freed first, from the int8 latent pool (c_kv 512
             and k_rope 64 codes a token a layer, asserted, 4.00x against
             fp32): rows 1b, 5b, 6b and 1c on the latent pair (two widths
             in one launch; and at 512 + 36, one tensor on the element
             loop) bit for bit with their twins and over two launches,
             timed; the engine phase's 16 requests x 64 new tokens whole
             prompt and chunked (128) with fused_attention=True, counts
             exact (a decode step 6 p2_append_paged + 6 p2_read_paged, a
             prefill 1 p2_prefill_paged, a chunk step 6 + 6, no
             paged-attention or codec launch), by counter and by profile
             name; a decode step's device and host ms beside its byte
             bound, by kind, peak memory, the dropped-pair share; then fp32
             at full width with 2 layers at capacity factor 64: engine ==
             chunked == preempted == static decode (lm_decode_step with
             mla_decode), the policy engine's int8 latent pool the int8
             engine's tokens. Under 100 s.
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
             wire, 6 steps of ``launch/train.py::train`` on
             ``lm_batch(step, batch=8, seq=256, seed=0)``, seeded weights
             on the card; counts zeroed just before and read just after
             (each 6 x ``steps.launches_per_step``, computed from the
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
             codec launch's device time listed); then the same 6 steps
             with f32 moments, whose cross-entropy must fall.
9b. frontend kernels — the frontends' ten bf16 PE1 / PE2 calls whose
             rows of c or d are not 16-byte multiples (hubert-xlarge's c
             = 20 and d = 10, llava-next-34b's c = 28 and d = 20), on the
             tensor cores by cp.async granules (asserted), each within
             2e-2 of the plain version, bit for bit over two launches,
             timed beside pe1_kernel / pe2_kernel (``previous_ms``), the
             plain version, the faster of bf16 torch.matmul and
             torch.einsum and the bound, with its launches a step.
10. train lm identity — one step of a small TT LM (2 layers, d_model 32,
             every projection TT, f32, int8 moments and the wire) from the
             same state on the card and on the CPU: loss, ce and prior
             within 1e-5, gnorm within 1e-4, scale exponents equal, params
             within 2 lr and 99.9% within 2e-5.
11. train frontend — the tenth main path: one low-precision step (TT
             sites, quantization, int8 moments and wire) of
             with_tt(hubert-xlarge) at full size (48 layers, audio frames
             of 8 x 256, no embedding site) and of with_tt(llava-next-34b)
             at full width with 2 layers (56 heads padded to 64; 64
             patches + 256 tokens, batch 2, the loss on the text
             positions), launch/train.py's loop on make_batch_fn's
             reference batches: launches exact against launches_per_step,
             by counter and by profile name (PE1-3 on the tensor cores:
             no pe1_kernel, pe2_kernel or pe3_kernel in either profile,
             asserted), the cross-entropy finite; then one step of each
             at reduced width
             on the card against the CPU, as train lm identity. Under 110 s.
12. train ckpt — the eleventh main path: the launch and checkpoint
             tooling through launch/train.py::train at LM100M's full size
             (12 layers, d_model 768, vocab 32,768, f32; 8 x 256 tokens,
             f32 moments and the int8 wire, a save every 2 steps). (a)
             with_tt(LM100M, d=3, max_rank=48) uninterrupted 6 steps
             twice, each in a fresh checkpoint directory, launches exact,
             the final states compared bit for bit (the differing leaves
             named otherwise); the final state's asynchronous save timed
             (snapshot on the caller's thread, background write, size)
             and loaded back bit for bit. (b) a child process of this
             script sends itself SIGTERM from on_step after step 3: exit
             143, the periodic step_2.ckpt and the emergency step_4.ckpt;
             a second child resumes it ("resumed from step 4") to step 6:
             its losses for steps 4-5 and its final state are (a)'s. (c)
             the same with TT embedding and head sites and quantization
             (18,962,334 parameters): 2 steps with launches exact, one
             step profiled (every counted kernel by name: PE1 on
             pe1_kernel, PE2 and PE3 on the tile route, pe2_tile_kernel and
             pe3_tile_kernel, and no pe2_kernel / pe3_kernel), PE1-3 at
             every f32 shape of its step (PE2 and PE3 on the tile route,
             bit for bit over two launches, timed beside the previous
             design, pe2_kernel / pe3_kernel, and beside the faster of
             torch.matmul and torch.einsum), the embedding's
             and head's core groups and the wire's encode and decode
             groups held to their twins and timed, a reduced step with TT
             embedding and head on the card against the CPU. (d) the
             parameters, 6ND model FLOPs and TT-chain FLOPs of (a)'s and
             (c)'s steps beside the FP32 peak over the profiled steps.
             Every train call of the script writes its final save into a
             directory of its own, removed after.
13. train recurrent — the twelfth main path: the recurrent LMs' train
             step through the per-token scans, each 512-token sequence in
             two chunks of SCAN_CHUNK = 256 under the chunk remat, nested
             in the layer's (remat full); TT sites, quantization, int8
             moments and wire. (a) with_tt(rwkv6-1.6b) at full size (24
             layers, 783,921,624 parameters, TT on the channel mix) on 4 x
             512 tokens through launch/train.py::train; (b)
             with_tt(jamba-1.5-large) at full width, one period of 3
             layers (Mamba, attention with the MoE FFN of 16 TT experts
             top-2, Mamba; 1,923,017,198 parameters: the 8-layer
             period's 4.02 B need ~135 GiB in a
             step) on 1 x 512 through make_train_step: launches exact
             against
             launches_per_step, by counter and by profile name (no
             pe1_kernel, pe2_kernel or pe3_kernel but the f32 router's
             chains; the trace's device
             events counted from its event list), the cross-entropy
             finite, the host wall and peak memory, the host wall and peak
             of one more step with SCAN_CHUNK = 512 (one chunk), and a
             step of the same rows profiled (rwkv6's at 64 x 32: a
             profile of its 4 x 512 step holds ~970,000 device events):
             the launches by name and the device time. (c) each of their
             ungrouped PE calls that no earlier
             phase holds, on the tensor cores (asserted), within 2e-2 of
             the plain version, bit for bit over two launches, timed
             beside the plain version, the faster of bf16 torch.matmul
             and torch.einsum and the bound, with its launches a step. (d)
             one step of each at reduced width (TT on the default sites
             and jamba's experts, f32, SCAN_CHUNK 4: 4 chunks of the 16
             tokens) on the card against the CPU, as train lm identity.
             Under 90 s.
14. train moe — the thirteenth main path: the MoE LMs' train step with
             TT experts (int8 moments and wire, remat full), each expert
             site's PE1 / PE2 / PE3 one grouped launch for all experts
             (pe*_grouped by counter) and its cores' fake-quant one
             p2_fq_rows launch a core. (a) with_tt(moonshot-v1-16b) uncut
             (48 layers, 64 experts top-6, 1,145,122,368 parameters) on
             8 x 256 tokens, 2 steps through launch/train.py::train, then
             a third profiled: launches exact by counter and by profile
             name, the CUDA-core PE launches exactly the f32 router's, the
             device time and busy share, peak memory; (b)
             with_tt(deepseek-v2-236b) at full width with 2 of its 60
             layers (MLA, 160 experts top-6 and 2 shared) on 2 x 256, one
             step through make_train_step: MLA's backward on the card;
             (e) every grouped call of (a), (b) and train recurrent's
             jamba period on the tensor cores (asserted), within 2e-2 of
             the plain version, bit for bit over two launches and with
             the loop of ungrouped launches over the experts, timed beside
             that loop (previous_ms), the faster of one bf16 batched
             matmul and torch.einsum, the plain version and the bound;
             p2_fq_rows at moonshot's stacked cores; (d) reduced moonshot
             and deepseek with TT experts, one step on the card against
             the CPU. Under 260 s.

Output: human-readable lines, then one JSON line describing every kernel,
then the card's name and power limit (nvidia-smi), then the last line
``{"ok": true, "device": {...}}``. Exits non-zero without printing a
result when no CUDA device is available or when the repository's
``src/repro_torch`` is not beside this script.

``python3 chip_smoke.py --pe-anatomy [--out report.json]`` runs only the
build and a diagnostic of the PE1/PE2/PE3 kernels: each rebuilt with its FMA
loop, its copies or its stores cut out and timed at the step's shapes, so
the time of each phase reads as a difference (no profiler of kernel
internals works on the card's machine). It covers the CUDA-core bodies:
the streamed ones at the MLP's f32 shapes, the f32 tile route
(tt_tile.cuh) at LM100M's PE2 and PE3 calls, then PE3's calls at every
cluster size; the tensor-core routes (tt_mma.cuh, pe1_mma_kernel) have no
anatomy. ``--pa-anatomy`` does the same for the attention split pass (K/V staging, query load, scores, softmax, P @ V)
beside its combine pass. ``--codec-anatomy`` times the LM step's large
fake-quant and blockwise-encode launches on their stream units and on
the previous units: the fake-quant group in full, with its arithmetic cut
out and as a table of one, beside a ``copy_`` loop; the blockwise encode
group in full, with its coding pass cut out and with loads only. None of
the three prints a result line.

``python3 chip_smoke.py --tokens PATH [--src DIR]`` serves the engine
phase's requests (fused and gather), the chunked-prefix run's and the int8
rwkv6-1.6b and jamba runs (whole-prompt and chunked) at full width with
the port found under DIR (default: this checkout's ``src``; another
tree's ``src`` compares two versions in one call) and writes their greedy
tokens to PATH as JSON; no result line. ``--steps PATH [--src DIR]``
likewise profiles a whole-prompt prefill of 512 tokens, the chunk step,
the fused and gather decode steps and the int8 rwkv6-1.6b and jamba
decode steps, chunk steps and whole-prompt prefills (host wall, device
time, the pool kernels' launches, peak memory) and writes them to PATH,
asserting nothing.
``--pe-repeat N`` replays ``lm kernels``' check sequence (kernel, plain
twin, cuBLAS yardstick, plan, kernel again into a fresh allocation) N
times for each of the LM's PE1, PE2 and PE3 calls and the frontends' ten
granule calls, plus one PE2 launch a round into a NaN-filled output, and
logs every launch whose bits differ;
no result line. ``--deploy PATH [--src DIR]``
likewise times the deploy export's packed
encode and decode of the six FMNIST cores, core by core and (where the
port has them) as one group each, and the host wall of
``export_tt_deploy`` and ``load_tt_deploy`` with their launches, and
writes them to PATH, asserting nothing. ``--paged-rows PATH [--src DIR]``
times the paged KV rows (1b, 5b, 6b, 1c) at GQA's shapes, each held to
its twin, and writes them to PATH; no result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = [ROOT / "src"]               # the directory holding repro_torch
ARCH = "internlm2-1.8b"
TRAIN_STEPS = 300


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


@contextlib.contextmanager
def _ckpt_dir(what: str):
    """A fresh checkpoint directory for one ``train`` call (its final save
    lands there; a shared one would resume another run), removed after."""
    d = tempfile.mkdtemp(prefix=f"chip_smoke_{what}_")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


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
             fp32: bool = False) -> tuple[float, str]:
    """The least time for the work: bytes at the HBM rate or operations at
    the bf16 tensor-core peak (with ``fp32``, the FP32 CUDA-core peak, for
    kernels that run on the CUDA cores), whichever is larger; the card's
    figures are ``repro_torch.launch.roofline``'s."""
    from repro_torch.launch import roofline as R
    tb = nbytes / R.HBM_BW * 1e3
    to = ops / (R.PEAK_FLOPS_FP32 if fp32 else R.PEAK_FLOPS_BF16) * 1e3
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


def _append_inputs(torch, gen, hkv: int = 8):
    """A decode step's append at full width: K and V of 8 slots x ``hkv``
    heads x 128 in bf16 (V the strided half of the fused kv projection, as
    ``gqa_qkv`` slices it) into an int8 pool (513, 16, 8, 128) of random
    codes, 64 pages a slot. Slots at the first and the last offset of a
    page and at the last of their last page, two inactive slots at distinct
    trash offsets, one slot past its pages (trash); scales cover each
    slot's max but one slot's, which clips at both ends."""
    b, dh, page, pps = 8, 128, 16, 64
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


def _append_row(torch, timer, gen, hkv: int = 8) -> dict:
    """The paged KV append (``hkv`` heads) against its twin on the whole
    pool, bit for bit (trash page included), over two launches and against
    the previous design; timed beside the twin and that design
    (``previous_ms``)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import kv_append as KA
    from repro_torch.numerics import cuda_backend as CB
    args, kw = _append_inputs(torch, gen, hkv)
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
                                                fp32=True)
    log(f"p2_append_paged (K and V, {b} slots x {args[4].shape[2]} x "
        f"{args[4].shape[3]} bf16): {row['ms']*1e3:.2f} us one launch "
        f"(previous design {row['previous_ms']*1e3:.2f} us, plain "
        f"{row['plain_ms']*1e3:.1f} us, library {APPEND_NONE[:4]}, bound "
        f"{row['bound_ms']*1e3:.4f} us); pool bit-exact with the twin and "
        "the previous design, trash page written, two launches equal")
    return row


PAGED_NONE = ("none: no PyTorch call writes or reads tokens through a page "
              "table under per-slot scales")


def _paged_pool(torch, gen, hkv: int = 8):
    """The serving pool at full width: int8 K and V pages (513, 16, hkv,
    128) of random codes, 8 slots x 64 pages, each slot's pow-2 scales."""
    b, dh, page, pps = 8, 128, 16, 64
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
    slot, page, s, hkv = 3, 16, 128, kd0.shape[2]
    kv = (torch.randn((1, s, 2, hkv, 128), generator=gen, device=gen.device)
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
                                                2 * n, fp32=True)
    log(f"p2_append_paged chunk write (K and V, 128 rows x {hkv} x 128 "
        f"bf16): {row['ms']*1e3:.2f} us one launch (previous route "
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
                                                fp32=True)
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
            n, fp32=True)
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


PREFILL_CASES = ((512, 512), (128, 128), (512, 400))     # (S, valid rows)


def _prefill_rows(torch, timer, gen, layers: int = 24, hkv: int = 8,
                  cases=PREFILL_CASES) -> list:
    """The whole-prompt prefill write at full width (``layers`` layers, K
    and V of ``hkv`` x 128 bf16 as ``lm_forward`` stacks them, into int8
    pools (layers, 513, 16, hkv, 128) of random codes, slot 3 of 8 x 64
    pages) at S = 128 and 512: pages and scales bit for bit with the twin
    and with the parent's route, and over two launches, one launch each;
    then S = 512 with 400 valid rows (bucket padding). Timed beside the
    twin and the parent's route (``previous_ms``)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import kv_prefill as KP
    from repro_torch.numerics import cuda_backend as CB
    b, dh, page, pps, slot = 8, 128, 16, 64, 3
    total = b * pps
    kd0, vd0 = (torch.randint(-128, 128, (layers, total + 1, page, hkv, dh),
                              generator=gen, device=gen.device
                              ).to(torch.int8) for _ in range(2))
    ks0, vs0 = (torch.randint(-9, -2, (layers, b), generator=gen,
                              device=gen.device).float() for _ in range(2))
    table = torch.randperm(total, generator=gen, device=gen.device).reshape(
        b, pps).to(torch.int32)
    rows = []
    for s, length in cases:
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
                                                    fp32=True)
        rows.append(row)
        log(f"p2_prefill_paged (K and V, {layers} x {s} x {hkv} x 128 bf16, "
            f"{length} "
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
    att_shapes, comb_shapes, (kd, vd, ks, vs, table, lens) = _attention_rows(
        torch, timer, gen)
    b, hq, hkv, dh, page, pps = PA_SHAPE
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


# S = 1 (decode), S = 4 (a q-block), and S = 4 as the spec verify meets it:
# slot 7's block overhanging the horizon
PA_CASES = ((1, False), (4, False), (4, True))


def _attention_rows(torch, timer, gen, shape=PA_SHAPE, cases=PA_CASES):
    """Paged attention over an int8 pool of ``shape`` (B, Hq, Hkv, Dh,
    page, pages a slot) at each (S, overhang) case: within 1e-5 in fp32
    and 2 bf16 ulp + 1e-5 with bf16 q of its twin, two launches
    bit-identical, each kernel against its plain mirror; timed beside the
    twin, the library's gather + dequant + SDPA and the bound. An
    overhanging case's rows past the horizon are never emitted, so only
    the rows inside it are held to the twin. Returns (attention rows,
    combine rows, the pool and the last case's lengths)."""
    from repro_torch.kernels import paged_attention as PA
    b, hq, hkv, dh, page, pps = shape
    kd, vd, ks, vs, table = _pa_pool(torch, gen, shape)
    kw = dict(page_size=page, quantized=True)
    att_shapes, comb_shapes = [], []
    for s_rows, overhang in cases:
        lens = _pa_lens(torch, s_rows, shape)
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
        log(f"paged_attention S={s_rows}{' overhanging' * overhang} (Hq "
            f"{hq}, Hkv {hkv}): {ms*1e3:.1f} us (split "
            f"{comb['split_ms']*1e3:.1f} + combine {comb['ms']*1e3:.1f}; "
            f"plain {pms*1e3:.1f} us, library "
            f"{lms*1e3:.1f} us, bound {bms*1e3:.2f} us); fp32 err "
            f"{err32:.2e}, bf16 {ulps:.2f} ulp, two launches bit-identical")
    return att_shapes, comb_shapes, (kd, vd, ks, vs, table, lens)


def _pa_pool(torch, gen, shape=PA_SHAPE):
    """The attention timing case's int8 pool (B * pps pages and the trash
    page), pow-2 scales and a shuffled page table."""
    b, hq, hkv, dh, page, pps = shape
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


def _pa_lens(torch, s_rows, shape=PA_SHAPE):
    """Ragged contexts up to the last position: slot 1's row 0 sees to the
    last key of the first span and its rows 1.. the next, a span where a
    row has no unmasked key."""
    from repro_torch.kernels import paged_attention as PA
    b, hq, hkv, dh, page, pps = shape
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
                       fp32=True)
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
    kinds = _device_by_kind(torch, prof, steps)
    log(f"{what} profile: {wall*1e3:.2f} ms per step (host wall), device "
        f"{total:.2f} ms busy, busy share {total / (wall*1e3):.3f}; peak "
        f"memory over the steps {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**20:.1f} MiB above the engine's resident "
        "bytes)")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    log("  by kind (ms, launches a step): " + ", ".join(
        f"{k} {v['ms_per_step']:.3f} ({v['calls_per_step']:.0f})"
        for k, v in kinds.items()))
    _log_kernels(kern)
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows,
            "by_kind": kinds, "kernels": kern, "peak_bytes": peak,
            "step_bytes": peak - base}


def _profile_prefill(torch, lm, params, prompts, reps: int = 10,
                     want=None, names=KV_KERNEL_FNS,
                     what: str = "prefill", cpu: bool = True,
                     window_tokens: int = 512,
                     window_reps: int | None = None) -> dict:
    """One whole-prompt prefill at full width (512 tokens into slot 0 of
    the int8 pool: ``lm_forward`` and the pool writes), repeated: host wall
    per prefill (synchronised) and the peak memory over the repeats, then
    one profiled window for the device time per kernel and the pool
    kernels' launches, of ``window_reps`` (default ``reps``) prefills of
    the prompt's first ``window_tokens`` (a shorter window keeps a
    recurrent scan's trace small; its host wall is timed too). Each repeat
    rewrites the slot's pages and scales with the same values."""
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
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng._prefill(prompt, table_row, 0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    window_reps = window_reps or reps
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
                        for _ in range(window_reps)], window_reps, names,
        _kv_want(want), what, cpu=cpu)
    total, rows = _device_summary(torch, prof, window_reps)
    log(f"{what} profile: S=512 {wall*1e3:.2f} ms per prefill (host wall); "
        f"profiled S={len(short)}: {win_wall*1e3:.2f} ms host, device "
        f"{total:.3f} ms busy, busy share {total / (win_wall*1e3):.3f}; "
        f"peak memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**20:.1f} "
        "MiB above the engine's resident bytes)")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    _log_kernels(kern)
    return {"step_ms": wall * 1e3, "window_tokens": len(short),
            "window_ms": win_wall * 1e3, "device_ms": total,
            "busy_share": total / (win_wall * 1e3), "top": rows,
            "kernels": kern, "peak_bytes": peak, "step_bytes": peak - base}


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


OBS_SECONDS = 150.0                    # serve obs's wall, at most


def _obs_engine(torch, lm, params, prompts, gen_len: int, health: bool,
                trace=None):
    """Serve ``prompts`` on a fresh int8 engine (8 slots x 64 pages of 16,
    fused attention), with ``NumericsPolicy(health=True)`` when ``health``
    (the pool's numerics the same as without a policy) and ``trace`` as its
    recorder. Returns (engine, tokens in submission order, launches)."""
    from repro_torch.kernels import build as B
    from repro_torch.numerics import NumericsPolicy
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    policy = NumericsPolicy(enable=True, health=True) if health else None
    eng = Engine(lm, params, EngineConfig(
        pool=PoolConfig(num_slots=8, page_size=16, pages_per_slot=64,
                        quantized=True), fused_attention=True,
        policy=policy), device="cuda", trace=trace)
    torch.cuda.synchronize()
    B.reset_launches()
    rids = [eng.submit(p, max_new_tokens=gen_len) for p in prompts]
    res = eng.run()
    torch.cuda.synchronize()
    return eng, [res[r].tokens for r in rids], dict(B.LAUNCHES)


def _obs_trace_checks(what, eng, rec, feat_per_step) -> dict:
    """Every request span closed and nested, one timeline row per decode
    step, the KV site's total the decode steps' active slots times
    ``feat_per_step`` (0: no KV site), the ledger reconciled against the
    CUDA allocator. Returns the summary."""
    from repro_torch.obs import check_nesting, request_spans
    s = eng.summary()
    spans = request_spans(rec.events())
    check(len(spans) == s["requests_completed"] and all(
        sp.end is not None and check_nesting(sp) for sp in spans.values()),
        f"{what}: a request span is open or does not nest")
    steps = rec.events("decode_step")
    check(len(eng.metrics.timeline) == len(steps) == s["decode_steps"],
          f"{what}: {len(eng.metrics.timeline)} timeline rows for "
          f"{len(steps)} decode_step events")
    if feat_per_step:
        want = feat_per_step * sum(e.fields["n_active"] for e in steps)
        got = s["quant_health"]["kv_cache"]["total"]
        check(got == want, f"{what}: kv_cache total {got}, want {want}")
    rc = s["memory"]["reconcile"]
    check(rc["ok"], f"{what}: the ledger does not reconcile against the CUDA "
          f"allocator: {rc}")
    kinds = {}
    for e in rec:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    log(f"{what}: events {kinds}; quant health {s['quant_health']}; ledger "
        f"{rc['ledger_bytes']:,} B of {rc['live_bytes']:,} B allocated "
        f"(coverage {rc['coverage_frac']:.4f}), sites " + ", ".join(
            f"{k} {v['bytes']:,}" for k, v in s["memory"]["sites"].items()
            if v["counted"]))
    return {"summary": s, "events": kinds}


def phase_serve_obs(torch, lm, params, engine: dict) -> dict:
    """The port's observability on the card, three paths:

    - internlm2-1.8b at full size (24 layers, bf16) from the int8 pool,
      the engine phase's 16 requests x 64 new tokens with
      ``NumericsPolicy(health=True)``, a ``TraceRecorder`` and the ledger:
      the tokens identical to the engine phase's health-off fused run and
      every kernel launched exactly as often (health adds no launch: the
      KV clip counts come out of the 24 ``p2_append_paged`` launches a
      step), every request span closed and nested, one timeline row per
      decode step, the ``kv_cache`` total the decode steps' active slots
      x 24 layers x 2 x 8 x 128, ``summary()["memory"]["reconcile"]`` ok
      against ``torch.cuda.memory_allocated``;
    - rwkv6-1.6b at full size from the int8 state pool, 8 requests of 32
      tokens x 16 new, with and without health: tokens and launches equal
      (the counts come out of the one ``st_enc_group`` a step), the
      ``ssm_state`` drift reported;
    - one step of ``with_tt(internlm2-1.8b, quantize=True)`` through
      ``launch/train.py::train`` with health, a trace and a ledger on the
      card: launches as ``launches_per_step`` counts them (the grad edge's
      saturation counted inside its group launches), one ``train_step``
      event with the health fields, the ledger's sites beside
      ``torch.cuda.max_memory_allocated`` and its reconcile ok.

    The phase's wall must stay under ``OBS_SECONDS``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import build as B
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import train
    from repro_torch.models.lm import build_lm
    from repro_torch.obs import MemoryLedger, TraceRecorder
    from repro_torch.serve import kv_cache as KC
    t0 = time.perf_counter()
    out = {}
    cfg = lm.cfg
    prompts = _requests(cfg.vocab_size)
    rec = TraceRecorder()
    eng, toks, launches = _obs_engine(torch, lm, params, prompts, 64, True,
                                      rec)
    check(toks == engine["fused_tokens"], "serve obs: the tokens with health "
          "and a trace differ from the engine phase's health-off run")
    check(launches == engine["launches_main"], f"serve obs: launches "
          f"{launches}, the health-off run's {engine['launches_main']}")
    feat = lm.n_periods * sum(math.prod(f) for sub in lm.period
                              for f in KC.kv_feature_shapes(sub).values())
    check(feat == 24 * 2 * 8 * 128, f"serve obs: {feat} KV values a slot")
    out[ARCH] = _obs_trace_checks(f"serve obs {ARCH}", eng, rec, feat)
    out[ARCH]["launches"] = launches
    del eng, rec

    lm6, p6 = _state_model(torch, SSM_ARCH)
    short = [p[:32] for p in _requests(lm6.cfg.vocab_size, n=8, seed=3)]
    _, off_toks, off_launches = _obs_engine(torch, lm6, p6, short, 16, False)
    rec = TraceRecorder()
    eng, toks, launches = _obs_engine(torch, lm6, p6, short, 16, True, rec)
    check(toks == off_toks and launches == off_launches,
          f"serve obs {SSM_ARCH}: health changed the tokens or the launches "
          f"({launches} against {off_launches})")
    out[SSM_ARCH] = _obs_trace_checks(f"serve obs {SSM_ARCH}", eng, rec, 0)
    st = out[SSM_ARCH]["summary"]["quant_health"]["ssm_state"]
    check(st["total"] > 0 and st["scale_drift_log2"] > 0,
          f"serve obs {SSM_ARCH}: ssm_state health {st}")
    del eng, rec, lm6, p6
    torch.cuda.empty_cache()

    lcfg = _lm_config()
    lcfg = lcfg.replace(quant=dataclasses.replace(lcfg.quant, health=True))
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=1, warmup_steps=5, log_every=1)
    per = S.launches_per_step(build_lm(lcfg), tcfg)
    rec, led = TraceRecorder(), MemoryLedger("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    B.reset_launches()
    with _ckpt_dir("obs") as d:
        state, losses = train(lcfg, "tp", dataclasses.replace(
            tcfg, ckpt_dir=d), batch=LM_BATCH, seq=LM_SEQ, device="cuda",
            trace=rec, ledger=led)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(dict(B.LAUNCHES) == per, f"serve obs train lm: launches "
          f"{dict(B.LAUNCHES)}, want {per}")
    evs = rec.events("train_step")
    check(len(evs) == 1 and {"grad_sat_fraction", "act_scale_log2",
                             "act_in_band"} <= set(evs[0].fields),
          f"serve obs train lm: train_step events {evs}")
    rc = led.reconcile()
    check(rc["ok"], f"serve obs train lm: reconcile {rc}")
    wm = led.watermark("train_step")
    sites = {k: v["bytes"] for k, v in led.summary()["sites"].items()}
    log(f"serve obs train lm: event {evs[0].fields}; ledger sites {sites}, "
        f"{led.total():,} B counted ({led.total() / 2**30:.3f} GiB), "
        f"train_step watermark {wm['total_bytes']:,} B; allocated after the "
        f"step {rc['live_bytes']:,} B (coverage {rc['coverage_frac']:.4f}); "
        f"the step's peak {peak:,} B ({peak / 2**30:.2f} GiB) above the "
        f"{base:,} B held before it")
    out["train_lm"] = {"event": evs[0].fields, "sites": sites,
                       "ledger_bytes": led.total(), "reconcile": rc,
                       "watermark": wm["total_bytes"], "peak_bytes": peak,
                       "base_bytes": base, "launches": per, "loss": losses}
    del state
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"serve obs: {out['seconds']:.1f} s")
    check(out["seconds"] < OBS_SECONDS, f"serve obs took {out['seconds']:.1f}"
          f" s, over {OBS_SECONDS:.0f}")
    return out


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
# PE2 and PE3's streamed body, csrc/tt_tile.cuh for their f32 tile route,
# csrc/ttm_pe1.cu for PE1; a store is kept behind a test that never holds,
# so the sums are still computed; the tile route's "store" cut keeps the
# write-back's shared-memory tile and its reads, and drops the stores to O)
PE_PHASES = {
    "fma": {"tt_contract.cuh": [
        ("fma_row<T, RD>(zr + r * p.zp, gr + r * p.gp, acc);", ";")],
        "tt_tile.cuh": [
            ("for (int j = 0; j < TN; ++j) acc[ii][j] = fmaf(av[ii], bv[j], "
             "acc[ii][j]);", "for (int j = 0; j < TN; ++j) {}")],
        "ttm_pe1.cu": [("      if (active) {\n        const T* zr = Zs",
                        "      if (false) {\n        const T* zr = Zs")]},
    "copy": {"tt_contract.cuh": [
        ("++i) issue(i, i);", "++i) {}"),
        ("if (ch + p.stages < nch) issue(ch + p.stages, st);", "")],
        "tt_tile.cuh": [
            ("    if (i < nch) issue(ch0 + i, i);", ""),
            ("    if (nx < nch) issue(ch0 + nx, nx % p.stages);", "")],
        "ttm_pe1.cu": [
            ("      tt_contract::copy_any<T>(p.gz, Zs,",
             "      if (false) tt_contract::copy_any<T>(p.gz, Zs,"),
            ("      stage_g_any<T>(p.gg, Gs,",
             "      if (false) stage_g_any<T>(p.gg, Gs,")]},
    "store": {"tt_contract.cuh": [
        ("if (dgi * RD + i < nrows_d) store4(",
         "if (acc[i][0] == 1.5e38f) store4(")],
        "tt_tile.cuh": [
            ("    put<N>(O + ((a0 + s)", "    if (v[0] == 1.5e38f) put<N>(O + "
             "((a0 + s)")],
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
    ``kernels/_build/anatomy``. The CUDA-core bodies only (the f32 routes:
    the streamed bodies at the MLP's shapes, the tile route at LM100M's
    PE2 and PE3 calls); the bf16 tensor-core route is not cut here. Then
    PE3's calls on the tile route at every cluster size, beside the
    clusters the card runs at once (``tt_tile.clusters``)."""
    from repro_torch.kernels import tt_contract as TC, tt_tile as TT, ttm_pe1
    cuts = {"full": [], **{f"no {k}": [k] for k in PE_PHASES},
            "none": list(PE_PHASES)}
    libs = {key: (ttm_pe1.typed(lib) if key[1] == "ttm_pe1"
                  else TC.typed(lib, key[1][4:]))
            for key, lib in _anatomy_libs(
                PE_PHASES, cuts, ("tt_contract.cuh", "tt_mma.cuh",
                                  "tt_tile.cuh", "ttm_pe1.cu"),
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
    # the f32 tile route at LM100M's PE2 and PE3 calls (train ckpt's)
    tile = []
    for kind, zs, gs in _lm_pe_calls(_ckpt_configs()[1]):
        if kind == "pe1":
            continue
        z = torch.randn(zs, generator=gen, device="cuda")
        g = torch.randn(gs, generator=gen, device="cuda") * 0.2
        zz, gg = _pe_contraction(kind, z, g)
        out = zz.new_empty((zz.shape[0], gg.shape[1], zz.shape[2]))
        p = TT.plan_for(zz, gg)
        check(p is not None, f"anatomy {kind} {zs}: not on the tile route")
        src = ANATOMY_SOURCES[kind]
        row = {"kind": kind, "z": list(zs), "g": list(gs), "route": "tile",
               "tile": [p.bm, p.bn], "cs": p.cs, "ks": p.ks}
        for cut in cuts:
            lib = libs[(cut, src)]
            row[cut] = timer(lambda: TT.launch(kind, src, p, zz, gg, out,
                                               lib=lib), iters=5)
        for ph in PE_PHASES:
            row[f"{ph}_ms"] = row["full"] - row[f"no {ph}"]
        tile.append(row)
        log(f"anatomy tile {kind} {zs} x {gs}: full {row['full']*1e3:.1f} "
            f"us; FMA loop {row['fma_ms']*1e3:.1f}, copies "
            f"{row['copy_ms']*1e3:.1f}, stores {row['store_ms']*1e3:.1f}; "
            f"with all three cut out {row['none']*1e3:.1f} us")
        del z, g, zz, gg, out
    # split-K at PE3's calls: the planner's cluster size beside every other,
    # and the clusters the card runs at once (tt_tile.CLUSTERS' source)
    split = []
    for kind, zs, gs in _lm_pe_calls(_ckpt_configs()[1]):
        if kind != "pe3":
            continue
        z = torch.randn(zs, generator=gen, device="cuda")
        g = torch.randn(gs, generator=gen, device="cuda") * 0.2
        zz, gg = _pe_contraction(kind, z, g)
        out = zz.new_empty((1, gg.shape[1], zz.shape[2]))
        p = TT.plan_for(zz, gg)
        row = {"z": list(zs), "g": list(gs), "planned": p.cs,
               "resident": TT._resident(p.tm, p.tn, p.threads, p.smem),
               "ms": {}, "clusters": {}}
        for cs in range(1, TT.MAX_CLUSTER + 1):
            kc = -(-p.nk // cs)
            if (cs - 1) * kc >= p.nk:
                continue
            q = dataclasses.replace(p, cs=cs, kc=kc, grid=p.tiles * cs)
            row["clusters"][cs] = TT.clusters(q)
            row["ms"][cs] = timer(lambda: TT.launch(kind, "ttm_pe3", q, zz,
                                                    gg, out), iters=5)
        best = min(row["ms"], key=row["ms"].get)
        split.append(row)
        log(f"anatomy split-K pe3 {zs} x {gs}: planned cs {p.cs} "
            f"{row['ms'][p.cs]*1e3:.1f} us, best cs {best} "
            f"{row['ms'][best]*1e3:.1f} us; by cs " + ", ".join(
                f"{k}: {v*1e3:.1f} us ({row['clusters'][k]} clusters at "
                "once)" for k, v in row["ms"].items()))
        del z, g, zz, gg, out
    torch.cuda.empty_cache()
    return {"rows": rows, "tile_rows": tile, "split_k": split}


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
    (``previous_ms``) and, PE2 and PE3, beside the f32 tile route at the
    same call (``tile_ms``: why these shapes stay under
    ``tt_tile.MIN_FLOPS``), and PE1's fused epilogue bit-identical to its
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
                    2 * n * 4 + 4, 4 * n, fp32=True)
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
                if kind != "pe1":   # the tile route here: MIN_FLOPS' reason
                    tile = _pe_tile(kind, z, g)
                    check((tile - r).abs().max().item() <= 1e-4 * (
                        1 + r.abs().max().item()), f"{kind} tile differs")
                    row["tile_ms"] = timer(lambda: _pe_tile(kind, z, g))
                nbytes, flops = _pe_work(kind, zs, gs, 4)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, flops, fp32=True)
        row["max_abs_err"] = row["max_abs_err_float32"]
        rows[kind].append(row)
        was = f", previous {row['previous_ms']*1e3:.1f} us" + (
            f", tile route {row['tile_ms']*1e3:.1f} us" if "tile_ms" in row
            else "")
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
            2 * n * 4 + 4 * len(cores), 4 * n, fp32=True)
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
            2 * n * 4 + 4 * len(xs), 4 * n, fp32=True)
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


# a device kernel's kind, by the first of these substrings its profile name
# holds (lower case); the rest is "other"
DEVICE_KINDS = (
    ("attention", ("pa_split", "pa_combine")),
    ("kv pool", ("p2_append", "p2_read", "p2_prefill")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "matmul")),
    ("sort", ("sort",)),
    ("index", ("index", "gather", "scatter")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "fill", "copy")),
    ("softmax", ("softmax",)))


def _device_by_kind(torch, prof, steps: int) -> dict:
    """Device ms and launches per step of a profiler window by kind of
    kernel (``DEVICE_KINDS``): where a step's device time goes."""
    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    cuda = torch.autograd.DeviceType.CUDA
    out: dict = {}
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) != cuda or dev(e) <= 0
                or "spin_kernel" in e.key):
            continue
        key = e.key.lower()
        kind = next((k for k, subs in DEVICE_KINDS
                     if any(sub in key for sub in subs)), "other")
        r = out.setdefault(kind, {"ms_per_step": 0.0, "calls_per_step": 0.0})
        r["ms_per_step"] += dev(e) / steps / 1e3
        r["calls_per_step"] += e.count / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms_per_step"]))


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
        n * 4 + rows * nb * (b + 4), 4 * n, fp32=True)
    dec = dict(shape=list(shape), block=block, b=b, what=what,
               max_abs_err=0.0,
               ms=timer(lambda: CB.bw_decode(codes, sc, last)),
               plain_ms=timer(lambda: CB.bw_decode_plain(codes, sc, last),
                              iters=10))
    dec["library_ms"], dec["library_note"] = _library_yardstick(
        timer, lambda: _library_bw_decode(torch, codes, sc, b, last),
        lambda r: _bits_equal(torch, r, y))
    dec["bound_ms"], dec["bound_by"] = bound_ms(
        rows * nb * (b + 4) + n * 4, n, fp32=True)
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
                                                    fp32=True)
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
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, n, fp32=True)
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
        n * 4 + rows * pk + srow.numel() * 4, 4 * n, fp32=True)
    dec = dict(shape=list(x.shape), what=what, max_abs_err=0.0,
               ms=timer(lambda: CB.decode_packed(p, srow, last)),
               plain_ms=timer(lambda: CB.decode_packed_plain(p, srow, last),
                              iters=10),
               library_ms=None, library_note=PACKED_NONE)
    dec["bound_ms"], dec["bound_by"] = bound_ms(
        rows * pk + n * 4 + srow.numel() * 4, 2 * n, fp32=True)
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
                                                fp32=True)
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
                                                fp32=True)
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
                    fp32=True)
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
                   what: str = "chunk step", cpu: bool = True,
                   window_reps: int | None = None) -> dict:
    """One chunk step at full width (128 tokens at position 256 of a slot
    whose history holds 384 prompt tokens), repeated: host wall per step
    (synchronised) and the peak memory over the repeats, then one profiled
    window of ``window_reps`` (default ``reps``) steps for the device time
    per kernel. The step rewrites the same positions with the same
    values."""
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
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng._chunk(toks, table_row, 0, 256)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated()
    window_reps = window_reps or reps
    prof, kern = _profile_window(
        torch, lambda: [eng._chunk(toks, table_row, 0, 256)
                        for _ in range(window_reps)], window_reps, names,
        _kv_want(want), what, cpu=cpu)
    total, rows = _device_summary(torch, prof, window_reps)
    log(f"{what} profile: {wall*1e3:.2f} ms per step (host wall), "
        f"device {total:.2f} ms busy, busy share {total / (wall*1e3):.3f}; "
        f"peak memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**20:.1f} "
        "MiB above the engine's resident bytes)")
    for r in rows:
        log(f"  {r['ms_per_step']:8.3f} ms  {r['calls_per_step']:6.1f}x  "
            f"{r['name']}")
    _log_kernels(kern)
    return {"step_ms": wall * 1e3, "device_ms": total,
            "busy_share": total / (wall * 1e3), "top": rows,
            "kernels": kern, "peak_bytes": peak, "step_bytes": peak - base}


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
# requests of each serve rwkv6 and serve moe run: one of the 8 slots each
# (the engine phase serves all 16); the script's time limit is shared by
# every phase, and these runs are host-bound (the recurrent prompts' scans
# a token at a time): 4 since train moe was added, 8 before
STATE_REQUESTS = 4
HYBRID_ARCH = "jamba-1.5-large"
PA_KV_FNS = KV_KERNEL_FNS + PA_KERNEL_FNS
ST_KERNEL_FNS = ["st_dec_group_kernel", "st_enc_group_kernel",
                 "st_dec_slot_kernel", "st_enc_slot_kernel"]
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
    out.update(_state_slot_rows(torch, timer, gen, scfg))
    return out


SLOT_CASES = (0, 3, STATE_SLOTS - 1)       # first, middle and last slot
TIMED_SLOT = 3


def _state_slot_case(torch, gen, entries):
    """A full pool of ``entries`` (random codes and scales, 8 slots) and one
    slot's new states, a (1, *feat) a (layer, tensor), each at its own
    magnitude; along the (tensor, layer) rows in order, row j of tensor e
    holds its max at the j-th (mod 7) of ``127 * 2^k`` and its six
    neighbours (k = -3 for even e, 2 for odd: every value of both kinds on
    rwkv6's and on jamba's rows), and the last row is all zero."""
    dts = [getattr(torch, d) for _, _, d in entries]
    codes, scales, news = [], [], []
    j = 0
    for e, ((layers, feat, _), dt) in enumerate(zip(entries, dts)):
        cols = math.prod(feat)
        codes.append(torch.randint(-128, 128, (layers, STATE_SLOTS) + feat,
                                   generator=gen, device="cuda",
                                   dtype=torch.int8))
        scales.append(torch.randint(-12, 4, (layers, STATE_SLOTS),
                                    generator=gen, device="cuda").float())
        edges = _edge_values(torch, dt, -3 if e % 2 == 0 else 2)
        rows = []
        for _ in range(layers):
            row = _state_inputs(torch, gen, 1, cols, dt)[0].reshape(-1)
            v = edges[j % 7]
            row.copy_((row.float() / row.float().abs().max() * (v / 2))
                      .to(dt))
            row[0] = -v if j % 2 else v
            rows.append(row.reshape((1,) + feat))
            j += 1
        news.append(rows)
    news[-1][-1].zero_()
    return codes, scales, news, dts


def _state_slot_read(torch, SC, scfg, codes, scales, dts, b):
    """The per-layer route's one-slot read (the previous design, the chunk
    step's): ``read_layer`` of ``data[l][b][None]`` a (layer, tensor),
    p2_dec each, stacked to (L, 1, *feat)."""
    return [torch.stack([SC.read_layer(q[lay][b][None], s[lay][b][None],
                                       dt, scfg)
                         for lay in range(q.shape[0])])
            for q, s, dt in zip(codes, scales, dts)]


def _state_slot_write(SC, scfg, codes, scales, news, b):
    """The per-layer route's one-slot write (the previous design, the chunk
    step's): ``write_slot`` a (layer, tensor), p2_enc each."""
    for q, s, layers in zip(codes, scales, news):
        for lay, new in enumerate(layers):
            SC.write_slot(q[lay], s[lay], new[0], b, scfg)


def _state_prefill_previous(SC, scfg, pool, state, b):
    """The previous whole-prompt prefill write: each tensor's (L, *feat)
    stack under a scale per layer in one encode launch a tensor
    (``p2_enc_rows``; ``p2_enc`` for a one-layer stack), then two index
    copies."""
    for key, kinds in state.items():
        for name, arr in kinds.items():
            codes, step = SC._encode(arr[:, 0], scfg)
            pool["data"][key][name][:, b] = codes
            pool["scale_log2"][key][name][:, b] = step


def _state_slot_rows(torch, timer, gen, scfg) -> dict:
    """The chunk step's and the prefill's one-slot launches at rwkv6-1.6b's
    full slot (24 layers x shift, wkv, shift_ffn) and jamba's period (7
    Mamba layers x conv, h) in a pool of 8 slots: for the first, a middle
    and the last slot, ``st_dec_slot`` decodes the slot's every layer and
    ``st_enc_slot`` encodes its new states (scale edges and an all-zero
    row in them, ``_state_slot_case``), each one launch (the plan's
    count), bit for bit with its plain twin (on the card) and with the
    per-layer route it replaced (``read_layer`` / ``write_slot``: a p2_dec
    and a p2_enc with the scale's eager ops a (layer, tensor)), every
    other slot's codes and scales untouched; the prefill write
    (``write_prefill``: the same launch over the stacked states) bit for
    bit with the previous prefill route (``p2_enc_rows`` a tensor, or
    ``p2_enc`` for jamba's one-layer stacks). Then each timed beside the
    per-layer route (``previous_ms``), its twin and the byte bound; the
    encode also re-reading its values (``reread_ms``) and with a CTA a
    row (``cta_ms``), the prefill beside its previous route; and the host
    wall of a chunk step's read and write, synchronised, beside the
    per-layer route's."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import grouped as G
    from repro_torch.numerics import cuda_backend as CB
    from repro_torch.serve import state_cache as SC
    out = {"st_dec_slot": [], "st_enc_slot": []}
    for what, entries in (("rwkv6-1.6b chunk step / prefill", RWKV6_STEP),
                          ("jamba period chunk step / prefill",
                           JAMBA_STEP)):
        codes, scales, news, dts = _state_slot_case(torch, gen, entries)
        feats = [math.prod(q.shape[2:]) for q in codes]
        want_dec = len(G.st_dec_plan([(q.shape[0], f)
                                      for q, f in zip(codes, feats)]))
        want_enc = len(G.st_enc_plan([(q.shape[0], 1, f, dt.itemsize)
                                      for q, f, dt in zip(codes, feats,
                                                          dts)]))
        names = [f"t{i}" for i in range(len(codes))]

        def as_pool(qs, ss):
            return {"data": {"sub_0": dict(zip(names, qs))},
                    "scale_log2": {"sub_0": dict(zip(names, ss))}}
        for b in SLOT_CASES:
            slot_t = torch.tensor([b], dtype=torch.int32, device="cuda")
            B.reset_launches()
            ys = CB.state_decode_slot(codes, scales, dts, slot_t)
            n_dec = dict(B.LAUNCHES)
            check(n_dec == {"st_dec_slot": want_dec},
                  f"st_dec_slot {what} slot {b}: launches {n_dec}, want "
                  f"{want_dec}")
            ok_plain = all(_bits_equal(torch, y, r) for y, r in zip(
                ys, CB.state_decode_slot_plain(codes, scales, dts, slot_t)))
            ok_prev = all(_bits_equal(torch, y, r) for y, r in zip(
                ys, _state_slot_read(torch, SC, scfg, codes, scales, dts,
                                     b)))
            check(ok_plain and ok_prev, f"st_dec_slot {what} slot {b}: "
                  f"differs from its twin ({ok_plain}) or the per-layer "
                  f"route ({ok_prev})")
            pools = [([q.clone() for q in codes], [s.clone() for s in scales])
                     for _ in range(7)]
            B.reset_launches()
            CB.state_encode_slot(*pools[0], news, slot_t, 8)
            n_enc = dict(B.LAUNCHES)
            check(n_enc == {"st_enc_slot": want_enc},
                  f"st_enc_slot {what} slot {b}: launches {n_enc}, want "
                  f"{want_enc}")
            CB.state_encode_slot_plain(*pools[1], news, slot_t, 8)
            _state_slot_write(SC, scfg, *pools[2], news, b)
            CB._st_encode_slot(*pools[3], news, slot_t, 8, reread=True)
            CB._st_encode_slot(*pools[4], news, slot_t, 8, cluster=False)
            state = {"sub_0": {n: torch.stack(layers)
                               for n, layers in zip(names, news)}}
            B.reset_launches()
            SC.write_prefill(as_pool(*pools[5]), state, b, scfg, slot_t)
            n_pre = dict(B.LAUNCHES)
            check(n_pre == {"st_enc_slot": want_enc},
                  f"write_prefill {what} slot {b}: launches {n_pre}")
            _state_prefill_previous(SC, scfg, as_pool(*pools[6]), state, b)
            for name, (qs, ss) in (("twin", pools[1]),
                                   ("per-layer", pools[2]),
                                   ("re-read", pools[3]),
                                   ("CTA a row", pools[4]),
                                   ("prefill", pools[5]),
                                   ("previous prefill", pools[6])):
                check(all(torch.equal(x, y) for x, y in zip(pools[0][0], qs))
                      and all(_bits_equal(torch, x, y)
                              for x, y in zip(pools[0][1], ss)),
                      f"st_enc_slot {what} slot {b}: codes or scales differ "
                      f"from the {name} route")
            off = torch.arange(STATE_SLOTS, device="cuda") != b
            check(all(torch.equal(x[:, off], y[:, off]) for x, y in
                      zip(pools[0][0] + pools[0][1], codes + scales)),
                  f"st_enc_slot {what} slot {b}: another slot was written")
        edges = [float(s[0, b]) for s in pools[0][1][:4]]
        log(f"state slot {what}: slots {list(SLOT_CASES)} decode, encode "
            f"and prefill write bit for bit with the twins and the "
            f"per-layer and previous prefill routes, no other slot "
            f"written; {want_dec} + {want_enc} launches; the first rows' "
            f"scales {edges}")
        b = TIMED_SLOT
        slot_t = torch.tensor([b], dtype=torch.int32, device="cuda")
        qc, sc = pools[0]
        pool = as_pool(qc, sc)
        dec_ms = timer(lambda: CB.state_decode_slot(codes, scales, dts,
                                                    slot_t))
        dec_prev = timer(lambda: _state_slot_read(torch, SC, scfg, codes,
                                                  scales, dts, b), iters=10)
        dec_plain = timer(lambda: CB.state_decode_slot_plain(
            codes, scales, dts, slot_t), iters=5)
        enc_ms = timer(lambda: CB.state_encode_slot(qc, sc, news, slot_t, 8))
        enc_reread = timer(lambda: CB._st_encode_slot(
            qc, sc, news, slot_t, 8, reread=True))
        enc_cta = timer(lambda: CB._st_encode_slot(qc, sc, news, slot_t, 8,
                                                   cluster=False))
        enc_prev = timer(lambda: _state_slot_write(SC, scfg, qc, sc, news, b),
                         iters=10)
        enc_plain = timer(lambda: CB.state_encode_slot_plain(
            qc, sc, news, slot_t, 8), iters=5)
        pre_ms = timer(lambda: SC.write_prefill(pool, state, b, scfg, slot_t))
        pre_prev = timer(lambda: _state_prefill_previous(SC, scfg, pool,
                                                         state, b), iters=10)
        host = _host_ms(torch, lambda: (
            CB.state_decode_slot(codes, scales, dts, slot_t),
            CB.state_encode_slot(qc, sc, news, slot_t, 8)))
        host_prev = _host_ms(torch, lambda: (
            _state_slot_read(torch, SC, scfg, codes, scales, dts, b),
            _state_slot_write(SC, scfg, qc, sc, news, b)))
        nbytes = _state_bytes(codes, news, 1)
        bms, by = bound_ms(nbytes)
        shape = [[q.shape[0], 1, *q.shape[2:]] for q in codes]
        layers = sum(q.shape[0] for q in codes)
        for name, ms, prev, plain, extra in (
                ("st_dec_slot", dec_ms, dec_prev, dec_plain, {}),
                ("st_enc_slot", enc_ms, enc_prev, enc_plain,
                 {"reread_ms": enc_reread, "cta_ms": enc_cta,
                  "prefill_ms": pre_ms, "prefill_previous_ms": pre_prev,
                  "prefill_previous_launches": len(codes),
                  "read_write_host_ms": host,
                  "previous_read_write_host_ms": host_prev})):
            out[name].append(dict(
                what=what, shape=shape, pool_slots=STATE_SLOTS, ms=ms,
                previous_ms=prev, plain_ms=plain, bound_ms=bms, bound_by=by,
                bytes=nbytes, library_ms=None, library_note=ST_NONE,
                max_abs_err=0,
                launches=want_dec if name == "st_dec_slot" else want_enc,
                previous_launches=layers, **extra))
            log(f"{name} {what}: {ms*1e3:.2f} us (per-layer route "
                f"{prev*1e3:.1f} us, plain {plain*1e3:.1f} us, bound "
                f"{bms*1e3:.2f} us, {nbytes} B"
                + (f"; re-reading its values {enc_reread*1e3:.2f} us, a CTA "
                   f"a row {enc_cta*1e3:.2f} us; the prefill write "
                   f"{pre_ms*1e3:.2f} us, its previous route "
                   f"{pre_prev*1e3:.1f} us; the chunk step's read and "
                   f"write {host:.3f} ms host wall, the per-layer route's "
                   f"{host_prev:.3f} ms" if extra else "") + ")")
    return out


def _host_ms(torch, fn, reps: int = 20) -> float:
    """Host wall of ``fn`` in ms, a mean over ``reps`` calls issued back to
    back, synchronised before the first and after the last."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _state_group_launches(lm, slots: int = STATE_SLOTS) -> tuple[int, int]:
    """The decode step's ``st_dec_group`` and ``st_enc_group`` launches on
    ``lm``'s int8 state pool: the plans' counts (``slots`` 1: the one-slot
    ``st_dec_slot`` and ``st_enc_slot``'s)."""
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
    the whole pool in one group launch and writes it in another, each
    chunk step reads and writes its one slot's every layer the same way
    (``st_dec_slot`` / ``st_enc_slot``), and each whole-prompt prefill
    writes the slot's every layer in one ``st_enc_slot`` (the plans'
    counts, ``_state_group_launches``); no row or scalar codec kernel."""
    dec, enc = _state_group_launches(lm)
    sdec, senc = _state_group_launches(lm, 1)
    want = {"st_dec_group": dec * decode_steps,
            "st_enc_group": enc * decode_steps,
            "st_dec_slot": sdec * chunk_steps,
            "st_enc_slot": senc * (chunk_steps + prefills)}
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

    ga, pa, la = run(lambda *a: eng._decode(*a)[0])
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


def _per_layer_chunk(torch, eng, toks, slot: int, start: int):
    """A chunk step of ``eng`` (no attention sublayer) through the
    per-layer route, the previous design: ``read_layer`` of the slot's
    ``data[l][slot][None]``, the mixer's forward over the chunk and
    ``write_slot`` a (layer, tensor), a p2_dec and a p2_enc each. Returns
    the last position's (1, V) logits; the pool is written in place."""
    from repro_torch.models.common import apply_site, rms_norm
    from repro_torch.models.lm import embed_tokens
    from repro_torch.serve import state_cache as SC
    lm, params, cfg = eng.lm, eng.params, eng.lm.cfg
    x = embed_tokens(params, eng._tensor([toks], torch.long), lm)
    for layer, pp in enumerate(params["layers"]):
        for i, sub in enumerate(lm.period):
            key = f"sub_{i}"
            shapes = SC.state_feature_shapes(sub, cfg)
            data = {n: t[layer] for n, t in eng.spool["data"][key].items()}
            scale = {n: t[layer]
                     for n, t in eng.spool["scale_log2"][key].items()}
            state = {n: SC.read_layer(data[n][slot][None],
                                      scale[n][slot][None],
                                      SC.natural_dtype(kind, cfg), eng.scfg)
                     for n, (_, kind) in shapes.items()}
            x, new = eng._state_mix(pp[key], x, sub, state)
            for n in shapes:
                SC.write_slot(data[n], scale[n], new[n][0], slot, eng.scfg)
    x = rms_norm(x[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
    return apply_site(params["head"], x, lm.head, cfg)[:, 0]


def _per_layer_prefill(torch, eng, toks, slot: int):
    """A whole-prompt prefill of ``eng`` (no attention sublayer) through
    the previous route: ``lm_forward`` with its cache, then each state
    tensor's layer stack encoded in one launch (``p2_enc_rows``; ``p2_enc``
    for a one-layer stack) and copied into the slot. Returns the last
    position's (1, V) logits."""
    from repro_torch.models import lm_forward
    from repro_torch.serve import state_cache as SC
    logits, _, cache = lm_forward(eng.params, eng.lm, tokens=eng._tensor(
        [toks], torch.long), return_cache=True)
    _state_prefill_previous(SC, eng.scfg, eng.spool,
                            {k: cache[k] for k in eng._state_keys}, slot)
    return logits[0, -1][None]


def _replay_chunked_prefill(torch, lm, params, prompts,
                            slot: int = STATE_SLOTS - 1) -> dict:
    """A chunked prefill (128) of a 300-token prompt into the last slot of
    the int8 rwkv6 engine at full size, whose other slots hold other
    prompts' states: the first chunk through the whole-prompt prefill, the other
    two through chunk steps, once through the engine and again, from the
    same pool, through the per-layer route (``_per_layer_prefill``,
    ``_per_layer_chunk``): every chunk's logits and every pool byte equal;
    the engine's launches the plans' one-slot counts (a prefill 1
    st_enc_slot, a chunk step 1 st_dec_slot + 1 st_enc_slot), the
    per-layer route's 3 p2_enc_rows a prefill and 72 p2_dec + 72 p2_enc a
    chunk step."""
    from repro_torch.kernels import build as B
    from repro_torch.serve import Engine, EngineConfig, PoolConfig
    from repro_torch.serve import state_cache as SC
    eng = Engine(lm, params, EngineConfig(pool=PoolConfig(
        num_slots=STATE_SLOTS, quantized=True), prefill_chunk=CHUNK),
        device="cuda")
    for p in prompts[:STATE_SLOTS - 1]:
        eng.submit(p[:40], max_new_tokens=2)
    eng.step()                          # other slots' states in the pool
    toks = (prompts[2] + prompts[3])[:300]
    table_row = eng._tensor(eng.sched.page_table[slot])
    chunks = [(c, min(c + CHUNK, len(toks))) for c in range(0, len(toks),
                                                            CHUNK)]
    snap = [t.clone() for t in _leaves(eng.spool)]

    def run(prefill, chunk):
        for t, s0 in zip(_leaves(eng.spool), snap):
            t.copy_(s0)
        SC.reset_slot(eng.spool, slot)
        torch.cuda.synchronize()
        B.reset_launches()
        with torch.no_grad():
            logits = [prefill(toks[:chunks[0][1]])]
            logits += [chunk(toks[c0:c1], c0) for c0, c1 in chunks[1:]]
        torch.cuda.synchronize()
        return logits, [t.clone() for t in _leaves(eng.spool)], \
            dict(B.LAUNCHES)

    ga, pa, la = run(lambda t: eng._prefill(t, table_row, slot),
                     lambda t, c0: eng._chunk(t, table_row, slot, c0))
    gb, pb, lb = run(lambda t: _per_layer_prefill(torch, eng, t, slot),
                     lambda t, c0: _per_layer_chunk(torch, eng, t, slot, c0))
    check(all(_bits_equal(torch, a, b) for a, b in zip(ga, gb)),
          "chunked replay: the engine's logits differ from the per-layer "
          "route's")
    check(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
              for a, b in zip(pa, pb)),
          "chunked replay: the pool differs from the per-layer route's")
    n = len(chunks) - 1
    check(la == _state_want(lm, 0, 1, n),
          f"chunked replay: engine launches {la}")
    tensors = sum(len(SC.state_feature_shapes(sub, lm.cfg))
                  for sub in lm.period)
    per = lm.n_periods * tensors
    check(lb == {"p2_enc_rows": tensors, "p2_dec": n * per,
                 "p2_enc": n * per},
          f"chunked replay: per-layer launches {lb}")
    log(f"chunked replay rwkv6: a {len(toks)}-token prompt in {len(chunks)} "
        f"chunks into slot {slot} through the engine ({la}) and the "
        f"per-layer route ({lb}): logits and "
        f"{sum(t.numel() * t.element_size() for t in pa)} pool bytes equal")
    del eng
    return {"chunks": len(chunks), "launches": la, "per_layer_launches": lb}


# ---------------------------------------------------------------------------
# quant-health counters inside the encoding kernels
# ---------------------------------------------------------------------------

def _counter_row(torch, timer, name, what, launch, fresh, check_codes,
                 twin_counts, nbytes, counts_of) -> dict:
    """One counter at one shape: ``launch(outputs, counter)`` runs the
    kernel into ``outputs`` (``fresh()`` makes a new copy; the counter
    None: the counter-off launch); ``check_codes(a, b)`` holds two
    launches' outputs bit for bit; ``twin_counts`` is the plain twin's
    count vector. Returns the counts and the launch's time with the
    counter and without it (each timed into one kept copy) beside the
    bound."""
    from repro_torch.kernels import build as B
    counter = torch.zeros(len(twin_counts), dtype=torch.int64, device="cuda")
    got, ref = fresh(), fresh()
    B.reset_launches()
    got = launch(got, counter)
    ref = launch(ref, None)
    _sync(torch, "cuda")
    check(sum(B.LAUNCHES.values()) == 2 and len(B.LAUNCHES) == 1,
          f"{name} ({what}): launches {B.LAUNCHES}, want one each way")
    counts = counter.tolist()
    check(counts == list(twin_counts), f"{name} ({what}): counts {counts}, "
          f"the twin's {list(twin_counts)}")
    check(check_codes(got, ref), f"{name} ({what}): codes with the counter "
          "differ from the counter-off launch")
    on_ms = timer(lambda: launch(got, counter))
    off_ms = timer(lambda: launch(ref, None))
    bms, by = bound_ms(nbytes)
    log(f"health {name} ({what}): counts {counts_of(counts)} equal the "
        f"twin's; codes bit for bit with the counter off; {on_ms*1e3:.2f} us "
        f"with the counter, {off_ms*1e3:.2f} us without (bound "
        f"{bms*1e3:.4f} us)")
    return {"what": what, "counts": counts, "ms": on_ms, "off_ms": off_ms,
            "bound_ms": bms, "bound_by": by}


def phase_health_kernels(torch, timer: Timer) -> dict:
    """The three quant-health counters at their paths' shapes, each held
    to its kernel's plain twin integer for integer, the kernel's outputs
    with the counter bit for bit those of the counter-off launch, and
    timed with the counter on and off:

    - row 1b, ``p2_append_paged`` (the decode step's ``append_health``): K
      and V of 8 slots x 8 heads x 128 bf16 (``_append_inputs``: two
      inactive slots, one past its pages, one slot's scale one below its
      max so it clips at both ends), and MLA's latent pair (c_kv 512 +
      k_rope 64, 8 slots, tokens of 64 standard deviations of a code so
      a share clips);
    - row 1e, ``st_enc_group`` (the decode step's ``write_health``):
      rwkv6-1.6b's 24-layer pool, slot 5 inactive, rows with maxima at
      ``127 * 2^k`` and their neighbours, an all-zero row
      (``_state_step_case``), stored scales random so the drift is not 0;
    - row 4b, ``p2_fq_group`` (the grad edge's ``tree_sat_stats``): the LM
      grad edge's first bf16 group (64 tensors, 380,597,248 elements, 16
      bits), each at its per-tensor-max step, every other step one lower
      so codes saturate."""
    from repro_torch.kernels import kv_append as KA
    from repro_torch.numerics import cuda_backend as CB
    gen = torch.Generator(device="cuda").manual_seed(32)
    out = {"p2_append_paged": [], "st_enc_group": [], "p2_fake_quant": []}

    def pages_equal(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def kv_counts(c):
        return f"{c[0]:,} clipped of {c[1]:,}"

    gqa, kw = _append_inputs(torch, gen)
    g = torch.Generator(device="cuda").manual_seed(33)
    (cd, rd), (cs, rs), table = _latent_pool(torch, g, MLA_WIDTHS)
    lat = [(torch.randn((8, 1, w), generator=g, device="cuda") * 64
            * torch.exp2(s)[:, None, None]).to(torch.bfloat16)
           for w, s in zip(MLA_WIDTHS, (cs, rs))]
    mla = (cd, rd, cs, rs, lat[0], lat[1], table, gqa[7], gqa[8])
    for what, args in (("8 slots x 8 x 128 bf16", gqa),
                       (f"latent pair {MLA_WIDTHS[0]} + {MLA_WIDTHS[1]}, "
                        "8 slots", mla)):
        twin = torch.zeros(2, dtype=torch.int64, device="cuda")
        KA.append_paged_torch(*[t.clone() for t in args[:2]], *args[2:], **kw,
                              health=twin)
        n = args[4].numel() + args[5].numel()
        out["p2_append_paged"].append(_counter_row(
            torch, timer, "p2_append_paged", what,
            lambda p, c, a=args: KA.append_paged_cuda(*p, *a[2:], **kw,
                                                      health=c),
            lambda a=args: [t.clone() for t in a[:2]],
            pages_equal, twin.tolist(), n * 3 + 8 * 17, kv_counts))
    check(all(0 < r["counts"][0] < r["counts"][1]
              for r in out["p2_append_paged"]),
          "p2_append_paged: the inputs clipped nothing")

    active = torch.ones(STATE_SLOTS, dtype=torch.bool, device="cuda")
    active[INACTIVE_SLOT] = False
    codes, scales, news, _ = _state_step_case(torch, gen, RWKV6_STEP, active)
    twin = torch.zeros(4, dtype=torch.int64, device="cuda")
    CB.state_encode_many_plain([q.clone() for q in codes],
                               [s.clone() for s in scales], news, active, 8,
                               twin)

    def st_launch(pool, c):
        CB.state_encode_many(*pool, news, active, 8, health=c)
        return pool

    row = _counter_row(
        torch, timer, "st_enc_group", "rwkv6-1.6b's 24-layer pool, 8 slots",
        st_launch, lambda: ([q.clone() for q in codes],
                            [t.clone() for t in scales]),
        lambda a, b: all(_bits_equal(torch, x, y)
                         for x, y in zip(a[0] + a[1], b[0] + b[1])),
        twin.tolist(), _state_bytes(codes, news, STATE_SLOTS - 1),
        lambda c: f"{c[0]:,} clipped of {c[1]:,}, drift {c[2]:,} over "
                  f"{c[3]:,} rows")
    check(row["counts"][1] > 0 and row["counts"][2] > 0
          and row["counts"][3] == sum(q.shape[0] for q in codes)
          * (STATE_SLOTS - 1), f"st_enc_group: counts {row['counts']}")
    out["st_enc_group"].append(row)

    from repro_torch.numerics import QuantSpec, per_tensor_max_scale_log2
    lm, _, xs = _lm_grad_group(torch, gen)
    what, bits = "grad-edge group", lm.cfg.quant.grad_bits
    spec = QuantSpec("pow2", bits)
    steps = torch.stack([per_tensor_max_scale_log2(x, spec) for x in xs])
    steps[1::2] -= 1
    twin = CB.sat_counts_plain(xs, steps, bits)
    row = _counter_row(
        torch, timer, "p2_fake_quant", f"the LM {what}, {len(xs)} bf16 "
        f"tensors, {sum(x.numel() for x in xs):,} elements, {bits}-bit",
        lambda _, c: CB.fake_quant_scalar_many(xs, steps, bits, sat=c),
        lambda: None,
        lambda a, b: all(_bits_equal(torch, x, y) for x, y in zip(a, b)),
        twin.tolist(), _fq_bytes(xs),
        lambda c: f"{c[0]:,} saturated of {c[1]:,}")
    check(0 < row["counts"][0] < row["counts"][1], "p2_fake_quant: the "
          f"inputs saturated nothing ({row['counts']})")
    out["p2_fake_quant"].append(row)
    del xs
    torch.cuda.empty_cache()
    return out


def phase_serve_rwkv6(torch, lm, params) -> dict:
    """The slice's main path: rwkv6-1.6b at full size serving the first
    ``STATE_REQUESTS`` of the engine phase's requests (64 new tokens, 8
    slots; a run's time is mostly the prompts' per-token scans) from an
    int8 state pool, an fp pool and, chunked (128), the int8 pool again;
    counts zeroed just
    before and read just after each run, exact (``_state_want``); no KV
    kernel, ``cache_bytes`` 0, every slot free at the end,
    ``state_reduction`` >= 3.5. Then the replay of 3 decode steps and of
    a chunked prefill through the engine and the per-layer route
    (``_replay_state_steps``, ``_replay_chunked_prefill``), and the decode
    step, a 512-token prefill and a chunk step, timed and profiled, the
    state kernels by name."""
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    cfg = lm.cfg
    prompts = _requests(cfg.vocab_size)
    runs = prompts[:STATE_REQUESTS]
    _serve_engine(torch, lm, params, prompts[:2], 4)              # warm-up
    out, toks = {}, {}
    for name, kw in (("int8", {}), ("fp", dict(quantized=False)),
                     ("chunked", dict(prefill_chunk=CHUNK))):
        B.reset_launches()
        t1 = time.perf_counter()
        eng, toks[name] = _serve_engine(torch, lm, params, runs, 64, **kw)
        wall = time.perf_counter() - t1
        launches = dict(B.LAUNCHES)
        summ = eng.summary()
        chunks = (_chunk_steps(eng.metrics.prefills, CHUNK)
                  if name == "chunked" else 0)
        want = ({} if name == "fp" else _state_want(
            lm, summ["decode_steps"], len(eng.metrics.prefills), chunks))
        s = _check_state_run(f"serve rwkv6 ({name})", eng, launches, want,
                             len(runs))
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
    out["chunk_replay"] = _replay_chunked_prefill(torch, lm, params, prompts)
    out["wkv_error_by_decay"] = _wkv_error_by_decay(torch, lm, params,
                                                    prompts[0])
    out["bf16_agreement_int8_fp"] = sum(
        a == b for x, y in zip(toks["int8"], toks["fp"])
        for a, b in zip(x, y)) / (len(runs) * 64)
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
    prefill one ``st_enc_slot`` and one ``p2_prefill_paged``; a chunk step
    one ``st_dec_slot`` and one ``st_enc_slot``, one paged append and one
    paged read. Then the decode step, a prefill and a chunk step,
    profiled, the kernels by name."""
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
        # attention leaves (L, 1, S, *feat) padded along S: GQA's K and V,
        # MLA's latent c_kv and k_rope
        cache = {key: {name: (torch.nn.functional.pad(
                     a, (0, 0) * (a.dim() - 3) + (0, horizon - n))
                     if name in ("k", "v", "c_kv", "k_rope") else a)
                     for name, a in kinds.items()}
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
    serves from an int8 state pool (the KV pool on an attention-only arch)
    with the int8 engine's tokens."""
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
    kind = "state" if peng._state_keys else "KV"
    quant, pool = ((peng.scfg.quantized, peng.spool) if peng._state_keys
                   else (peng.pcfg.quantized, peng.pool))
    leaf = next(t for kinds in pool["data"].values() for t in kinds.values())
    check(quant and leaf.dtype == torch.int8 and pol == q,
          f"{what}: policy engine's {kind} pool {leaf.dtype}, "
          f"{sum(a == b for a, b in zip(pol, q))}/{len(prompts)} "
          "completions equal to the int8 engine's")
    agree = sum(a == b for x, y in zip(q, static) for a, b in zip(x, y)) \
        / (len(prompts) * gen_len)
    log(f"identity ({what}): fp32 engine == static decode == chunked "
        f"({chunks} chunk steps of {chunk}) == preempted on all "
        f"{len(prompts)} completions; the policy engine serves from an int8 "
        f"{kind} pool with the int8 engine's tokens (int8 vs fp32 greedy "
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
# serve moe: moonshot-v1-16b at full size from the int8 paged pool
# ---------------------------------------------------------------------------

MOE_ARCH = "moonshot-v1-16b"
# 48 layers x 570,560,512 + the embedding and the untied head (163,840 x
# 2,048 each) + the final norm
MOE_PARAMS = 28_057_995_264
MOE_SHAPE = (8, 16, 16, 128, 16, 64)   # B, Hq, Hkv (g = 1), Dh, page, pps
MOE_SECONDS = 150.0                    # the phase's wall, at most


def _moe_kernel_rows(torch, timer) -> dict:
    """Rows 1b, 5b, 6b, 1c and 3 at moonshot's shapes: 16 KV heads (16
    query heads over 16 KV heads, g = 1), the prefill write over its 48
    layers; each held to its twin as at internlm2's shapes and timed."""
    from repro_torch.kernels import build as B
    gen = torch.Generator(device="cuda").manual_seed(3)
    hkv = MOE_SHAPE[2]
    pool = _paged_pool(torch, gen, hkv)
    out = {"p2_append_paged": [_append_row(torch, timer, gen, hkv),
                               _paged_write_row(torch, timer, gen, pool)],
           "p2_read_paged": _paged_read_rows(torch, timer, pool)}
    del pool
    out["p2_prefill_paged"] = _prefill_rows(torch, timer, gen, layers=48,
                                            hkv=hkv, cases=((512, 512),))
    att, comb, _ = _attention_rows(torch, timer, gen, MOE_SHAPE,
                                   ((1, False),))
    out["paged_attention"], out["paged_attention_combine"] = att, comb
    for rows in out.values():
        for r in rows:
            r["what"] = (f"{MOE_ARCH}, {hkv} KV heads: "
                         + r.get("what", f"S={r.get('S')}"))
    torch.cuda.synchronize()
    B.reset_launches()
    return out


def _with_drop_count(torch, fn):
    """(fn(), the (expert, token) pairs the MoE routers routed while it
    ran, and of those the pairs their capacity dropped; summed over layers
    and calls): each capacity selection adds its counts on the device,
    read once at the end."""
    from repro_torch.models import moe as M
    select, counts = M._select, []

    def counted(w_tok, capacity):
        cw, cidx = select(w_tok, capacity)
        routed = (w_tok > 0).sum()
        counts.append(torch.stack([routed, routed - (cw > 0).sum()]))
        return cw, cidx
    M._select = counted
    try:
        out = fn()
    finally:
        M._select = select
    routed, dropped = (torch.stack(counts).sum(0).tolist() if counts
                       else (0, 0))
    return out, routed, dropped


def _moe_layer_parts(torch, timer, lm, params) -> dict:
    """One MoE layer of the decode step (8 rows, layer 0's weights) by
    part, each timed alone: the route (router, softmax, top-6), the
    capacity selection (every expert's top-8 rows), the gather, the
    experts' GLU (three bmm over all 64 experts at C = 8) and the combine
    (``index_add_``); then ``moe_forward`` whole, beside its byte bound
    (every expert's weights read once)."""
    from repro_torch.models import moe as M
    d, cfg = lm.period[0].ffn, lm.cfg
    p = params["layers"][0]["sub_0"]["moe"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((8, cfg.d_model), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    cap = M._capacity(8, d)
    idx, w, _ = M._route(p, x, d, cfg)
    eids = torch.arange(d.num_experts, device="cuda")

    def w_tok():
        return torch.where(idx[None] == eids[:, None, None], w[None].float(),
                           0.0).sum(-1)
    cw, cidx = M._select(w_tok(), cap)
    flat = cidx.reshape(-1)
    xe = x[flat].reshape(d.num_experts, cap, -1)
    ye = M._expert_glu(p, xe, d, cfg)
    yw = (ye * (cw * (cw > 0))[..., None].to(ye.dtype)).reshape(
        -1, ye.shape[-1])
    nbytes = sum(p[n]["w"].numel() * p[n]["w"].element_size()
                 for n in ("gate", "up", "down"))
    bms, by = bound_ms(nbytes + p["router"]["w"].numel() * 2
                       + 2 * x.numel() * 2)
    out = {"rows": 8, "capacity": cap, "experts_bytes": nbytes,
           "bound_ms": bms, "bound_by": by,
           "route_ms": timer(lambda: M._route(p, x, d, cfg)),
           "select_ms": timer(lambda: M._select(w_tok(), cap)),
           "gather_ms": timer(lambda: x[flat].reshape(d.num_experts, cap,
                                                      -1)),
           "experts_ms": timer(lambda: M._expert_glu(p, xe, d, cfg)),
           "combine_ms": timer(lambda: torch.zeros_like(x).index_add_(
               0, flat, yw)),
           "layer_ms": timer(lambda: M.moe_forward(p, x[:, None], d, cfg))}
    log(f"moe layer (decode, 8 rows, C = {cap}, all {d.num_experts} experts):"
        f" {out['layer_ms']*1e3:.1f} us (route {out['route_ms']*1e3:.1f}, "
        f"select {out['select_ms']*1e3:.1f}, gather "
        f"{out['gather_ms']*1e3:.1f}, experts' GLU "
        f"{out['experts_ms']*1e3:.1f}, combine {out['combine_ms']*1e3:.1f}; "
        f"bound {bms*1e3:.1f} us: {nbytes/1e9:.3f} GB of experts)")
    return out


def _moe_records(torch, M, fn):
    """(fn(), each routing's and each capacity selection's inputs and
    outputs on the host, in call order): ``moe._route`` and
    ``moe._select`` wrapped while ``fn`` runs."""
    rec = {"route": [], "select": []}
    route, select = M._route, M._select

    def routed(params, x2d, d, cfg, mask=None):
        out = route(params, x2d, d, cfg, mask)
        rec["route"].append((x2d.float().cpu(), out[0].cpu()))
        return out

    def selected(w_tok, capacity):
        cw, cidx = select(w_tok, capacity)
        rec["select"].append((w_tok.cpu(), cw.cpu(), cidx.cpu()))
        return cw, cidx
    M._route, M._select = routed, selected
    try:
        return fn(), rec
    finally:
        M._route, M._select = route, select


def _moe_card_vs_cpu(torch, lm, params, prompt) -> dict:
    """One whole-prompt prefill (``lm_forward`` with the engine's mask) at
    the config's capacity on the card and on the CPU, fp32: per layer the
    routed experts and the kept (expert, token) pairs equal, but for pairs
    whose boundary weights lie within 1e-6 relative (listed), the logits
    within 1e-4 of their largest magnitude, and the capacity dropped
    pairs."""
    from repro_torch.models import lm_forward
    from repro_torch.models import moe as M
    toks = torch.tensor([prompt], dtype=torch.long)
    mask = torch.ones((1, len(prompt)), dtype=torch.bool)
    host = _tensor_tree(torch, params, "cpu")

    def prefill(p, dev):
        with torch.no_grad():
            return lm_forward(p, lm, tokens=toks.to(dev),
                              token_mask=mask.to(dev))[0].cpu()
    t0 = time.perf_counter()
    card, crec = _moe_records(torch, M, lambda: prefill(params, "cuda"))
    cpu, hrec = _moe_records(torch, M, lambda: prefill(host, "cpu"))
    cpu_s = time.perf_counter() - t0
    near, dropped = [], 0
    for layer, pp in enumerate(host["layers"]):
        (xh, ih), (_, ic) = hrec["route"][layer], crec["route"][layer]
        probs = torch.softmax(xh @ pp["sub_0"]["moe"]["router"]["w"].float(),
                              dim=-1)
        swapped: dict = {}
        for t, j in (ic != ih).nonzero().tolist():
            a, b = int(ic[t, j]), int(ih[t, j])
            pa, pb = float(probs[t, a]), float(probs[t, b])
            rel = abs(pa - pb) / max(pa, pb)
            check(rel < 1e-6, f"moe routing, layer {layer}, token {t}: the "
                  f"card routes expert {a} (p {pa:.9g}), the CPU expert {b} "
                  f"(p {pb:.9g}), {rel:.2e} apart")
            near.append(dict(layer=layer, token=t, card=a, cpu=b, rel=rel))
            swapped.setdefault(t, set()).update((a, b))
        (wc, cwc, cic), (wh, cwh, cih) = crec["select"][layer], \
            hrec["select"][layer]
        dropped += int((wc > 0).sum() - (cwc > 0).sum())

        def kept(cw, cidx):
            return {(e, t) for e in range(cidx.shape[0])
                    for t, w in zip(cidx[e].tolist(), cw[e].tolist())
                    if w > 0}
        for e, t in kept(cwc, cic) ^ kept(cwh, cih):
            if e in swapped.get(t, ()):
                continue            # the routing's listed near tie
            edge, w = float(cwh[e, -1]), float(wh[e, t])
            rel = abs(w - edge) / max(edge, 1e-30)
            check(rel < 1e-6, f"moe capacity, layer {layer}: (expert {e}, "
                  f"token {t}) kept on one side only, weight {w:.9g} "
                  f"against the boundary {edge:.9g} ({rel:.2e} apart)")
            near.append(dict(layer=layer, token=t, expert=e, rel=rel))
    err = float((card - cpu).abs().max() / cpu.abs().max())
    check(err <= 1e-4, f"moe prefill: card logits {err:.2e} of their "
          "largest magnitude from the CPU's")
    check(dropped > 0, "moe prefill: the capacity dropped nothing")
    for n in near:
        log(f"  moe near tie allowed: {n}")
    log(f"moe identity (capacity factor {lm.cfg.moe.capacity_factor}, "
        f"{len(prompt)}-token prefill, {lm.cfg.num_layers} layers): routing "
        f"and kept pairs equal on the card and the CPU ({len(near)} near "
        f"ties), {dropped} (expert, token) pairs dropped, logits within "
        f"{err:.2e}; the CPU side {cpu_s:.1f} s")
    return {"near_ties": near, "dropped": dropped, "logits_rel_err": err,
            "capacity": M._capacity(len(prompt), lm.period[0].ffn),
            "tokens": len(prompt)}


def _moe_identity(torch) -> dict:
    """fp32 at full width, 2 layers: at a drop-free capacity factor (64,
    as ``tests/test_models.py`` takes it) the engine ≡ chunked ≡ preempted
    ≡ static decode, token for token (``_identity_checks``); at the
    config's 1.25 a capacity-bound 512-token prefill on the card against
    the CPU (``_moe_card_vs_cpu``)."""
    import repro_torch.configs as C
    from repro_torch.models import build_lm
    cfg = C.get_config(MOE_ARCH).replace(num_layers=2, dtype="float32")
    free = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=64.0))
    lm, params = _state_model(torch, MOE_ARCH, num_layers=2, dtype="float32",
                              moe=free.moe)
    prompts = _requests(cfg.vocab_size, n=8, seed=2)
    out = {"drop_free": _identity_checks(torch, f"{MOE_ARCH} 2 layers", lm,
                                         params, prompts, 32, 4, CHUNK)}
    out["capacity"] = _moe_card_vs_cpu(torch, build_lm(cfg), params,
                                       sum(prompts, [])[:512])
    del params
    torch.cuda.empty_cache()
    return out


def phase_serve_moe(torch) -> dict:
    """moonshot-v1-16b at full size (48 layers, 64 experts, top-6, bf16,
    seeded weights on the card) from the int8 paged pool (8 x 64 x 16),
    fused attention: the first ``STATE_REQUESTS`` of the engine phase's
    requests x 64 new tokens whole prompt and chunked (128); counts exact:
    a decode step 48 ``p2_append_paged``, 48 split and 48 combine, a
    whole-prompt prefill 1 ``p2_prefill_paged``, a chunk step 48
    ``p2_append_paged`` and 48 ``p2_read_paged``, no codec or state
    launch; by counter, and by profile name for a decode step, a prefill
    and a chunk step. Then the
    decode step's breakdown, one MoE layer by part, rows 1b, 1c, 3, 5b and
    6b at 16 KV heads, and the fp32 identities (``_moe_identity``)."""
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())
    resident = torch.cuda.memory_allocated()
    check(resident < 2 << 30, f"serve moe: {resident / 2**30:.2f} GiB "
          "still allocated before the model")
    timer = Timer(torch)
    out = {"kernels": _moe_kernel_rows(torch, timer), "parts_s": parts}
    part("kernels")
    lm, params = _state_model(torch, MOE_ARCH)
    cfg, layers = lm.cfg, lm.cfg.num_layers
    n = sum(t.numel() for t in _leaves(params))
    check(n == MOE_PARAMS and cfg.dtype == "bfloat16" and layers == 48,
          f"serve moe: {n} {cfg.dtype} parameters in {layers} layers")
    out["params"], out["resident_bytes"] = n, torch.cuda.memory_allocated()
    log(f"serve moe: {n:,} parameters, {out['resident_bytes'] / 2**30:.2f} "
        "GiB resident")
    prompts = _requests(cfg.vocab_size)
    runs = prompts[:STATE_REQUESTS]
    _serve_engine(torch, lm, params, prompts[:2], 4, fused_attention=True)
    part("init")
    for name, chunk in (("whole", 0), ("chunked", CHUNK)):
        B.reset_launches()
        t1 = time.perf_counter()
        (eng, _), routed, dropped = _with_drop_count(
            torch, lambda: _serve_engine(torch, lm, params, runs, 64,
                                         fused_attention=True,
                                         prefill_chunk=chunk))
        wall = time.perf_counter() - t1
        launches = dict(B.LAUNCHES)
        steps = eng.summary()["decode_steps"]
        admits = len(eng.metrics.prefills)
        chunks = _chunk_steps(eng.metrics.prefills, chunk) if chunk else 0
        check(bool(chunk) == (chunks > 0),
              f"serve moe ({name}): {chunks} chunk steps")
        want = {"p2_append_paged": layers * (steps + chunks),
                "paged_attention": layers * steps,
                "paged_attention_combine": layers * steps,
                "p2_prefill_paged": admits}
        if chunks:
            want["p2_read_paged"] = layers * chunks
        s = _check_state_run(f"serve moe ({name})", eng, launches, want,
                             len(runs))
        check(eng.sched.alloc.free_pages == eng.pcfg.total_pages,
              f"serve moe ({name}): pages still mapped at the end")
        log(f"serve moe ({name}): {s['requests_completed']} requests in "
            f"{wall:.2f} s, {steps} decode steps, {chunks} chunk steps, "
            f"{s['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{s['ttft_p50_s']*1e3:.1f} ms; the capacity dropped {dropped} "
            f"of {routed} routed (expert, token) pairs "
            f"({dropped / max(routed, 1):.4f}); cache_bytes "
            f"{s['cache_bytes']} "
            f"({s['cache_reduction']:.3f}x); launches {launches}")
        out[name] = {"summary": s, "launches": launches, "wall_s": wall,
                     "chunk_steps": chunks, "routed": routed,
                     "dropped": dropped}
        del eng
        part(name)
    # device activity only: a window's ~7,000 launches a step with their
    # host-side op events would multiply what the profiler processes
    out.update({
        "decode_profile": _profile_decode(
            torch, lm, params, prompts, steps=6, fused=True, names=STATE_FNS,
            what="moe decode", want={"p2_append_paged_kernel": layers,
                                     "pa_split_kernel": layers,
                                     "pa_combine_kernel": layers},
            cpu=False),
        "prefill_profile": _profile_prefill(
            torch, lm, params, prompts, reps=2, names=STATE_FNS,
            what="moe prefill", want={"p2_prefill_paged_kernel": 1},
            cpu=False),
        "chunk_profile": _profile_chunk(
            torch, lm, params, prompts, reps=2, names=STATE_FNS,
            what="moe chunk step", want={"p2_append_paged_kernel": layers,
                                         "p2_read_paged_kernel": layers},
            cpu=False)})
    part("profiles")
    out["layer"] = _moe_layer_parts(torch, timer, lm, params)
    del params, timer
    torch.cuda.empty_cache()
    part("layer")
    out["identity"] = _moe_identity(torch)
    part("identity")
    out["seconds"] = time.perf_counter() - t0
    log(f"serve moe: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    check(out["seconds"] < MOE_SECONDS, f"serve moe took "
          f"{out['seconds']:.1f} s, over {MOE_SECONDS:.0f}")
    return out


# ---------------------------------------------------------------------------
# serve mla: deepseek-v2-236b at full width (6 layers) from int8 latent pages
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v2-236b"
MLA_LAYERS = 6
# 6 layers x 3,972,116,480 + the embedding and the untied head (102,400 x
# 5,120 each) + the final norm
MLA_PARAMS = 24_881_280_000
MLA_WIDTHS = (512, 64)          # c_kv (kv_lora_rank), k_rope (rope dim)
MLA_ODD_WIDTHS = (512, 36)      # k_rope no multiple of a 16-byte vector
MLA_SECONDS = 100.0             # the phase's wall, at most


def _latent_pool(torch, gen, widths, layers=None, slots=8, page=16,
                 pps=64):
    """The serving pool's latent pages at ``widths``: int8 codes of random
    values (one leading layer axis when ``layers``), a page table of 8
    slots x 64 pages and each slot's (each layer's) pow-2 scales."""
    total = slots * pps
    lead = () if layers is None else (layers,)
    pools = [torch.randint(-128, 128, lead + (total + 1, page, w),
                           generator=gen, device=gen.device).to(torch.int8)
             for w in widths]
    scales = [torch.randint(-9, -2, lead + (slots,), generator=gen,
                            device=gen.device).float() for _ in widths]
    table = torch.randperm(total, generator=gen, device=gen.device).reshape(
        slots, pps).to(torch.int32)
    return pools, scales, table


def _latent_check(torch, what, launch, twin, pools, real):
    """``launch`` (the kernel) and ``twin`` (its plain version) each on a
    fresh copy of ``pools``; bit for bit on ``real(t)`` (the real pages, or
    the outputs), one launch, and a second launch the same."""
    from repro_torch.kernels import build as B
    want = twin([p.clone() for p in pools])
    _sync(torch, "cuda")
    B.reset_launches()
    got = launch([p.clone() for p in pools])
    _sync(torch, "cuda")
    check(sum(B.LAUNCHES.values()) == 1, f"{what}: launches {B.LAUNCHES}")
    again = launch([p.clone() for p in pools])
    for a, w, r in zip(got, want, again):
        check(_bits_equal(torch, real(a), real(w))
              and _bits_equal(torch, real(a), real(r)),
              f"{what}: differs from the twin or its own second launch")
    return got


def _latent_rows(torch, timer, widths=MLA_WIDTHS, timed=True) -> dict:
    """Rows 1b (the decode append, 8 slots x 1 row), 5b (the chunk write,
    128 rows of one slot past its page ends: the clamp rule), 6b (the read,
    one slot and 8 slots of 64 pages -> bf16) and 1c (the prefill write, 6
    layers x 512 rows) on MLA's latent pair, ``c_kv`` and ``k_rope`` at
    ``widths`` in one launch each: bit for bit with the twins (every real
    page and scale, or every position read) and over two launches; timed
    beside the twin and the byte bound (``timed``)."""
    from repro_torch.kernels import kv_append as KA
    from repro_torch.kernels import kv_prefill as KP
    from repro_torch.kernels import kv_read as KR
    gen = torch.Generator(device="cuda").manual_seed(sum(widths))
    dev = gen.device
    (cd, rd), (cs, rs), table = _latent_pool(torch, gen, widths)
    tag = f"{MLA_ARCH} latent pair {widths[0]} + {widths[1]}"
    out = {"p2_append_paged": [], "p2_read_paged": [],
           "p2_prefill_paged": []}

    def tokens(*lead):
        return [(torch.randn(lead + (w,), generator=gen, device=dev) * 3
                 ).to(torch.bfloat16) for w in widths]

    def row(name, what, shape, n, bytes_, kernel, twin):
        r = dict(shape=shape, what=f"{tag}: {what}", widths=list(widths),
                 max_abs_err=0.0, library_ms=None, library_note=PAGED_NONE)
        if timed:
            r["ms"] = timer(kernel)
            r["plain_ms"] = timer(twin, iters=10)
            r["bound_ms"], r["bound_by"] = bound_ms(bytes_, n,
                                                    fp32=True)
            log(f"{name} {tag}, {what}: {r['ms']*1e3:.2f} us one launch "
                f"(plain {r['plain_ms']*1e3:.1f} us, bound "
                f"{r['bound_ms']*1e3:.4f} us); bit-exact with the twin, two "
                "launches equal")
        out[name].append(r)

    # row 1b: the decode step's append, one inactive slot, one at a page's
    # last offset and one past its pages
    k, v = tokens(8, 1)
    lens = torch.tensor([0, 15, 1023, 100, 16, 511, 1024, 5],
                        dtype=torch.int32, device=dev)
    active = torch.tensor([1, 1, 1, 0, 1, 1, 1, 0], dtype=torch.bool,
                          device=dev)
    a = (cs, rs, k, v, table, lens, active)
    kw = dict(page_size=16, bits=8)
    _latent_check(torch, f"p2_append_paged ({tag}, decode)",
                  lambda p: KA.append_paged_cuda(*p, *a, **kw),
                  lambda p: KA.append_paged_torch(*p, *a, **kw), [cd, rd],
                  lambda t: t[:-1])
    n = k.numel() + v.numel()
    pool = [cd.clone(), rd.clone()]
    row("p2_append_paged", "decode append, 8 slots",
        [list(k.shape), list(v.shape)], n, n * 3 + 8 * 17,
        lambda: KA.append_paged_cuda(*pool, *a, **kw),
        lambda: KA.append_paged_torch(*pool, *a, **kw))
    # row 5b: a chunk of 128 rows of slot 3 (rows past its last page)
    k, v = tokens(1, 128)
    for start, valid in ((1000, 100), (256, 128)):      # the last timed
        a = (cs[3:4], rs[3:4], k, v, table[3:4],
             torch.tensor([start], dtype=torch.int32, device=dev), None)
        kw = dict(page_size=16, bits=8, n_valid=torch.tensor(
            [valid], dtype=torch.int32, device=dev), clamp_last=True)
        _latent_check(torch, f"p2_append_paged ({tag}, chunk at {start})",
                      lambda p: KA.append_paged_cuda(*p, *a, **kw),
                      lambda p: KA.append_paged_torch(*p, *a, **kw),
                      [cd, rd], lambda t: t[:-1])
    n = k.numel() + v.numel()
    row("p2_append_paged", "chunk write, S=128",
        [list(k.shape), list(v.shape)], n, n * 3 + 48,
        lambda: KA.append_paged_cuda(*pool, *a, **kw),
        lambda: KA.append_paged_torch(*pool, *a, **kw))
    # row 6b: one slot (the chunk step) and 8 (the decode step) -> bf16
    for b in (1, 8):
        sl = slice(3, 4) if b == 1 else slice(0, 8)
        a = (cd, rd, cs[sl], rs[sl], table[sl])
        got = _latent_check(
            torch, f"p2_read_paged ({tag}, {b} slots)",
            lambda p: KR.read_paged_cuda(*a, dtype=torch.bfloat16),
            lambda p: KR.read_paged_torch(*a, dtype=torch.bfloat16), [],
            lambda t: t)
        n = got[0].numel() + got[1].numel()
        row("p2_read_paged", f"read, {b} slot{'s' if b > 1 else ''}",
            [list(t.shape) for t in got], n, n * 3 + b * (8 + 4 * 64),
            lambda: KR.read_paged_cuda(*a, dtype=torch.bfloat16),
            lambda: KR.read_paged_torch(*a, dtype=torch.bfloat16))
    # row 1c: a whole-prompt prefill's write, 6 layers x 512 rows of slot 3
    (pc, pr), (sc, sr), ptable = _latent_pool(torch, gen, widths,
                                              layers=MLA_LAYERS)
    k, v = tokens(MLA_LAYERS, 512)
    for length in (512, 400):
        a = (k, v, ptable[3], 3, torch.tensor([length], dtype=torch.int32,
                                               device=dev))
        _latent_check(
            torch, f"p2_prefill_paged ({tag}, {length} valid)",
            lambda p: KP.prefill_paged_cuda(*p, *a, page_size=16, bits=8)
            and p, lambda p: KP.prefill_paged_torch(*p, *a, page_size=16,
                                                    bits=8) and p,
            [pc, pr, sc, sr], lambda t: t[:, :-1] if t.dim() > 2 else t)
    n = k.numel() + v.numel()
    pool = [pc.clone(), pr.clone(), sc.clone(), sr.clone()]
    row("p2_prefill_paged", f"prefill, {MLA_LAYERS} layers x S=512",
        [list(k.shape), list(v.shape)], 4 * n,
        n * 3 + 2 * MLA_LAYERS * 4 + 4 * 64 + 4,
        lambda: KP.prefill_paged_cuda(*pool, *a, page_size=16, bits=8),
        lambda: KP.prefill_paged_torch(*pool, *a, page_size=16, bits=8))
    torch.cuda.synchronize()
    return out


def _mla_decode_bound(torch, lm, params, pool) -> tuple[float, str, int]:
    """A decode step's byte bound (ms, what bounds it, bytes): every weight
    but the embedding read once (the MoE reads all its experts at C = 8),
    8 rows of the embedding, every slot's latent pages read (the gather
    path's ``p2_read_paged``) and a row of each written."""
    w = sum(t.numel() * t.element_size() for t in _leaves(params))
    emb = params["embed"]["w"]
    w += 8 * emb.shape[1] * emb.element_size() \
        - emb.numel() * emb.element_size()
    kv = sum(t.numel() * t.element_size() for t in _leaves(pool["data"]))
    nbytes = w + kv
    ms, by = bound_ms(nbytes)
    return ms, by, nbytes


def _mla_identity(torch) -> dict:
    """fp32 at full width, 2 layers, a drop-free capacity factor (64): the
    engine ≡ chunked ≡ preempted ≡ static decode (``lm_decode_step`` with
    ``mla_decode``) token for token, and the policy engine's int8 latent
    pool serves the int8 engine's tokens (``_identity_checks``)."""
    import repro_torch.configs as C
    cfg = C.get_config(MLA_ARCH)
    free = dataclasses.replace(cfg.moe, capacity_factor=64.0)
    lm, params = _state_model(torch, MLA_ARCH, num_layers=2, dtype="float32",
                              moe=free)
    out = _identity_checks(torch, f"{MLA_ARCH} 2 layers", lm, params,
                           _requests(cfg.vocab_size, n=8, seed=2), 32, 4,
                           CHUNK)
    del params
    torch.cuda.empty_cache()
    return out


def phase_serve_mla(torch) -> dict:
    """deepseek-v2-236b at full width (d_model 5,120, 128 heads, kv_lora
    512, q_lora 1,536, nope/rope/v 128/64/128, 160 experts + 2 shared of
    d_ff 1,536, top-6, vocab 102,400, bf16) cut to 6 of its 60 layers,
    seeded weights on the card, from the int8 latent pool (8 x 64 x 16):
    the engine phase's 16 requests x 64 new tokens whole prompt and chunked
    (128), ``fused_attention=True`` (MLA takes the gather path all the
    same); counts exact: a decode step 6 ``p2_append_paged`` + 6
    ``p2_read_paged``, a whole-prompt prefill 1 ``p2_prefill_paged``, a
    chunk step 6 + 6, no paged-attention or codec launch; by counter and
    by profile name; the pool's bytes (4.00x against fp32, 576 codes a
    token a layer). Then a decode step's breakdown beside its byte bound,
    rows 1b, 5b, 6b and 1c on the latent pair, and the fp32 identities
    (``_mla_identity``)."""
    from repro_torch.kernels import build as B
    from repro_torch.serve import kv_cache as KC
    t0 = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t0 - sum(parts.values())
    resident = torch.cuda.memory_allocated()
    check(resident < 2 << 30, f"serve mla: {resident / 2**30:.2f} GiB "
          "still allocated before the model")
    timer = Timer(torch)
    out = {"kernels": _latent_rows(torch, timer), "parts_s": parts}
    _latent_rows(torch, timer, MLA_ODD_WIDTHS, timed=False)
    log(f"serve mla: the three paged kernels bit-exact at the latent pair "
        f"{MLA_ODD_WIDTHS} (k_rope on the element loop in the same launch)")
    part("kernels")
    lm, params = _state_model(torch, MLA_ARCH, num_layers=MLA_LAYERS)
    cfg, layers = lm.cfg, lm.cfg.num_layers
    n = sum(t.numel() for t in _leaves(params))
    check(n == MLA_PARAMS and cfg.dtype == "bfloat16" and layers == 6
          and [s.mixer_kind for s in lm.period] == ["attn_mla"]
          and lm.period[0].ffn.shared is not None,
          f"serve mla: {n} {cfg.dtype} parameters in {layers} layers")
    out["params"], out["resident_bytes"] = n, torch.cuda.memory_allocated()
    log(f"serve mla: {n:,} parameters, {out['resident_bytes'] / 2**30:.2f} "
        "GiB resident")
    prompts = _requests(cfg.vocab_size)
    _serve_engine(torch, lm, params, prompts[:2], 4, fused_attention=True)
    part("init")
    for name, chunk in (("whole", 0), ("chunked", CHUNK)):
        B.reset_launches()
        t1 = time.perf_counter()
        (eng, _), routed, dropped = _with_drop_count(
            torch, lambda: _serve_engine(torch, lm, params, prompts, 64,
                                         fused_attention=True,
                                         prefill_chunk=chunk))
        wall = time.perf_counter() - t1
        launches = dict(B.LAUNCHES)
        steps = eng.summary()["decode_steps"]
        admits = len(eng.metrics.prefills)
        chunks = _chunk_steps(eng.metrics.prefills, chunk) if chunk else 0
        check(bool(chunk) == (chunks > 0),
              f"serve mla ({name}): {chunks} chunk steps")
        want = {"p2_append_paged": layers * (steps + chunks),
                "p2_read_paged": layers * (steps + chunks),
                "p2_prefill_paged": admits}
        s = _check_state_run(f"serve mla ({name})", eng, launches, want,
                             len(prompts))
        check(eng.sched.alloc.free_pages == eng.pcfg.total_pages,
              f"serve mla ({name}): pages still mapped at the end")
        per_token = KC.page_nbytes(eng.pool, eng.pcfg) // eng.pcfg.page_size
        check(per_token == sum(MLA_WIDTHS) * layers
              and 3.99 < s["cache_reduction"] <= 4.0,
              f"serve mla ({name}): {per_token} B a token, "
              f"{s['cache_reduction']:.4f}x against fp32")
        log(f"serve mla ({name}): {s['requests_completed']} requests in "
            f"{wall:.2f} s, {steps} decode steps, {chunks} chunk steps, "
            f"{s['tokens_per_s']:.1f} tok/s, TTFT p50 "
            f"{s['ttft_p50_s']*1e3:.1f} ms; the capacity dropped {dropped} "
            f"of {routed} routed (expert, token) pairs "
            f"({dropped / max(routed, 1):.4f}); cache_bytes "
            f"{s['cache_bytes']} ({s['cache_reduction']:.3f}x), {per_token} "
            f"codes a token ({per_token // layers} a layer); launches "
            f"{launches}")
        out[name] = {"summary": s, "launches": launches, "wall_s": wall,
                     "chunk_steps": chunks, "routed": routed,
                     "dropped": dropped,
                     "dropped_share": dropped / max(routed, 1),
                     "bytes_per_token": per_token}
        if name == "whole":
            out["decode_bound_ms"], out["decode_bound_by"], \
                out["decode_bytes"] = _mla_decode_bound(torch, lm, params,
                                                        eng.pool)
        del eng
        part(name)
    # the paged-attention kernels may not appear, fused or not
    names = STATE_FNS
    out.update({
        "decode_profile": _profile_decode(
            torch, lm, params, prompts, steps=6, fused=True, names=names,
            what="mla decode", want={"p2_append_paged_kernel": layers,
                                     "p2_read_paged_kernel": layers},
            cpu=False),
        "prefill_profile": _profile_prefill(
            torch, lm, params, prompts, reps=2, names=names,
            what="mla prefill", want={"p2_prefill_paged_kernel": 1},
            cpu=False),
        "chunk_profile": _profile_chunk(
            torch, lm, params, prompts, reps=2, names=names,
            what="mla chunk step", want={"p2_append_paged_kernel": layers,
                                         "p2_read_paged_kernel": layers},
            cpu=False)})
    d = out["decode_profile"]
    log(f"serve mla decode step: device {d['device_ms']:.3f} ms, host "
        f"{d['step_ms']:.2f} ms, byte bound {out['decode_bound_ms']:.3f} ms "
        f"({out['decode_bytes'] / 1e9:.2f} GB at 3.35 TB/s), peak memory "
        f"{d['peak_bytes'] / 2**30:.2f} GiB; dropped-pair share "
        f"{out['whole']['dropped_share']:.4f} (whole prompt), "
        f"{out['chunked']['dropped_share']:.4f} (chunked)")
    part("profiles")
    del params, timer
    torch.cuda.empty_cache()
    out["identity"] = _mla_identity(torch)
    part("identity")
    out["seconds"] = time.perf_counter() - t0
    log(f"serve mla: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    check(out["seconds"] < MLA_SECONDS, f"serve mla took "
          f"{out['seconds']:.1f} s, over {MLA_SECONDS:.0f}")
    return out


# ---------------------------------------------------------------------------
# the zoo-LM training slice: with_tt(internlm2-1.8b) with the low-precision
# step (TT weight sites, activation and gradient edges, int8 moments, the
# int8 gradient wire)
# ---------------------------------------------------------------------------

# train lm's steps: 6 since train moe was added, 8 before
LM_BATCH, LM_SEQ, LM_STEPS = 8, 256, 6


def _lm_config():
    from repro_torch import configs as C
    return C.with_tt(C.get_config(ARCH), quantize=True)


def _lm_pe_calls(cfg=None):
    """(kind, Z shape, G shape) of every distinct PE call of the LM step
    (``cfg``, default ``_lm_config()``): each TT site's forward and
    transposed chains at 8 x 256 rows, and each site's Ŵ (PE3: Ybar (rows,
    out), X (rows, in)); a TT embedding has none (its lookup contracts
    core slices eagerly)."""
    from repro_torch.core.ttm import pe_shapes
    from repro_torch.models.lm import _walk_sites, build_lm
    lm = build_lm(cfg or _lm_config())
    rows = LM_BATCH * LM_SEQ
    seen = []
    for path, site in _walk_sites(lm):
        if not site.use_tt or path[0] == "embed":
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


def _pe_tile(kind, z, g):
    """A PE2 or PE3 call on the f32 tile route under ``tt_tile.layout``,
    whatever its size (below ``tt_tile.MIN_FLOPS`` the route the wrappers
    take is the streamed body): a yardstick at the MLP's shapes."""
    from repro_torch.kernels import tt_tile
    zz, gg = _pe_contraction(kind, z, g)
    out = zz.new_empty((zz.shape[0], gg.shape[1], zz.shape[2]))
    tt_tile.launch(kind, f"ttm_{kind}", tt_tile.layout_for(zz, gg), zz, gg,
                   out)
    return out if kind == "pe2" else out[0]


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
                                                    fp32=False)
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


def _lm_grad_group(torch, gen):
    """(lm, its flattened meta params, the grad edge's first bf16 group):
    the first ``FQ_CAP`` bf16 leaves of ``with_tt(internlm2-1.8b)`` as
    seeded stand-ins for their gradients."""
    from repro_torch.kernels.grouped import FQ_CAP
    from repro_torch.models.lm import build_lm, init_lm
    from repro_torch.tree import flatten_with_path
    lm = build_lm(_lm_config())
    flat = flatten_with_path(init_lm(None, lm, device="meta"))
    grads = [(torch.randn(t.shape, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16) for _, t in flat if t.dtype == torch.bfloat16][:FQ_CAP]
    return lm, flat, grads


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
    from repro_torch.kernels.grouped import BW_CAP
    from repro_torch.numerics import QuantSpec
    from repro_torch.numerics.codecs import per_tensor_max_scale_log2
    from repro_torch.optim.adam import _is_adam_leaf
    from repro_torch.tree import stacked_groups
    lm, flat, grads = _lm_grad_group(torch, gen)
    q = lm.cfg.quant
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
    ("out.v[j] = wide_one<T, RT, MUL, SAT>(in[k].v[j], step, inv, lo, hi, "
     "lo_t, hi_t,\n                                               int_codes, "
     "sat);", "out.v[j] = in[k].v[j];"),
    ("y[i] = wide_one<T, RT, MUL, SAT>(x[i], step, inv, lo, hi, lo_t, hi_t, "
     "int_codes, sat);", "y[i] = x[i];")]}}
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
        FQ_PHASES, fq_cuts, ("pow2_fq.cu", "health.cuh"), ("pow2_fq",),
        "fq").items()}
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
    with _ckpt_dir("lm") as d:
        state, losses = train(
            cfg, "tp", dataclasses.replace(tcfg, ckpt_dir=d), batch=LM_BATCH,
            seq=LM_SEQ, device=device,
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
    ces_f32 = []
    with _ckpt_dir("lm_f32") as d:
        f32 = dataclasses.replace(tcfg, opt_state_dtype="float32",
                                  ckpt_dir=d)
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
    from repro_torch.models.lm import build_lm

    cfg = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64, remat="full",
                      dtype="float32",
                      tt=TTConfig(enable=True, d=3, max_rank=4,
                                  min_elements=1024),
                      quant=QuantConfig(enable=True))
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=8, warmup_steps=5)
    return _step_card_vs_cpu(torch, build_lm(cfg), tcfg,
                             lm_batch(0, batch=2, seq=16, vocab=64, seed=0),
                             "lm identity", device)


def _step_card_vs_cpu(torch, lm, tcfg, b, what: str,
                      device: str = "cuda") -> dict:
    """One train step of ``lm`` from one seeded state on the CPU and on the
    card on the numpy batch ``b``, held as ``phase_train_lm_identity``
    states."""
    from repro_torch.launch import steps as S
    from repro_torch.models.lm import init_lm
    from repro_torch.tree import flatten_with_path
    cfg = lm.cfg
    p_cpu = init_lm(torch.Generator().manual_seed(0), lm, device="cpu")
    out = {}
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
              f"{what}: {k} rel diff {rels[k]:.2e}")
    for name in ("activation", "grad_edge"):
        check(int(sg.scales[name].log2) == int(sc.scales[name].log2),
              f"{what}: {name} exponent differs")
        r = abs(sg.scales[name].mean_abs.item()
                - sc.scales[name].mean_abs.item()) \
            / sc.scales[name].mean_abs.item()
        check(r <= 1e-5, f"{what}: {name} statistic rel diff {r:.2e}")
    close = total = 0
    move = 0.0
    for (p, a), (_, c) in zip(flatten_with_path(sg.params),
                              flatten_with_path(sc.params)):
        if not a.is_floating_point():
            check(torch.equal(a.cpu(), c), f"{what}: {p} differs")
            continue
        e = (a.cpu() - c).abs()
        check(e.max().item() <= 2 * tcfg.learning_rate + 1e-6,
              f"{what}: {p} differs by {e.max().item():.3e}")
        move = max(move, e.max().item())
        close += int((e <= 2e-5).sum())
        total += e.numel()
    check(close >= 0.999 * total, f"{what}: {close}/{total} close")
    log(f"train {what}: card vs CPU {rels}, params within {move:.2e} "
        f"({close}/{total} within 2e-5); scale exponents equal")
    return {"rel": rels, "param_max_diff": move, "params_close": close,
            "params_total": total}


# ---------------------------------------------------------------------------
# train frontend: the audio and vision frontends' low-precision train step
# ---------------------------------------------------------------------------

# (arch, layers (None: the config's), batch, seq): hubert's reference batch
# of 8 x 256 frames; llava at full width with 2 layers, 2 x (64 patches +
# 256 tokens)
FRONTEND_CELLS = (("hubert-xlarge", None, 8, 256),
                  ("llava-next-34b", 2, 2, 256))
# launch-count name -> the kernel functions that count as it in a profile
# (PE1-3 take the tensor cores or the CUDA cores by shape)
FRONTEND_FNS = {"pe1": ("pe1_kernel", "pe1_mma_kernel"),
                "pe2": ("pe2_kernel", "pe2_mma_kernel"),
                "pe3": ("pe3_kernel", "pe3_mma_kernel"),
                "p2_fake_quant": ("p2_fq_group_kernel",),
                "bw_enc": ("bw_enc_group_kernel",),
                "bw_dec": ("bw_dec_group_kernel",)}
FRONTEND_SECONDS = 110.0        # the phase's wall, at most
# the CUDA-core PE bodies, which no frontend call reaches
FRONTEND_FMA = ("pe1_kernel", "pe2_kernel", "pe3_kernel")


def _frontend_lm(arch: str, layers):
    """``with_tt(arch, quantize=True)``'s model (no weights), ``layers``
    deep where given."""
    import repro_torch.configs as C
    from repro_torch.models.lm import build_lm
    cfg = C.get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    return build_lm(C.with_tt(cfg, quantize=True))


def _frontend_granule_calls() -> list:
    """(arch, kind, Z shape, G shape, launches a step) of the frontends'
    PE1 and PE2 calls whose rows of c or d are not 16-byte multiples (c or
    d off a multiple of 8): the calls the tensor cores take on cp.async
    granules (``ttm_pe1.plan_pe1``'s ``gran``, ``tt_mma.plan``'s ``gz`` /
    ``gg``), at the cells' rows."""
    out = []
    for arch, layers, batch, seq in FRONTEND_CELLS:
        per = _pe_launches_by_shape(_frontend_lm(arch, layers), batch * seq)
        for (kind, zs, gs), n in sorted(per.items()):
            c, d = zs[-1], gs[1]
            if kind != "pe3" and (c % 8 or d % 8):
                out.append((arch, kind, zs, gs, n))
    return out


def phase_frontend_kernels(torch, timer: Timer) -> dict:
    """The frontends' bf16 PE1 / PE2 calls on granules
    (``_frontend_granule_calls``: the ten calls of hubert-xlarge's and
    llava-next-34b's steps whose rows of c or d the TMA cannot take), at
    their shapes: each on the tensor-core route with its granules
    (asserted), within ``PE_TOL`` of the plain version, bit for bit over
    two launches, timed beside the CUDA-core body it replaced
    (``previous_ms``: ``pe1_kernel`` / ``pe2_kernel``), the plain version,
    the faster of one bf16 ``torch.matmul`` / ``torch.einsum`` (a yardstick
    only) and the bound (bytes at 3.35 TB/s or bf16 operations at 989
    TFLOP/s), with its launches a step."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import tt_mma, ttm_pe1
    gen = torch.Generator(device="cuda").manual_seed(7)
    tol = PE_TOL["bfloat16"]
    calls = _frontend_granule_calls()
    check(len(calls) == 10, f"frontend kernels: {len(calls)} granule calls, "
          "want the ten")
    rows = {"pe1": [], "pe2": []}

    def close(out, ref):
        return bool(((out.float() - ref.float()).abs()
                     <= tol + tol * ref.float().abs()).all())
    for arch, kind, zs, gs, per_step in calls:
        name = f"frontend {kind} {zs}x{gs} ({arch})"
        kern, plain = _pe_fns(kind)
        z = torch.randn(zs, generator=gen, device="cuda").to(torch.bfloat16)
        g = (torch.randn(gs, generator=gen, device="cuda") * 0.2).to(
            torch.bfloat16)
        p = (ttm_pe1.plan_pe1_for(z, g) if kind == "pe1" else
             tt_mma.plan_for(z, g))
        gran = (None if p is None else
                {"gran": p.gran} if kind == "pe1" else {"gz": p.gz,
                                                        "gg": p.gg})
        check(p is not None and any(gran.values()),
              f"{name}: not on the tensor cores' granules ({gran})")
        B.reset_launches()
        o = kern(z, g)
        check(B.LAUNCHES == {kind: 1}, f"{name}: launches {B.LAUNCHES}")
        r = plain(z, g)
        err = (o.float() - r.float()).abs()
        check(close(o, r), f"{name}: max err {err.max().item()}")
        check(_bits_equal(torch, kern(z, g), o), f"{name}: two launches "
              "differ")
        check(close(_pe_fma(kind, z, g), r),
              f"{name}: the CUDA-core body differs")
        row = dict(arch=arch, z=list(zs), g=list(gs), dtype="bfloat16",
                   max_abs_err=err.max().item(), route="tensor cores",
                   launches_per_step=per_step, tile=[p.bm, p.bn],
                   stages=p.stages, grid=p.grid, smem=p.smem, **gran)
        if kind == "pe2":
            row.update(orientation=p.orientation, slabs=p.slabs,
                       resident=bool(p.resident))
        row.update(_pe_yardsticks(torch, timer, kind, z, g, r))
        del o, r, err
        row["ms"] = timer(lambda: kern(z, g), iters=10)
        row["previous_ms"] = timer(lambda: _pe_fma(kind, z, g), iters=3)
        row["plain_ms"] = timer(lambda: plain(z, g), iters=3)
        nbytes, flops = _pe_work(kind, zs, gs, 2)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        row["of_bound"] = row["ms"] / row["bound_ms"]
        rows[kind].append(row)
        log(f"{name}: {row['ms']*1e3:.1f} us on granules {gran}, "
            f"{row['of_bound']:.2f}x the bound {row['bound_ms']*1e3:.1f} us "
            f"{row['bound_by']}; previous {row['previous_ms']*1e3:.1f} us "
            f"({row['previous_ms'] / row['ms']:.1f}x), "
            f"{row['library_call']} {row['library_ms']*1e3:.1f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us; {per_step} a step; err "
            f"{row['max_abs_err']:.1e}; two launches equal")
        del z, g
        torch.cuda.empty_cache()
    return rows


def _frontend_cell(torch, arch: str, layers, batch: int, seq: int) -> dict:
    """One step of ``launch/train.py::train`` on ``with_tt(arch,
    quantize=True)`` (int8 moments, the int8 wire) on the reference's
    frontend batch, seeded weights on the card: counts zeroed just before
    and read just after equal ``launches_per_step``, the cross-entropy
    finite; then one more step profiled, each counted kernel by name."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import build as B
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_batch_fn, train

    lm = _frontend_lm(arch, layers)
    cfg = lm.cfg
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=1, warmup_steps=1)
    per = S.launches_per_step(lm, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ces = []
    B.reset_launches()
    t0 = time.perf_counter()
    with _ckpt_dir("frontend") as d:
        state, losses = train(cfg, "tp", dataclasses.replace(
            tcfg, ckpt_dir=d), batch=batch, seq=seq, device="cuda",
            verbose=False, on_step=lambda i, m: ces.append(float(m["ce"])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(B.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches == per, f"train frontend ({arch}): launches {launches}, "
          f"want {per}")
    check(all(math.isfinite(x) for x in losses + ces),
          f"train frontend ({arch}): loss {losses}, ce {ces}")
    n = sum(t.numel() for t in _leaves(state.params))
    batch_np = make_batch_fn(cfg, batch, seq, tcfg.seed)(1)
    step = S.make_train_step(lm, None, tcfg)
    box = {"state": state}
    del state

    def one():
        box["state"], _ = step(box["state"], {
            k: torch.from_numpy(v).to("cuda") for k, v in batch_np.items()})
    torch.cuda.synchronize()            # warm: the first step ran in train
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    names = [f for fns in FRONTEND_FNS.values() for f in fns]
    for attempt in range(PROFILE_TRIES):
        prof, kern = _profile_window(torch, one, 1, names, None,
                                     f"train frontend ({arch})", cpu=False)
        by_name = {k: sum(kern.get(f, {}).get("calls_per_step", 0.0)
                          for f in fns) for k, fns in FRONTEND_FNS.items()}
        if {k: v for k, v in by_name.items() if v} == \
                {k: float(v) for k, v in per.items()}:
            break
        log(f"  train frontend ({arch}) profile: launches by name "
            f"{by_name}, want {per}; profiling another window")
    else:
        check(False, f"train frontend ({arch}): profile launches {by_name}, "
              f"want {per}")
    # every bf16 PE call on the tensor cores (the ten on granules since
    # c or d off a multiple of 8 no longer sends a call to the CUDA cores)
    fma = {f: kern[f]["calls_per_step"] for f in FRONTEND_FMA if f in kern}
    check(not fma, f"train frontend ({arch}): CUDA-core PE launches {fma}")
    total, _ = _device_summary(torch, prof, 1)
    del box
    torch.cuda.empty_cache()
    extra = " + patches" if cfg.frontend == "vision" else ""
    log(f"train frontend ({arch}, {cfg.num_layers} layers, {n:,} params, "
        f"batch {batch} x {seq}{extra}): ce {ces[0]:.4f}, first step "
        f"{wall:.1f} s with init, a step "
        f"{step_ms:.1f} ms host, {total:.2f} ms device, peak "
        f"{peak / 2**30:.2f} GiB; launches {per} by counter and by name "
        f"({ {f: round(r['calls_per_step']) for f, r in kern.items()} })")
    return {"params": n, "layers": cfg.num_layers, "ce": ces,
            "launches": launches, "launches_per_step": per,
            "step_ms": step_ms, "device_ms": total, "peak_bytes": peak,
            "profile": kern}


def phase_train_frontend(torch) -> dict:
    """The audio and vision frontends' low-precision train step
    (``_frontend_cell``): with_tt(hubert-xlarge, quantize=True) at full
    size (48 layers, 12,883,040 parameters with TT, asserted) on 8 x 256
    frames, with_tt(llava-next-34b, quantize=True) at full width with 2
    layers (56 heads padded to 64) on 2 x (64 patches + 256 tokens); then,
    at a reduced width (every projection TT, d = 3, rank 4, f32, int8
    moments and the wire), one step of each on the card against the same
    step on the CPU (``_step_card_vs_cpu``)."""
    import repro_torch.configs as C
    from repro_torch.configs.base import QuantConfig, TrainConfig, TTConfig
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.lm import build_lm
    t0 = time.perf_counter()
    out = {"parts_s": {}}
    for arch, layers, batch, seq in FRONTEND_CELLS:
        out[arch] = _frontend_cell(torch, arch, layers, batch, seq)
        out["parts_s"][arch] = time.perf_counter() - t0 - sum(
            out["parts_s"].values())
    check(out["hubert-xlarge"]["params"] == 12_883_040
          and out["hubert-xlarge"]["layers"] == 48,
          f"train frontend: hubert {out['hubert-xlarge']['params']} params")
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=8, warmup_steps=5)
    for arch, _, _, _ in FRONTEND_CELLS:
        cfg = C.get_reduced(arch).replace(
            dtype="float32", tt=TTConfig(enable=True, d=3, max_rank=4,
                                         min_elements=1024),
            quant=QuantConfig(enable=True))
        out[f"{arch} identity"] = _step_card_vs_cpu(
            torch, build_lm(cfg), tcfg, make_batch_fn(cfg, 2, 16, 0)(0),
            f"frontend identity ({arch})")
    out["seconds"] = time.perf_counter() - t0
    log(f"train frontend: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in out["parts_s"].items()) + ", identity "
        f"{out['seconds'] - sum(out['parts_s'].values()):.1f})")
    check(out["seconds"] < FRONTEND_SECONDS, f"train frontend took "
          f"{out['seconds']:.1f} s, over {FRONTEND_SECONDS:.0f}")
    return out


# ---------------------------------------------------------------------------
# train ckpt: the launch and checkpoint tooling on LM100M
# ---------------------------------------------------------------------------

CKPT_STEPS = 6             # (a)'s and (b)'s total_steps
CKPT_KILL = 3              # (b)'s child sends itself SIGTERM after this step
CKPT_EVERY = 2             # periodic saves after steps 2 and 4
CKPT_SITES = ("ffn", "attn_qkv", "attn_o", "expert", "embed", "head")
CKPT_PARAMS_EH = 18_962_334        # (c)'s parameters, the TT embedding's
CKPT_SECONDS = 240.0               # the phase's wall, at most
# LM100M's f32 step: PE1 on pe1_kernel, PE2 and PE3 on the tile route, and
# none of their launches on the tensor cores or the streamed bodies
CKPT_KERNEL_FN = {**KERNEL_FN, "pe2": "pe2_tile_kernel",
                  "pe3": "pe3_tile_kernel"}
CKPT_ABSENT_FN = ("pe1_mma_kernel", "pe2_mma_kernel", "pe3_mma_kernel",
                  "pe2_kernel", "pe3_kernel")


def _ckpt_configs():
    """(a)'s model (``examples/train_lm_100m.py --tt``'s:
    ``with_tt(LM100M, d=3, max_rank=48)``, f32), (c)'s (the same with TT
    embedding and head sites and quantization on) and the train config of
    both: the example's learning rate and warm-up, ``CKPT_STEPS`` steps,
    f32 moments and the int8 gradient wire, periodic saves every
    ``CKPT_EVERY`` steps."""
    from repro_torch import configs as C
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import LM100M
    a = C.with_tt(LM100M, d=3, max_rank=48)
    c = C.with_tt(LM100M, d=3, max_rank=48, apply_to=CKPT_SITES,
                  quantize=True)
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=CKPT_STEPS,
                       warmup_steps=10, grad_compress=True,
                       ckpt_every=CKPT_EVERY, log_every=1)
    return a, c, tcfg


def _tensors(tree, prefix: str = "") -> list:
    """(path, tensor) of every tensor of a tree in the checkpoint's order
    (a ``QTensor`` as its codes and steps)."""
    from repro_torch.ckpt.checkpoint import _children
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [(prefix, tree)]
    return [pl for k, v in kids for pl in _tensors(v, f"{prefix}/{k}")]


def _state_diff(torch, a, b) -> dict:
    """Leaves of two states that differ in a bit, and the largest absolute
    difference over them (0.0 when every bit agrees)."""
    ta, tb = _tensors(a), _tensors(b)
    check([p for p, _ in ta] == [p for p, _ in tb], "states differ in shape")
    differ, worst = [], 0.0
    for (p, x), (_, y) in zip(ta, tb):
        same = (_bits_equal(torch, x, y) if x.is_floating_point()
                else torch.equal(x, y))
        if not same:
            differ.append(p)
            worst = max(worst, (x.double() - y.double()).abs().max().item())
    return {"leaves": len(ta), "differ": differ, "max_abs_diff": worst}


def phase_ckpt_child(torch, ckpt_dir: str, kill_at: int, out: str) -> None:
    """(b)'s child process: ``train`` of (a)'s configs on the card from
    ``ckpt_dir`` (resuming its newest file), writing each step's loss to
    ``out`` as JSON as it goes and, after step ``kill_at`` (-1: never),
    sending itself SIGTERM: the emergency save, then exit code 143."""
    import signal
    from repro_torch.launch.train import train
    a, _, tcfg = _ckpt_configs()
    losses = {}

    def on_step(i, m):
        losses[i] = float(m["loss"])
        Path(out).write_text(json.dumps(losses))
        if i == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
    train(a, "tp", dataclasses.replace(tcfg, ckpt_dir=ckpt_dir),
          batch=LM_BATCH, seq=LM_SEQ, device="cuda", on_step=on_step)


def _ckpt_child(ckpt_dir: str, kill_at: int, out: str):
    """Run ``phase_ckpt_child`` in a child process of this script; its
    result, output captured."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--src",
           str(SRC[0]), "--ckpt-child", ckpt_dir, str(kill_at), out]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    return res, time.perf_counter() - t0


def _pe_launches_by_shape(lm, rows: int) -> dict:
    """Launches a step of each distinct PE call ``(kind, Z shape, G shape)``
    of ``lm``'s training step at ``rows`` rows: a layer site's forward
    chain in every layer (twice under ``remat="full"``), its transposed
    chain and its Ŵ; a TT head's once; a TT embedding none (as
    ``steps.launches_per_step`` counts them, by shape); TT expert sites
    none (their grouped calls: ``_grouped_launches_by_shape``), nor a TT
    router (f32 in a bf16 step: ``_f32_site_launches``)."""
    from repro_torch.core.ttm import pe_shapes
    from repro_torch.models.lm import _walk_sites
    fwd = 2 if lm.cfg.remat == "full" else 1
    out: dict = {}
    for path, site in _walk_sites(lm):
        if not site.use_tt or path[0] == "embed" or site.family == "expert" \
                or path[-1] == "router":
            continue        # experts: _grouped_launches_by_shape; the
            #                 router's chains run in f32 (moe._route)
        n, f = (lm.n_periods, fwd) if path[0] == "layers" else (1, 1)
        s = site.spec
        calls = [(c, n * f) for c in pe_shapes(s, rows)] + [
            (c, n) for c in pe_shapes(s.transposed(), rows)] + [
            (("pe3", (rows, s.out_dim), (rows, s.in_dim)), n)]
        for c, k in calls:
            out[c] = out.get(c, 0) + k
    return out


PE_EINSUM = {"pe1": "abc,bdc->ad", "pe2": "abc,bd->adc", "pe3": "bj,bi->ji"}


def _pe_yardsticks(torch, timer: Timer, kind, z, g, ref) -> dict:
    """Yardsticks only: one ``torch.matmul`` (``_pe_library``) and one
    ``torch.einsum`` computing the same call on the same tensors (TF32 off),
    each held to the plain version's result and timed; ``library_ms`` is
    the faster, named in ``library_call``."""
    tol = PE_TOL[str(z.dtype)[6:]]
    calls = {"torch.matmul": lambda: _pe_library(torch, kind, z, g),
             f'torch.einsum("{PE_EINSUM[kind]}")':
                 lambda: torch.einsum(PE_EINSUM[kind], z, g)}
    times = {}
    for name, fn in calls.items():
        check((fn() - ref).abs().max().item() <= tol * (
            1 + ref.abs().max().item()), f"{kind} yardstick {name} differs")
        times[name] = timer(fn, iters=5)
    best = min(times, key=times.get)
    return {"library_ms": times[best], "library_call": best,
            "matmul_ms": times["torch.matmul"],
            "einsum_ms": times[f'torch.einsum("{PE_EINSUM[kind]}")']}


def _ckpt_pe_rows(torch, timer: Timer, cfg, per_a: dict,
                  per_c: dict) -> dict:
    """PE1/PE2/PE3 at every distinct f32 shape of (c)'s step (LM100M's
    layer sites and TT head at 8 x 256 rows), each with its launches a step
    in (a) and (c) (``per_a``, ``per_c``: ``_pe_launches_by_shape``): no
    tensor-core plan for f32 (asserted); PE2 and PE3 on the tile route
    (``tt_tile.plan``; one launch a call, asserted) and PE1 on
    ``pe1_kernel``; within 1e-4 of the plain version, bit for bit over two
    launches, timed beside it, beside the previous design at the same call
    (PE2 and PE3: ``pe2_kernel`` / ``pe3_kernel`` through
    ``tt_contract.launch``, ``previous_ms``), beside the faster of one
    ``torch.matmul`` and one ``torch.einsum`` of the same product (TF32 off)
    and beside the bound (bytes at 3.35 TB/s or the FP32 operations at 67
    TFLOP/s)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import tt_mma, tt_tile, ttm_pe1
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = {"pe1": [], "pe2": [], "pe3": []}
    tol = PE_TOL["float32"]
    for kind, zs, gs in _lm_pe_calls(cfg):
        kern, plain = _pe_fns(kind)
        z = torch.randn(zs, generator=gen, device="cuda")
        g = torch.randn(gs, generator=gen, device="cuda") * 0.2
        p = (ttm_pe1.plan_pe1_for(z, g) if kind == "pe1" else
             tt_mma.plan_for(*_pe_contraction(kind, z, g)))
        check(p is None, f"ckpt {kind} {zs}x{gs}: f32 on the tensor cores")
        row = dict(z=list(zs), g=list(gs), dtype="float32",
                   route="CUDA cores", launches_per_step_a=per_a.get(
                       (kind, zs, gs), 0),
                   launches_per_step_c=per_c[(kind, zs, gs)])
        if kind != "pe1":
            t = tt_tile.plan_for(*_pe_contraction(kind, z, g))
            check(t is not None, f"ckpt {kind} {zs}x{gs}: not on the tile "
                  "route")
            row.update(route="tile", tile=[t.bm, t.bn], spc=t.spc, ct=t.ct,
                       tn=t.tn, ks=t.ks, cs=t.cs, stages=t.stages,
                       grid=t.grid, smem=t.smem)
        torch.cuda.synchronize()
        B.reset_launches()
        o = kern(z, g)
        torch.cuda.synchronize()
        check(B.LAUNCHES == {kind: 1}, f"ckpt {kind} {zs}x{gs}: launches "
              f"{B.LAUNCHES}")
        r = plain(z, g)
        err = (o - r).abs()
        check(bool((err <= tol + tol * r.abs()).all()),
              f"ckpt {kind} {zs}x{gs}: max err {err.max().item()}")
        check(_bits_equal(torch, kern(z, g), o),
              f"ckpt {kind} {zs}x{gs}: two launches differ")
        row["max_abs_err"] = err.max().item()
        if kind != "pe1":
            prev = _pe_fma(kind, z, g)
            check(bool(((prev - r).abs() <= tol + tol * r.abs()).all()),
                  f"ckpt {kind} {zs}x{gs}: the previous design differs")
            del prev
        del o, err
        row.update(_pe_yardsticks(torch, timer, kind, z, g, r))
        del r
        row["ms"] = timer(lambda: kern(z, g), iters=10)
        if kind != "pe1":
            row["previous_ms"] = timer(lambda: _pe_fma(kind, z, g), iters=5)
        row["plain_ms"] = timer(lambda: plain(z, g), iters=5)
        nbytes, flops = _pe_work(kind, zs, gs, 4)
        row["flops"] = flops
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                    fp32=True)
        row["tflops"] = flops / row["ms"] / 1e9
        rows[kind].append(row)
        was = (f", previous {row['previous_ms']*1e3:.1f} us"
               if "previous_ms" in row else "")
        log(f"ckpt {kind} {zs} x {gs} f32 ({row['route']}, "
            f"{row['launches_per_step_a']} / {row['launches_per_step_c']} a "
            f"step in (a) / (c)): {row['ms']*1e3:.1f} us "
            f"({row['tflops']:.2f} TFLOP/s; plain {row['plain_ms']*1e3:.1f}"
            f" us{was}, {row['library_call']} {row['library_ms']*1e3:.1f} "
            f"us (matmul {row['matmul_ms']*1e3:.1f}, einsum "
            f"{row['einsum_ms']*1e3:.1f}), bound {row['bound_ms']*1e3:.2f} "
            f"us {row['bound_by']}); err {row['max_abs_err']:.1e}")
        del z, g
    torch.cuda.empty_cache()
    return rows


def _ckpt_fq_rows(torch, timer: Timer, lm, params) -> list:
    """The TT embedding's and the TT head's core groups (4-bit, at their
    ``wscale_log2``), each one ``p2_fq_group`` launch (asserted), bit for
    bit with the plain version and over two launches, timed beside it,
    beside a loop of ``torch.fake_quantize_per_tensor_affine`` and beside
    the group's byte bound (row 4b's embedding and head cores)."""
    from repro_torch.kernels import build as B
    from repro_torch.numerics import cuda_backend as CB
    bits = lm.cfg.quant.weight_bits
    rows = []
    for name in ("embed", "head"):
        sp = params[name]
        xs = [sp[k].detach() for k in sorted(sp) if k.startswith("core_")]
        steps = sp["wscale_log2"].float()
        torch.cuda.synchronize()
        B.reset_launches()
        ys = CB.fake_quant_scalar_many(xs, steps, bits)
        torch.cuda.synchronize()
        check(B.LAUNCHES == {"p2_fake_quant": 1},
              f"ckpt fake-quant {name} cores: launches {B.LAUNCHES}")
        check(all(_bits_equal(torch, y, r) for y, r in zip(
            ys, CB.fake_quant_many_plain(xs, steps, bits))),
              f"ckpt fake-quant {name} cores: not bit-exact")
        check(all(_bits_equal(torch, y, a) for y, a in zip(
            ys, CB.fake_quant_scalar_many(xs, steps, bits))),
              f"ckpt fake-quant {name} cores: two launches differ")
        hi = 2 ** (bits - 1)
        scales = [2.0 ** v for v in steps.tolist()]
        row = dict(what=f"{name} cores", shape=[list(x.shape) for x in xs],
                   bits=bits, dtype=["float32"], entries=len(xs),
                   elements=sum(x.numel() for x in xs), max_abs_err=0.0)
        row["ms"] = timer(lambda: CB.fake_quant_scalar_many(xs, steps, bits))
        row["plain_ms"] = timer(
            lambda: CB.fake_quant_many_plain(xs, steps, bits), iters=5)
        row["library_ms"], row["library_note"] = _library_yardstick(
            timer, lambda: [torch.fake_quantize_per_tensor_affine(
                x, scales[i], 0, -hi, hi - 1) for i, x in enumerate(xs)],
            lambda r: all(torch.equal(a, b) for a, b in zip(r, ys)))
        row["bound_ms"], row["bound_by"] = bound_ms(_fq_bytes(xs))
        log(f"ckpt p2_fake_quant {name} cores {row['shape']} ({bits}-bit): "
            f"{row['ms']*1e3:.1f} us one launch (plain "
            f"{row['plain_ms']*1e3:.1f} us, library loop "
            f"{row['library_note']}, bound {row['bound_ms']*1e3:.3f} us); "
            "bit-exact, two launches equal")
        rows.append(row)
    return rows


def _ckpt_wire_rows(torch, timer: Timer, cfg) -> tuple[list, list]:
    """The wire's one encode and one decode group at (a)'s leaves (every
    reference leaf's gradient flattened, seeded f32 stand-ins, block
    1,024; the first block of the first large leaf all zero), each held to
    its twin bit for bit as ``train lm`` holds row 10b and row 11."""
    from repro_torch.models.lm import build_lm, init_lm
    from repro_torch.numerics import cuda_backend as CB
    from repro_torch.tree import flatten_with_path, stacked_groups
    gen = torch.Generator(device="cuda").manual_seed(9)
    floats = [(p, t) for p, t in flatten_with_path(
        init_lm(None, build_lm(cfg), device="meta")) if t.is_floating_point()]
    wire = []
    for grp in stacked_groups([p for p, _ in floats]):
        n = sum(floats[i][1].numel() for i in grp)
        w = torch.randn((1, n), generator=gen, device="cuda") * 1e-2
        if n >= 1 << 20 and not any(x.numel() >= 1 << 20 for x in wire):
            w[0, :1024] = 0.0
        wire.append(w)
    enc = _lm_bw_rows(torch, {"bw": [("wire group (lm100m)", wire, 1024)]})
    got = CB.bw_encode_many(wire, 1024)
    dec = _bw_dec_group_row(torch, timer, got, wire, 1024,
                            "wire group (lm100m)", "cuda")
    del got, wire
    torch.cuda.empty_cache()
    return enc, [dec]


def _ckpt_cost(cfg, prof: dict) -> dict:
    """Parameters, model FLOPs (the reference's 6·N·D at 8 x 256 tokens)
    and the TT chains' FLOPs (``steps.step_flops``) of one step of
    ``cfg``, with their shares of the FP32 peak over the profiled step's
    host wall and device time."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import (active_params, count_params,
                                           meta_params)
    from repro_torch.launch.roofline import (PEAK_FLOPS_FP32,
                                             model_flops_estimate)
    from repro_torch.models.lm import build_lm
    n = count_params(meta_params(cfg))
    shape = ShapeConfig("lm100m", LM_SEQ, LM_BATCH, "train")
    model = model_flops_estimate(cfg, shape, active_params(cfg, n), "train")
    chains = S.step_flops(build_lm(cfg), LM_BATCH, LM_SEQ)
    wall, dev = prof["step_ms"] / 1e3, prof["device_ms"] / 1e3
    return {"params": n, "model_flops": model, "chain_flops": chains,
            "step_ms": prof["step_ms"], "device_ms": prof["device_ms"],
            "model_share_wall": model / (PEAK_FLOPS_FP32 * wall),
            "model_share_device": model / (PEAK_FLOPS_FP32 * dev),
            "chain_share_wall": chains / (PEAK_FLOPS_FP32 * wall),
            "chain_share_device": chains / (PEAK_FLOPS_FP32 * dev)}


def _ckpt_profile(torch, lm, tcfg, state, cfg, what: str) -> dict:
    """One step of ``state`` timed (host wall) and one profiled (device
    time, busy share, every counted kernel by name: PE2 and PE3 on the tile
    route, no tensor-core PE kernel and no streamed PE2 / PE3 body)."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_batch_fn
    step = S.make_train_step(lm, None, tcfg)
    batch_fn = make_batch_fn(cfg, LM_BATCH, LM_SEQ, tcfg.seed)
    box = {"state": state}

    def one(i):
        box["state"], _ = step(box["state"], {
            k: torch.from_numpy(v).to("cuda")
            for k, v in batch_fn(CKPT_STEPS + i).items()})
    log(f"train ckpt ({what}): profile")
    prof = _profile_train(torch, one, S.launches_per_step(lm, tcfg),
                          steps=1, fn=CKPT_KERNEL_FN,
                          absent=CKPT_ABSENT_FN)
    del box
    torch.cuda.empty_cache()
    return prof


def phase_train_ckpt(torch) -> dict:
    """The launch and checkpoint tooling through ``launch/train.py::train``
    at LM100M's full size (12 layers, d_model 768, vocab 32,768, f32;
    seeded weights, 8 x 256 tokens of ``lm_batch``, f32 moments and the
    int8 gradient wire, so the wire residual is checkpointed too):

    (a) ``with_tt(LM100M, d=3, max_rank=48)`` uninterrupted for
        ``CKPT_STEPS`` steps twice, each in a fresh checkpoint directory
        (saves after steps 2 and 4 and the final one; launches counted
        exactly, per ``launches_per_step``): the two final states compared
        bit for bit (the differing leaves named otherwise, and (b) then
        held to the largest difference those two runs show). The final
        state's save timed: the snapshot on the caller's thread, the
        background write, the file's size, and its load back, bit for bit.
    (b) a child process of the same config that sends itself SIGTERM
        after step ``CKPT_KILL``: exit code 143, the emergency file
        ``step_4.ckpt`` (meta ``emergency``) beside the periodic
        ``step_2.ckpt``, its losses (a)'s; a second child resumes it to
        ``CKPT_STEPS`` (``resumed from step 4``), leaves steps 2, 4 and 6,
        and its final state and its losses for steps 4-5 are (a)'s.
    (c) the same with TT embedding and head sites and quantization on
        (``CKPT_PARAMS_EH`` parameters, asserted; the embedding and head
        TT shapes asserted): 2 steps with the launches counted exactly,
        one step profiled (host wall, device time, busy share, every
        counted kernel by name, PE2 and PE3 on the tile route); PE1-3 at
        every f32 shape of its step with its launches a step in (a) and
        (c) (``_ckpt_pe_rows``), the embedding's and head's core groups and
        the wire's encode and decode groups held to their twins and
        timed; one step at a reduced width with TT embedding and head on
        the card against the CPU (``_step_card_vs_cpu``).
    (d) parameters, model FLOPs and the TT chains' FLOPs of (a)'s and
        (c)'s steps beside the FP32 peak over the profiled steps."""
    from repro_torch.ckpt import AsyncCheckpointer, load, step_path
    from repro_torch.configs.base import (ModelConfig, QuantConfig,
                                          TrainConfig, TTConfig)
    from repro_torch.data import lm_batch
    from repro_torch.kernels import build as B
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import count_params, meta_params
    from repro_torch.launch.train import train
    from repro_torch.models.lm import build_lm
    t0 = time.perf_counter()
    a_cfg, c_cfg, tcfg = _ckpt_configs()
    lm_a = build_lm(a_cfg)
    per_a = S.launches_per_step(lm_a, tcfg)
    out = {"launches_per_step": per_a}
    saves = [f"step_{s}.ckpt" for s in (2, 4, 6)]

    # (a) two uninterrupted runs
    finals, losses = [], []
    for run in range(2):
        torch.cuda.synchronize()
        B.reset_launches()
        t = time.perf_counter()
        with _ckpt_dir("a") as d:
            state, ls = train(a_cfg, "tp", dataclasses.replace(
                tcfg, ckpt_dir=d), batch=LM_BATCH, seq=LM_SEQ,
                device="cuda", verbose=False)
            torch.cuda.synchronize()
            files = sorted(os.listdir(d))
        wall = time.perf_counter() - t
        launches = dict(B.LAUNCHES)
        want = {k: v * CKPT_STEPS for k, v in per_a.items()}
        check(launches == want, f"train ckpt (a) run {run}: launches "
              f"{launches}, want {want}")
        check(files == saves, f"train ckpt (a) run {run}: files {files}")
        check(all(math.isfinite(x) for x in ls), f"train ckpt (a): {ls}")
        finals.append(state)
        losses.append(ls)
        log(f"train ckpt (a) run {run}: {CKPT_STEPS} steps in {wall:.1f} s "
            f"with init and saves, losses {ls}, launches {launches}")
        if run == 0:
            out["launches"], out["run_s"] = launches, wall
    diff = _state_diff(torch, finals[0], finals[1])
    same_losses = losses[0] == losses[1]
    tol = diff["max_abs_diff"]
    out["determinism"] = dict(diff, losses_equal=same_losses)
    if diff["differ"] or not same_losses:
        log(f"train ckpt (a): the two runs DIFFER in {len(diff['differ'])} "
            f"of {diff['leaves']} leaves (first {diff['differ'][:8]}), by "
            f"up to {tol:.3e}; losses {losses}; (b) is held to {tol:.3e}")
    else:
        log(f"train ckpt (a): the two runs agree bit for bit in all "
            f"{diff['leaves']} leaves and every loss")
    ref = finals.pop(0)
    del finals
    torch.cuda.empty_cache()

    # the final state's save, timed, and its load back
    with _ckpt_dir("save") as d:
        ck = AsyncCheckpointer(d)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ck.save(CKPT_STEPS, S.stack_state(ref), {"final": True})
        snap = time.perf_counter() - t
        t = time.perf_counter()
        ck.wait()
        write = time.perf_counter() - t
        ck.close()
        path = step_path(d, CKPT_STEPS)
        size = os.path.getsize(path)
        t = time.perf_counter()
        back, meta = S.load_state(path, ref)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    back_diff = _state_diff(torch, back, ref)
    check(not back_diff["differ"] and meta == {"final": True,
                                               "step": CKPT_STEPS},
          f"train ckpt: the saved state did not load back bit for bit "
          f"({back_diff['differ'][:8]}, meta {meta})")
    del back
    out["save"] = {"snapshot_s": snap, "write_s": write, "bytes": size,
                   "load_s": load_s}
    log(f"train ckpt: the final state's save: snapshot {snap*1e3:.1f} ms on "
        f"the caller's thread, background write {write*1e3:.1f} ms, "
        f"{size:,} B ({size / 2**20:.1f} MiB); load back {load_s*1e3:.1f} "
        "ms, bit for bit")

    # (b) preempt and resume in child processes
    with _ckpt_dir("b") as d:
        first = f"{d}/losses_kill.json"
        res, s1 = _ckpt_child(d, CKPT_KILL, first)
        files = sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))
        check(res.returncode == 143, f"train ckpt (b): the preempted child "
              f"exited {res.returncode}: {res.stderr[-3000:]}")
        check(files == saves[:2], f"train ckpt (b): files after SIGTERM "
              f"{files}, want {saves[:2]}")
        _, emergency = load(step_path(d, CKPT_KILL + 1))
        check(emergency == {"emergency": True, "step": CKPT_KILL + 1},
              f"train ckpt (b): the emergency file's meta {emergency}")
        killed = json.loads(Path(first).read_text())
        check([killed[str(i)] for i in range(CKPT_KILL + 1)]
              == losses[0][:CKPT_KILL + 1] or tol > 0,
              f"train ckpt (b): the child's losses {killed}, (a)'s "
              f"{losses[0]}")
        second = f"{d}/losses_resume.json"
        res2, s2 = _ckpt_child(d, -1, second)
        check(res2.returncode == 0, f"train ckpt (b): the resumed child "
              f"exited {res2.returncode}: {res2.stderr[-3000:]}")
        check(f"[train] resumed from step {CKPT_KILL + 1}" in res2.stdout,
              f"train ckpt (b): no resume line in {res2.stdout[-2000:]}")
        files2 = sorted(f for f in os.listdir(d) if f.endswith(".ckpt"))
        check(files2 == saves, f"train ckpt (b): files after the resume "
              f"{files2}, want {saves}")
        resumed = json.loads(Path(second).read_text())
        got = [resumed[str(i)] for i in range(CKPT_KILL + 1, CKPT_STEPS)]
        want = losses[0][CKPT_KILL + 1:]
        state_b, meta = S.load_state(step_path(d, CKPT_STEPS), ref)
    check(meta == {"final": True, "step": CKPT_STEPS},
          f"train ckpt (b): the resumed run's final meta {meta}")
    check(sorted(resumed) == [str(i) for i in range(CKPT_KILL + 1,
                                                    CKPT_STEPS)],
          f"train ckpt (b): the resumed child ran steps {sorted(resumed)}")
    bdiff = _state_diff(torch, state_b, ref)
    ok = (not bdiff["differ"] and got == want) if tol == 0 else (
        bdiff["max_abs_diff"] <= tol
        and all(abs(x - y) <= tol * max(1.0, abs(y))
                for x, y in zip(got, want)))
    check(ok, f"train ckpt (b): the resumed run's final state differs from "
          f"(a)'s in {bdiff['differ'][:8]} by {bdiff['max_abs_diff']:.3e} "
          f"(held to {tol:.3e}), losses {got} against {want}")
    del state_b, ref
    torch.cuda.empty_cache()
    out["resume"] = {"exit_code": res.returncode, "files_after_kill": files,
                     "files_after_resume": files2, "losses": got,
                     "state_diff": bdiff, "child_s": [s1, s2]}
    log(f"train ckpt (b): the child exited 143 after SIGTERM at step "
        f"{CKPT_KILL} leaving {files} (the emergency file's meta "
        f"{emergency}); the "
        f"resumed child printed 'resumed from step {CKPT_KILL + 1}', left "
        f"{files2}, its losses {got} are (a)'s and its final state is "
        f"(a)'s {'bit for bit' if tol == 0 else f'within {tol:.3e}'} "
        f"({s1:.1f} s and {s2:.1f} s a child)")

    # the profiled step of (a)'s config, from a fresh state
    from repro_torch.models.lm import init_lm
    params = init_lm(torch.Generator(device="cuda").manual_seed(0), lm_a,
                     device="cuda")
    out["profile_a"] = _ckpt_profile(
        torch, lm_a, tcfg, S.init_train_state(params, tcfg,
                                              a_cfg.quant.policy()),
        a_cfg, "a")
    del params

    # (c) TT embedding and head at full size
    lm_c = build_lm(c_cfg)
    n_c = count_params(meta_params(c_cfg))
    n_c = int(n_c)
    check(n_c == CKPT_PARAMS_EH, f"train ckpt (c): {n_c:,} params, want "
          f"{CKPT_PARAMS_EH:,}")
    for site in (lm_c.embed, lm_c.head):
        check(site.use_tt and site.spec.j_dims == (32, 32, 32)
              and site.spec.i_dims == (8, 8, 12)
              and tuple(site.spec.ranks) == (1, 48, 48, 1),
              f"train ckpt (c): site {site.spec}")
    tc = dataclasses.replace(tcfg, total_steps=2)
    per_c = S.launches_per_step(lm_c, tc)
    torch.cuda.synchronize()
    B.reset_launches()
    with _ckpt_dir("c") as d:
        state_c, ls_c = train(c_cfg, "tp", dataclasses.replace(
            tc, ckpt_dir=d), batch=LM_BATCH, seq=LM_SEQ, device="cuda",
            verbose=False)
    torch.cuda.synchronize()
    launches_c = dict(B.LAUNCHES)
    want_c = {k: v * 2 for k, v in per_c.items()}
    check(launches_c == want_c, f"train ckpt (c): launches {launches_c}, "
          f"want {want_c}")
    check(all(math.isfinite(x) for x in ls_c), f"train ckpt (c): {ls_c}")
    log(f"train ckpt (c): {n_c:,} params (embedding and head TT), 2 steps, "
        f"losses {ls_c}, launches {launches_c} ({per_c} a step)")
    out["eh"] = {"params": n_c, "launches": launches_c,
                 "launches_per_step": per_c, "losses": ls_c}
    timer = Timer(torch)
    out["fq_rows"] = _ckpt_fq_rows(torch, timer, lm_c, state_c.params)
    out["profile_c"] = _ckpt_profile(torch, lm_c, tc, state_c, c_cfg, "c")
    del state_c
    torch.cuda.empty_cache()
    rows = LM_BATCH * LM_SEQ
    by_shape = {w: _pe_launches_by_shape(lm, rows)
                for w, lm in (("a", lm_a), ("c", lm_c))}
    for w, per in (("a", per_a), ("c", per_c)):
        for kind in ("pe1", "pe2", "pe3"):
            got = sum(v for (k, *_), v in by_shape[w].items() if k == kind)
            check(got == per[kind], f"train ckpt ({w}): {kind} launches by "
                  f"shape {got}, launches_per_step {per[kind]}")
    out["pe_launches_by_shape"] = {w: [[*k, v] for k, v in d.items()]
                                   for w, d in by_shape.items()}
    out["pe_rows"] = _ckpt_pe_rows(torch, timer, c_cfg, by_shape["a"],
                                   by_shape["c"])
    out["bw_enc_rows"], out["bw_dec_rows"] = _ckpt_wire_rows(torch, timer,
                                                             a_cfg)
    del timer
    red = ModelConfig(name="t", num_layers=2, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=128, remat="full",
                      dtype="float32",
                      tt=TTConfig(enable=True, d=3, max_rank=4,
                                  min_elements=1024, apply_to=CKPT_SITES),
                      quant=QuantConfig(enable=True))
    lm_red = build_lm(red)
    check(lm_red.embed.use_tt and lm_red.head.use_tt,
          "train ckpt: the reduced config's embedding and head are not TT")
    out["identity"] = _step_card_vs_cpu(
        torch, lm_red, TrainConfig(opt_state_dtype="int8",
                                   grad_compress=True, total_steps=8,
                                   warmup_steps=5),
        lm_batch(0, batch=2, seq=16, vocab=128, seed=0),
        "ckpt embed/head identity")

    # (d) the cost arithmetic
    out["cost"] = {}
    for what, cfg, prof in (("a", a_cfg, out["profile_a"]),
                            ("c", c_cfg, out["profile_c"])):
        c = _ckpt_cost(cfg, prof)
        out["cost"][what] = c
        log(f"train ckpt cost ({what}): {int(c['params']):,} params; model "
            f"FLOPs "
            f"6ND {c['model_flops']:.4e}, TT-chain FLOPs "
            f"{c['chain_flops']:.4e} a step of 8 x 256; the step "
            f"{c['step_ms']:.1f} ms host wall, {c['device_ms']:.1f} ms "
            f"device: 6ND {c['model_share_wall']:.4f} / "
            f"{c['model_share_device']:.4f} of the FP32 peak (67 TFLOP/s) "
            f"over wall / device, the chains {c['chain_share_wall']:.4f} / "
            f"{c['chain_share_device']:.4f}")
    out["seconds"] = time.perf_counter() - t0
    log(f"train ckpt: {out['seconds']:.1f} s")
    check(out["seconds"] < CKPT_SECONDS, f"train ckpt took "
          f"{out['seconds']:.1f} s, over {CKPT_SECONDS:.0f}")
    return out


# ---------------------------------------------------------------------------
# train recurrent: the recurrent LMs' train step through the per-token scans
# ---------------------------------------------------------------------------

# (arch, layers (None: the config's), batch, seq): rwkv6-1.6b at full size
# on 4 x 512 tokens; jamba-1.5-large at full width, cut to one period of
# 3 layers (Mamba, attention with its MoE FFN, Mamba) on 1 x 512: its 8-layer
# period has 4,020,136,881 parameters, and the step holds ~36 bytes a
# parameter at its peak (the new params, moments and wire residual beside
# the old, and every moment decoded to f32 at once: rwkv6's 26.42 GiB at
# 783,921,624), ~135 GiB, over the card's 80 GB. Each 512-token sequence
# is two scan chunks of ``ssm.SCAN_CHUNK`` = 256.
RECURRENT_CELLS = (("rwkv6-1.6b", None, 4, 512),
                   ("jamba-1.5-large", 3, 1, 512))
RECURRENT_PARAMS = {"rwkv6-1.6b": 783_921_624,
                    "jamba-1.5-large": 1_923_017_198}
# the profiled step's (batch, seq): the cell's rows, so the same PE calls
# and launches; rwkv6's at 32 tokens, since a profile of its 4 x 512 step
# (~970,000 device events: the scans launch per token) costs ~50 s of the
# phase on an H100 (stop 16 s, the event list 6 s, freeing it ~10 s)
RECURRENT_PROFILE = {"rwkv6-1.6b": (64, 32), "jamba-1.5-large": (1, 512)}
RECURRENT_SECONDS = 90.0        # the phase's wall, at most
RECURRENT_CHUNK = 4             # (d)'s SCAN_CHUNK: 16 tokens in 4 chunks


def _recurrent_lm(arch: str, layers):
    """``with_tt(arch, quantize=True)``'s model (no weights); where
    ``layers`` is given, one period of that many layers with attention at
    position 1 and the MoE FFN (16 TT experts top-2) at position 1 (jamba's
    cell)."""
    import repro_torch.configs as C
    from repro_torch.models.lm import build_lm
    cfg = C.get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers, period=layers,
                          attn_positions=(1,), moe_positions=(1,))
    return build_lm(C.with_tt(cfg, quantize=True))


def _event_profile(torch, window, names, what: str) -> tuple[dict, float]:
    """``_profile_window`` for a window of ~10^6 device events (a recurrent
    train step: the scans launch a few kernels a token): device activity
    only, counted straight from the profiler's event list
    (``kineto_results.events()``), not through ``key_averages``, whose
    parse of such a window took minutes on the card's host. Returns (the
    named kernels' launches and device ms, the window's device ms without
    the pad spins); a window whose trace kept none of its leading spins is
    profiled again."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(PROFILE_TRIES):
        n = _lead_spins()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _pad_window(torch, n, LEAD_CYCLES)
            window()
            _pad_window(torch, TRAIL_SPINS, TRAIL_CYCLES)
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        events = prof.profiler.kineto_results.events()
        t3 = time.perf_counter()
        calls, ns, spins, total, of = {}, {}, 0, 0, {}
        for e in events:
            if e.device_type() != cuda:
                continue
            key = e.name()
            if key not in of:           # the named kernel a key is, once
                of[key] = ("spin" if "spin_kernel" in key else next(
                    (m for m in names if f"{m}<" in key), None))
            name = of[key]
            if name == "spin":
                spins += 1
                continue
            total += e.duration_ns()
            if name is not None:
                calls[name] = calls.get(name, 0) + 1
                ns[name] = ns.get(name, 0) + e.duration_ns()
        lead = spins - TRAIL_SPINS
        LEAD_LOST[0] = max(LEAD_LOST[0], n - lead)
        log(f"  {what} profile window {attempt + 1}: the trace kept {lead} "
            f"of {n} leading pad spins; {len(events):,} events; window "
            f"{t1 - t0:.1f} s, stop {t2 - t1:.1f} s, event list "
            f"{t3 - t2:.1f} s, count {time.perf_counter() - t3:.1f} s")
        if lead > 0:
            return ({k: {"calls_per_step": float(c),
                         "ms_per_step": ns[k] / 1e6}
                     for k, c in calls.items()}, total / 1e6)
        log(f"  {what} profile window {attempt + 1}: the trace may have "
            "lost the window's first launches; profiling another window")
    check(False, f"{what}: no profile window kept its leading spins")


def _recurrent_pe_calls() -> list:
    """(arch, kind, Z shape, G shape, launches a step) of the recurrent
    cells' PE calls that no earlier phase holds (``lm kernels``' LM calls,
    ``frontend kernels``' granule calls), each once, at the cells' rows."""
    seen = set(_lm_pe_calls()) | {(k, z, g) for _, k, z, g, _ in
                                  _frontend_granule_calls()}
    out = []
    for arch, layers, batch, seq in RECURRENT_CELLS:
        per = _pe_launches_by_shape(_recurrent_lm(arch, layers), batch * seq)
        for call, n in sorted(per.items()):
            if call not in seen:
                seen.add(call)
                out.append((arch, *call, n))
    return out


def _recurrent_pe_rows(torch, timer: Timer) -> dict:
    """The recurrent steps' new bf16 PE1 / PE2 / PE3 calls
    (``_recurrent_pe_calls``) at their shapes: each on the tensor cores
    (``ttm_pe1.plan_pe1`` / ``tt_mma.plan``; asserted) in one launch,
    within ``PE_TOL`` of the plain version, bit for bit over two launches,
    timed beside the plain version, the faster of one bf16
    ``torch.matmul`` / ``torch.einsum`` (a yardstick only) and the bound
    (bytes at 3.35 TB/s or bf16 operations at 989 TFLOP/s), with its
    launches a step."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import tt_mma, ttm_pe1
    gen = torch.Generator(device="cuda").manual_seed(9)
    tol = PE_TOL["bfloat16"]
    rows = {"pe1": [], "pe2": [], "pe3": []}
    for arch, kind, zs, gs, per_step in _recurrent_pe_calls():
        name = f"recurrent {kind} {zs}x{gs} ({arch})"
        kern, plain = _pe_fns(kind)
        z = torch.randn(zs, generator=gen, device="cuda").to(torch.bfloat16)
        g = (torch.randn(gs, generator=gen, device="cuda") * 0.2).to(
            torch.bfloat16)
        p = (ttm_pe1.plan_pe1_for(z, g) if kind == "pe1" else
             tt_mma.plan_for(*_pe_contraction(kind, z, g)))
        check(p is not None, f"{name}: not on the tensor cores")
        B.reset_launches()
        o = kern(z, g)
        check(B.LAUNCHES == {kind: 1}, f"{name}: launches {B.LAUNCHES}")
        r = plain(z, g)
        err = (o.float() - r.float()).abs()
        check(bool((err <= tol + tol * r.float().abs()).all()),
              f"{name}: max err {err.max().item()}")
        check(_bits_equal(torch, kern(z, g), o), f"{name}: two launches "
              "differ")
        row = dict(arch=arch, z=list(zs), g=list(gs), dtype="bfloat16",
                   max_abs_err=err.max().item(), route="tensor cores",
                   launches_per_step=per_step, tile=[p.bm, p.bn],
                   stages=p.stages, grid=p.grid, smem=p.smem)
        del o, err
        row.update(_pe_yardsticks(torch, timer, kind, z, g, r))
        del r
        row["ms"] = timer(lambda: kern(z, g), iters=10)
        row["plain_ms"] = timer(lambda: plain(z, g), iters=3)
        nbytes, flops = _pe_work(kind, zs, gs, 2)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        row["of_bound"] = row["ms"] / row["bound_ms"]
        rows[kind].append(row)
        log(f"{name}: {row['ms']*1e3:.1f} us on the tensor cores, "
            f"{row['of_bound']:.2f}x the bound {row['bound_ms']*1e3:.1f} us "
            f"{row['bound_by']}; {row['library_call']} "
            f"{row['library_ms']*1e3:.1f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us; {per_step} a step; err "
            f"{row['max_abs_err']:.1e}; two launches equal")
        del z, g
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _grad_peaks(torch, into: list):
    """Append to ``into`` the peak allocated bytes at the end of each train
    step's forward and backward (``steps._value_and_grad``), before the
    wire and the optimizer: the part of a step where the scans' states
    live."""
    from repro_torch.launch import steps as S
    inner = S._value_and_grad

    def wrapped(*a, **k):
        out = inner(*a, **k)
        into.append(torch.cuda.max_memory_allocated())
        return out
    S._value_and_grad = wrapped
    try:
        yield
    finally:
        S._value_and_grad = inner


def _recurrent_cell(torch, arch: str, layers, batch: int, seq: int) -> dict:
    """One train step of ``with_tt(arch, quantize=True)`` (int8 moments,
    the int8 wire, ``remat="full"``) on ``lm_batch`` tokens, seeded weights
    on the card: counts zeroed just before and read just after equal
    ``launches_per_step``, the cross-entropy finite, the peak memory read
    after the step and after its forward and backward (``_grad_peaks``).
    rwkv6-1.6b's step runs through ``launch/train.py::train``; jamba's
    through ``make_train_step`` on the state ``train`` would build (its
    final save would write ~15 GB: params, moments and the f32 wire
    residual of 1.9 B parameters). Then one step with ``SCAN_CHUNK`` =
    ``seq`` (one chunk): its host wall and peaks beside the chunked
    step's; and one chunked step at ``RECURRENT_PROFILE``'s batch x seq
    (the same rows), profiled (``_event_profile``): each counted kernel by
    name, no CUDA-core PE body but the f32 router's, the device time."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import build as B
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_batch_fn, train
    from repro_torch.models import ssm
    from repro_torch.models.lm import init_lm
    from repro_torch.obs import TraceRecorder

    lm = _recurrent_lm(arch, layers)
    cfg = lm.cfg
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=1, warmup_steps=1)
    per = S.launches_per_step(lm, tcfg)
    check(cfg.remat == "full" and seq % ssm.SCAN_CHUNK == 0
          and seq > ssm.SCAN_CHUNK, f"train recurrent ({arch}): remat "
          f"{cfg.remat}, {seq} tokens at SCAN_CHUNK {ssm.SCAN_CHUNK}")
    batches = make_batch_fn(cfg, batch, seq, tcfg.seed)

    def to_card(b):
        return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ces, grad_peaks = [], []
    t0 = time.perf_counter()
    if layers is None:
        trace = TraceRecorder()
        B.reset_launches()
        with _ckpt_dir("recurrent") as d, _grad_peaks(torch, grad_peaks):
            state, _ = train(cfg, "tp", dataclasses.replace(
                tcfg, ckpt_dir=d), batch=batch, seq=seq, device="cuda",
                verbose=False, trace=trace,
                on_step=lambda i, m: ces.append(float(m["ce"])))
        torch.cuda.synchronize()
        launches = dict(B.LAUNCHES)
        step_s = trace.events("train_step")[0].fields["dur"]
    else:
        params = init_lm(torch.Generator(device="cuda").manual_seed(
            tcfg.seed), lm, device="cuda")
        state = S.init_train_state(params, tcfg, policy=cfg.quant.policy())
        del params
        b0 = to_card(batches(0))
        torch.cuda.synchronize()
        B.reset_launches()
        t1 = time.perf_counter()
        with _grad_peaks(torch, grad_peaks):
            state, m = S.make_train_step(lm, None, tcfg)(state, b0)
        ces.append(float(m["ce"]))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t1
        launches = dict(B.LAUNCHES)
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    what = f"train recurrent ({arch})"
    check(launches == per, f"{what}: launches {launches}, want {per}")
    check(all(math.isfinite(x) for x in ces), f"{what}: ce {ces}")
    n = sum(t.numel() for t in _leaves(state.params))
    check(n == RECURRENT_PARAMS[arch], f"{what}: {n:,} params")
    step = S.make_train_step(lm, None, tcfg)
    box = {"state": state}
    del state

    def run(b):
        torch.cuda.reset_peak_memory_stats()
        del grad_peaks[1:]
        with _grad_peaks(torch, grad_peaks):
            box["state"], _ = step(box["state"], b)
    b1 = to_card(batches(1))
    chunk = ssm.SCAN_CHUNK
    torch.cuda.synchronize()
    try:
        ssm.SCAN_CHUNK = seq
        t1 = time.perf_counter()
        run(b1)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t1
    finally:
        ssm.SCAN_CHUNK = chunk
    one_peak = torch.cuda.max_memory_allocated()
    check(len(grad_peaks) == 2, f"{what}: {len(grad_peaks)} gradient passes")
    one_grad_peak = grad_peaks[1]
    pb, ps = RECURRENT_PROFILE[arch]
    check(pb * ps == batch * seq, f"{what}: profiled rows {pb} x {ps}")
    b2 = to_card(make_batch_fn(cfg, pb, ps, tcfg.seed)(2))
    names = [f for fns in MOE_FNS.values() for f in fns]
    want = _by_name(per)
    for attempt in range(PROFILE_TRIES):
        kern, device_ms = _event_profile(torch, lambda: run(b2), names, what)
        by_name = {k: sum(kern.get(f, {}).get("calls_per_step", 0.0)
                          for f in fns) for k, fns in MOE_FNS.items()}
        if {k: v for k, v in by_name.items() if v} == want:
            break
        log(f"  {what} profile: launches by name {by_name}, want {want}; "
            "profiling another window")
    else:
        check(False, f"{what}: profile launches {by_name}, want {want}")
    # only the f32 router's chains (jamba's experts) reach the CUDA cores
    fma = {k: int(sum(kern.get(f, {}).get("calls_per_step", 0.0)
                      for f in fns)) for k, fns in MOE_CUDA_CORE.items()}
    check(fma == _f32_site_launches(lm), f"{what}: CUDA-core PE launches "
          f"{fma}, the f32 router's {_f32_site_launches(lm)}")
    del box
    torch.cuda.empty_cache()
    log(f"{what}: {cfg.num_layers} layers, {n:,} params, batch {batch} x "
        f"{seq}, {seq // chunk} scan chunks: ce {ces[0]:.4f}; first step "
        f"{step_s * 1e3:.1f} ms host ({first_s:.1f} s with init"
        f"{' and the final save' if layers is None else ''}), peak "
        f"{peak / 2**30:.2f} GiB (forward and backward "
        f"{grad_peaks[0] / 2**30:.2f}); one chunk (SCAN_CHUNK {seq}): "
        f"{one_s * 1e3:.1f} ms host, peak {one_peak / 2**30:.2f} GiB "
        f"({(one_peak - peak) / 2**30:+.2f}; forward and backward "
        f"{one_grad_peak / 2**30:.2f}, "
        f"{(one_grad_peak - grad_peaks[0]) / 2**30:+.2f}); profiled at "
        f"{pb} x {ps}: {device_ms:.1f} ms device, launches {per} by counter "
        "and by name "
        f"({ {f: round(r['calls_per_step']) for f, r in kern.items()} })")
    return {"params": n, "layers": cfg.num_layers, "batch": batch,
            "seq": seq, "chunks": seq // chunk, "ce": ces,
            "launches": launches, "launches_per_step": per,
            "step_ms": step_s * 1e3, "peak_bytes": peak,
            "grad_peak_bytes": grad_peaks[0],
            "one_chunk_step_ms": one_s * 1e3,
            "one_chunk_peak_bytes": one_peak,
            "one_chunk_grad_peak_bytes": one_grad_peak,
            "profiled": [pb, ps], "device_ms": device_ms, "profile": kern,
            "entry": "train" if layers is None else "make_train_step"}


def phase_train_recurrent(torch) -> dict:
    """The recurrent LMs' low-precision train step through the per-token
    scans and their ``SCAN_CHUNK`` remat (``_recurrent_cell``): (a)
    with_tt(rwkv6-1.6b, quantize=True) at full size (24 layers, TT on the
    channel mix) on 4 x 512 tokens; (b) with_tt(jamba-1.5-large,
    quantize=True) at full width, one period of 3 layers (Mamba, attention
    with the MoE FFN of 16 TT experts top-2, Mamba), on 1 x 512; (c) every
    ungrouped PE call of their steps that no earlier phase holds
    (``_recurrent_pe_rows``; the experts' grouped calls are train moe's
    rows); (d) at a reduced width (TT on the default sites and the
    experts, d = 3, rank 4, f32, int8 moments and the wire, ``SCAN_CHUNK``
    4 so the 16 tokens run 4 chunks) one step of each on the card against
    the same step on the CPU (``_step_card_vs_cpu``)."""
    import repro_torch.configs as C
    from repro_torch.configs.base import QuantConfig, TrainConfig, TTConfig
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import ssm
    from repro_torch.models.lm import build_lm
    t0 = time.perf_counter()
    out = {"parts_s": {}}

    def part(name):
        out["parts_s"][name] = time.perf_counter() - t0 - sum(
            out["parts_s"].values())
    for arch, layers, batch, seq in RECURRENT_CELLS:
        out[arch] = _recurrent_cell(torch, arch, layers, batch, seq)
        part(arch)
    out["kernels"] = _recurrent_pe_rows(torch, Timer(torch))
    part("kernels")
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=8, warmup_steps=5)
    chunk = ssm.SCAN_CHUNK
    try:
        ssm.SCAN_CHUNK = RECURRENT_CHUNK
        for arch, layers, _, _ in RECURRENT_CELLS:
            cfg = C.get_reduced(arch).replace(
                dtype="float32", quant=QuantConfig(enable=True),
                tt=TTConfig(enable=True, d=3, max_rank=4, min_elements=1024,
                            apply_to=("ffn", "attn_qkv", "attn_o",
                                      "expert")))
            out[f"{arch} identity"] = _step_card_vs_cpu(
                torch, build_lm(cfg), tcfg, make_batch_fn(cfg, 2, 16, 0)(0),
                f"recurrent identity ({arch})")
    finally:
        ssm.SCAN_CHUNK = chunk
    part("identity")
    out["seconds"] = time.perf_counter() - t0
    log(f"train recurrent: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in out["parts_s"].items()) + ")")
    check(out["seconds"] < RECURRENT_SECONDS, f"train recurrent took "
          f"{out['seconds']:.1f} s, over {RECURRENT_SECONDS:.0f}")
    return out


# ---------------------------------------------------------------------------
# train moe: the MoE LMs' low-precision train step, TT experts grouped
# ---------------------------------------------------------------------------

# (arch, layers (None: the config's), batch, seq): with_tt(moonshot-v1-16b)
# uncut on 8 x 256 tokens; with_tt(deepseek-v2-236b) at full width, 2 of
# its 60 layers (60 need ~3 B parameters, ~105 GB in a step), on 2 x 256
MOE_TRAIN_CELLS = (("moonshot-v1-16b", None, 8, 256),
                   ("deepseek-v2-236b", 2, 2, 256))
MOE_TRAIN_PARAMS = {"moonshot-v1-16b": 1_145_122_368,
                    "deepseek-v2-236b": 1_104_183_292}
MOE_TRAIN_SECONDS = 260.0       # the phase's wall, at most
# launch-count name -> the kernel functions that count as it in a profile
# (a grouped launch is the same function: "pe1" counts pe1 + pe1_grouped)
MOE_FNS = {"pe1": ("pe1_kernel", "pe1_mma_kernel"),
           "pe2": ("pe2_kernel", "pe2_mma_kernel", "pe2_tile_kernel"),
           "pe3": ("pe3_kernel", "pe3_mma_kernel", "pe3_tile_kernel"),
           "p2_fake_quant": ("p2_fq_group_kernel",),
           "p2_fq_rows": ("p2_fq_rows_kernel",),
           "bw_enc": ("bw_enc_group_kernel",),
           "bw_dec": ("bw_dec_group_kernel",)}
# the CUDA-core PE bodies: in a bf16 MoE step only the f32 router's chains
# reach them
MOE_CUDA_CORE = {"pe1": ("pe1_kernel",),
                 "pe2": ("pe2_kernel", "pe2_tile_kernel"),
                 "pe3": ("pe3_kernel", "pe3_tile_kernel")}
PE_GROUPED_EINSUM = {"pe1": "eabc,ebdc->ead", "pe2": "eabc,ebd->eadc",
                     "pe3": "ebj,ebi->eji"}


def _moe_lm(arch: str, layers):
    """``with_tt(arch, quantize=True)``'s model (no weights), cut to
    ``layers`` layers where given."""
    import repro_torch.configs as C
    from repro_torch.models.lm import build_lm
    cfg = C.get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    return build_lm(C.with_tt(cfg, quantize=True))


def _by_name(per: dict) -> dict:
    """A step's launches by profile name group (``MOE_FNS``): a grouped
    launch runs the same kernel function as an ungrouped one."""
    out = {k: per.get(k, 0) + per.get(f"{k}_grouped", 0) for k in MOE_FNS}
    return {k: float(v) for k, v in out.items() if v}


def _f32_site_launches(lm) -> dict:
    """PE launches a step of the TT sites a bf16 model runs in f32: the
    MoE router (``moe._route`` applies it to ``x2d.float()``), whose
    chains take the CUDA-core routes (f32 has no tensor-core plan)."""
    from repro_torch.models.lm import _walk_sites
    fwd = 2 if lm.cfg.remat == "full" else 1
    out = {"pe1": 0, "pe2": 0, "pe3": 0}
    for path, site in _walk_sites(lm):
        if site.use_tt and path[-1] == "router":
            n, d = lm.n_periods, site.spec.d
            out["pe1"] += n * (fwd + 1)
            out["pe2"] += n * (fwd + 1) * (d - 1)
            out["pe3"] += n
    return out


def _moe_cell(torch, arch: str, layers, batch: int, seq: int) -> dict:
    """One MoE train step of ``with_tt(arch, quantize=True)`` (int8
    moments, the int8 wire, ``remat="full"``) on seeded weights on the
    card: the counts zeroed just before and read just after equal
    ``launches_per_step`` (grouped and not), the cross-entropy finite, the
    parameters counted, the peak memory read. moonshot trains 2 steps
    through ``launch/train.py::train`` (its final save into a temporary
    directory), then one step profiled: each counted kernel by name, the
    CUDA-core PE launches exactly the f32 router's, the device time and
    the busy share against the second step's host wall; deepseek one step
    through ``make_train_step``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import build as B
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import make_batch_fn, train
    from repro_torch.models.lm import init_lm
    from repro_torch.obs import TraceRecorder

    lm = _moe_lm(arch, layers)
    cfg = lm.cfg
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=2, warmup_steps=1)
    per = S.launches_per_step(lm, tcfg)
    what = f"train moe ({arch})"
    check(cfg.remat == "full" and per.get("pe1_grouped", 0) > 0,
          f"{what}: remat {cfg.remat}, launches {per}")
    batches = make_batch_fn(cfg, batch, seq, tcfg.seed)

    def to_card(b):
        return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ces = []
    t0 = time.perf_counter()
    if layers is None:
        steps, trace = 2, TraceRecorder()
        B.reset_launches()
        with _ckpt_dir("moe") as d:
            state, _ = train(cfg, "tp", dataclasses.replace(
                tcfg, ckpt_dir=d), batch=batch, seq=seq, device="cuda",
                verbose=False, trace=trace,
                on_step=lambda i, m: ces.append(float(m["ce"])))
        torch.cuda.synchronize()
        launches = dict(B.LAUNCHES)
        step_s = [e.fields["dur"] for e in trace.events("train_step")]
    else:
        steps = 1
        params = init_lm(torch.Generator(device="cuda").manual_seed(
            tcfg.seed), lm, device="cuda")
        state = S.init_train_state(params, tcfg, policy=cfg.quant.policy())
        del params
        b0 = to_card(batches(0))
        torch.cuda.synchronize()
        B.reset_launches()
        t1 = time.perf_counter()
        state, m = S.make_train_step(lm, None, tcfg)(state, b0)
        ces.append(float(m["ce"]))
        torch.cuda.synchronize()
        step_s = [time.perf_counter() - t1]
        launches = dict(B.LAUNCHES)
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * steps for k, v in per.items()}
    check(launches == want, f"{what}: launches {launches}, want {want}")
    check(len(ces) == steps and all(math.isfinite(x) for x in ces),
          f"{what}: ce {ces}")
    n = sum(t.numel() for t in _leaves(state.params))
    check(n == MOE_TRAIN_PARAMS[arch], f"{what}: {n:,} params")
    out = {"params": n, "layers": cfg.num_layers, "batch": batch,
           "seq": seq, "ce": ces, "launches": launches,
           "launches_per_step": per, "step_ms": [s * 1e3 for s in step_s],
           "peak_bytes": peak, "first_s": first_s,
           "entry": "train" if layers is None else "make_train_step"}
    if layers is None:
        step = S.make_train_step(lm, None, tcfg)
        box = {"state": state}
        del state
        b2 = to_card(batches(2))

        def run():
            box["state"], _ = step(box["state"], b2)
        names = [f for fns in MOE_FNS.values() for f in fns]
        want_names = _by_name(per)
        for attempt in range(PROFILE_TRIES):
            kern, device_ms = _event_profile(torch, run, names, what)
            by_name = {k: sum(kern.get(f, {}).get("calls_per_step", 0.0)
                              for f in fns) for k, fns in MOE_FNS.items()}
            if {k: v for k, v in by_name.items() if v} == want_names:
                break
            log(f"  {what} profile: launches by name {by_name}, want "
                f"{want_names}; profiling another window")
        else:
            check(False, f"{what}: profile launches {by_name}, want "
                  f"{want_names}")
        fma = {k: int(sum(kern.get(f, {}).get("calls_per_step", 0.0)
                          for f in fns)) for k, fns in MOE_CUDA_CORE.items()}
        check(fma == _f32_site_launches(lm), f"{what}: CUDA-core PE "
              f"launches {fma}, the f32 router's {_f32_site_launches(lm)}")
        del box
        out.update(device_ms=device_ms, profile=kern, cuda_core=fma,
                   busy=device_ms / (step_s[-1] * 1e3))
        log(f"{what}: {cfg.num_layers} layers, {n:,} params, batch "
            f"{batch} x {seq}: ce {ces}; steps "
            f"{', '.join(f'{s * 1e3:.1f}' for s in step_s)} ms host "
            f"({first_s:.1f} s with init and the final save), peak "
            f"{peak / 2**30:.2f} GiB; profiled step {device_ms:.1f} ms "
            f"device, busy {out['busy']:.3f} of the second step; launches "
            f"{per} a step by counter and by name "
            f"({ {f: round(r['calls_per_step']) for f, r in kern.items()} })"
            f"; CUDA-core PE launches {fma} (the f32 router's)")
    else:
        del state
        log(f"{what}: {cfg.num_layers} layers, {n:,} params, batch {batch} "
            f"x {seq}: ce {ces[0]:.4f}; step {step_s[0] * 1e3:.1f} ms host "
            f"({first_s:.1f} s with init), peak {peak / 2**30:.2f} GiB; "
            f"launches {per} by counter")
    torch.cuda.empty_cache()
    return out


def _grouped_launches_by_shape(lm, rows: int) -> dict:
    """Launches a step of each distinct grouped PE call ``(kind, Z shape,
    G shape)`` of ``lm``'s TT expert sites at ``rows`` tokens: each site's
    forward chain over the E experts at the capacity's C rows (twice under
    remat), its transposed chain, and one PE3 a Ŵ window (``("pe3", Ybar
    (E', C, J), X (E', C, I))``)."""
    from repro_torch.core.ttm import pe_shapes, what_windows
    from repro_torch.models import moe as M
    from repro_torch.models.lm import _walk_sites
    fwd = 2 if lm.cfg.remat == "full" else 1
    d = next(s.ffn for s in lm.period if s.ffn_kind == "moe")
    e, cap = d.num_experts, M._capacity(rows, d)
    out: dict = {}
    for path, site in _walk_sites(lm):
        if not site.use_tt or site.family != "expert":
            continue
        n, s = lm.n_periods, site.spec
        calls = [(c, n * fwd) for c in pe_shapes(s, cap, groups=e)] + [
            (c, n) for c in pe_shapes(s.transposed(), cap, groups=e)] + [
            (("pe3", (e1 - e0, cap, s.out_dim), (e1 - e0, cap, s.in_dim)), n)
            for e0, e1 in what_windows(s, e)]
        for c, k in calls:
            out[c] = out.get(c, 0) + k
    return out


def _grouped_pe_calls() -> list:
    """(arch, kind, Z shape, G shape, launches a step) of every grouped PE
    call of train moe's cells and train recurrent's jamba period, each
    once."""
    seen, out = set(), []
    cells = [(a, lay, b * s, _moe_lm(a, lay)) for a, lay, b, s in
             MOE_TRAIN_CELLS] + [(a, lay, b * s, _recurrent_lm(a, lay))
                                 for a, lay, b, s in RECURRENT_CELLS
                                 if a.startswith("jamba")]
    for arch, _, rows, lm in cells:
        for call, n in sorted(_grouped_launches_by_shape(lm, rows).items()):
            if call not in seen:
                seen.add(call)
                out.append((arch, *call, n))
    return out


def _grouped_library(torch, kind, z, g):
    """Yardstick only: one bf16 batched matmul computing a grouped call
    (``torch.bmm``; PE2 a broadcast ``torch.matmul``)."""
    if kind == "pe1":                     # (E, a, 1, c) x (E, 1, d, c)
        return torch.bmm(z[:, :, 0], g[:, 0].transpose(1, 2))
    if kind == "pe2":                     # (E, b, d)^T @ (E, a, b, c)
        return torch.matmul(g.transpose(1, 2)[:, None], z)
    return torch.bmm(z.transpose(1, 2), g)    # PE3: Ybar^T X a group


def _moe_grouped_rows(torch, timer: Timer) -> dict:
    """Every grouped PE1 / PE2 / PE3 call of the MoE steps
    (``_grouped_pe_calls``) at its shapes: on the tensor cores (asserted),
    one launch, within ``PE_TOL`` of the plain version, bit for bit over
    two launches and with the loop of ungrouped launches over the experts
    (each tile one warpgroup's sum in a fixed order); timed beside that
    loop (``previous_ms``, the design a grouped launch replaces), the
    faster of one bf16 batched matmul and ``torch.einsum``
    (``library_ms``), the plain version and the bound (bytes at 3.35 TB/s
    or bf16 operations at 989 TFLOP/s)."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import tt_mma, ttm_pe1
    gen = torch.Generator(device="cuda").manual_seed(11)
    tol = PE_TOL["bfloat16"]
    rows = {"pe1": [], "pe2": [], "pe3": []}
    for arch, kind, zs, gs, per_step in _grouped_pe_calls():
        name = f"grouped {kind} {zs}x{gs} ({arch})"
        kern, plain = _pe_fns(kind)
        z = torch.randn(zs, generator=gen, device="cuda").to(torch.bfloat16)
        g = (torch.randn(gs, generator=gen, device="cuda") * 0.2).to(
            torch.bfloat16)
        e = zs[0]
        p = (ttm_pe1.plan_pe1_for(z, g) if kind == "pe1" else
             tt_mma.plan_for(z, g) if kind == "pe2" else
             tt_mma.plan_for(g[:, None], z))
        check(p is not None, f"{name}: not on the tensor cores")
        B.reset_launches()
        o = kern(z, g)
        check(B.LAUNCHES == {f"{kind}_grouped": 1},
              f"{name}: launches {B.LAUNCHES}")
        r = plain(z, g)
        err = (o.float() - r.float()).abs()
        check(bool((err <= tol + tol * r.float().abs()).all()),
              f"{name}: max err {err.max().item()}")
        del err
        check(_bits_equal(torch, kern(z, g), o), f"{name}: two launches "
              "differ")

        def loop():
            return [kern(z[k], g[k]) for k in range(e)]
        check(_bits_equal(torch, torch.stack(loop()), o),
              f"{name}: the loop of ungrouped launches differs")
        row = dict(arch=arch, z=list(zs), g=list(gs), dtype="bfloat16",
                   groups=e, max_abs_err=(o.float() - r.float()).abs().max(
                   ).item(), route="tensor cores", launches_per_step=per_step,
                   tile=[p.bm, p.bn], stages=p.stages, grid=[p.grid, e],
                   smem=p.smem)
        del o
        times = {}
        for lib, fn in (("torch.bmm" if kind != "pe2" else "torch.matmul",
                         lambda: _grouped_library(torch, kind, z, g)),
                        (f'torch.einsum("{PE_GROUPED_EINSUM[kind]}")',
                         lambda: torch.einsum(PE_GROUPED_EINSUM[kind], z,
                                              g))):
            check((fn().float() - r.float()).abs().max().item() <= tol * (
                1 + r.float().abs().max().item()), f"{name}: {lib} differs")
            times[lib] = timer(fn, iters=5)
        del r
        row["library_call"] = min(times, key=times.get)
        row["library_ms"] = times[row["library_call"]]
        row["ms"] = timer(lambda: kern(z, g), iters=10)
        row["previous_ms"] = timer(loop, iters=5)
        row["plain_ms"] = timer(lambda: plain(z, g), iters=3)
        nbytes, flops = _pe_work(kind, zs[1:], gs[1:], 2)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes * e, flops * e)
        row["of_bound"] = row["ms"] / row["bound_ms"]
        rows[kind].append(row)
        log(f"{name}: {row['ms']*1e3:.1f} us in one launch on the tensor "
            f"cores, {row['of_bound']:.2f}x the bound "
            f"{row['bound_ms']*1e3:.1f} us {row['bound_by']}; the loop of "
            f"{e} launches {row['previous_ms']*1e3:.1f} us, "
            f"{row['library_call']} {row['library_ms']*1e3:.1f} us, plain "
            f"{row['plain_ms']*1e3:.1f} us; {per_step} a step; err "
            f"{row['max_abs_err']:.1e}; two launches and the loop equal")
        del z, g
        torch.cuda.empty_cache()
    return rows


def _moe_fq_rows(torch, timer: Timer) -> list:
    """``p2_fq_rows`` at the stacked cores of moonshot's gate site (64
    experts, a step each, bf16): the kernel against its plain version (bit
    for bit), ``fake_quantize_per_channel_affine`` and the bound."""
    from repro_torch.numerics import cuda_backend as CB
    lm = _moe_lm(MOE_TRAIN_CELLS[0][0], 1)
    spec = lm.period[0].ffn.gate.spec
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = []
    for shape in spec.core_shapes:
        x = (torch.randn((64,) + shape, generator=gen, device="cuda")
             * 0.05).to(torch.bfloat16)
        s = torch.full((64,), -6.0, device="cuda")
        x2d, srow = CB._rowwise(x, s)
        y = CB.fake_quant_rows(x, s, 4)
        check(_bits_equal(torch, y.reshape(x2d.shape),
                          CB.fake_quant_rows_plain(x2d, srow, 4)),
              f"p2_fq_rows {tuple(x.shape)}: differs from its twin")
        n = x.numel()
        row = dict(shape=list(x.shape), scales=[64], bits=4,
                   dtype="bfloat16", what="moonshot's stacked gate cores",
                   max_abs_err=0,
                   ms=timer(lambda: CB.fake_quant_rows(x, s, 4)),
                   plain_ms=timer(lambda: CB.fake_quant_rows_plain(
                       x2d, srow, 4), iters=10))
        row["library_ms"], row["library_note"] = _library_yardstick(
            timer, lambda: _library_fq_rows(torch, x2d.float(), srow, 4),
            lambda r: torch.equal(r.to(torch.bfloat16), y.reshape(r.shape)))
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * n * x.element_size() + srow.numel() * 4, 4 * n, fp32=True)
        out.append(row)
        log(f"p2_fq_rows {tuple(x.shape)} 4-bit bf16 (moonshot's gate "
            f"core): {row['ms']*1e3:.1f} us (plain "
            f"{row['plain_ms']*1e3:.1f} us, library "
            f"{row['library_note']}, bound {row['bound_ms']*1e3:.3f} us)")
    return out


def phase_train_moe(torch) -> dict:
    """The MoE LMs' low-precision train step with TT experts, each expert
    site's PE1 / PE2 / PE3 one grouped launch for all experts and its
    cores' fake-quant one ``p2_fq_rows`` launch a core (``_moe_cell``):
    (a) with_tt(moonshot-v1-16b, quantize=True) uncut (48 layers, 64
    experts top-6) on 8 x 256 tokens through ``train``; (b)
    with_tt(deepseek-v2-236b, quantize=True) at full width, 2 of 60
    layers (MLA, 160 experts top-6 and 2 shared), on 2 x 256 through
    ``make_train_step``: MLA's first backward on the card; (e) every
    grouped call of (a), (b) and train recurrent's jamba period
    (``_moe_grouped_rows``) and ``p2_fq_rows`` at moonshot's stacked
    cores; (d) at a reduced width (TT experts, d = 3, rank 4, f32, int8
    moments and the wire) one step of moonshot and of deepseek on the card
    against the same step on the CPU (``_step_card_vs_cpu``)."""
    import repro_torch.configs as C
    from repro_torch.configs.base import QuantConfig, TrainConfig, TTConfig
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.lm import build_lm
    t0 = time.perf_counter()
    out = {"parts_s": {}}

    def part(name):
        out["parts_s"][name] = time.perf_counter() - t0 - sum(
            out["parts_s"].values())
    for arch, layers, batch, seq in MOE_TRAIN_CELLS:
        out[arch] = _moe_cell(torch, arch, layers, batch, seq)
        part(arch)
    timer = Timer(torch)
    out["kernels"] = _moe_grouped_rows(torch, timer)
    out["fq_rows"] = _moe_fq_rows(torch, timer)
    del timer
    part("kernels")
    tcfg = TrainConfig(opt_state_dtype="int8", grad_compress=True,
                       total_steps=8, warmup_steps=5)
    for arch, _, _, _ in MOE_TRAIN_CELLS:
        cfg = C.get_reduced(arch).replace(
            dtype="float32", quant=QuantConfig(enable=True),
            tt=TTConfig(enable=True, d=3, max_rank=4, min_elements=1024,
                        apply_to=("ffn", "attn_qkv", "attn_o", "expert")))
        out[f"{arch} identity"] = _step_card_vs_cpu(
            torch, build_lm(cfg), tcfg, make_batch_fn(cfg, 2, 16, 0)(0),
            f"moe identity ({arch})")
    part("identity")
    out["seconds"] = time.perf_counter() - t0
    log(f"train moe: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in out["parts_s"].items()) + ")")
    check(out["seconds"] < MOE_TRAIN_SECONDS, f"train moe took "
          f"{out['seconds']:.1f} s, over {MOE_TRAIN_SECONDS:.0f}")
    return out


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
# the f32 tile route of PE2 / PE3 (LM100M's step: every launch of each)
TILE_KERNELS = {
    "pe2_tile": ("src/repro_torch/kernels/csrc/ttm_pe2.cu",
                 "src/repro/kernels/ttm_pe2.py:25", "pe2"),
    "pe3_tile": ("src/repro_torch/kernels/csrc/ttm_pe3.cu",
                 "src/repro/kernels/ttm_pe3.py:23", "pe3"),
}
CKPT_TILE = ("pe2", "pe3")
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
ST_DEC_SLOT = ("src/repro_torch/kernels/csrc/state_codec.cu",
               "src/repro/numerics/pallas_backend.py:127")
ST_ENC_SLOT = ("src/repro_torch/kernels/csrc/state_codec.cu",
               "src/repro/numerics/pallas_backend.py:120")
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
                 rwkv: dict, hybrid: dict, sgroup: dict, moe: dict,
                 mla: dict, frontend: dict, ckpt: dict,
                 fkern: dict, recurrent: dict, tmoe: dict) -> dict:
    rows = []
    # the MoE train steps (train moe's cells and train recurrent's jamba
    # period with its experts): their launches by counter
    moe_cells = [(a.split("-")[0], tmoe[a]["launches"])
                 for a, *_ in MOE_TRAIN_CELLS] + [
        (a.split("-")[0], recurrent[a]["launches"])
        for a, *_ in RECURRENT_CELLS if a.startswith("jamba")]

    def moe_path(name):
        got = [lc.get(name, 0) for _, lc in moe_cells]
        return sum(got), "train moe (" + ", ".join(
            f"{n} {g}" for (n, _), g in zip(moe_cells, got)) + ")"
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
        # the MoE path's launches and its g = 1 shapes (the same five)
        got = [moe[r]["launches"].get(row["name"], 0)
               for r in ("whole", "chunked")]
        row["moe_launches"] = sum(got)
        row["path"] += (f"; serve moe (whole-prompt run {got[0]}, chunked "
                        f"run {got[1]})")
        row["shapes"] = row["shapes"] + moe["kernels"][row["name"]]
        # the MLA path's launches and its latent-pair shapes (the paged
        # write, prefill write and read; no attention launch there)
        if row["name"] in mla["kernels"]:
            got = [mla[r]["launches"].get(row["name"], 0)
                   for r in ("whole", "chunked")]
            row["mla_launches"] = sum(got)
            row["path"] += (f"; serve mla (whole-prompt run {got[0]}, "
                            f"chunked run {got[1]})")
            row["shapes"] = row["shapes"] + mla["kernels"][row["name"]]
    # the state path's codec launches (the int8 rwkv6 run for the group
    # kernels and the prefill's row encode, the chunked run for the scalar
    # ones), its shapes first
    api = skern["api_launches"]
    for name, src, run in (("st_dec_group", ST_DEC, "int8"),
                           ("st_enc_group", ST_ENC, "int8"),
                           ("st_dec_slot", ST_DEC_SLOT, "chunked"),
                           ("st_enc_slot", ST_ENC_SLOT, "chunked")):
        rows.append(_kernel_row(
            name, *src, sgroup[name], rwkv[run]["launches"].get(name, 0),
            _state_path(name, rwkv, hybrid, api)))
    # no serving path runs the row and scalar codecs on the state pool
    # since the grouped launches: their launches are the replays' per-layer
    # routes', the previous design run on the same engine
    replay = rwkv["replay"]["per_layer_launches"]
    chunk_replay = rwkv["chunk_replay"]["per_layer_launches"]
    for name, src in (("p2_enc_rows", ENC_ROWS), ("p2_dec_rows", DEC_ROWS)):
        launches = replay.get(name, 0) + chunk_replay.get(name, 0)
        path = ("no serving path (the decode step, the chunk step and the "
                "prefill read and write through st_*_group / st_*_slot); "
                f"the replays' per-layer routes {launches}; "
                + _state_path(name, rwkv, hybrid, api))
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
    cells = [(a.split("-")[0], frontend[a]) for a, *_ in FRONTEND_CELLS]
    for row in rows:
        # the frontends' step launches (PE1-3 on either route)
        got = [c["launches"].get(row["name"], 0) for _, c in cells]
        if any(got):
            row["frontend_launches"] = sum(got)
            row["path"] += "; train frontend (" + ", ".join(
                f"{n} {g}" for (n, _), g in zip(cells, got)) + " a step)"
        # the LM step's launches (its PE launches are the tensor-core rows
        # below)
        name = row["name"]
        if name in lm["launches"] and name not in ("pe1", "pe2", "pe3"):
            row["lm_launches"] = lm["launches"][name]
            row["path"] += (f"; train lm ({lm['steps']} steps, "
                            f"{lm['launches_per_step'][name]} a step)")
        # the recurrent LMs' step launches (their PE launches are the
        # tensor-core rows below)
        got = [recurrent[a]["launches"].get(name, 0)
               for a, *_ in RECURRENT_CELLS]
        if any(got) and name not in ("pe1", "pe2", "pe3"):
            row["recurrent_launches"] = sum(got)
            row["path"] += "; train recurrent (" + ", ".join(
                f"{a.split('-')[0]} {g}" for (a, *_), g in
                zip(RECURRENT_CELLS, got)) + " a step)"
        # the MoE steps' ungrouped launches (the router, attention and
        # shared sites' chains, the core and grad-edge groups, the wire)
        if name in ("pe1", "pe2", "pe3", "p2_fake_quant", "bw_enc",
                    "bw_dec"):
            n, path = moe_path(name)
            if n:
                row["moe_launches"] = n
                row["path"] += "; " + path
        if name == "p2_fake_quant":
            row["shapes"] = row["shapes"] + lm["fq_rows"]
        if name == "bw_enc":
            row["shapes"] = row["shapes"] + lm["bw_rows"]
        # LM100M's f32 step (train ckpt): PE1-3 on the CUDA cores, the
        # embedding's and head's core groups, the wire
        got = [ckpt["launches"].get(name, 0), ckpt["eh"]["launches"].get(
            name, 0)]
        if any(got) and name not in CKPT_TILE:   # those: the tile rows
            row["ckpt_launches"] = sum(got)
            row["path"] += (f"; train ckpt (lm100m {got[0]} in "
                            f"{CKPT_STEPS} steps, with TT embedding and head "
                            f"{got[1]} in 2)")
            row["shapes"] = row["shapes"] + {
                "p2_fake_quant": ckpt["fq_rows"],
                "bw_enc": ckpt["bw_enc_rows"],
                "bw_dec": ckpt["bw_dec_rows"]}.get(
                    name, ckpt["pe_rows"].get(name, []))
    for name, (src, replaces, kind) in LM_KERNELS.items():
        rows.append(_kernel_row(
            name, src, replaces, lmkern[kind], lm["launches"].get(kind, 0),
            f"train lm ({lm['steps']} steps, "
            f"{lm['launches_per_step'][kind]} a step: every {kind} launch of "
            "the LM step, by route and by profile name)"))
        # the frontends' calls on granules (frontend kernels), their
        # launches a step among the train frontend cells'
        if fkern.get(kind):
            rows[-1]["shapes"] = rows[-1]["shapes"] + fkern[kind]
            rows[-1]["path"] += (
                f"; train frontend ({len(fkern[kind])} {kind} calls on "
                "granules, " + ", ".join(
                    f"{r['arch'].split('-')[0]} {tuple(r['z'])} "
                    f"{r['launches_per_step']}" for r in fkern[kind])
                + " a step)")
        # the recurrent steps' launches (every PE launch of theirs on the
        # tensor cores, by profile name) and their new calls
        got = [recurrent[a]["launches"].get(kind, 0)
               for a, *_ in RECURRENT_CELLS]
        rows[-1]["recurrent_launches"] = sum(got)
        rows[-1]["shapes"] = rows[-1]["shapes"] + recurrent["kernels"][kind]
        rows[-1]["path"] += "; train recurrent (" + ", ".join(
            f"{a.split('-')[0]} {g}" for (a, *_), g in
            zip(RECURRENT_CELLS, got)) + (
            f" a step; {len(recurrent['kernels'][kind])} new {kind} calls)")
    # the grouped launches: every expert site's PE1 / PE2 / PE3, one launch
    # for all experts, on the tensor-core bodies (by profile name the same
    # functions as the rows above)
    for name, (src, replaces, kind) in LM_KERNELS.items():
        n, path = moe_path(f"{kind}_grouped")
        rows.append(_kernel_row(
            f"{kind}_grouped", src, replaces, tmoe["kernels"][kind], n,
            f"{path}: every {kind}_grouped launch of the steps, by counter; "
            f"{len(tmoe['kernels'][kind])} grouped {kind} calls"))
    for name, (src, replaces, kind) in TILE_KERNELS.items():
        got = [ckpt["launches"].get(kind, 0),
               ckpt["eh"]["launches"].get(kind, 0)]
        rows.append(_kernel_row(
            name, src, replaces, ckpt["pe_rows"][kind], sum(got),
            f"train ckpt (lm100m {got[0]} in {CKPT_STEPS} steps, "
            f"{ckpt['launches_per_step'][kind]} a step; with TT embedding "
            f"and head {got[1]} in 2: every {kind} launch of LM100M's f32 "
            "step, by route and by profile name)"))
    for name, (src, replaces) in SCALAR_KERNELS.items():
        if name == "p2_fq_rows":
            n, path = moe_path(name)
            rows.append(_kernel_row(
                name, src, replaces, tmoe["fq_rows"] + skern[name], n,
                f"{path}: the stacked expert cores, one launch a core and a "
                f"step an expert; codec API {api.get(name, 0)}"))
            continue
        launches = chunk_replay.get(name, 0)
        rows.append(_kernel_row(
            name, src, replaces, state[name] + skern[name], launches,
            "no serving path (the chunk step reads and writes through "
            "st_dec_slot / st_enc_slot); the chunked replay's per-layer "
            f"route {launches}; " + _state_path(name, rwkv, hybrid, api)))
        rows[-1]["api_launches"] = api.get(name, 0)
    return {"kernels": rows}


def phase_tokens(torch, path: str) -> None:
    """The greedy tokens of the serving runs at full width (engine fused
    and gather, chunked prefix; the int8 rwkv6-1.6b and jamba runs of
    ``_recurrent_cells``, whole-prompt and chunked (128)), written to
    ``path``."""
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
        for run, extra in ((name, {}),
                           (f"{name}_chunked", {"prefill_chunk": CHUNK})):
            _, out[run] = _serve_engine(torch, lm, params, reqs(lm), 64,
                                        **kw, **extra)
            log(f"tokens {run}: {len(out[run])} completions")
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
    jamba decode steps' (``_recurrent_cells``; 6 steps), chunk steps' (128
    tokens at 256) and whole-prompt prefills' (512 tokens; a window of
    128), each with the state kernels' launches and peak memory, written
    to ``path``; nothing asserted, so a parent tree's port can be measured
    beside this one in one call."""
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
        # a recurrent scan issues a launch a token a layer: one step a
        # profiled window, 128 tokens of the prefill's
        out[f"{name}_chunk"] = _profile_chunk(
            torch, lm, params, reqs(lm), reps=3, window_reps=1,
            names=STATE_FNS, what=f"{name} chunk step", cpu=False)
        out[f"{name}_prefill"] = _profile_prefill(
            torch, lm, params, reqs(lm), reps=3, window_reps=1,
            names=STATE_FNS, what=f"{name} prefill", cpu=False,
            window_tokens=128)
        del params
        torch.cuda.empty_cache()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out))


def _pe_diff(torch, o, first, ref) -> dict:
    """Where ``o`` and ``first`` differ bit for bit: how many elements,
    the (a, d, c) they touch (at most 8 of each), each launch's largest
    error there against the plain version, and the two outputs' addresses
    mod 1024."""
    diff = o.view(torch.int16) != first.view(torch.int16)
    at = diff.nonzero()
    return {"elements": int(diff.sum()),
            "a": sorted(set(at[:, 0].tolist()))[:8],
            "d": sorted(set(at[:, 1].tolist()))[:8],
            "c": sorted(set(at[:, -1].tolist()))[:8],
            "err": float((o.float() - ref.float())[diff].abs().max()),
            "first_err": float((first.float() - ref.float())[diff]
                               .abs().max()),
            "ptr_mod_1024": [o.data_ptr() % 1024, first.data_ptr() % 1024]}


def phase_pe_repeat(torch, reps: int) -> dict:
    """ROADMAP queue 3's open fault, "lm pe2 (16384, 256, 16)x(256, 256):
    two launches differ" (``phase_lm_kernels``), replayed: every PE1, PE2
    and PE3 call of the LM step and the frontends' ten granule calls
    (``_frontend_granule_calls``), on the same seeded inputs in the same
    order, runs ``reps`` times the check's own sequence: the kernel into a
    fresh allocation, the plain twin, the cuBLAS yardstick, the plan, and
    the kernel again into another fresh allocation while the first output
    is alive. A second launch that differs from the first, or a round's
    first launch that differs from round 0's, is logged with its
    elements, a / d / c, each launch's error against the plain twin and
    the outputs' addresses mod 1024. Each PE2 call also launches once a
    round into an output filled with NaN (an element never written shows
    as NaN). Nothing asserted, no result line."""
    from repro_torch.kernels import tt_mma, ttm_pe1
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    calls = list(_lm_pe_calls()) + [
        (kind, zs, gs) for _, kind, zs, gs, _ in _frontend_granule_calls()]
    for kind, zs, gs in calls:
        kern, plain = _pe_fns(kind)
        z = torch.randn(zs, generator=gen, device="cuda").to(torch.bfloat16)
        g = (torch.randn(gs, generator=gen, device="cuda") * 0.2).to(
            torch.bfloat16)
        base, pair, rounds, nan = None, [], [], 0
        t0 = time.perf_counter()
        for i in range(reps):
            o = kern(z, g)
            r = plain(z, g)
            _pe_library(torch, kind, z, g)
            p = (ttm_pe1.plan_pe1_for(z, g) if kind == "pe1" else
                 tt_mma.plan_for(*_pe_contraction(kind, z, g)))
            o2 = kern(z, g)
            if not _bits_equal(torch, o2, o):
                pair.append({"round": i, **_pe_diff(torch, o2, o, r)})
            if base is None:
                base = o
            elif not _bits_equal(torch, o, base):
                rounds.append({"round": i, **_pe_diff(torch, o, base, r)})
            if kind == "pe2":
                n = torch.full((zs[0], gs[1], zs[2]), float("nan"),
                               dtype=torch.bfloat16, device="cuda")
                tt_mma.launch("pe2", "ttm_pe2", p, z, g, n)
                nan += int(n.isnan().sum())
            del o, o2, r
        torch.cuda.synchronize()
        name = f"{kind} {zs}x{gs}"
        out[name] = {"route": "tensor cores" if p is not None else "fma",
                     "orientation": getattr(p, "orientation", "K-major"),
                     "rounds": reps, "pair_differ": pair,
                     "round_differ": rounds, "nan": nan,
                     "seconds": time.perf_counter() - t0}
        log(f"pe repeat {name} ({out[name]['orientation']}): {len(pair)} of "
            f"{reps} rounds' two launches differ, {len(rounds)} rounds' first "
            f"launch differs from round 0's, {nan} NaN elements, "
            f"{out[name]['seconds']:.1f} s; {pair[:3]} {rounds[:3]}")
        del z, g, base
        torch.cuda.empty_cache()
    total = sum(len(v["pair_differ"]) + len(v["round_differ"]) + v["nan"]
                for v in out.values())
    log(f"pe repeat: {reps} rounds of each of {len(out)} calls, "
        f"{total} differences in all")
    return out


def phase_paged_rows(torch, path: str) -> None:
    """Rows 1b, 5b, 6b and 1c at GQA's shapes (internlm2-1.8b's 8 KV heads
    and moonshot-v1-16b's 16; the prefill write at 24 x 8 and 48 x 16),
    each held to its twin as in the kernel phases and timed, written to
    ``path``: with ``--src`` a parent tree's kernels take the same inputs
    in one call, so the two designs compare on one card."""
    from repro_torch.kernels import build as B
    B.build(["kv_append", "kv_read", "kv_prefill", "pow2_rows",
             "pow2_scalar"])
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for hkv in (8, 16):
        out[f"1b {hkv} heads"] = _append_row(torch, timer, gen, hkv)["ms"]
        pool = _paged_pool(torch, gen, hkv)
        out[f"5b {hkv} heads"] = _paged_write_row(torch, timer, gen,
                                                  pool)["ms"]
        for r in _paged_read_rows(torch, timer, pool):
            out[f"6b {hkv} heads, {r['what']}"] = r["ms"]
        del pool
    for layers, hkv in ((24, 8), (48, 16)):
        for r in _prefill_rows(torch, timer, gen, layers, hkv,
                               ((512, 512), (128, 128))):
            out[f"1c {layers} x {hkv} heads, {r['what']}"] = r["ms"]
    log(f"paged rows: {json.dumps(out)}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out))


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
    ap.add_argument("--paged-rows", metavar="PATH",
                    help="only time rows 1b, 5b, 6b and 1c at GQA's shapes "
                    "and write them here (no result line)")
    ap.add_argument("--pe-repeat", type=int, metavar="N",
                    help="only replay the lm kernels check's sequence N "
                    "times for each of the LM's PE1, PE2 and PE3 calls and "
                    "the frontends' granule calls, and log every launch "
                    "whose bits differ (no result line)")
    ap.add_argument("--src", help="the directory holding repro_torch "
                    "(default: src beside this script)")
    ap.add_argument("--ckpt-child", nargs=3, metavar=("DIR", "KILL", "OUT"),
                    help=argparse.SUPPRESS)  # train ckpt's child process
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
    SRC[0] = src
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ckpt_child:
        d, kill, out = args.ckpt_child
        phase_ckpt_child(torch, d, int(kill), out)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    if (args.tokens or args.steps or args.deploy or args.pe_repeat
            or args.paged_rows):
        if args.paged_rows:
            phase_paged_rows(torch, args.paged_rows)
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
    def done(name):     # where the script's time limit goes
        log(f"phase {name} done at {time.perf_counter() - t0:.1f} s")
    report["kernels"] = phase_kernels(torch, timer)
    done("kernels")
    report["train_kernels"] = phase_train_kernels(torch, timer)
    done("train_kernels")
    report["wire_kernels"] = phase_wire_kernels(torch, timer)
    done("wire_kernels")
    report["scalar_kernels"] = phase_scalar_kernels(torch, timer)
    done("scalar_kernels")
    report["state_kernels"] = phase_state_kernels(torch, timer)
    done("state_kernels")
    report["state_group"] = phase_state_group(torch, timer)
    done("state_group")
    report["health_kernels"] = phase_health_kernels(torch, timer)
    done("health_kernels")
    del timer
    lm, params = full_model(torch)
    report["engine"] = phase_engine(torch, lm, params)
    done("engine")
    report["serve_chunked"] = phase_serve_chunked(torch, lm, params)
    done("serve_chunked")
    report["serve_spec"] = phase_serve_spec(
        torch, lm, params, report["engine"]["fused_tokens"])
    done("serve_spec")
    report["serve_obs"] = phase_serve_obs(torch, lm, params, report["engine"])
    done("serve_obs")
    del params
    torch.cuda.empty_cache()
    report["identity"] = phase_identity(torch)
    done("identity")
    report["chunked_identity"] = phase_chunked_identity(torch)
    done("chunked_identity")
    t_state = time.perf_counter()
    lm, params = _state_model(torch, SSM_ARCH)
    report["serve_rwkv6"] = phase_serve_rwkv6(torch, lm, params)
    done("serve_rwkv6")
    del params
    torch.cuda.empty_cache()
    report["serve_hybrid"] = phase_serve_hybrid(torch)
    done("serve_hybrid")
    report["ssm_identity"] = phase_ssm_identity(torch)
    done("ssm_identity")
    report["state_phases_s"] = time.perf_counter() - t_state
    log(f"recurrent phases (serve rwkv6, serve hybrid, ssm identity) in "
        f"{report['state_phases_s']:.1f} s")
    report["serve_moe"] = phase_serve_moe(torch)
    done("serve_moe")
    report["serve_mla"] = phase_serve_mla(torch)
    done("serve_mla")
    report["train"] = phase_train(torch)
    done("train")
    report["train_identity"] = phase_train_identity(torch)
    done("train_identity")
    report["train_wire"] = phase_train_wire(torch)
    done("train_wire")
    report["train_wire_identity"] = phase_train_wire_identity(torch)
    done("train_wire_identity")
    report["lm_kernels"] = phase_lm_kernels(torch, Timer(torch))
    done("lm_kernels")
    report["frontend_kernels"] = phase_frontend_kernels(torch, Timer(torch))
    done("frontend_kernels")
    report["train_lm"] = phase_train_lm(torch)
    done("train_lm")
    report["train_lm_identity"] = phase_train_lm_identity(torch)
    done("train_lm_identity")
    report["train_frontend"] = phase_train_frontend(torch)
    done("train_frontend")
    report["train_ckpt"] = phase_train_ckpt(torch)
    done("train_ckpt")
    report["train_recurrent"] = phase_train_recurrent(torch)
    done("train_recurrent")
    report["train_moe"] = phase_train_moe(torch)
    done("train_moe")
    report["seconds"] = time.perf_counter() - t0
    line = kernels_line(report["kernels"], report["engine"],
                        report["train_kernels"], report["train"],
                        report["wire_kernels"], report["train_wire"],
                        report["scalar_kernels"], report["serve_chunked"],
                        report["lm_kernels"], report["train_lm"],
                        report["serve_spec"], report["state_kernels"],
                        report["serve_rwkv6"], report["serve_hybrid"],
                        report["state_group"], report["serve_moe"],
                        report["serve_mla"], report["train_frontend"],
                        report["train_ckpt"], report["frontend_kernels"],
                        report["train_recurrent"], report["train_moe"])
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
