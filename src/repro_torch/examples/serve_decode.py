"""Serving example on the port's continuous-batching engine
(``repro_torch.serve``): a stream of variable-length requests is packed
into a fixed-slot batch with a slot-paged, optionally int8-quantized
KV-cache pool — and, for SSM/hybrid archs, a slot-indexed quantized
recurrent-state cache:

    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch internlm2-1.8b
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch internlm2-1.8b --quantized
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch deepseek-v2-236b --temperature 0.8
    PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch rwkv6-1.6b --quantized

The reduced config of ``--arch`` in f32, seeded weights; on the card
unless ``--device cpu`` is given. ``--fused`` decodes through the fused
paged-attention kernels (the engine's ``fused_attention``).
"""
import argparse
import json
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.device import resolve_device
from repro_torch.models import build_lm, init_lm
from repro_torch.serve import Engine, EngineConfig, PoolConfig, SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--quantized", action="store_true",
                    help="int8 pow-2 KV-cache pool + recurrent-state cache "
                         "(fp storage otherwise)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--fused", action="store_true",
                    help="fused paged-attention decode (MLA sublayers take "
                         "the gather path)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = C.get_reduced(args.arch).replace(dtype="float32", remat="none")
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only — no decode path")
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch}: frontend (vision/audio) serving is "
                         f"an open roadmap item")
    device = resolve_device(args.device)
    lm = build_lm(cfg)
    params = init_lm(torch.Generator(device=device).manual_seed(0), lm,
                     device=device)

    horizon = args.prompt_len + args.gen_len
    pcfg = PoolConfig(
        num_slots=args.slots, page_size=args.page_size,
        pages_per_slot=-(-horizon // args.page_size) + 1,
        quantized=args.quantized)
    eng = Engine(lm, params,
                 EngineConfig(pool=pcfg, prefill_chunk=args.prefill_chunk,
                              fused_attention=args.fused),
                 device=device)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p)

    rng = np.random.RandomState(1)
    rids = []
    for _ in range(args.requests):
        # variable-length prompts: 1/2..1x of --prompt-len
        plen = int(rng.randint(max(args.prompt_len // 2, 1),
                               args.prompt_len + 1))
        prompt = rng.randint(0, cfg.vocab_size, plen).tolist()
        rids.append(eng.submit(prompt, max_new_tokens=args.gen_len,
                               sampling=sp))

    t0 = time.time()
    results = eng.run()
    dt = time.time() - t0
    s = eng.summary()
    mode = "int8" if args.quantized else "fp"
    # only the pools this arch allocates: pure-SSM archs have no KV pool
    # (and run unpaged), attention-only archs no state cache
    pools = []
    if s["cache_bytes"]:
        pools.append(f"kv cache {s['cache_bytes']/1024:.0f} KiB "
                     f"({s['cache_reduction']:.1f}x vs fp32)")
    if s["state_bytes"]:
        pools.append(f"state cache {s['state_bytes']/1024:.0f} KiB "
                     f"({s['state_reduction']:.1f}x vs fp32)")
    label = f"{mode}-paged" if s["cache_bytes"] else f"{mode}-state"
    print(f"served {s['requests_completed']} requests "
          f"({s['generated_tokens']} tokens) on {args.slots} slots "
          f"[{label}] in {dt:.2f}s — {s['tokens_per_s']:.0f} tok/s, "
          f"ttft p50 {s['ttft_p50_s']*1e3:.0f}ms, "
          + ", ".join(pools))
    print("sample:", results[rids[0]].tokens[:16])
    print(json.dumps(s, indent=2))
    return s


if __name__ == "__main__":
    main()
