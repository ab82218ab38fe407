"""End-to-end driver on the port: train a ~100M-param decoder LM for a few
hundred steps on synthetic data — dense baseline or TT-compressed
(--tt) — with checkpoint/resume, asynchronous checkpointing, straggler
monitoring and prefetch (``repro_torch.launch.train``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm_100m --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm_100m --steps 200 --tt

It runs on the card unless ``--device cpu`` is given; rerun with the same
``--ckpt-dir`` to resume from its newest checkpoint.
"""
import argparse

import repro_torch.configs as C
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.train import LM100M, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tt", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_lm100m")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = LM100M
    if args.tt:
        cfg = C.with_tt(cfg, d=3, max_rank=48)
    tcfg = TrainConfig(learning_rate=3e-4, total_steps=args.steps,
                       warmup_steps=max(10, args.steps // 20),
                       ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=10)
    return train(cfg, "tp", tcfg, batch=args.batch, seq=args.seq,
                 device=args.device)


if __name__ == "__main__":
    main()
