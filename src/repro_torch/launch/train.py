"""Training launcher: --arch <id> [--reduced] with the full fault-tolerant
loop (checkpoint/restart, watchdog, microbatching). The port of
``repro.launch.train``, with the port's ``--device`` and ``--layers``.

On the GPU (the default; it raises where there is none):

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 200 --batch 8 --seq 256 --microbatches 2 --ckpt-dir /tmp/ckpt

On the CPU, a reduced config:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 32

``--layers N`` keeps the config's width and cuts its depth to N layers (a
full-width smoke run that fits a smaller card or a quicker checkpoint).
SIGTERM saves a checkpoint and exits; a rerun with the same
``--ckpt-dir`` resumes from it.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.loop import run_training


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's own)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, reduced=args.reduced)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    opt = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                      total_steps=args.steps)
    res = run_training(cfg, steps=args.steps, global_batch=args.batch,
                       seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       microbatches=args.microbatches, opt=opt,
                       seed=args.seed, device=args.device,
                       log_fn=lambda m: print(m, flush=True))
    t = res["timing"]
    print(f"done: final loss {res['losses'][-1]:.4f}, "
          f"step p50 {t.get('p50', 0):.3f}s p99 {t.get('p99', 0):.3f}s, "
          f"stragglers {t.get('stragglers', 0)}", flush=True)


if __name__ == "__main__":
    main()
