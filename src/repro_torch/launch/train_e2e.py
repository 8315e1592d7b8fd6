"""End-to-end training: train a ~100M-parameter llama-family model
for a few hundred steps on the synthetic pipeline with checkpointing and
the straggler watchdog. The port of ``examples/train_e2e.py``.

  PYTHONPATH=src python -m repro_torch.launch.train_e2e [--steps 300] \\
      [--ckpt-dir DIR] [--device cpu]

(~100M params: 12 layers x d=768 x ff=2048, 32k vocab; global batch 8 x
128 tokens, AdamW at 6e-4 with 30 warmup steps, a checkpoint every 100
steps.) It runs on the GPU unless ``--device cpu`` is given (it raises
where there is none); no kernel of the port is on this path (training
runs the float weights and the naive attention, as the reference's).
Without ``--ckpt-dir`` the checkpoints go to a fresh temporary directory,
removed at the end; with one, a rerun resumes from its newest checkpoint.
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
from typing import Any, Callable, Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.loop import run_training

# the reference example's config, run and optimizer, field for field
LLAMA_100M = ModelConfig(
    name="llama-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab_size=32000, rope_theta=1e4,
    attn_impl="naive", remat=False,
)
RUN = dict(global_batch=8, seq_len=128, ckpt_every=100)
OPT = dict(lr=6e-4, warmup_steps=30)


def run(cfg: ModelConfig = LLAMA_100M, *, steps: int = 300,
        ckpt_dir: Optional[str] = None, device="cuda",
        log_fn: Callable[[str], None] = print) -> Dict[str, Any]:
    """``run_training`` at the example's batch, sequence, optimizer and
    checkpoint interval for ``steps`` steps, resuming from the newest
    checkpoint under ``ckpt_dir`` if there is one; returns its result."""
    opt = AdamWConfig(total_steps=steps, **OPT)
    where = (contextlib.nullcontext(ckpt_dir) if ckpt_dir
             else tempfile.TemporaryDirectory(prefix="train_e2e_"))
    with where as d:
        return run_training(cfg, steps=steps, ckpt_dir=d, opt=opt,
                            device=device, log_fn=log_fn, **RUN)


def main(argv=None) -> Dict[str, Any]:
    """Run the flow on ``argv``; returns ``run``'s result. Raises if the
    loss did not fall."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(steps=args.steps, ckpt_dir=args.ckpt_dir, device=args.device)
    losses = res["losses"]
    t = res["timing"]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps")
    print(f"step time p50 {t['p50']:.3f}s p99 {t['p99']:.3f}s, "
          f"stragglers {t['stragglers']}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"training should reduce loss: {losses[0]} -> "
                           f"{losses[-1]}")
    return res


if __name__ == "__main__":
    main()
