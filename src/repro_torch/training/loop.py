"""Fault-tolerant training loop: checkpoint/restart, straggler watchdog.

Counterpart of ``repro.training.loop``. The loop is preemption-safe end
to end:
  * auto-resume from the newest valid checkpoint (atomic MANIFEST check),
    restored onto the device;
  * async checkpoint every ``ckpt_every`` steps + final sync save;
  * data batches are pure functions of step -> restart is bit-identical;
  * SIGTERM triggers a synchronous save before exit (cluster preemption),
    and the old handler comes back when the loop ends;
  * step-time watchdog tracks p50/p99 and flags stragglers (steps slower
    than ``straggler_factor`` x p50): logged.
A step's time is a host clock read after ``torch.cuda.synchronize()`` on
the card; the loss is read back once a step.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import steps as S


class Watchdog:
    def __init__(self, straggler_factor: float = 2.0):
        self.times: List[float] = []
        self.factor = straggler_factor
        self.stragglers = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) >= 8:
            p50 = float(np.percentile(self.times[-100:], 50))
            if dt > self.factor * p50:
                self.stragglers += 1
                return True
        return False

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times[1:] or self.times)   # drop the first step
        return dict(p50=float(np.percentile(t, 50)),
                    p99=float(np.percentile(t, 99)),
                    mean=float(t.mean()), stragglers=self.stragglers)


def run_training(cfg: ModelConfig, *, steps: int, global_batch: int,
                 seq_len: int, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 50, microbatches: int = 1,
                 opt: Optional[AdamWConfig] = None, seed: int = 0,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print,
                 device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    opt = opt or AdamWConfig(total_steps=steps)
    data = DataPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=seq_len,
                                   global_batch=global_batch, seed=seed))
    train_step = S.make_train_step(cfg, opt, microbatches=microbatches)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    state = None
    if ckpt:
        latest, restored = ckpt.restore_latest(device=dev)
        if latest is not None:
            state = restored
            start_step = latest
            log_fn(f"[resume] restored checkpoint step={latest}")
    if state is None:
        state = S.init_train_state(
            cfg, opt, torch.Generator(device=dev).manual_seed(seed),
            device=dev)

    # preemption hook: save synchronously on SIGTERM
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True
    old = signal.signal(signal.SIGTERM, _on_term)

    wd = Watchdog()
    losses: List[float] = []
    try:
        for step in range(start_step, steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(step).items()}
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            losses.append(loss)
            dt = time.perf_counter() - t0
            if wd.record(dt):
                log_fn(f"[watchdog] straggler step {step}: {dt:.3f}s")
            if step % log_every == 0:
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"gnorm {float(metrics['grad_norm']):.3f} "
                       f"lr {float(metrics['lr']):.2e} ({dt:.3f}s)")
            if ckpt and ((step + 1) % ckpt_every == 0):
                ckpt.save_async(step + 1, state)
            if preempted["flag"]:
                log_fn(f"[preempt] SIGTERM at step {step}; saving + exiting")
                if ckpt:
                    ckpt.save(step + 1, state)
                break
    finally:
        signal.signal(signal.SIGTERM, old)
        if ckpt:
            ckpt.wait()
    if ckpt and not preempted["flag"]:
        ckpt.save(min(steps, len(losses) + start_step), state)
    return dict(state=state, losses=losses, timing=wd.summary(),
                preempted=preempted["flag"])
