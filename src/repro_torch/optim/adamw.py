"""AdamW + cosine schedule + global-norm clipping on parameter trees.

Counterpart of ``repro.optim.adamw``: a pure function of (params, grads,
state) that returns new trees, so the tests compare it with the
reference leaf by leaf (no ``torch.optim``, which updates in place).
Trees are nested dicts of tensors, walked in sorted key order as JAX
walks a dict pytree. Weight decay is masked off 1-D parameters (norm
scales, biases). The moments are f32 by default; ``moment_dtype``
"bfloat16" halves optimizer memory. The update itself runs in f32
whatever the moments' dtype, with the bias correction in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import torch_dtype


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of one or more dict trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in sorted key order (``jax.tree.leaves`` of a dict tree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine to ``lr * min_lr_ratio``
    at ``total_steps``; f32, as the reference."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(cfg: AdamWConfig, params) -> Dict[str, Any]:
    dt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree_leaves(params)[0].device
    return dict(m=tree_map(zeros, params), v=tree_map(zeros, params),
                step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state,
                  lr: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, metrics); the inputs are left as
    they were."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step) if lr is None else lr
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    mdt = torch_dtype(cfg.moment_dtype)
    f32 = torch.float32

    def upd(p, g, m, v):
        g = g.to(f32) * scale
        m32 = b1 * m.to(f32) + (1 - b1) * g
        v32 = b2 * v.to(f32) + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2 and cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(f32)
        return ((p.to(f32) - lr * delta).to(p.dtype), m32.to(mdt),
                v32.to(mdt))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)   # a leaf is a 3-tuple
    new_state = dict(m=pick(1), v=pick(2), step=step)
    return pick(0), new_state, dict(grad_norm=gnorm, lr=lr)
