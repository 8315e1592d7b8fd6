"""Compressed gradient all-reduce with error feedback.

Counterpart of ``repro.distributed.compress``. Each data-parallel rank
casts its local gradients to ``wire_dtype`` (bf16 halves the data-parallel
traffic), the ranks sum the wire values with one all-reduce each, and the
mean comes back in f32. The rounding residual of the cast is carried to
the next step (error feedback), which keeps SGD unbiased in expectation.

The sum runs in the wire dtype, as the reference's ``psum`` of the wire
values does: the backend adds bf16 values in its own order and rounds
each partial sum to bf16. A CUDA tensor on a gloo group (ranks sharing
one card) goes through host memory, as the tensor-parallel group's
collectives do (``distributed/group.py``).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_leaves, tree_map


def _all_reduce_sum(wire: torch.Tensor, group) -> torch.Tensor:
    staged = wire.detach().clone().contiguous()
    if staged.is_cuda and dist.get_backend(group) == "gloo":
        staged = staged.cpu()
    dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=group)
    return staged.to(wire.device)


def compressed_psum(grads: Any, group=None, wire_dtype=torch.bfloat16,
                    error: Optional[Any] = None) -> Tuple[Any, Any]:
    """All-reduce-mean ``grads`` (a tree of this rank's local gradients)
    over the ranks of ``group`` (a ``torch.distributed`` group of the
    data-parallel ranks; None: the default group) at ``wire_dtype``.
    Returns (the reduced f32 gradients, the new error-feedback state);
    ``error`` is the state the previous step returned (zeros when None).
    Every rank of the group calls it with trees of the same structure."""
    n = dist.get_world_size(group)
    if error is None:
        error = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)

    def reduce_one(g, e):
        corrected = g.to(torch.float32) + e
        wire = corrected.to(wire_dtype)
        new_e = corrected - wire.to(torch.float32)      # residual feedback
        summed = _all_reduce_sum(wire, group)
        return summed.to(torch.float32) / n, new_e

    pairs = tree_map(reduce_one, grads, error)
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))


def wire_bytes(grads, wire_dtype=torch.bfloat16) -> int:
    """Data-parallel traffic per step at the compressed wire dtype."""
    size = torch.empty((), dtype=wire_dtype).element_size()
    return sum(math.prod(g.shape) * size for g in tree_leaves(grads))
