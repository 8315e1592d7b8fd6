"""Top-k capacity-based MoE (GShard-style), dispatched per batch row.

Counterpart of ``repro.models.moe``, with its expert-parallel branch
(under a serve-TP plan with ``moe_ep``, each rank runs the products of
its own E/size experts and one all-gather assembles the buffers). Each
batch row routes its own S tokens into a ``(E, C, d)`` dispatch buffer
with per-row capacity ``C``; token choices ranked at or past ``C`` in
their expert are dropped, as GShard does, and the switch-style aux
load-balance loss is returned beside the output.

Every numerical choice is the reference's: an f32 router product, top-k
on the logits and a softmax over the k kept logits for the gates, ranks
from a cumulative sum over the S*k choices in token order (k inner), the
three expert products and ``silu(hg) * hu`` in bf16 whatever the model's
dtype, and an f32 combine weighted by keep x gate, cast to ``x.dtype``.

Expert weights may be an E*K-packed ``QTensor`` (``core.qlinear``); it is
dequantized whole to bf16 at each use and the products are plain
``torch.bmm``, as the reference computes them outside any kernel.

Row independence: the router product and the expert products run one
batch row at a time at a shape fixed by (S, E, C, d), and the combine
sums the k choices in a fixed order, so a row's output has the same bits
whatever the batch size (a prefill group of 4 rows gives each row what a
group of 1 gives it).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.core import calibrate as CAL
from repro_torch.core.formats import get_format
from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.distributed.sharding import (serve_tp_group, serve_tp_plan,
                                              serve_tp_rank)


def expert_weights(w, E: int, lo: int = 0, n: int = 0) -> torch.Tensor:
    """(n, K, N) in bf16, experts [lo, lo + n) of E (all E where ``n`` is
    0), from either a plain stack or an E*K-packed QTensor. A plain stack
    that holds fewer than E experts is already this rank's share (expert
    parallelism) and is returned whole. A packed stack whose K is a whole
    number of super-blocks is cut to those experts' rows before it is
    dequantized (dequantization is per super-block, so the values are the
    bits of cutting after)."""
    n = n or E
    if isinstance(w, QTensor):
        EK, N = w.shape
        K = EK // E
        if n < E and K % get_format(w.variant).super_block == 0:
            w = QTensor(w.variant, (n * K, N),
                        {k: v.narrow(-2, lo * (v.shape[-2] // E),
                                     n * (v.shape[-2] // E))
                         for k, v in w.data.items()})
            return dequantize(w, dtype=torch.bfloat16).reshape(n, K, N)
        full = dequantize(w, dtype=torch.bfloat16).reshape(E, K, N)
        return full[lo:lo + n]
    if w.shape[0] == E:
        w = w[lo:lo + n]
    return w.to(torch.bfloat16)


def _silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with each step rounded to bf16, as the reference's
    ``jax.nn.silu`` lowers (neg, exp, add, divide, multiply); the fused
    ``torch.sigmoid`` rounds once and differs in a third of the values."""
    return x * (1 / (1 + torch.exp(-x)))


def _capacity(S: int, k: int, E: int, cf: float) -> int:
    c = int(S * k * cf / E) + 1
    return max(4, min(c, S * k))


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """(router logits (B, S, E) f32, computed one batch row at a time;
    the top-k expert ids (B, S, k); the gates, a softmax over the k
    kept logits)."""
    r = router.to(torch.float32)
    xf = x.to(torch.float32)
    logits = torch.stack([xf[b] @ r for b in range(x.shape[0])])
    topv, topi = torch.topk(logits, k, dim=-1)
    return logits, topi, torch.softmax(topv, dim=-1)


def dispatch(topi: torch.Tensor, E: int, C: int):
    """Each token choice's rank in its expert, counted over the row's S*k
    choices in token order with k inner. Returns (expert, slot, keep),
    each (B, S*k): choices ranked >= C are dropped (keep False) and point
    at slot 0, where they add zeros."""
    B, S, k = topi.shape
    e_flat = topi.reshape(B, S * k)
    oh = Fn.one_hot(e_flat, E)                              # (B, S*k, E)
    ranks = torch.cumsum(oh, dim=1) - oh
    myrank = torch.gather(ranks, 2, e_flat[..., None])[..., 0]
    keep = myrank < C
    return e_flat, torch.where(keep, myrank, torch.zeros_like(myrank)), keep


def moe_block(x: torch.Tensor, p: Dict, cfg) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x.dtype, aux_loss f32 scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    C = _capacity(S, k, E, cfg.capacity_factor)

    logits, topi, gates = route(x, p["router"], k)
    # aux load-balance loss (Switch-style): E * sum_e f_e * P_e
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    ce = Fn.one_hot(topi[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    e_flat, slot, keep = dispatch(topi, E, C)
    g_flat = gates.reshape(B, S * k)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    contrib = torch.where(keep[..., None], x.repeat_interleave(k, dim=1),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    bufs = torch.zeros((B, E, C, d), dtype=x.dtype, device=x.device)
    bufs.index_put_((bidx, e_flat, slot), contrib, accumulate=True)

    # serving-side expert parallelism (ServeTPPlan.moe_ep): routing,
    # dispatch and combine run replicated on all E experts, each rank's
    # products cover its own E/size experts, and one tiled all-gather of
    # the output buffers (pure data movement) assembles all E
    plan = serve_tp_plan()
    ep = (plan is not None and plan.moe_ep and plan.size > 1
          and E % plan.size == 0)
    El = E // plan.size if ep else E
    lo = serve_tp_rank() * El if ep else 0
    bufs_c = bufs[:, lo:lo + El]

    wg = expert_weights(p["w_gate"], E, lo, El)             # (El, d, fe)
    wu = expert_weights(p["w_up"], E, lo, El)
    CAL.tap(("moe/w_gate", "moe/w_up"), bufs_c)
    hidden = []
    for b in range(B):
        xb = bufs_c[b].to(torch.bfloat16)
        hg = torch.bmm(xb, wg)
        hu = torch.bmm(xb, wu)
        hidden.append(_silu_bf16(hg) * hu)
    del wg, wu
    hidden = torch.stack(hidden)                            # (B, El, C, fe)
    CAL.tap("moe/w_down", hidden)
    wd = expert_weights(p["w_down"], E, lo, El)
    out_buf = torch.stack([torch.bmm(hidden[b], wd) for b in range(B)])
    if ep:
        out_buf = serve_tp_group().all_gather(out_buf, dim=1)

    vals = out_buf[bidx, e_flat, slot].to(torch.float32)    # (B, S*k, d)
    vals = (vals * (keep * g_flat)[..., None]).reshape(B, S, k, d)
    y = vals[:, :, 0]
    for j in range(1, k):       # the k choices summed in a fixed order
        y = y + vals[:, :, j]
    return y.to(x.dtype), aux.to(torch.float32)
