"""Loss and train-step functions.

Counterpart of ``repro.training.steps``. ``make_train_step`` builds a
microbatch-accumulating train step:
  * f32 master parameters, cast to ``cfg.dtype`` for compute (mixed
    precision), gradients back to f32 through the cast;
  * optional gradient accumulation over microbatches, a Python loop
    where the reference has ``lax.scan``, accumulated in ``accum_dtype``,
    then divided and cast to f32;
  * remat is a model-config knob (``cfg.remat``: each layer recomputed
    in the backward pass, ``models/transformer.forward_seq``).

The loss is the mean token cross entropy with a z-loss, plus
``aux_weight`` times the MoE aux loss. For a vocabulary of 8192 or more
with ``cfg.loss_chunk`` set it is chunked over tokens (``chunked_xent``):
each chunk's head product and log-sum-exp are recomputed in the backward
pass, so the (B, S, V) logits never exist at once.

No kernel of the port is on this path, as in the reference: training
runs float weights, so every product is a plain one. Attention must be
``naive`` or ``blockwise`` (``"auto"`` picks one): the fused kernel has no
backward and ``forward_seq`` raises if asked to differentiate it.

``make_serve_steps`` is the reference's serve path for the families that
take embeddings (vlm, audio; any family takes tokens): a prefill through
``forward_seq(want_cache=True)`` with the LM head on the last position
only, and ``decode_step``; ``models.transformer.cache_from_prefill``
turns the prefill's payload into the decode cache. With packed weights
it runs the matmul kernel, and under ``attn_impl="fused"`` the prefill
attention kernel.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


def cast_params(params, dtype):
    """Floating leaves of two or more dims to ``dtype`` (stacked norm
    scales included, as the reference casts them); the rest as they are."""
    return tree_map(lambda x: x.to(dtype) if (x.is_floating_point()
                                              and x.dim() >= 2) else x,
                    params)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """logits (..., V) f32, labels (...) int. Mean token loss + z-loss."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss


def _xent_chunk(hc, lc, head, tie_wte):
    """One chunk's (loss sum, z sum, valid count); label -1 is padding."""
    if tie_wte is not None:
        logits = torch.matmul(hc.to(torch.float32),
                              SH.gather_dp(tie_wte).to(torch.float32).t())
    else:
        logits = torch.matmul(hc, SH.gather_dp(head).to(hc.dtype)).to(
            torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    valid = (lc >= 0).to(torch.float32)
    ll = torch.gather(logits, -1, lc.clamp_min(0).long()[:, None])[:, 0]
    return (torch.sum((lse - ll) * valid), torch.sum((lse ** 2) * valid),
            valid.sum())


def chunked_xent(h: torch.Tensor, head, labels: torch.Tensor, *,
                 tie_wte=None, chunk: int = 2048,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Cross entropy from hidden states h (B, S, d), chunked over tokens:
    each chunk of ``chunk`` tokens computes its own head product (against
    ``head`` (d, V) in h's dtype, or the tied ``tie_wte`` (V, d) as an f32
    product) and log-sum-exp, recomputed in the backward pass. A ragged
    last chunk is padded with label -1, which counts for nothing."""
    B, S, d = h.shape
    hf = h.reshape(B * S, d)
    lf = labels.reshape(B * S)
    n = B * S
    c = min(chunk, n)
    if n % c:
        pad = c - n % c
        hf = torch.nn.functional.pad(hf, (0, 0, 0, pad))
        lf = torch.cat([lf, torch.full((pad,), -1, dtype=lf.dtype,
                                       device=lf.device)])
        n += pad
    # chunk i is row i of (n/c, c, ...), as the reference's scan takes
    # it; a dry run lays each chunk's tokens over the data-parallel ranks
    # (sharding.constrain: the identity elsewhere)
    hf = SH.constrain(hf.reshape(n // c, c, d), None, "dp", None)
    lf = SH.constrain(lf.reshape(n // c, c), None, "dp")
    sums = [torch.zeros((), dtype=torch.float32, device=h.device)] * 3
    for i in range(n // c):
        args = (hf[i], lf[i], head, tie_wte)
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(_xent_chunk, *args,
                                                     use_reentrant=False)
        else:
            part = _xent_chunk(*args)
        sums = [a + b for a, b in zip(sums, part)]
    loss_sum, z_sum, nvalid = sums
    return loss_sum / nvalid + z_loss * z_sum / nvalid


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 1e-2):
    """loss_fn(params, batch) -> (loss, {"loss", "aux"}); batch holds
    ``labels`` (B, S) and ``tokens`` (B, S) or ``embeds`` (B, S, d), and
    may hold ``positions`` ((3, B, S) under M-RoPE)."""
    use_chunked = cfg.loss_chunk and cfg.vocab_size >= 8192

    def loss_fn(params, batch):
        compute = cast_params(params, torch_dtype(cfg.dtype))
        out, aux = T.forward_seq(compute, cfg, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"),
                                 positions=batch.get("positions"),
                                 return_hidden=bool(use_chunked),
                                 with_aux=True)
        if use_chunked:
            tie = compute["wte"] if cfg.tie_embeddings else None
            head = None if cfg.tie_embeddings else compute["lm_head"]
            loss = chunked_xent(out, head, batch["labels"], tie_wte=tie,
                                chunk=cfg.loss_chunk)
        else:
            loss = softmax_xent(out, batch["labels"])
        loss = loss + aux_weight * aux
        return loss, dict(loss=loss.detach(), aux=aux.detach())
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads): the gradient of every floating leaf, zeros
    where the loss does not reach one (as ``jax.grad`` gives)."""
    with torch.enable_grad():
        live = tree_map(lambda x: x.detach().requires_grad_(
            x.is_floating_point()), params)
        loss, metrics = loss_fn(live, batch)
        want = [x for x in tree_leaves(live) if x.requires_grad]
        got = dict(zip(map(id, want), torch.autograd.grad(
            loss, want, allow_unused=True)))
    grads = tree_map(lambda x: torch.zeros_like(x) if got.get(id(x)) is None
                     else got[id(x)], live)
    return loss.detach(), metrics, grads


def make_train_step(cfg: ModelConfig, opt: adamw.AdamWConfig,
                    microbatches: int = 1, accum_dtype=torch.float32):
    """train_step(state, batch) -> (new_state, metrics); state is
    {"params", "opt", "step"} and is left as it was."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        if microbatches <= 1:
            _, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            mb = batch["labels"].shape[0] // microbatches
            accum, losses, auxes = None, [], []
            for i in range(microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                # M-RoPE positions (3, B, S) split on their batch axis
                sub = {k: v[:, rows] if k == "positions" and v.dim() == 3
                       else v[rows] for k, v in batch.items()}
                _, m, g = value_and_grad(loss_fn, params, sub)
                g = tree_map(lambda x: x.to(accum_dtype), g)
                # the reference adds the first gradient to zeros: the same
                # bits as starting from it
                accum = g if accum is None else tree_map(
                    lambda a, b: a.add_(b), accum, g)
                losses.append(m["loss"])
                auxes.append(m["aux"])
            # in place: the accumulator is this step's own (the same bits
            # as dividing into a copy), and a copy would add a gradient
            # tree's size to the peak
            grads = tree_map(lambda g: g.div_(microbatches).to(
                torch.float32), accum)
            del accum
            metrics = dict(loss=torch.stack(losses).mean(),
                           aux=torch.stack(auxes).mean())
        new_params, new_opt, om = adamw.apply_updates(
            opt, params, grads, state["opt"])
        metrics.update(om)
        return dict(params=new_params, opt=new_opt,
                    step=state["step"] + 1), metrics

    return train_step


def make_serve_steps(cfg: ModelConfig):
    """(prefill, decode), the reference's serve steps.

    prefill(params, batch) -> (logits (B, V) f32 of the last position,
    the ``forward_seq(want_cache=True)`` payload); batch holds ``tokens``
    (B, S) or ``embeds`` (B, S, d), and may hold ``positions``. The head
    runs on the last position only, so the (B, S, V) logits never exist.
    decode(params, cache, batch) -> (logits (B, V) f32, the cache updated
    in place); batch holds ``tokens`` (B,) or ``embeds`` (B, d), and
    ``position`` (B,)."""
    def prefill(params, batch):
        h, _, caches = T.forward_seq(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), positions=batch.get("positions"),
            want_cache=True, return_hidden=True)
        # the head under the default impl, as the reference's ``_logits``
        return T._logits(params, cfg, h[:, -1]), caches

    def decode(params, cache, batch):
        return T.decode_step(params, cfg, cache, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"),
                             position=batch["position"])

    return prefill, decode


def init_train_state(cfg: ModelConfig, opt: adamw.AdamWConfig,
                     generator: torch.Generator, *, device="cuda"):
    """f32 parameters from ``generator`` (which must live on ``device``),
    zero moments and step 0."""
    params = T.init_params(cfg, generator, dtype=torch.float32,
                           device=device)
    return dict(params=params, opt=adamw.init_state(opt, params),
                step=torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device))
