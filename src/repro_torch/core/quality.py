"""Quantization quality metrics: teacher-logit KL and pseudo-perplexity.

Counterpart of ``repro.core.quality``. A quantized ("student") model is
scored against its own float weights ("teacher") on a fixed eval batch,
through ``forward_seq``; deterministic for a given seed and device.

Metrics (all averaged over batch x sequence):
  * ``kl``         -- KL(teacher || student) over the vocab softmax; the
                      search's objective (0 = logit-identical).
  * ``pseudo_ppl`` -- exp(mean student NLL of the teacher's argmax token).
  * ``top1``       -- fraction of positions where the argmaxes agree.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device, tree_device


def eval_tokens(cfg, *, batch: int = 2, seq: int = 64, seed: int = 1234,
                device="cuda") -> torch.Tensor:
    """Deterministic eval inputs, drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (not the reference's ``jax.random`` draw;
    the tests hand both the same inputs): (batch, seq) tokens, or (batch,
    seq, d) standard-normal f32 embeddings for a family without a token
    embedding (``cfg.embed_input`` False), as the reference's."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    if not cfg.embed_input:
        return torch.randn(batch, seq, cfg.d_model, generator=g, device=dev)
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                         device=dev)


def _forward_logits(params, cfg, inputs) -> torch.Tensor:
    from repro_torch.models import transformer as T
    key = "tokens" if cfg.embed_input else "embeds"
    return T.forward_seq(params, cfg, **{key: inputs}).to(torch.float32)


def logit_metrics(teacher_logits, student_logits) -> Dict[str, float]:
    """Metrics from two (B, S, V) logit tensors (teacher = reference); one
    device -> host copy."""
    tl = torch.log_softmax(teacher_logits.to(torch.float32), dim=-1)
    sl = torch.log_softmax(student_logits.to(torch.float32), dim=-1)
    kl = torch.sum(torch.exp(tl) * (tl - sl), dim=-1)         # (B, S)
    labels = torch.argmax(teacher_logits, dim=-1)             # (B, S)
    nll = -torch.gather(sl, -1, labels[..., None])[..., 0]
    top1 = (torch.argmax(student_logits, dim=-1) == labels)
    kl_m, nll_m, top1_m = torch.stack(
        [kl.mean(), nll.mean(), top1.to(torch.float32).mean()]).tolist()
    return dict(kl=kl_m, pseudo_ppl=float(torch.exp(torch.tensor(nll_m))),
                top1=top1_m)


def quality_eval(teacher_params, student_params, cfg, *, inputs=None,
                 batch: int = 2, seq: int = 64, seed: int = 1234,
                 teacher_logits=None) -> Dict[str, float]:
    """Score ``student_params`` (typically quantized) against
    ``teacher_params`` (float) on a fixed eval batch. Pass
    ``teacher_logits`` to reuse the teacher forward across many student
    evaluations (the policy search's inner loop)."""
    if inputs is None:
        inputs = eval_tokens(cfg, batch=batch, seq=seq, seed=seed,
                             device=tree_device(student_params))
    if teacher_logits is None:
        teacher_logits = _forward_logits(teacher_params, cfg, inputs)
    student_logits = _forward_logits(student_params, cfg, inputs)
    return logit_metrics(teacher_logits, student_logits)


def teacher_logits_for(params, cfg, *, inputs=None, batch: int = 2,
                       seq: int = 64, seed: int = 1234):
    """(inputs, teacher_logits) pair for repeated student scoring."""
    if inputs is None:
        inputs = eval_tokens(cfg, batch=batch, seq=seq, seed=seed,
                             device=tree_device(params))
    return inputs, _forward_logits(params, cfg, inputs)
