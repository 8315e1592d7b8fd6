"""Explore mixed-quantization policies: the quality-against-size trade-off
across the BFP variant ladder (the paper's Fig. 1 motivation and the
future-work variants). The port of ``examples/mixed_quant_policy.py``.

  PYTHONPATH=src python -m repro_torch.launch.mixed_quant_policy [--device cpu]

For each of six policies (pure q2_k, q3_k, q4_k and q6_k,
``paper_llama_mix``, ``extended_mix``) it packs the float weights,
prints the model's bytes in MiB and KL(f32 weights || packed) over the
vocabulary, averaged over a (2, 32) token batch, through
``core/quality.py`` (the policy search's metric). As in the reference the
model is reduced llama3.2-1b. On the GPU (the default; it raises where
there is none) every packed MatMul runs the hand-written kernel
(llama3.2-1b's LM head is tied to the embedding: an f32 product, no
kernel). The weights and tokens are drawn from torch generators seeded
with 0 and 1, not the reference's ``jax.random`` keys; the tests hand
both packages the same ones.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, List

import torch

from repro_torch.configs.base import ModelConfig, get_arch
from repro_torch.core import quality
from repro_torch.core.policy import QuantPolicy, get_policy, pure
from repro_torch.core.qlinear import quantize_params, quantized_param_bytes
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

BATCH, SEQ = 2, 32


def policies() -> List[QuantPolicy]:
    """The example's six policies, in its order."""
    return [pure("q2_k"), pure("q3_k"), pure("q4_k"), pure("q6_k"),
            get_policy("paper_llama_mix"), get_policy("extended_mix")]


def run(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor, *,
        log: Callable[[str], None] = print) -> List[Dict[str, Any]]:
    """One row a policy: its name, the packed model's bytes (``sizes``,
    as ``quantized_param_bytes`` gives them) and its metrics against the
    float weights on ``tokens``."""
    _, teacher = quality.teacher_logits_for(params, cfg, inputs=tokens)
    log(f"{'policy':24s} {'MiB':>8s} {'KL(fp||q)':>10s}")
    rows = []
    for pol in policies():
        qp, _ = quantize_params(params, pol)
        sizes = quantized_param_bytes(qp)
        m = quality.quality_eval(params, qp, cfg, inputs=tokens,
                                 teacher_logits=teacher)
        log(f"{pol.name:24s} {sizes['total'] / 2**20:8.1f} {m['kl']:10.4f}")
        rows.append(dict(policy=pol.name, sizes=sizes, **m))
        del qp
    return rows


def main(argv=None) -> List[Dict[str, Any]]:
    """Run the flow on ``argv``; returns ``run``'s rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_arch("llama3.2-1b", reduced=True)
    dev = resolve_device(args.device)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tokens = quality.eval_tokens(cfg, batch=BATCH, seq=SEQ, seed=1,
                                 device=dev)
    return run(cfg, params, tokens)


if __name__ == "__main__":
    main()
