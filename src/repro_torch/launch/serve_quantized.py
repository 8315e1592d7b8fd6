"""Serve a mixed-BFP-quantized model end to end: the port of
``examples/serve_quantized.py``, the paper's Table IV scenario (6-token
prompts, 10 generated tokens) through the continuous-batching engine: 6
requests share 2 batch slots, tokens stream through callbacks, and the
decode loop runs on the device (one host sync per fused chunk, not per
token).

  PYTHONPATH=src python -m repro_torch.launch.serve_quantized [--full] \\
      [--device cpu]

As in the reference the model is reduced tinyllama-1.1b under
``paper_llama_mix``; ``--full`` serves it at its published width. On the
GPU (the default; it raises where there is none) every packed MatMul runs
the hand-written kernel: with ``--full`` it launches 45 q2_k + 110 q3_k a
forward. With ``--device cpu`` the plain versions run. The weights are
drawn from a torch generator seeded with 0, not the reference's
``jax.random`` key; the tests hand both packages the same weights.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_arch
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import (quantize_params, quantized_param_bytes,
                                      variant_counts)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, ServeConfig

ARCH, POLICY = "tinyllama-1.1b", "paper_llama_mix"
REQUESTS = 6
PROMPT_LEN = 6
SERVE = dict(max_new_tokens=10, max_slots=2, decode_chunk=10, cache_len=32)


def make_prompts(cfg: ModelConfig) -> List[List[int]]:
    """The example's prompts: ``REQUESTS`` of ``PROMPT_LEN`` tokens from
    ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, PROMPT_LEN)]
            for _ in range(REQUESTS)]


def run(cfg: ModelConfig, params: Dict[str, Any], *, device="cuda",
        log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Pack the float ``params`` (on ``device``) with ``POLICY``, serve
    the example's prompts on 2 slots with an ``on_token`` callback on
    each, and check that the callbacks saw every token in order. Returns
    the engine, the prompts, ``results`` and ``streamed`` ({request id:
    tokens}), ``events`` (every callback's (request id, token) in call
    order), the tensors and MatMul layers a variant, the byte sizes and
    the engine's stats."""
    dev = resolve_device(device)
    qp, report = quantize_params(params, get_policy(POLICY))
    tensors: Dict[str, int] = {}
    for v in report.values():
        if v:
            tensors[v] = tensors.get(v, 0) + 1
    layers = variant_counts(report, qp)
    sizes = quantized_param_bytes(qp)
    log(f"quantized tensors by variant: {tensors} ({layers} MatMul layers)")
    log(f"packed {sizes['packed'] / 2**20:.1f} MiB + fp residual "
        f"{sizes['unpacked'] / 2**20:.1f} MiB")

    engine = Engine(cfg, qp, ServeConfig(**SERVE), device=dev)
    streamed: Dict[int, List[int]] = {}
    events: List[tuple] = []

    def on_token(rid: int, tok: int) -> None:
        streamed.setdefault(rid, []).append(tok)
        events.append((rid, tok))

    prompts = make_prompts(cfg)
    for p in prompts:
        engine.submit(p, on_token=on_token)
    results = engine.run()
    for rid, toks in sorted(results.items()):
        log(f"request {rid}: prompt {prompts[rid]} -> {toks}")
    if streamed != results:
        raise RuntimeError(f"the callbacks saw {streamed}, run() gave "
                           f"{results}")
    s = dict(engine.stats)
    log(f"prefill {s['prefill_s']:.3f}s; decode {s['decode_s']:.3f}s; "
        f"{s['tok_per_s']:.1f} tok/s; {s['host_syncs']} host syncs for "
        f"{s['requests']} requests over {s['chunks']} fused chunks "
        f"({SERVE['max_slots']} slots, continuous batching)")
    return dict(engine=engine, prompts=prompts, results=results,
                streamed=streamed, events=events, tensors=tensors,
                layers=layers, sizes=sizes, stats=s)


def main(argv=None) -> Dict[str, Any]:
    """Run the flow on ``argv``; returns ``run``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: reduced, as the "
                         "reference example)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(ARCH, reduced=not args.full)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    return run(cfg, params, device=dev)


if __name__ == "__main__":
    main()
