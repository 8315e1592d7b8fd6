"""Serving launcher: quantize a model with a mixed BFP policy and serve a
queue of requests through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy paper_llama_mix --tokens 10 --requests 8 --slots 4

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy extended_mix --prompt-len 384 --prefill-chunk 128 \
      --prefill-bucket 128 --cache-len 1024 --tokens 32

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy auto --policy-json results/auto_tinyllama.json

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --policy paper_llama_mix --temperature 0.8 --seed 7 --stream

``--policy auto`` loads the searched policy file ``--policy-json`` if it
exists (recalibrating first when a rule asks for q3_k_o, whose outlier
rows follow the activation stats) and otherwise runs the policy search
(``launch/policy_search.py``, ``--search-rounds`` refinement rounds),
writes the file and packs with the stats the search used.

Every dense config of the port serves (``--arch`` llama3.2-1b,
qwen3-1.7b, phi3-mini-3.8b, h2o-danube-1.8b, tinyllama-1.1b,
mobilellama-1.4b) and gpt2-paper. ``--temperature T`` samples (0, the
default, is greedy), ``--eos-id`` ends a request at that token,
``--stream`` prints each token as it is emitted and ``--no-quant`` serves
the float weights (plain ``torch.matmul``, no kernel). The weights, the
prompts and the sampling stream are random, drawn from ``--seed``
(default 0). The model runs on the GPU (``--device cuda``, the default;
it raises where there is none). Add ``--reduced --device cpu`` for a
small run on the CPU through the kernel's plain PyTorch version.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import calibrate as CAL
from repro_torch.core.policy import get_policy, load_policy
from repro_torch.core.qlinear import (quantize_params, quantized_param_bytes,
                                      variant_counts)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, ServeConfig


def resolve_policy(cfg, params, *, policy: str, arch: str,
                   policy_json=None, search_rounds: int = 2,
                   device="cuda"):
    """(QuantPolicy, calib, info) for ``--policy``: a named preset, or
    "auto", which loads ``policy_json`` (default
    ``results/auto_<arch>.json``) if it exists and otherwise searches and
    writes it. ``calib`` maps parameter paths to the activation abs-max
    that q3_k_o packing uses (None for a preset); ``info`` is the
    search's (None unless it ran). As in the reference, a loaded file with
    a q3_k_o rule recalibrates, and the stats are looked up by the rules'
    patterns: a glob rule such as ``*mlp/w_gate`` matches no tap name, so
    that rule packs without them."""
    if policy != "auto":
        return get_policy(policy), None, None
    from repro_torch.launch.policy_search import (save_searched_policy,
                                                  search_policy)
    path = policy_json or f"results/auto_{arch}.json"
    if os.path.exists(path):
        pol = load_policy(path)
        print(f"loaded searched policy from {path}")
        calib = None
        if any(v == "q3_k_o" for _, v in pol.rules):
            # q3_k_o weighs outliers by activation abs-max; redo the
            # (cheap, deterministic) calibration pass
            stats = CAL.run_calibration(params, cfg)
            calib = stats.for_paths([p for p, _ in pol.rules])
        return pol, calib, None
    pol, info = search_policy(cfg, params, arch=arch, rounds=search_rounds,
                              device=device)
    save_searched_policy(path, pol, info)
    print(f"searched policy written to {path}")
    # pack with the activation stats the search's verified evals used
    return pol, info["stats"].for_paths([p for p, _ in pol.rules]), info


def main(argv=None):
    """Run the launcher on ``argv``; returns ``(engine, results)``, the
    engine after its run and ``{request id: tokens}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="default_serve_mix",
                    help="named policy from core.policy.POLICIES, or "
                         "'auto' to load/search a calibrated per-layer "
                         "assignment (see --policy-json)")
    ap.add_argument("--policy-json", default=None,
                    help="searched-policy JSON for --policy auto; if the "
                         "file exists it is loaded, otherwise the search "
                         "runs and writes it (default: "
                         "results/auto_<arch>.json)")
    ap.add_argument("--search-rounds", type=int, default=2,
                    help="refinement rounds for the --policy auto search")
    ap.add_argument("--no-quant", action="store_true",
                    help="serve the float weights (no packing, no kernel)")
    ap.add_argument("--requests", type=int, default=4,
                    help="queue depth (may exceed --slots)")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent batch slots")
    ap.add_argument("--chunk", type=int, default=0,
                    help="decode steps per host sync (0 = --tokens)")
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--prefill-batch", type=int, default=8,
                    help="max requests per batched prefill group")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="tokens per prefill chunk (long prompts stream "
                         "through it chunk by chunk)")
    ap.add_argument("--prefill-bucket", type=int, default=16,
                    help="prompt pad granularity")
    ap.add_argument("--prompt-len", type=int, default=6)   # paper: 6 tokens
    ap.add_argument("--tokens", type=int, default=10)      # paper: 10 tokens
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the prompts and the sampling")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they are emitted")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=dev)
    if args.no_quant:
        qp = params
        print("serving UNQUANTIZED (baseline)")
    else:
        t0 = time.perf_counter()
        policy, calib, _ = resolve_policy(
            cfg, params, policy=args.policy, arch=args.arch,
            policy_json=args.policy_json, search_rounds=args.search_rounds,
            device=dev)
        qp, report = quantize_params(params, policy, calib=calib)
        del params
        sizes = quantized_param_bytes(qp)
        print(f"quantized with policy {args.policy} in "
              f"{time.perf_counter() - t0:.1f}s: "
              f"{variant_counts(report, qp)} matmuls; packed "
              f"{sizes['packed'] / 2**20:.1f} MiB + residual "
              f"{sizes['unpacked'] / 2**20:.1f} MiB")

    scfg = ServeConfig(max_new_tokens=args.tokens,
                       temperature=args.temperature, eos_id=args.eos_id,
                       cache_len=args.cache_len, seed=args.seed,
                       max_slots=args.slots,
                       decode_chunk=args.chunk or args.tokens,
                       prefill_batch=args.prefill_batch,
                       prefill_chunk=args.prefill_chunk,
                       prefill_bucket=args.prefill_bucket)
    engine = Engine(cfg, qp, scfg, device=dev)
    on_token = None
    if args.stream:
        on_token = lambda rid, tok: print(f"  [req {rid}] += {tok}")
    rng = np.random.default_rng(args.seed)
    ids = [engine.submit([int(t) for t in rng.integers(0, cfg.vocab_size,
                                                       args.prompt_len)],
                         on_token=on_token)
           for _ in range(args.requests)]
    results = engine.run()
    for rid in ids[:4]:
        print(f"req {rid}: {results[rid]}")
    s = engine.stats
    print(f"prefill {s['prefill_s']:.3f}s ({s['prefill_tok_per_s']:.1f} "
          f"tok/s, {s['prefill_groups']} groups, mean ttft "
          f"{s['ttft_s'] * 1e3:.1f}ms), decode {s['decode_s']:.3f}s, "
          f"{s['tok_per_s']:.1f} tok/s ({s['tokens']} tokens, "
          f"{s['host_syncs']} host syncs / {s['requests']} requests, "
          f"{s['chunks']} chunks) on {dev}")
    return engine, results


if __name__ == "__main__":
    main()
