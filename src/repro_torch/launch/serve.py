"""Serving launcher: quantize a model with a mixed BFP policy and serve a
queue of requests through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy paper_llama_mix --tokens 10 --requests 8 --slots 4

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy extended_mix --prompt-len 384 --prefill-chunk 128 \
      --prefill-bucket 128 --cache-len 1024 --tokens 32

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy auto --policy-json results/auto_tinyllama.json

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --policy auto --search-rounds 1

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --policy paper_llama_mix --temperature 0.8 --seed 7 --stream

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy paper_llama_mix --tokens 32 --drafter ngram --draft-k 4 \
      --prefix-cache --shared-prefix 64 --max-queue 16 --preempt

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy paper_llama_mix --disagg --prefill-workers 2 \
      --decode-workers 2 --shared-prefix 20 --prompt-len 18 --prefix-page 8

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy paper_llama_mix --http --port 8000 --request-timeout 60

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --policy paper_llama_mix --tp 2 --tp-matmul sliced

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --prompt-len 384 --prefill-chunk 128 --cache-len 1024 --tokens 32 \
      --prefix-cache --shared-prefix 384 --prefix-bytes 1073741824

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --disagg --tp 2 --force-host-devices 2 --shared-prefix 20 \
      --prompt-len 18 --prefix-page 8

``--tp N`` serves on N ranks, one process each (rank r on cuda:r, so
N cards; ``--force-host-devices N`` runs them on the CPU instead, and
``--device`` may list one device a rank, ``cuda:0,cuda:0`` putting two
ranks on one card), with ``--tp-matmul`` padded|sliced|sliced_row and
``--no-tp-ep``; ssm and hybrid archs refuse it. With ``--disagg`` every
prefill and decode worker is an N-rank engine, all on one group of N
ranks and one weight shard set a rank. The engine prints its backend:
NCCL with a card a rank, gloo on the host.

``--policy auto`` loads the searched policy file ``--policy-json`` if it
exists (recalibrating first when a rule asks for q3_k_o, whose outlier
rows follow the activation stats) and otherwise runs the policy search
(``launch/policy_search.py``, ``--search-rounds`` refinement rounds),
writes the file and packs with the stats the search used.

Every dense config of the port serves (``--arch`` llama3.2-1b,
qwen3-1.7b, phi3-mini-3.8b, h2o-danube-1.8b, tinyllama-1.1b,
mobilellama-1.4b), gpt2-paper, the MoE configs (olmoe-1b-7b,
granite-moe-3b-a800m) and the recurrent ones (mamba2-2.7b, zamba2-1.2b)
under any policy, ``--policy auto`` included. qwen2-vl-72b and
musicgen-large take embeddings, not tokens, so the launcher refuses
them, as the reference's does; ``training.steps.make_serve_steps``
serves them. For ssm and hybrid
the chunk is clamped down to a divisor of ``--cache-len`` and
``--prefix-page`` is ignored: a checkpoint page is one prefill chunk.
``--temperature T`` samples (0, the default, is greedy), ``--eos-id``
ends a request at that token,
``--stream`` prints each token as it is emitted and ``--no-quant`` serves
the float weights (plain ``torch.matmul``, no kernel). ``--drafter``
(``ngram`` or ``self``) turns on speculative decoding (``--draft-k``,
``--draft-layers``, ``--draft-ngram``, ``--draft-verify``),
``--prefix-cache`` the prefix cache (``--prefix-page``,
``--prefix-bytes``; ``--shared-prefix N`` prepends N shared tokens to
every prompt, the workload it serves), and ``--max-queue``/``--preempt``
SLO admission; the stats line then reports acceptance and prefix reuse.
``--disagg`` serves through ``--prefill-workers`` prefill and
``--decode-workers`` decode engines behind the KV-aware router (KV-ring
families only: on mamba2-2.7b or zamba2-1.2b it raises the
``DisaggEngine``'s ValueError), and its stats line gains the router's
counts. ``--http`` serves the HTTP front end on ``--host``/``--port``
(``--request-timeout`` the default per-request ceiling) over either
engine, instead of draining the synthetic queue; it blocks until
interrupted.
The weights, the prompts and the sampling stream are random, drawn from
``--seed`` (default 0). The model runs on the GPU (``--device cuda``, the
default; it raises where there is none). Add ``--reduced --device cpu``
for a small run on the CPU through the kernel's plain PyTorch version.
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
from repro_torch.serving.disagg import DisaggEngine
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
    engine after its run and ``{request id: tokens}`` (``{}`` under
    ``--http``, once the server stops)."""
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
    ap.add_argument("--drafter", default=None, choices=("ngram", "self"),
                    help="enable speculative decoding with this drafter "
                         "(greedy output stays plain decode's)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="drafted tokens per verify round")
    ap.add_argument("--draft-layers", type=int, default=2,
                    help="self-drafter: how many leading layers of the "
                         "model draft (same packed weights)")
    ap.add_argument("--draft-ngram", type=int, default=2,
                    help="ngram drafter: match gram length")
    ap.add_argument("--draft-verify", default="scan",
                    choices=("scan", "batched"),
                    help="verify datapath: 'scan' gives plain decode's "
                         "logits bit for bit, 'batched' scores the whole "
                         "draft block in one masked forward")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the prefix cache: admission reuses the "
                         "longest cached token prefix and prefills only "
                         "the suffix (greedy output stays the same)")
    ap.add_argument("--prefix-page", type=int, default=16,
                    help="positions per KV page (clamped to a divisor of "
                         "the ring length; the recurrent families, ssm "
                         "and hybrid, pin the page to --prefill-chunk "
                         "instead and ignore this flag)")
    ap.add_argument("--prefix-bytes", type=int, default=64 << 20,
                    help="device byte budget for the page pool (LRU "
                         "eviction of unreferenced pages beyond it)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens "
                         "to every request (the prefix-cache workload)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: submit() beyond this "
                         "depth raises EngineSaturated; 0 = unbounded")
    ap.add_argument("--preempt", action="store_true",
                    help="let a strictly higher-priority queued request "
                         "preempt the lowest-priority running slot")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: prefill-worker and "
                         "decode-worker engines behind a KV-aware radix "
                         "router; prefilled KV pages migrate to the decode "
                         "tier (routed output stays the monolithic "
                         "engine's tokens)")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="prefill-tier engines (--disagg)")
    ap.add_argument("--decode-workers", type=int, default=1,
                    help="decode-tier engines (--disagg)")
    ap.add_argument("--http", action="store_true",
                    help="serve an OpenAI-style HTTP front end (POST "
                         "/v1/completions with a token-id prompt, SSE "
                         "streaming, per-request priority/deadline_s/"
                         "timeout_s; GET /health, /v1/models, /stats) "
                         "instead of draining a synthetic queue")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--http listen address")
    ap.add_argument("--port", type=int, default=8000,
                    help="--http listen port (0 = ephemeral)")
    ap.add_argument("--request-timeout", type=float, default=120.0,
                    help="--http default per-request wall ceiling in "
                         "seconds (a request's timeout_s overrides it)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: this many ranks, one "
                         "process each (lane-only sharding; greedy output "
                         "stays --tp 1's under --tp-matmul padded). On the "
                         "card rank r takes cuda:r: it needs --tp cards")
    ap.add_argument("--tp-matmul", default="padded",
                    choices=("padded", "sliced", "sliced_row"),
                    help="TP projection datapath: 'padded' keeps the "
                         "single-device product shape on every rank (tp=1's "
                         "bits; weights and KV still sharded), 'sliced' "
                         "runs the lane-sliced products (1/tp of the work "
                         "a rank, within an f32 ulp), 'sliced_row' adds "
                         "row-parallel o-/down-projections (half the "
                         "collectives a layer; within a few activation-"
                         "dtype ulps)")
    ap.add_argument("--no-tp-ep", dest="tp_ep", action="store_false",
                    help="no expert parallelism under --tp for MoE archs "
                         "(by default expert stacks shard over the ranks "
                         "when n_experts divides --tp; the tokens are the "
                         "same either way)")
    ap.add_argument("--force-host-devices", type=int, default=None,
                    help="serve on this many host (CPU) ranks: the CPU "
                         "stand-in for --tp cards (also read from "
                         "REPRO_FORCE_HOST_DEVICES); --device cuda with it "
                         "is an error")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; under --tp N also a "
                         "comma-separated list of N devices, one a rank "
                         "(cuda:0,cuda:0 puts two ranks on one card)")
    args = ap.parse_args(argv)

    host = args.force_host_devices
    if host is None and os.environ.get("REPRO_FORCE_HOST_DEVICES"):
        host = int(os.environ["REPRO_FORCE_HOST_DEVICES"])
    if host is not None:
        if args.device not in (None, "cpu"):
            raise SystemExit(f"--force-host-devices {host} runs the ranks on "
                             f"the host; it cannot serve on --device "
                             f"{args.device}")
        if args.tp > host:
            raise SystemExit(f"--tp {args.tp} needs {args.tp} ranks but "
                             f"--force-host-devices gives {host}")
        args.device = "cpu"
    ranks = None                # the engines' device argument, a list of
                                # one device a rank where one was given
    if args.device is not None and "," in args.device:
        ranks = [d.strip() for d in args.device.split(",")]
        if len(ranks) != args.tp:
            raise SystemExit(f"--device lists {len(ranks)} devices for "
                             f"--tp {args.tp}: give one a rank")
    dev = resolve_device(ranks[0] if ranks else args.device or "cuda")
    cfg = get_arch(args.arch, reduced=args.reduced)
    if not cfg.embed_input:
        raise SystemExit(f"{args.arch} has a stub modality frontend; "
                         "the serve launcher needs token inputs")
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

    decode_chunk = args.chunk or args.tokens
    if args.drafter is not None:
        decode_chunk = max(decode_chunk, args.draft_k + 1)
    scfg = ServeConfig(max_new_tokens=args.tokens,
                       temperature=args.temperature, eos_id=args.eos_id,
                       cache_len=args.cache_len, seed=args.seed,
                       max_slots=args.slots, decode_chunk=decode_chunk,
                       prefill_batch=args.prefill_batch,
                       prefill_chunk=args.prefill_chunk,
                       prefill_bucket=args.prefill_bucket,
                       drafter=args.drafter, draft_k=args.draft_k,
                       draft_layers=args.draft_layers,
                       draft_ngram=args.draft_ngram,
                       draft_verify=args.draft_verify,
                       prefix_cache=args.prefix_cache,
                       prefix_page=args.prefix_page,
                       prefix_bytes=args.prefix_bytes,
                       max_queue=args.max_queue, preempt=args.preempt,
                       tp=args.tp, tp_matmul=args.tp_matmul, tp_ep=args.tp_ep)
    if args.tp > 1:
        print(f"tensor-parallel: tp={args.tp} ({args.tp_matmul} matmul, "
              f"expert parallelism {'on' if args.tp_ep else 'off'}) on "
              f"{dev.type}")
    if args.disagg:
        print(f"disaggregated: {args.prefill_workers} prefill + "
              f"{args.decode_workers} decode worker(s), KV-aware router")
        engine = DisaggEngine(cfg, qp, scfg,
                              prefill_workers=args.prefill_workers,
                              decode_workers=args.decode_workers,
                              device=ranks or dev)
    else:
        engine = Engine(cfg, qp, scfg, device=ranks or dev)
    if args.http:
        from repro_torch.serving.frontend import FrontendConfig, serve_forever
        try:
            serve_forever(engine, FrontendConfig(
                host=args.host, port=args.port, model_name=args.arch,
                request_timeout_s=args.request_timeout,
                max_tokens_default=args.tokens))
        finally:
            _close(engine)
        return engine, {}
    on_token = None
    if args.stream:
        on_token = lambda rid, tok: print(f"  [req {rid}] += {tok}")
    rng = np.random.default_rng(args.seed)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size,
                                           args.shared_prefix)]
    ids = [engine.submit(shared + [int(t) for t in rng.integers(
        0, cfg.vocab_size, args.prompt_len)], on_token=on_token)
           for _ in range(args.requests)]
    results = engine.run()
    for rid in ids[:4]:
        print(f"req {rid}: {results[rid]}")
    s = engine.stats
    spec = prefix = disagg = ""
    if args.drafter is not None:
        spec = (f", spec accept {s['accept_rate']:.0%} "
                f"({s['draft_accepted']}/{s['draft_tokens']} drafts over "
                f"{s['spec_rounds']} rounds)")
    if args.prefix_cache:
        hits = s["prefix_hits"] / s["admissions"] if s["admissions"] else 0.0
        prefix = (f", prefix hits {hits:.0%} ({s['prefix_tokens_reused']} "
                  f"tokens reused, {s['prefix_evictions']} evictions, "
                  f"{s['prefix_insert_drops']} insert drops)")
    if args.disagg:
        rt = s["router"]
        disagg = (f", router: {rt['migrated_pages_total']} pages migrated, "
                  f"prefill hit rates {rt['prefill_hit_rate']}, "
                  f"{rt['direct_decode']} direct-to-decode, peak depths "
                  f"P{rt['prefill_peak_depth']}/D{rt['decode_peak_depth']}"
                  f", hand-off {s['handoff_s'] * 1e3:.1f} ms for "
                  f"{s['handoff_bytes']} bytes")
    print(f"prefill {s['prefill_s']:.3f}s ({s['prefill_tok_per_s']:.1f} "
          f"tok/s, {s['prefill_groups']} groups, mean ttft "
          f"{s['ttft_s'] * 1e3:.1f}ms), decode {s['decode_s']:.3f}s, "
          f"{s['tok_per_s']:.1f} tok/s ({s['tokens']} tokens, "
          f"{s['host_syncs']} host syncs / {s['requests']} requests, "
          f"{s['chunks']} chunks{spec}{prefix}{disagg}) on {dev}")
    _close(engine)
    return engine, results


def _close(engine) -> None:
    """Stop a tensor-parallel engine's worker ranks: an ``Engine``'s, or
    every worker of a ``DisaggEngine`` and their group."""
    close = getattr(engine, "close", None)
    if close is not None:
        close()


if __name__ == "__main__":
    main()
