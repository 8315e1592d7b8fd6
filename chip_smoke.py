#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with one NVIDIA GPU (it
is written for an H100). It imports neither JAX nor the JAX package.
Phases, each of which exits nonzero on failure:

1. build: compile every CUDA source of the port with nvcc, from the
   checkout's sources, and print the build time.
2. kernels: hold the fused Q2_K/Q3_K dequant-matmul kernel against its
   plain PyTorch version at tinyllama-1.1b's five (K, N) projection
   shapes, at decode M (``max_slots``) and prefill M (``prefill_batch *
   prefill_chunk``), with f32 and bf16 outputs; check that row 0 of an
   M=33 product equals the M=1 product bit for bit; and check that the
   reduced model's logits on the card agree with the CPU's plain path.
3. serve: full-width tinyllama-1.1b from random weights (seeded), packed
   with paper_llama_mix on the card, serves the paper's Table IV scenario
   (8 requests, 6-token prompts, 10 new tokens, 4 slots) through the
   port's Engine. The kernel launch counts are zeroed just before and
   read just after; every forward must launch 45 q2_k + 110 q3_k kernels.
   Greedy tokens must equal the engine's own generate_reference.
4. timing: the kernel's time for one forward's launches of each variant,
   at decode and prefill M, beside its bound, the plain version's time
   and torch.matmul on pre-dequantized bf16 weights.

Without a GPU, or outside a checkout, it exits nonzero and prints no
result. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# card peaks for bound_ms (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

TOL_F32 = 1e-5          # kernel vs plain, f32 out: summation order only
TOL_BF16 = 2.0 ** -7    # bf16 out: one bf16 ulp at the output's max
TOL_MODEL = 2.0 ** -7   # reduced model, card vs CPU: bf16 input flips

# tinyllama-1.1b's (K, N): wq/wo, wk/wv, w_gate/w_up, w_down, lm_head
SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
          (2048, 32000))
SERVE = dict(max_new_tokens=10, max_slots=4, decode_chunk=10, cache_len=64,
             prefill_batch=4, prefill_chunk=16, prefill_bucket=16)
N_REQUESTS, PROMPT_LEN = 8, 6
M_DECODE = SERVE["max_slots"]
M_PREFILL = SERVE["prefill_batch"] * SERVE["prefill_chunk"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def phase_build(build):
    t0 = time.perf_counter()
    paths = build.build()
    dt = time.perf_counter() - t0
    regs = [ln.strip() for out in build.build_log.values()
            for ln in out.splitlines() if "registers" in ln]
    print(f"[build] {sorted(paths)} in {dt:.1f}s; ptxas: "
          f"{regs[0] if regs else 'cached build'} ... "
          f"({len(regs)} kernel instantiations)", flush=True)


def phase_kernels(torch, Q, PB, dev):
    """Kernel vs plain at the main path's shapes; returns max abs error
    (f32 output) per variant."""
    g = torch.Generator(device=dev).manual_seed(1)
    max_abs = {}
    for variant in PB.VARIANTS:
        worst = 0.0
        for (K, N) in SHAPES:
            w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
            t = Q.quantize(variant, w)
            for M in (M_DECODE, M_PREFILL):
                x = torch.randn(M, K, generator=g, device=dev).bfloat16()
                y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
                ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
                yb = PB.bfp_matmul_cuda(x, t)
                rb = PB.bfp_matmul_plain(x, t)
                torch.cuda.synchronize()
                e32, e16 = rel_err(y, ref), rel_err(yb, rb)
                worst = max(worst, float((y - ref).abs().max()))
                print(f"[kernels] {variant} M={M:3d} K={K:5d} N={N:5d}: "
                      f"f32 rel {e32:.2e} (tol {TOL_F32:.0e}), bf16 rel "
                      f"{e16:.2e} (tol {TOL_BF16:.2e})", flush=True)
                check(bool(torch.isfinite(y).all()), "non-finite output")
                check(e32 <= TOL_F32, f"{variant} {M}x{K}x{N} f32 error")
                check(e16 <= TOL_BF16, f"{variant} {M}x{K}x{N} bf16 error")
        x = torch.randn(33, 2048, generator=g, device=dev).bfloat16()
        t = Q.quantize(variant, torch.randn(2048, 256, generator=g,
                                            device=dev))
        row_ok = torch.equal(PB.bfp_matmul_cuda(x, t)[0],
                             PB.bfp_matmul_cuda(x[:1], t)[0])
        print(f"[kernels] {variant} row 0 of M=33 == M=1 bit for bit: "
              f"{row_ok}", flush=True)
        check(row_ok, f"{variant}: a row depends on M")
        max_abs[variant] = worst
    return max_abs


def phase_small_model(torch, get_arch, get_policy, quantize_params,
                      to_device, T, dev):
    """Reduced tinyllama in f32: prefill + two decode steps through the
    kernel on the card against the plain path on the CPU."""
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    qp, _ = quantize_params(params, get_policy("paper_llama_mix"))
    qg = to_device(qp, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(3))
    lengths = torch.tensor([8, 5])
    outs = {}
    for name, p, d in (("cpu", qp, torch.device("cpu")), ("cuda", qg, dev)):
        cache = T.init_cache(cfg, 2, 32, dtype=torch.float32, device=d)
        h, cache = T.prefill_chunk(p, cfg, cache, tokens=toks.to(d), start=0,
                                   lengths=lengths.to(d))
        logits = [T.lm_logits(p, cfg, h[torch.arange(2, device=d),
                                        lengths.to(d) - 1])]
        pos = lengths.clone()
        nxt = torch.tensor([1, 2])
        for _ in range(2):
            lg, cache = T.decode_step(p, cfg, cache, tokens=nxt.to(d),
                                      position=pos.to(d))
            logits.append(lg)
            pos = pos + 1
            nxt = nxt + 1
        outs[name] = [lg.cpu() for lg in logits]
    errs = [rel_err(a, b) for a, b in zip(outs["cuda"], outs["cpu"])]
    print(f"[kernels] reduced model logits, card vs CPU plain path: rel "
          f"{max(errs):.2e} (tol {TOL_MODEL:.2e})", flush=True)
    check(max(errs) <= TOL_MODEL, "reduced model disagrees with the CPU")
    check(all(bool(torch.isfinite(lg).all()) for lg in outs["cuda"]),
          "non-finite logits")


def phase_serve(torch, np, cfg, qp, Engine, ServeConfig, PB, T, dev):
    eng = Engine(cfg, qp, ServeConfig(**SERVE), device=dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, PROMPT_LEN)]
               for _ in range(N_REQUESTS)]
    eng.generate(prompts[:M_DECODE])            # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    PB.reset_launches()
    t0 = time.perf_counter()
    results = eng.generate(prompts)             # the main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(PB.launches)
    s = dict(eng.stats)

    fwd = s["forwards"]
    print(f"[serve] {len(results)} requests in {wall:.3f}s: prefill "
          f"{s['prefill_tok_per_s']:.1f} tok/s ({s['prefill_groups']} "
          f"groups), decode {s['tok_per_s']:.1f} tok/s, {s['host_syncs']} "
          f"host syncs, {fwd} forwards", flush=True)
    for i, toks in enumerate(results):
        print(f"[serve] request {i}: {len(toks)} tokens {toks}", flush=True)
    per_fwd = {v: launches[v] / max(fwd, 1) for v in PB.VARIANTS}
    print(f"[serve] kernel launches: {launches} = {per_fwd} per forward",
          flush=True)
    check(fwd > 0 and launches == {"q2_k": 45 * fwd, "q3_k": 110 * fwd},
          f"expected 45 q2_k + 110 q3_k launches per forward, got "
          f"{launches} over {fwd} forwards")
    check(all(len(t) == SERVE["max_new_tokens"] for t in results),
          "a request did not get its 10 tokens")
    check(all(0 <= x < cfg.vocab_size for t in results for x in t),
          "token out of vocabulary")
    for lo in range(0, N_REQUESTS, M_DECODE):
        ref = eng.generate_reference(prompts[lo:lo + M_DECODE])
        check(ref == results[lo:lo + M_DECODE],
              f"requests {lo}..: generate != generate_reference")
    print("[serve] greedy tokens == generate_reference: True", flush=True)

    cache = T.init_cache(cfg, 1, 16, device=dev)
    h, _ = T.prefill_chunk(qp, cfg, cache, tokens=torch.tensor(
        [prompts[0]], device=dev), start=0,
        lengths=torch.tensor([PROMPT_LEN], device=dev))
    logits = T.lm_logits(qp, cfg, h[:, PROMPT_LEN - 1])
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "bad full-width logits")
    return launches, s


def _device_ms(torch, fn, reps):
    """Median device time of ``fn`` (many launches): the stream is held by
    a spin kernel while the host enqueues, so host overhead between
    launches does not count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(max(host_s, 1e-3) * 1.5 * 2e9))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timing(torch, qp, cfg, PB, Q, dev):
    """Per variant, one forward's launches at decode and prefill M."""
    layers = qp["layers"]
    mats = {"q2_k": [], "q3_k": []}
    for blk, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                      ("attn", "wo"), ("mlp", "w_gate"), ("mlp", "w_up"),
                      ("mlp", "w_down")):
        t = layers[blk][name]
        mats[t.variant] += [(t.layer(i), False) for i in range(cfg.n_layers)]
    mats[qp["lm_head"].variant].append((qp["lm_head"], True))
    g = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for variant, ws in mats.items():
        dense = [Q.dequantize(t, torch.bfloat16) for t, _ in ws]
        res = {}
        for phase, M in (("decode", M_DECODE), ("prefill", M_PREFILL)):
            # the LM head runs on one gathered row per sequence
            ms_ = [M_DECODE if head else M for _, head in ws]
            xs = {(m, t.shape[0]): torch.randn(
                m, t.shape[0], generator=g, device=dev).bfloat16()
                for m, (t, _) in zip(ms_, ws)}
            jobs = [(xs[(m, t.shape[0])], t, w)
                    for m, (t, _), w in zip(ms_, ws, dense)]
            kern = _device_ms(torch, lambda: [PB.bfp_matmul_cuda(x, t)
                                              for x, t, _ in jobs], 10)
            plain = _device_ms(torch, lambda: [PB.bfp_matmul_plain(x, t)
                                               for x, t, _ in jobs], 3)
            lib = _device_ms(torch, lambda: [torch.matmul(x, w)
                                             for x, _, w in jobs], 10)
            nbytes = sum(x.numel() * 2 + t.nbytes + x.shape[0] * t.shape[1]
                         * 2 for x, t, _ in jobs)
            flops = sum(2 * x.shape[0] * t.shape[0] * t.shape[1]
                        for x, t, _ in jobs)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / BF16_FLOPS_PER_S * 1e3
            res[phase] = dict(
                ms=kern, plain_ms=plain, library_ms=lib,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                launches_per_forward=len(jobs), bytes=nbytes, flops=flops)
            print(f"[timing] {variant} {phase} forward ({len(jobs)} "
                  f"launches, M={M}): kernel {kern:.3f} ms, bound "
                  f"{res[phase]['bound_ms']:.3f} ms ({res[phase]['bound_by']}"
                  f", {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                  f"plain {plain:.3f} ms, torch.matmul on bf16 {lib:.3f} ms",
                  flush=True)
        del dense
        out[variant] = res
    return out


def main() -> None:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc" / "bfp_matmul.cu").is_file():
        fail("run from a checkout of the repository: src/repro_torch is "
             "missing beside this script")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs.base import get_arch
    from repro_torch.core import quantize as Q
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import (quantize_params, to_device,
                                          variant_counts)
    from repro_torch.kernels import _build
    from repro_torch.kernels import bfp_matmul as PB
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_build(_build)
    max_abs = phase_kernels(torch, Q, PB, dev)
    phase_small_model(torch, get_arch, get_policy, quantize_params,
                      to_device, T, dev)

    cfg = get_arch("tinyllama-1.1b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    qp, report = quantize_params(params, get_policy("paper_llama_mix"))
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = variant_counts(report, qp)
    print(f"[serve] full-width {cfg.name} packed in "
          f"{time.perf_counter() - t0:.1f}s: {counts} matmuls", flush=True)
    check(counts == {"q2_k": 45, "q3_k": 110}, f"Table III layout: {counts}")
    launches, _ = phase_serve(torch, np, cfg, qp, Engine, ServeConfig, PB, T,
                              dev)
    timing = phase_timing(torch, qp, cfg, PB, Q, dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    kernels = []
    for v in PB.VARIANTS:
        dec = timing[v]["decode"]
        kernels.append({
            "name": f"bfp_matmul_{v}", "route": "cuda",
            "source": "src/repro_torch/csrc/bfp_matmul.cu",
            "replaces": "src/repro/kernels/bfp_matmul.py:89",
            "launches": launches[v], "max_abs_err": max_abs[v],
            "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"],
            "per": "the launches of one decode forward (M=max_slots)",
            "prefill": timing[v]["prefill"]})
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
