"""Time the port's fused matmul kernel and read its f32 error against the
exact product, at decode and prefill shapes, on one CUDA card.

    python3 scripts/matmul_vs_exact.py [ROOT]

ROOT is a checkout of the repository (default: this one); its
``src/repro_torch`` is imported and its kernels are built, so two versions
are compared on one card by running the script once for each, back to
back on one machine (parent, change, change, parent). Each shape prints
one line: the kernel's time between CUDA events (mean of 50 launches
after 5), its f32 output's largest error relative to the output's
largest magnitude against the f64 product of the same bf16 x and bf16
dequantized weight, and the kernel's K splits. The last line is a JSON
object of the same.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

# (variant, K, N, M): qwen2-vl-72b's head, w_gate/w_up and w_down and
# tinyllama-1.1b's shapes at decode (M = 4); prefill and search M
SHAPES = (("q2_k", 8192, 152064, 4), ("q3_k", 8192, 29568, 4),
          ("q8_0", 29568, 8192, 4), ("q3_k", 2048, 5632, 4),
          ("q3_k", 2048, 2048, 4), ("q2_k", 2048, 256, 4),
          ("q3_k", 2048, 5632, 512), ("q4_k", 2048, 5632, 512),
          ("q3_k", 8192, 29568, 512), ("q3_k", 2048, 5632, 128))
EXACT_COLS = 16384      # f64 columns at once
WARMUP, REPS = 5, 50


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.core import quantize as Q
    from repro_torch.kernels import bfp_matmul as PB
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for variant, K, N, M in SHAPES:
        w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
        t = Q.quantize(variant, w)
        del w
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
        wb = Q.dequantize(t, dtype=torch.float32).bfloat16()
        exact = torch.cat([x.double() @ wb[:, j:j + EXACT_COLS].double()
                           for j in range(0, N, EXACT_COLS)], 1)
        err = float((y.double() - exact).abs().max() / exact.abs().max())
        del wb, exact
        for _ in range(WARMUP):
            PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / REPS
        splits = PB.k_splits(K, N)
        out[f"{variant} {K}x{N} M={M}"] = dict(ms=ms, rel_vs_exact=err,
                                               k_splits=splits)
        print(f"{root.name} {variant} ({K}, {N}) M={M}: {ms:.4f} ms, "
              f"kernel vs exact {err:.2e}, K in {splits} part(s)",
              flush=True)
    print(json.dumps({"root": str(root), "shapes": out}))


if __name__ == "__main__":
    main()
