"""Quickstart: quantize a weight matrix with the paper's two BFP variants,
run the fused MatMul kernel, and check it against the oracle -- the F-BFQ
accelerator datapath in five steps. The port of ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

On the GPU (the default; it raises where there is none) steps 2 and 4 run
the hand-written CUDA kernels (the dequant-matmul and the Q8_K
quantization); with ``--device cpu`` their plain PyTorch versions. The
kernel computes in bf16, as the port's serving path does, where the
reference's example asks its kernel for f32, so step 2's error is about a
bf16 rounding (~1e-3), not the reference's ~1e-7.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.quantize import quantize
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

M, K, N = 16, 1024, 512


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (M, K), dtype=np.float32)).to(dev)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (K, N), dtype=np.float32) * np.float32(0.1)).to(dev)

    for variant in ("q2_k", "q3_k"):
        # 1) quantize weights to the packed BFP format (llama.cpp semantics)
        t = quantize(variant, w)
        bits = t.nbytes * 8.0 / (K * N)
        print(f"[{variant}] packed {w.numel() * 4 / 2**20:.2f} MiB fp32 -> "
              f"{t.nbytes / 2**20:.2f} MiB ({bits} bits/weight)")

        # 2) fused dequant-matmul kernel (its plain version on the CPU)
        out = ops.bfp_matmul(x, t, out_dtype=torch.float32)

        # 3) oracle check
        expect = ref.matmul_ref(x, t)
        print(f"[{variant}] kernel vs oracle rel err {_rel(out, expect):.2e}")

        # 4) the paper's integer datapath (Q8_K activations, per-block int
        #    dots); the quantization is the Q8_K kernel on the card
        qx = ops.q8k_quantize(x)
        out_int = ref.matmul_q8k_ref(qx, t)
        print(f"[{variant}] integer (Q8_K) datapath vs dequant err "
              f"{_rel(out_int, expect):.2e}")

        # 5) micro-ISA driver + functional accelerator simulator (Table I)
        out_sim, stats = isa.run_matmul(x, t, device=dev)
        print(f"[{variant}] ISA sim: {stats.schedules} schedules, "
              f"{stats.total_stream_bytes / 2**20:.2f} MiB streamed\n")


if __name__ == "__main__":
    main()
