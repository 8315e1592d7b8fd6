"""Plain oracle for the BFP matmul (counterpart of ``repro.kernels.ref``).

``matmul_ref`` dequantizes to f32 and runs an f32 matmul with no bf16
rounding anywhere: the golden numerical reference the kernel and its plain
version are held against within a stated tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import QTensor, dequantize


def matmul_ref(x: torch.Tensor, t: QTensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """x: (..., K) float; t: packed (K, N). Returns (..., N)."""
    w = dequantize(t, dtype=torch.float32)
    return (x.to(torch.float32) @ w).to(out_dtype)
