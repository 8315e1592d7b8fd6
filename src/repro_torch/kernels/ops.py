"""Public fused BFP-matmul entry point (counterpart of ``repro.kernels.ops``).

``impl`` selects the datapath:
  * "cuda"  -- the hand-written kernel (``csrc/bfp_matmul.cu``); the
               weight stays packed in device memory. CUDA tensors only.
  * "torch" -- the kernel's plain PyTorch version (dequantize, then f32
               matmul); what CPU tensors run.
  * "ref"   -- the f32 oracle (``kernels.ref.matmul_ref``).
  * "auto"  -- "cuda" for a CUDA tensor, "torch" for a CPU tensor. A CUDA
               tensor launches the kernel or raises; nothing falls back.

As in the reference, x and the dequantized weight are cast to
``compute_dtype`` (bf16 by default, for every model dtype) and the
products accumulate in f32 with one cast at the end.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bfp_matmul import bfp_matmul_cuda, bfp_matmul_plain


def bfp_matmul(x: torch.Tensor, t: QTensor, *, impl: str = "auto",
               compute_dtype=torch.bfloat16,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (..., K) activation; t: packed (K, N) weights. Returns (..., N)."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if impl == "cuda":
        out = bfp_matmul_cuda(x2.contiguous(), t, compute_dtype=compute_dtype,
                              out_dtype=out_dtype)
    elif impl == "torch":
        out = bfp_matmul_plain(x2, t, compute_dtype=compute_dtype,
                               out_dtype=out_dtype)
    elif impl == "ref":
        out = _ref.matmul_ref(x2, t, out_dtype=out_dtype)
    else:
        raise ValueError(f"unknown impl {impl!r}; known: cuda, torch, ref, "
                         "auto")
    return out.reshape(*lead, t.shape[1])
