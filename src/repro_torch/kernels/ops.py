"""Public kernel entry points (counterpart of ``repro.kernels.ops``): the
fused BFP matmul and the Q8_K activation quantization.

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

from typing import Dict, Optional

import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bfp_matmul import bfp_matmul_cuda, bfp_matmul_plain
from repro_torch.kernels.q8k_quant import (q8k_quantize_cuda,
                                           q8k_quantize_plain)


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


def q8k_quantize(x: torch.Tensor, *, valid: Optional[torch.Tensor] = None,
                 impl: str = "auto") -> Dict[str, torch.Tensor]:
    """Quantize activations (..., K) to the Q8_K payload dict, the input
    format of the integer datapath (``ref.matmul_q8k_ref``, the ISA
    simulator). Leading dims flatten into the kernel's rows. ``valid``: an
    optional boolean mask over the leading dims; masked rows give all-zero
    payloads. ``impl``: "cuda" (the kernel), "torch" (its plain version)
    or "auto": the kernel for a CUDA tensor, which launches or raises, the
    plain version for a CPU tensor."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    v2 = None if valid is None else valid.reshape(-1)
    if impl == "cuda":
        q = q8k_quantize_cuda(x2.contiguous(), v2)
    elif impl == "torch":
        q = q8k_quantize_plain(x2, v2)
    else:
        raise ValueError(f"unknown impl {impl!r}; known: cuda, torch, auto")
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in q.items()}
