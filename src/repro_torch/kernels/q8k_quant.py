"""Q8_K activation quantization: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``repro.kernels.q8k_quant`` (``q8k_quantize_pallas``). The
integer (Q8_K) datapath -- ``kernels.ref.matmul_q8k_ref`` and the ISA
simulator's SCHEDULE (``core/isa.py``) -- quantizes its activations with
it; the serving matmuls take float activations and never do. Per 256-value
super-block of each row: ``d = absmax / 127``, ``qs = clip(round(x / d),
-127, 127)`` as int8 and the int16 sums of each 16-value block of ``qs``
(``bsums``, which the Q2_K min correction consumes). An optional ``valid``
row mask gives masked rows (batch padding) all-zero payloads.

``q8k_quantize_plain`` is the same function in plain PyTorch
(``core.quantize.quantize_q8_k`` after the mask). CPU tensors take it; on
the card it is what the kernel is checked against, byte for byte.
``q8k_quantize_cuda`` launches the kernel (``csrc/q8k_quant.cu``, CUDA C++
for sm_90a; its source note gives its bound and design).

``launches["q8k_quantize"]`` counts kernel launches: the wrapper adds one
where it launches and nowhere else.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.quantize import quantize_q8_k
from repro_torch.kernels import _build

launches: Dict[str, int] = {"q8k_quantize": 0}

# x dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    launches["q8k_quantize"] = 0


def q8k_quantize_plain(x: torch.Tensor, valid: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """x: (M, K), K % 256 == 0; valid: optional (M,) bool row mask.
    Returns dict(qs int8 (M, K), d f32 (M, K/256), bsums int16 (M, K/16))."""
    xf = x.to(torch.float32)
    if valid is not None:
        xf = torch.where(valid.to(torch.bool)[:, None], xf,
                         torch.zeros((), dtype=torch.float32,
                                     device=x.device))
    return quantize_q8_k(xf)


def q8k_quantize_cuda(x: torch.Tensor, valid: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Launch the CUDA kernel on the current stream. Same arguments and
    result as ``q8k_quantize_plain``; raises on anything the kernel does
    not take."""
    if not x.is_cuda:
        raise ValueError("the CUDA kernel needs a CUDA tensor")
    if x.dim() != 2 or x.shape[1] % 256 or x.shape[1] == 0:
        raise ValueError(f"x must be (M, K) with K % 256 == 0, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes x in float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    M, K = x.shape
    v = None
    if valid is not None:
        if tuple(valid.shape) != (M,) or valid.device != x.device:
            raise ValueError(f"valid must be ({M},) on {x.device}, got "
                             f"{tuple(valid.shape)} on {valid.device}")
        v = valid.to(torch.bool).contiguous().view(torch.uint8)
    qs = torch.empty((M, K), dtype=torch.int8, device=x.device)
    d = torch.empty((M, K // 256), dtype=torch.float32, device=x.device)
    bsums = torch.empty((M, K // 16), dtype=torch.int16, device=x.device)
    if M == 0:
        return dict(qs=qs, d=d, bsums=bsums)
    lib = _build.load("q8k_quant")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.q8k_quantize(x.data_ptr(), None if v is None else v.data_ptr(),
                           qs.data_ptr(), d.data_ptr(), bsums.data_ptr(),
                           _DTYPE_CODE[x.dtype], M, K, stream)
    if err != 0:
        raise RuntimeError(f"q8k_quantize launch failed with cudaError_t "
                           f"{err} (M={M}, K={K})")
    launches["q8k_quantize"] += 1
    return dict(qs=qs, d=d, bsums=bsums)
