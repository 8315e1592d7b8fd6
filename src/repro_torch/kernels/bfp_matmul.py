"""Fused BFP dequant-matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.bfp_matmul`` (``bfp_matmul_pallas``). The
kernel (``csrc/bfp_matmul.cu``, CUDA C++ for sm_90a) reads a
reference-packed ``QTensor`` of any of the eight weight variants as it
is, dequantizes each tile on chip into the tensor cores' fragments and
accumulates in f32; the dequantized weight never reaches device memory.
Its source note gives its bound and design.

The kernel splits K into ``k_splits(K, N)`` parts, a function of the
weight's shape alone, so that a row's value never depends on M. With more
than one part the wrapper hands it an f32 workspace of (S, M, N).

``bfp_matmul_plain`` is the same function in plain PyTorch: dequantize to
f32, round to bf16 and back, one f32 matmul per row, one cast. CPU tensors
take it (the CPU tests use it); on the card it is only the yardstick the
kernel is checked against.

The kernel takes any N: on the card each payload's rows start on 16-byte
boundaries (``core.quantize.QTensor`` pads N to ``lane_stride(N)`` lanes
once, when the tensor is made), and the kernel gets that row stride.

``launches`` counts kernel launches per variant. The wrapper adds one
where it launches and nowhere else, so a run can show that the main path
went through the kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.kernels import _build

VARIANTS = ("q2_k", "q3_k", "q3_k_o", "q4_0", "q4_k", "q5_k", "q6_k",
            "q8_0")
launches: Dict[str, int] = {v: 0 for v in VARIANTS}

# output dtype codes of the C interface
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
# payload dtypes the kernel reads, per variant, in argument order
_PAYLOADS = {
    "q2_k": (("qs", torch.uint8, 4), ("scales", torch.uint8, 16),
             ("d", torch.float16, 256), ("dmin", torch.float16, 256)),
    "q3_k": (("qs", torch.uint8, 4), ("hmask", torch.uint8, 8),
             ("scales", torch.uint8, 16), ("d", torch.float16, 256)),
    "q3_k_o": (("qs", torch.uint8, 4), ("hmask", torch.uint8, 8),
               ("scales", torch.uint8, 16), ("d", torch.float16, 256),
               ("oidx", torch.uint8, 32), ("ovals", torch.float16, 32)),
    "q4_0": (("qs", torch.uint8, 2), ("d", torch.float16, 32)),
    "q4_k": (("qs", torch.uint8, 2), ("scales", torch.uint8, 32),
             ("mins", torch.uint8, 32), ("d", torch.float16, 256),
             ("dmin", torch.float16, 256)),
    "q5_k": (("qs", torch.uint8, 2), ("qh", torch.uint8, 8),
             ("scales", torch.uint8, 32), ("mins", torch.uint8, 32),
             ("d", torch.float16, 256), ("dmin", torch.float16, 256)),
    "q6_k": (("ql", torch.uint8, 2), ("qh", torch.uint8, 4),
             ("scales", torch.int8, 16), ("d", torch.float16, 256)),
    "q8_0": (("qs", torch.int8, 1), ("d", torch.float16, 32)),
}


# the kernel's column tile (kBN in csrc/bfp_matmul.cu) and the card's SM
# count (NVIDIA H100 SXM), which set the split along K
BLOCK_N = 128
SMS = 132
SUPER_BLOCK = 256


def k_splits(K: int, N: int) -> int:
    """How many parts the kernel splits K into, from the weight's shape
    alone (never from M): the least divisor S of the 256-row tiles along K
    for which column tiles times S fill the card's SMs at decode, else
    every tile its own part. N = 256, K = 2048: 2 column tiles, S = 8."""
    tiles = -(-K // SUPER_BLOCK)
    cols = -(-N // BLOCK_N)
    for s in range(1, tiles + 1):
        if tiles % s == 0 and cols * s >= SMS:
            return s
    return tiles


def reset_launches() -> None:
    for v in VARIANTS:
        launches[v] = 0


def bfp_matmul_plain(x: torch.Tensor, t: QTensor, *,
                     compute_dtype=torch.bfloat16,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (M, K); t: packed (K, N). Returns (M, N) in ``out_dtype``.

    Each row is its own (1, K) @ (K, N) product: BLAS picks its kernel,
    and so its summation order, by M, so one product over all rows would
    make a row's value depend on how many rows share the call. Batched
    admission equals sequential admission only if it does not."""
    out_dtype = out_dtype or x.dtype
    w = dequantize(t, dtype=torch.float32).to(compute_dtype).to(torch.float32)
    xf = x.to(compute_dtype).to(torch.float32)
    rows = [xf[m:m + 1] @ w for m in range(xf.shape[0])]
    out = torch.cat(rows) if rows else xf.new_zeros((0, t.shape[1]))
    return out.to(out_dtype)


def _check(x: torch.Tensor, t: QTensor, compute_dtype, out_dtype):
    if t.variant not in _PAYLOADS:
        raise ValueError(f"the CUDA kernel has no {t.variant!r} variant; it "
                         f"has {VARIANTS}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"the kernel computes in bf16, got {compute_dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if x.dtype not in _OUT_CODE or out_dtype not in _OUT_CODE:
        raise ValueError(f"the kernel takes x and out in float32 or "
                         f"bfloat16, got {x.dtype} -> {out_dtype}")
    if not x.is_cuda:
        raise ValueError("the CUDA kernel needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    M, K = x.shape
    Kt, N = t.shape
    sb = get_format(t.variant).super_block    # 256, or 32 for q4_0/q8_0
    if K != Kt or K % sb:
        raise ValueError(f"x has K={K}, weight has K={Kt} (must match and "
                         f"be a multiple of {t.variant}'s {sb}-row "
                         "super-block)")
    # the kernel copies 16-byte chunks of packed rows: every payload's rows
    # lie ld elements apart, ld a multiple of 16 (a QTensor made on the
    # card is laid out so, core/quantize.py)
    ld = t.data[_PAYLOADS[t.variant][0][0]].stride(0)
    for name, dtype, kdiv in _PAYLOADS[t.variant]:
        a = t.data[name]
        if a.shape != (K // kdiv, N) or a.dtype != dtype:
            raise ValueError(
                f"{t.variant} payload {name!r} is {tuple(a.shape)} "
                f"{a.dtype}, the kernel takes ({K // kdiv}, {N}) {dtype}")
        if a.device != x.device:
            raise ValueError(f"payload {name!r} must be on {x.device}")
        if a.stride() != (ld, 1) or ld % 16 or a.data_ptr() % 16:
            raise ValueError(
                f"payload {name!r} has strides {a.stride()}: its rows must "
                f"start on 16-byte boundaries, ld={ld} elements apart "
                "(a multiple of 16) like every payload of the tensor")
    return M, K, N, ld


def bfp_matmul_cuda(x: torch.Tensor, t: QTensor, *,
                    compute_dtype=torch.bfloat16,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the CUDA kernel on x (M, K) against packed t (K, N) on the
    current stream. Raises on anything the kernel does not take."""
    out_dtype = out_dtype or x.dtype
    M, K, N, ld = _check(x, t, compute_dtype, out_dtype)
    lib = _build.load("bfp_matmul")
    # the kernel reads bf16(x): the cast is the compute-dtype cast of the
    # reference, done once here (free for the bf16 activations of a model)
    xb = x.to(torch.bfloat16)
    if xb.data_ptr() % 16:
        raise ValueError("x is not 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    splits = k_splits(K, N)
    # split partials go through a workspace only where the launch spreads
    # the splits over blocks (the kernel folds them in-block otherwise)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if lib.bfp_matmul_spreads_splits(M, N, splits) else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data[name].data_ptr() for name, _, _ in _PAYLOADS[t.variant]]
    fn = getattr(lib, f"bfp_matmul_{t.variant}")
    err = fn(xb.data_ptr(), *ptrs, out.data_ptr(), _OUT_CODE[out_dtype],
             None if ws is None else ws.data_ptr(), splits, M, K, N, ld,
             stream)
    if err != 0:
        raise RuntimeError(f"bfp_matmul_{t.variant} launch failed with "
                           f"cudaError_t {err} (M={M}, K={K}, N={N}, "
                           f"splits={splits})")
    launches[t.variant] += 1
    return out
