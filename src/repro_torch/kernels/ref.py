"""Plain oracles for the BFP matmul (counterpart of ``repro.kernels.ref``).

Two reference semantics:

  * ``matmul_ref``      -- dequantize to f32, then an f32 matmul with no
    bf16 rounding anywhere: the golden numerical reference the kernel and
    its plain version are held against within a stated tolerance.
  * ``matmul_q8k_ref``  -- llama.cpp ``vec_dot_qX_K_q8_K`` semantics:
    integer dot products per 16-row block with two-level rescaling,
    activations in Q8_K. The model of the paper's DSBP datapath (shared
    integer vector engine, Q2/Q3 scalar units, accumulator).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.formats import slab_unpack
from repro_torch.core.quantize import QTensor, dequantize


def matmul_ref(x: torch.Tensor, t: QTensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """x: (..., K) float; t: packed (K, N). Returns (..., N)."""
    w = dequantize(t, dtype=torch.float32)
    return (x.to(torch.float32) @ w).to(out_dtype)


# ---------------------------------------------------------------------------
# integer-datapath reference (llama.cpp vec_dot semantics)
# ---------------------------------------------------------------------------

def _int_dot(x_blk: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-16-block integer dot products (M, nsb, 16, 16) x (nsb, 16, 16,
    N) -> (M, nsb, 16, N), as a float product of integer-valued tensors:
    integer matmuls are not implemented on CUDA tensors. It is exact:
    every operand (|qs| <= 127, |q| <= 4) is exact in f32 and even in
    TF32, and every partial sum is an integer of magnitude at most
    16 * 127 * 4 = 8128 < 2**24, so any summation order gives the integer
    result."""
    return torch.einsum("msbi,sbin->msbn", x_blk.to(torch.float32),
                        q.to(torch.float32))


def matmul_q8k_ref(qx: Dict[str, torch.Tensor], t: QTensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Integer-accumulation reference. qx: Q8_K activation dict over
    (M, K). Models the paper's native variants (q2_k, q3_k) only. The
    block scales weigh the exact integer dots (also exact in f32: at most
    16 * 8128 * 32 < 2**24), then the two-level rescaling runs in the
    reference's order, ``(scaled * d - mins * dmin) * d8``, and the
    super-blocks are summed."""
    K, N = t.shape
    nsb = K // 256
    qs = qx["qs"]
    M = qs.shape[0]
    d8 = qx["d"].to(torch.float32)                        # (M, nsb)
    x_blk = qs.reshape(M, nsb, 16, 16)

    if t.variant == "q2_k":
        q = slab_unpack(t.data["qs"], 2, 256).reshape(nsb, 16, 16, N)
        sc = (t.data["scales"] & 0xF).reshape(nsb, 16, N)
        mn = (t.data["scales"] >> 4).reshape(nsb, 16, N)
        d = t.data["d"].to(torch.float32)                 # (nsb, N)
        dmin = t.data["dmin"].to(torch.float32)
        idot = _int_dot(x_blk, q)                         # (M, nsb, 16, N)
        scaled = torch.einsum("msbn,sbn->msn", idot, sc.to(torch.float32))
        # the min correction uses the Q8 block sums (the paper's bsum trick)
        bs = qx["bsums"].reshape(M, nsb, 16).to(torch.float32)
        mins = torch.einsum("msb,sbn->msn", bs, mn.to(torch.float32))
        acc = (scaled * d[None] - mins * dmin[None]) * d8[:, :, None]
        return acc.sum(dim=1).to(out_dtype)

    if t.variant == "q3_k":
        lo = slab_unpack(t.data["qs"], 2, 256).to(torch.int32)
        hi = slab_unpack(t.data["hmask"], 1, 256).to(torch.int32)
        q = (lo + (hi << 2) - 4).reshape(nsb, 16, 16, N)   # [-4, 3]
        sc = t.data["scales"].to(torch.int32).reshape(nsb, 16, N) - 32
        d = t.data["d"].to(torch.float32)
        idot = _int_dot(x_blk, q)
        scaled = torch.einsum("msbn,sbn->msn", idot, sc.to(torch.float32))
        acc = scaled * d[None] * d8[:, :, None]
        return acc.sum(dim=1).to(out_dtype)

    raise NotImplementedError(
        f"integer reference only models the paper's native variants "
        f"(q2_k, q3_k); got {t.variant}")


def dequant_ref(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    return dequantize(t, dtype=dtype)
