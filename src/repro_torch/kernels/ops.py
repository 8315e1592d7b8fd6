"""Public kernel entry points (counterpart of ``repro.kernels.ops``): the
fused BFP matmul, the Q8_K activation quantization, and the ring and page
copies of speculative decoding and the prefix cache (plain torch
indexing, as the reference's are plain XLA gathers and scatters).

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

import numpy as np
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


# ---------------------------------------------------------------------------
# ring and page copies
# ---------------------------------------------------------------------------
# ``arr`` carries the batch dimension at ``ring_axis - 1`` and the ring
# (cache position) dimension at ``ring_axis``: a KV ring (L, B, T, ...)
# has ring_axis=2, the position ring (B, T) ring_axis=1.

def _ring_index(slots: torch.Tensor, arr: torch.Tensor, ring_axis: int):
    """``slots`` (B, S) shaped to gather along ``arr``'s ring axis."""
    if ring_axis not in (1, 2):
        raise ValueError(f"unsupported ring_axis {ring_axis}")
    B, S = slots.shape
    lead = (1,) * (ring_axis - 1)
    idx = slots.to(torch.long).reshape(lead + (B, S)
                                       + (1,) * (arr.dim() - ring_axis - 1))
    return idx.expand(arr.shape[:ring_axis - 1] + (B, S)
                      + arr.shape[ring_axis + 1:])


def ring_gather(arr: torch.Tensor, slots: torch.Tensor, *,
                ring_axis: int) -> torch.Tensor:
    """A copy of ring rows ``slots`` (B, S) of a per-slot ring: ``arr``
    with the ring axis replaced by S (the rows a speculative draft block
    is about to overwrite). Never a view."""
    return torch.gather(arr, ring_axis, _ring_index(slots, arr, ring_axis))


def ring_restore(arr: torch.Tensor, snap: torch.Tensor, slots: torch.Tensor,
                 keep: torch.Tensor, *, ring_axis: int) -> torch.Tensor:
    """Un-write rejected speculative entries, in place: snapshot column
    ``j`` (``ring_gather`` of the same ``slots``) goes back into the ring
    for every ``j >= keep[b]``; columns ``j < keep[b]`` keep their
    accepted values (written back as they are). The slots of a row must
    be distinct (S <= T). Returns ``arr``."""
    idx = _ring_index(slots, arr, ring_axis)
    B, S = slots.shape
    j = torch.arange(S, device=slots.device)
    restore = (j[None] >= keep[:, None]).reshape(
        (1,) * (ring_axis - 1) + (B, S) + (1,) * (arr.dim() - ring_axis - 1))
    cur = torch.gather(arr, ring_axis, idx)
    arr.scatter_(ring_axis, idx, torch.where(restore, snap.to(arr.dtype),
                                             cur))
    return arr


def _host_index(a, name: str) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name} must be a host array, got a tensor on "
                             f"{a.device}")
        a = a.numpy()
    return np.asarray(a, dtype=np.int64)


def page_gather(arr: torch.Tensor, rows, cols, *,
                ring_axis: int) -> torch.Tensor:
    """Copy page-shaped row blocks out of a per-slot ring: ``rows`` (n,)
    batch rows, ``cols`` (n, page) ring slots, both host arrays (a
    position ``p`` lives at slot ``p % T``). Returns ``arr`` with its
    (batch, ring) dims replaced by (n, page). Indices are checked on the
    host: torch raises on an out-of-range gather where XLA clamps."""
    rows, cols = _host_index(rows, "rows"), _host_index(cols, "cols")
    B, T = arr.shape[ring_axis - 1], arr.shape[ring_axis]
    if rows.size and (rows.min() < 0 or rows.max() >= B or cols.min() < 0
                      or cols.max() >= T):
        raise ValueError(f"page index out of range of a ({B}, {T}) ring")
    r = torch.as_tensor(rows[:, None], device=arr.device)
    c = torch.as_tensor(cols, device=arr.device)
    if ring_axis == 1:
        return arr[r, c]
    if ring_axis == 2:
        return arr[:, r, c]
    raise ValueError(f"unsupported ring_axis {ring_axis}")


def page_scatter(arr: torch.Tensor, pages, rows, cols, *,
                 ring_axis: int) -> torch.Tensor:
    """Scatter page-shaped row blocks into a per-slot ring, in place (the
    inverse of ``page_gather``). ``pages`` is shaped like its output (a
    tensor, or a host array such as the positions of ``pos``); ``rows``
    and ``cols`` are host arrays. An entry of ``cols`` >= T drops that
    element, filtered on the host before anything reaches the device:
    batch padding, and the partial pages of copy-on-write. Destinations
    must be distinct. Returns ``arr``."""
    rows, cols = _host_index(rows, "rows"), _host_index(cols, "cols")
    B, T = arr.shape[ring_axis - 1], arr.shape[ring_axis]
    n, j = np.nonzero(cols < T)
    if n.size == 0:
        return arr
    r, c = rows[n], cols[n, j]
    if r.min() < 0 or r.max() >= B or c.min() < 0:
        raise ValueError(f"page index out of range of a ({B}, {T}) ring")
    dev = arr.device
    r, c = torch.as_tensor(r, device=dev), torch.as_tensor(c, device=dev)
    n, j = torch.as_tensor(n, device=dev), torch.as_tensor(j, device=dev)
    pages = torch.as_tensor(pages, device=dev).to(arr.dtype)
    if ring_axis == 1:
        arr[r, c] = pages[n, j]
    elif ring_axis == 2:
        arr[:, r, c] = pages[:, n, j]
    else:
        raise ValueError(f"unsupported ring_axis {ring_axis}")
    return arr
