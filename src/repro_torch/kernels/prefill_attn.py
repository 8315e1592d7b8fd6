"""Fused prefill attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.prefill_attn`` (``prefill_attn_fused``):
flash-style causal attention with an online softmax, masked by position
(absolute query positions against per-slot key positions, ``-1`` for an
empty slot), GQA folded into rows, an optional sliding window and tanh
softcap. Scores, the running max and denominator and the accumulator are
f32; the output is cast once to q's dtype. Rows with no visible key are
garbage on every path, and callers discard them.

``prefill_attn_plain`` is the reference's recurrence in plain PyTorch, over
the same ``(BLOCK_Q, BLOCK_K)`` tiles and the same GQA fold. CPU tensors
take it; on the card it is the yardstick the kernel is checked against.
``prefill_attn_cuda`` launches the kernel (``csrc/prefill_attn.cu``, CUDA
C++ for sm_90a on the tensor cores, any head dim up to ``MAX_HEAD_DIM``;
its source note gives its bound and design).
``prefill_attn_fused`` dispatches by device: a CUDA tensor launches the
kernel or raises, nothing falls back.

``launches["prefill_attn"]`` counts kernel launches: the wrapper adds one
where it launches and nowhere else.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
BLOCK_Q, BLOCK_K = 128, 256  # the reference kernel's tiles
MAX_HEAD_DIM = 256          # the kernel's widest instance

launches: Dict[str, int] = {"prefill_attn": 0}

# dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    launches["prefill_attn"] = 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prefill_attn_plain(q, k, v, q_pos, kv_pos, *, window=None, scale=None,
                       softcap=None) -> torch.Tensor:
    """q: (B,C,H,D); k/v: (B,T,KH,D); q_pos: (B,C); kv_pos: (B,T).

    Returns (B,C,H,D) in q.dtype. The reference kernel's arithmetic, one
    (BLOCK_Q, BLOCK_K) tile at a time, every head of the batch at once."""
    B, C, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale or (1.0 / math.sqrt(D))

    # fold GQA: (B,C,H,D) -> (B*KH, C*G, D); row r <-> (c = r // G, g)
    qg = q.reshape(B, C, KH, G, D).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(B * KH, C * G, D).to(torch.float32)
    k2 = k.permute(0, 2, 1, 3).reshape(B * KH, T, D).to(torch.float32)
    v2 = v.permute(0, 2, 1, 3).reshape(B * KH, T, D).to(torch.float32)
    qp = q_pos.to(torch.int32).repeat_interleave(G, dim=1)      # (B, C*G)
    qp = qp[:, None].expand(B, KH, C * G).reshape(B * KH, C * G)
    kp = kv_pos.to(torch.int32)[:, None].expand(B, KH, T).reshape(B * KH, T)

    M = C * G
    bq = min(BLOCK_Q, _round_up(M, 8))
    bk = min(BLOCK_K, _round_up(T, 128))
    Mp, Tp = _round_up(M, bq), _round_up(T, bk)
    qg = torch.nn.functional.pad(qg, (0, 0, 0, Mp - M))
    qp = torch.nn.functional.pad(qp, (0, Mp - M), value=-1)
    k2 = torch.nn.functional.pad(k2, (0, 0, 0, Tp - T))
    v2 = torch.nn.functional.pad(v2, (0, 0, 0, Tp - T))
    kp = torch.nn.functional.pad(kp, (0, Tp - T), value=-1)

    out = torch.empty((B * KH, Mp, D), dtype=torch.float32, device=q.device)
    for i in range(0, Mp, bq):
        qi, qpi = qg[:, i:i + bq], qp[:, i:i + bq, None]
        m = torch.full((B * KH, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B * KH, bq, 1), device=q.device)
        acc = torch.zeros((B * KH, bq, D), device=q.device)
        for j in range(0, Tp, bk):
            kpj = kp[:, None, j:j + bk]
            s = torch.bmm(qi, k2[:, j:j + bk].transpose(1, 2)) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            msk = (kpj >= 0) & (kpj <= qpi)
            if window:
                msk &= kpj > qpi - window
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.bmm(p, v2[:, j:j + bk])
            m = m_new
        out[:, i:i + bq] = acc / torch.clamp(l, min=1e-30)

    out = out[:, :M].reshape(B, KH, C, G, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, C, H, D).to(q.dtype)


def _check(q, k, v, q_pos, kv_pos):
    if not q.is_cuda:
        raise ValueError("the CUDA kernel needs a CUDA tensor")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,C,H,D) and k, v (B,T,KH,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, C, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KH)")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD_DIM}, "
                         f"got {D}")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE \
            or v.dtype != k.dtype:
        raise ValueError(f"the kernel takes q and k/v in float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(q_pos.shape) != (B, C) or tuple(kv_pos.shape) != (B, T):
        raise ValueError(f"q_pos must be ({B}, {C}) and kv_pos ({B}, {T}), "
                         f"got {tuple(q_pos.shape)}, {tuple(kv_pos.shape)}")
    for name, a in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if a.device != q.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    if B * KH > 65535:
        raise ValueError(f"B * KH = {B * KH} exceeds the grid's y limit")
    return B, C, H, D, T, KH


def prefill_attn_cuda(q, k, v, q_pos, kv_pos, *, window=None, scale=None,
                      softcap=None) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. Same arguments and
    result as ``prefill_attn_plain``; raises on anything the kernel does
    not take."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    kv_pos = kv_pos.to(torch.int32).contiguous()
    B, C, H, D, T, KH = _check(q, k, v, q_pos, kv_pos)
    scale = scale or (1.0 / math.sqrt(D))
    lib = _build.load("prefill_attn")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.prefill_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           q_pos.data_ptr(), kv_pos.data_ptr(),
                           out.data_ptr(), _DTYPE_CODE[q.dtype],
                           _DTYPE_CODE[k.dtype], B, C, T, H, KH, D,
                           int(window or 0), float(scale),
                           float(softcap or 0.0), stream)
    if err != 0:
        raise RuntimeError(f"prefill_attn launch failed with cudaError_t "
                           f"{err} (B={B}, C={C}, T={T}, H={H}, KH={KH}, "
                           f"D={D})")
    launches["prefill_attn"] += 1
    return out


def prefill_attn_fused(q, k, v, q_pos, kv_pos, *, window=None,
                       scale: Optional[float] = None, softcap=None,
                       impl: str = "auto") -> torch.Tensor:
    """``impl``: "cuda" (the kernel), "torch" (the plain version) or
    "auto": the kernel for a CUDA tensor, the plain version for a CPU
    tensor. Returns (B,C,H,D) in q.dtype."""
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    if impl == "cuda":
        return prefill_attn_cuda(q, k, v, q_pos, kv_pos, window=window,
                                 scale=scale, softcap=softcap)
    if impl == "torch":
        return prefill_attn_plain(q, k, v, q_pos, kv_pos, window=window,
                                  scale=scale, softcap=softcap)
    raise ValueError(f"unknown impl {impl!r}; known: cuda, torch, auto")
