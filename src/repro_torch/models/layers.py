"""Model building blocks: norms, rotary embeddings, attention, MLPs.

Counterpart of ``repro.models.layers`` for the dense llama family and
gpt2 (LayerNorm, GELU MLP). Plain functions on tensors; any weight
matrix may be a packed ``QTensor``, in which case the matmul goes to
``kernels.ops.bfp_matmul`` (the CUDA kernel on the card). Shapes and
layouts are the reference's: q ``(B, S, H, D)``, caches
``(B, T, KH, D)``, positions ``(B, S)``.

The matmul inputs feed ``core.calibrate.tap`` at the reference's sites
(inert outside ``calibrate.collecting``). Attention is the reference's
materializing ``naive`` path in f32, its ``blockwise`` online softmax over
KV chunks (plain torch, as the reference has no kernel for it), or, for a
prefill chunk with ``impl="fused"``, the fused flash-style kernel
``kernels.prefill_attn.prefill_attn_fused`` (the CUDA kernel on the card,
its plain version on the CPU). ``verify_attention`` replays
``decode_attention`` column by column for a speculative draft block.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as Fn

from repro_torch.core import calibrate as CAL
from repro_torch.core.quantize import QTensor
from repro_torch.kernels import ops as kops
from repro_torch.kernels.prefill_attn import prefill_attn_fused

NEG_INF = -1e30


def dense(x: torch.Tensor, w, *, impl: str = "auto") -> torch.Tensor:
    """MatMul against either a plain tensor or a packed QTensor."""
    if isinstance(w, QTensor):
        return kops.bfp_matmul(x, w, impl=impl)
    return x @ w.to(x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def norm(x, p: Dict, kind: str, eps: float):
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"], eps)
    return layernorm(x, p["w"], p["b"], eps)


# ---------------------------------------------------------------------------
# position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_head))


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float):
    """positions: (B, S). Returns cos/sin (B, S, D/2) in f32."""
    inv = rope_freqs(d_head, theta, device=positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, D); cos/sin: (B, S, D/2). Split-half (llama) convention."""
    dt = x.dtype
    xf = x.to(torch.float32)
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _split_gqa(q, n_kv: int):
    """(B, S, H, D) -> (B, S, KH, G, D)."""
    B, S, H, D = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, D)


def naive_attention(q, k, v, *, causal=True, window=None, scale=None,
                    softcap=None, q_positions=None, kv_positions=None):
    """q: (B,S,H,D), k/v: (B,T,KH,D) -> (B,S,H,D). Materializes scores.

    Each batch row runs alone: a batched einsum lets cuBLAS pick its
    kernel by the batch size, and a row's bits then depend on how many
    rows share the call (on the card, a prefill group of 4 gave a row
    other bits than a group of 1)."""
    if q.shape[0] > 1:
        def row(pos, b):
            return pos if pos is None or pos.shape[0] == 1 else pos[b:b + 1]
        return torch.cat([naive_attention(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal,
            window=window, scale=scale, softcap=softcap,
            q_positions=row(q_positions, b),
            kv_positions=row(kv_positions, b)) for b in range(q.shape[0])])
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    scale = scale or (1.0 / math.sqrt(D))
    qg = _split_gqa(q, KH)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    dev = q.device
    qp = (q_positions if q_positions is not None
          else torch.arange(S, device=dev)[None])
    kp = (kv_positions if kv_positions is not None
          else torch.arange(T, device=dev)[None])
    mask = torch.ones((B, S, T), dtype=torch.bool, device=dev)
    if causal:
        mask &= kp[:, None, :] <= qp[:, :, None]
    if window:
        mask &= kp[:, None, :] > qp[:, :, None] - window
    mask &= kp[:, None, :] >= 0              # invalid cache slots carry -1
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.to(torch.float32))
    return o.reshape(B, S, H, D).to(q.dtype)


def blockwise_attention(q, k, v, *, causal=True, window=None, scale=None,
                        softcap=None, q_chunk=1024, kv_chunk=1024):
    """Exact chunked online-softmax attention over a full sequence, the
    reference's arithmetic step for step: q chunks of ``q_chunk`` rows,
    each walking only the KV chunks its causal (and window) range needs.
    Requires S % q_chunk == 0 and T % kv_chunk == 0 (after clamping each
    chunk to the sequence); q/k positions are 0..S-1 and 0..T-1."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale or (1.0 / math.sqrt(D))
    cq = min(q_chunk, S)
    ck = min(kv_chunk, T)
    if S % cq or T % ck:
        raise ValueError(f"blockwise attention needs S % q_chunk == 0 and "
                         f"T % kv_chunk == 0, got S={S}, q_chunk={cq}, "
                         f"T={T}, kv_chunk={ck}")
    dev = q.device
    out = []
    for i in range(S // cq):
        q0 = i * cq
        qi = _split_gqa(q[:, q0:q0 + cq], KH).to(torch.float32)
        # the KV chunks this q chunk needs
        hi = (q0 + cq + ck - 1) // ck if causal else T // ck
        lo = max(0, (q0 - window + 1) // ck) if window is not None else 0
        qpos = q0 + torch.arange(cq, device=dev)
        m = torch.full((B, KH, G, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KH, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KH, G, cq, D), dtype=torch.float32, device=dev)
        for j in range(lo, hi):
            kc = k[:, j * ck:(j + 1) * ck].to(torch.float32)
            vc = v[:, j * ck:(j + 1) * ck].to(torch.float32)
            s = torch.einsum("bqkgd,btkd->bkgqt", qi, kc) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kpos = j * ck + torch.arange(ck, device=dev)
            msk = torch.ones((cq, ck), dtype=torch.bool, device=dev)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window:
                msk &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p, vc)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,KH,G,cq,D)
        out.append(o.permute(0, 3, 1, 2, 4).reshape(B, cq, H, D))
    return torch.cat(out, dim=1).to(q.dtype)


def prefill_attention(q, k_cache, v_cache, slot_pos, k_new, v_new,
                      positions, valid, *, window=None, scale=None,
                      softcap=None, impl="naive"):
    """Chunked-prefill attention: one prompt chunk against cache + itself.

    q: (B,C,H,D) chunk queries; k_cache/v_cache: (B,T,KH,D) ring *before*
    this chunk's writes; slot_pos: (B,T) absolute positions per ring slot
    (-1 empty); k_new/v_new: (B,C,KH,D) this chunk's keys/values;
    positions: (B,C) absolute; valid: (B,C) False on right-padding (those
    keys never win attention; their query outputs are garbage the caller
    ignores).

    ``impl="fused"`` routes the concatenated problem through
    ``prefill_attn_fused`` (no (C, T) score materialization); the default
    ``"naive"`` materializes the scores."""
    if impl not in ("naive", "fused"):
        raise ValueError(f"unknown prefill attention impl {impl!r}; known: "
                         "naive, fused")
    kv_pos_new = torch.where(valid, positions, torch.full_like(positions, -1))
    k_all = torch.cat([k_cache, k_new.to(k_cache.dtype)], dim=1)
    v_all = torch.cat([v_cache, v_new.to(v_cache.dtype)], dim=1)
    kv_pos = torch.cat([slot_pos, kv_pos_new], dim=1)
    if impl == "fused":
        return prefill_attn_fused(q, k_all, v_all, positions, kv_pos,
                                  window=window, scale=scale,
                                  softcap=softcap)
    return naive_attention(q, k_all, v_all, causal=True, window=window,
                           scale=scale, softcap=softcap,
                           q_positions=positions, kv_positions=kv_pos)


def verify_attention(q, k_cache, v_cache, slot_pos, k_new, v_new,
                     positions, valid, *, window=None, scale=None,
                     softcap=None):
    """Draft-block verify attention (speculative decoding): the same
    numbers as ``decode_attention`` run once per token.

    ``prefill_attention`` sums the block's own keys at the end of the
    concatenated KV axis, while decode sums each new key at its ring slot,
    another f32 order. So verify replays decode's dataflow: for each column
    j it writes that column's K/V (if valid) into a copy of the ring at
    ``positions[:, j] % T`` and runs ``decode_attention`` for query j on
    it. The caller's ring is not touched.

    q: (B, S, H, D); k_new/v_new: (B, S, KH, D), rounded or dequantized as
    the decode write path stores them; positions (B, S) per-row absolute;
    valid (B, S) marks the columns that run. Invalid columns leave the ring
    copy untouched and their outputs are garbage. Requires S <= T.
    Returns (B, S, H, D)."""
    B, S = q.shape[:2]
    T = k_cache.shape[1]
    bidx = torch.arange(B, device=q.device)
    kc, vc, sp = k_cache.clone(), v_cache.clone(), slot_pos.clone()
    outs = []
    for j in range(S):
        pj, ok = positions[:, j], valid[:, j]
        slot = pj % T
        kc[bidx, slot] = torch.where(ok[:, None, None],
                                     k_new[:, j].to(kc.dtype),
                                     kc[bidx, slot])
        vc[bidx, slot] = torch.where(ok[:, None, None],
                                     v_new[:, j].to(vc.dtype),
                                     vc[bidx, slot])
        sp[bidx, slot] = torch.where(ok, pj.to(sp.dtype), sp[bidx, slot])
        outs.append(decode_attention(q[:, j:j + 1], kc, vc, sp, pj,
                                     window=window, scale=scale,
                                     softcap=softcap)[:, 0])
    return torch.stack(outs, dim=1)


def decode_attention(q, k_cache, v_cache, slot_pos, q_pos, *,
                     window=None, scale=None, softcap=None):
    """Single-step decode. q: (B,1,H,D); caches: (B,T,KH,D);
    slot_pos: (B,T) absolute positions per cache slot (-1 = empty);
    q_pos: (B,) current position."""
    B, _, H, D = q.shape
    KH = k_cache.shape[2]
    scale = scale or (1.0 / math.sqrt(D))
    qg = _split_gqa(q, KH).to(torch.float32)[:, 0]          # (B,KH,G,D)
    s = torch.einsum("bkgd,btkd->bkgt", qg,
                     k_cache.to(torch.float32)) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    msk = (slot_pos >= 0) & (slot_pos <= q_pos[:, None])
    if window:
        msk &= slot_pos > (q_pos[:, None] - window)
    s = torch.where(msk[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_mlp(x, p: Dict, *, impl="auto"):
    CAL.tap(("mlp/w_gate", "mlp/w_up"), x)
    g = dense(x, p["w_gate"], impl=impl)
    u = dense(x, p["w_up"], impl=impl)
    h = Fn.silu(g) * u
    CAL.tap("mlp/w_down", h)
    return dense(h, p["w_down"], impl=impl)


def gelu_mlp(x, p: Dict, *, impl="auto"):
    """gpt2's MLP: c_fc, + b_fc, tanh-approximate GELU, c_proj, + b_proj
    (the reference's single-device branch)."""
    CAL.tap("mlp/c_fc", x)
    h = dense(x, p["c_fc"], impl=impl)
    if "b_fc" in p:
        h = h + p["b_fc"].to(h.dtype)
    h = Fn.gelu(h, approximate="tanh")
    CAL.tap("mlp/c_proj", h)
    o = dense(h, p["c_proj"], impl=impl)
    if "b_proj" in p:
        o = o + p["b_proj"].to(o.dtype)
    return o
