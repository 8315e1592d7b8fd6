"""Model building blocks: norms, rotary embeddings, attention, MLPs.

Counterpart of ``repro.models.layers``: RMSNorm and LayerNorm, split-half
RoPE and Qwen2-VL's M-RoPE, sinusoidal positions, SwiGLU and GELU MLPs.
Plain functions on tensors; any weight matrix may be a packed
``QTensor``, in which case the matmul goes to ``kernels.ops.bfp_matmul``
(the CUDA kernel on the card). Shapes and
layouts are the reference's: q ``(B, S, H, D)``, caches
``(B, T, KH, D)``, positions ``(B, S)`` (``(3, B, S)`` for M-RoPE).

The matmul inputs feed ``core.calibrate.tap`` at the reference's sites
(inert outside ``calibrate.collecting``). Attention is the reference's
materializing ``naive`` path in f32, its ``blockwise`` online softmax over
KV chunks (plain torch, as the reference has no kernel for it), or, for a
prefill chunk with ``impl="fused"``, the fused flash-style kernel
``kernels.prefill_attn.prefill_attn_fused`` (the CUDA kernel on the card,
its plain version on the CPU). ``verify_attention`` replays
``decode_attention`` column by column for a speculative draft block.

Under an active serve-TP plan (``distributed.sharding.serve_tp``) the
``tp_*`` projections run this rank's share of a projection and its
collectives (the reference's ``tp_lane_dense``, ``tp_ring_dense`` and
``tp_row_dense``), and the MLPs shard the ffn hidden.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.core import calibrate as CAL
from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.distributed.sharding import (constrain, gather_dp,
                                              serve_tp_group,
                                              serve_tp_plan, serve_tp_rank)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.prefill_attn import prefill_attn_fused

NEG_INF = -1e30


def dense(x: torch.Tensor, w, *, impl: str = "auto") -> torch.Tensor:
    """MatMul against either a plain tensor or a packed QTensor."""
    if isinstance(w, QTensor):
        return kops.bfp_matmul(x, w, impl=impl)
    return x @ gather_dp(w).to(x.dtype)


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


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float,
                 mrope_sections: Optional[Tuple[int, int, int]] = None):
    """positions: (B, S), or (3, B, S) for M-RoPE. Returns cos/sin
    (B, S, D/2) in f32.

    M-RoPE (Qwen2-VL): the D/2 rotary frequencies are split into
    (temporal, height, width) sections of ``mrope_sections`` frequencies;
    each section rotates by its own position stream. Where the three
    streams coincide (text) it is RoPE."""
    inv = rope_freqs(d_head, theta, device=positions.device)
    ang = positions[..., None].to(torch.float32) * inv
    if positions.dim() == 3:
        if mrope_sections is None:
            raise ValueError("(3, B, S) positions need mrope_sections")
        sel = torch.cat([torch.full((n,), i, dtype=torch.long,
                                    device=positions.device)
                         for i, n in enumerate(mrope_sections)])
        # frequency j takes its angle from stream sel[j]
        ang = torch.gather(ang.movedim(0, -1), -1,
                           sel.expand(*ang.shape[1:3], -1)[..., None])[..., 0]
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


def sincos_pos_emb(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(B, S) -> (B, S, d_model) fixed sinusoidal embedding in f32
    (musicgen): sines of the first half of the frequencies, then cosines."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
# tensor-parallel projections (inside one rank, under sharding.serve_tp)
# ---------------------------------------------------------------------------

def _tp_mlp_active() -> bool:
    """Serve-TP lane sharding of the ffn block."""
    plan = serve_tp_plan()
    return plan is not None and plan.size > 1 and plan.mlp


def tp_lane_dense(x, w, out: str, *, impl="auto"):
    """Serve-TP projection against a lane-sharded weight (``w`` is this
    rank's (K, N/size) lane slice; K rows whole, so every output column is
    a full-K product).

    ``out="local"``: this rank's lane block, no collective (q/k/v: the
    block is this rank's heads; gate/up/fc: the ffn hidden stays sharded
    through the activation). ``out="full"``: the replicated output by one
    all-gather (o-proj and down-proj, whose consumers need it whole).

    Datapath per ``ServeTPPlan.matmul``: "padded" zero-embeds the slice
    and runs the single-device product shape (the same column bits as
    tp=1); "sliced" runs the lane-sliced product (1/size of the work and
    of the packed weight traffic, within an f32 ulp)."""
    plan = serve_tp_plan()
    if plan is None or plan.size == 1:
        return dense(x, w, impl=impl)
    if plan.matmul == "padded":
        y = kops.tp_local_lanes(dense(x, kops.tp_embed_lanes(w), impl=impl))
    else:
        y = dense(x, w, impl=impl)
    return y if out == "local" else kops.tp_gather_lanes(y)


def tp_ring_dense(x, w, *, impl="auto"):
    """Ring collective-matmul: a full-output projection whose input lives
    lane-sharded (``x`` is this rank's K chunk) and whose weight does too
    (``w`` is (K, N/size)), computed without gathering the input. Each of
    the ``size`` steps multiplies the chunk in hand by its K rows of the
    local weight while ``ring_shift`` (``dist.batch_isend_irecv``, the
    reference's ``ppermute``) forwards the chunk one hop; then one
    all-gather assembles the lanes. K accumulates in an f32 carry and
    rounds once. A packed weight dequantizes its local lane slice once,
    outside the loop, so the per-step K rows need no super-block
    alignment."""
    plan = serve_tp_plan()
    if plan is None or plan.size == 1:
        return dense(x, w, impl=impl)
    size, i = plan.size, serve_tp_rank()
    group = serve_tp_group()
    kl = x.shape[-1]
    # the products take the chunk in the weight's compute dtype (bf16 for
    # a packed weight) and accumulate in f32
    wdt = torch.bfloat16 if isinstance(w, QTensor) else x.dtype
    wf = (dequantize(w, dtype=wdt) if isinstance(w, QTensor)
          else w.to(wdt)).to(torch.float32)
    chunk, acc = x, None
    for s in range(size):
        # the chunk in hand at step s started at rank (i - s): its K offset
        j = (i - s) % size
        part = chunk.to(wdt).to(torch.float32) @ wf[j * kl:(j + 1) * kl]
        acc = part if acc is None else acc + part
        if s + 1 < size:
            chunk = group.ring_shift(chunk)
    return kops.tp_gather_lanes(acc.to(x.dtype))


def tp_row_dense(x, w, mode: str, *, impl="auto"):
    """Serve-TP row-parallel projection ("sliced_row"): ``x`` is this
    rank's K slice of the input (its own head outputs, or ffn lanes), fed
    straight into a partial-K product; one all-reduce assembles the
    replicated output (Megatron's column/row pairing: one collective where
    the lane dataflow has two).

    ``mode`` (``ServeTPPlan.attn_row``/``mlp_row``): "packed" -- ``w`` is
    this rank's K-row slice; "dequant" -- ``w`` is the whole replicated
    packed tensor (``kops.tp_row_local_matmul``). A plain weight is always
    this rank's (K/size, N) rows. Partials are f32 and the sum rounds to
    the activation dtype once, so the only difference from the lane
    dataflow is the order of the K reduction across ranks."""
    plan = serve_tp_plan()
    if plan is None or plan.size == 1:
        return dense(x, w, impl=impl)
    if isinstance(w, QTensor):
        y = kops.tp_row_local_matmul(x, w, mode, impl=impl)
    else:
        y = x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)
    return serve_tp_group().all_reduce(y).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _tp_down(h, w, *, impl):
    """The down-projection of a lane-sharded ffn hidden ``h``: row-parallel
    under a row mode, the ring matmul under "sliced_row" without one,
    else gather the hidden and project its lanes."""
    plan = serve_tp_plan()
    if plan.mlp_row:
        return tp_row_dense(h, w, plan.mlp_row, impl=impl)
    if plan.matmul == "sliced_row":
        return tp_ring_dense(h, w, impl=impl)
    return tp_lane_dense(kops.tp_gather_lanes(h), w, "full", impl=impl)


def swiglu_mlp(x, p: Dict, *, impl="auto"):
    if _tp_mlp_active():
        # gate/up give this rank's ffn lanes and the activation stays local
        g = tp_lane_dense(x, p["w_gate"], "local", impl=impl)
        u = tp_lane_dense(x, p["w_up"], "local", impl=impl)
        return _tp_down(Fn.silu(g) * u, p["w_down"], impl=impl)
    CAL.tap(("mlp/w_gate", "mlp/w_up"), x)
    g = dense(x, p["w_gate"], impl=impl)
    u = dense(x, p["w_up"], impl=impl)
    # the ffn hidden over "model"; the row-parallel down-projection's
    # output replicated on d, so its reduction happens here, in the
    # activation dtype (sharding.constrain: the identity outside a dry run)
    h = constrain(Fn.silu(g) * u, "dp", None, "model")
    CAL.tap("mlp/w_down", h)
    return constrain(dense(h, p["w_down"], impl=impl), "dp", None, None)


def gelu_mlp(x, p: Dict, *, impl="auto"):
    """gpt2's MLP: c_fc, + b_fc, tanh-approximate GELU, c_proj, + b_proj.
    Under serve TP ``b_fc`` is lane-sharded with ``c_fc`` (its add stays
    local) and ``b_proj`` adds after the output is assembled."""
    if _tp_mlp_active():
        h = tp_lane_dense(x, p["c_fc"], "local", impl=impl)
        if "b_fc" in p:
            h = h + p["b_fc"].to(h.dtype)
        o = _tp_down(Fn.gelu(h, approximate="tanh"), p["c_proj"], impl=impl)
        if "b_proj" in p:
            o = o + p["b_proj"].to(o.dtype)
        return o
    CAL.tap("mlp/c_fc", x)
    h = dense(x, p["c_fc"], impl=impl)
    if "b_fc" in p:
        h = h + p["b_fc"].to(h.dtype)
    h = constrain(Fn.gelu(h, approximate="tanh"), "dp", None, "model")
    CAL.tap("mlp/c_proj", h)
    o = constrain(dense(h, p["c_proj"], impl=impl), "dp", None, None)
    if "b_proj" in p:
        o = o + p["b_proj"].to(o.dtype)
    return o
