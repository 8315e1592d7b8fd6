"""Analytic model FLOPs and HBM bytes per (arch x shape): the yardstick.

Counterpart of ``repro.launch.flops``, with its constants. Convention:
6*N*D for training (forward and backward), 2*N*D for inference, with N
the *active* non-embedding parameter count (MoE: experts counted at k/E),
plus the sequence-interaction terms the N*D rule misses:
  * attention: 4*B*H*Dh*(causal token pairs) per layer (x3 for training)
  * SSD: intra-chunk quadratic + state terms per layer
The dry run's useful-FLOPs ratio is MODEL_FLOPS over the counted FLOPs
(remat, padding and capacity-factor waste show up as a ratio < 1).
``param_counts`` walks ``init_params`` on the meta device: shapes only,
nothing allocated.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T


def _meta_params(cfg: ModelConfig):
    return T.init_params(cfg, torch.Generator(), dtype=torch.bfloat16,
                         device="meta")


@functools.lru_cache(maxsize=64)
def param_counts(cfg: ModelConfig) -> Dict[str, float]:
    shapes = _meta_params(cfg)

    def walk(node, prefix=""):
        total = expert = embed = 0
        if isinstance(node, dict):
            for k, v in node.items():
                t, e, m = walk(v, f"{prefix}{k}/")
                total += t
                expert += e
                embed += m
            return total, expert, embed
        n = math.prod(node.shape)
        path = prefix[:-1]
        is_expert = "moe/w_" in path
        is_embed = path.split("/")[-1] in ("wte", "wpe")
        return n, n if is_expert else 0, n if is_embed else 0

    total, expert, embed = walk(shapes)
    active = total - embed
    if cfg.n_experts:
        active = active - expert * (1 - cfg.n_experts_active / cfg.n_experts)
    head = 0.0 if cfg.tie_embeddings else float(
        cfg.d_model * cfg.vocab_size)
    if cfg.tie_embeddings:
        head = float(cfg.d_model * cfg.vocab_size)
        active += head                   # tied head still costs flops
    return dict(total=float(total), active=float(active),
                expert=float(expert), embed=float(embed), head=head)


def _attn_pairs(S: int, window) -> float:
    """Causal (q, k) pair count per sequence."""
    if window and window < S:
        return S * window - window * (window - 1) / 2.0
    return S * (S + 1) / 2.0


def _attn_flops_seq(cfg: ModelConfig, B: int, S: int, n_layers: int,
                    heads: int, d_head: int) -> float:
    pairs = _attn_pairs(S, cfg.sliding_window)
    return 4.0 * B * heads * d_head * pairs * n_layers


def _ssd_flops_seq(cfg: ModelConfig, B: int, S: int, n_layers: int) -> float:
    dd = M2.ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    H, P, N = dd["n_heads"], dd["head_dim"], dd["state"]
    intra = 2.0 * B * S * Q * (N + H * P)
    inter = 4.0 * B * S * H * P * N
    return (intra + inter) * n_layers


# ---------------------------------------------------------------------------
# analytic HBM-traffic model (the roofline memory term)
#
# The dry run's counted bytes include every unfused op's operands; a fused
# execution keeps elementwise chains on chip, so those counts overstate the
# traffic. This model counts what a fused step pays, per rank per step:
#
#   train : weights 6 B/param (bf16 read fwd + bwd + remat-recompute)
#           + optimizer 32 B/param (fp32 grad w+r, m/v r+w, master r+w)
#           + activation boundary traffic per layer (write fwd + read bwd,
#             x1.5 remat recompute) + flash-attention KV re-reads
#           + chunked-loss logits spills
#   serve : weights once (PACKED bits for quantized tensors -- the paper's
#           benefit), KV cache read + slot write, boundary activations
# ---------------------------------------------------------------------------

_TRAIN_WEIGHT_B = 6.0
_TRAIN_OPT_B = 32.0
_REMAT_FACTOR = 1.5


def _act_bytes_per_token_layer(cfg: ModelConfig) -> float:
    """Boundary activation bytes (bf16 write+read) per token per layer."""
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        dd = M2.ssm_dims(cfg)
        base = 3 * dd["d_inner"] + 2 * dd["state"] + dd["n_heads"] + 2 * d
        # SSD chunk decay/score spills ~ Q * H fp32 per token
        base += 2 * min(cfg.ssm_chunk, 256) * dd["n_heads"]
    elif cfg.family == "moe":
        fe = cfg.moe_d_ff * cfg.n_experts_active * cfg.capacity_factor
        base = 4 * d + 2 * cfg.n_kv_heads * cfg.d_head + 3 * fe
    else:
        base = (4 * d + 2 * cfg.n_kv_heads * cfg.d_head + 3 * cfg.d_ff)
    return base * 2 * 2.0            # bf16, write + read


def _kv_reread_bytes_per_token_layer(cfg: ModelConfig, S: int,
                                     q_chunk: int) -> float:
    """Flash attention re-reads K/V once per query chunk."""
    if cfg.family == "ssm":
        return 0.0
    ctx = min(S, cfg.sliding_window or S)
    rereads = max(ctx / (2.0 * q_chunk), 1.0)
    return rereads * 2 * cfg.n_kv_heads * cfg.d_head * 2


def serve_param_bytes(cfg: ModelConfig, quantized: bool = True,
                      policy_name: str = "default_serve_mix") -> float:
    """Per-replica serve weight bytes (packed where the policy quantizes)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import _flatten_paths, spec_like_quantized
    from repro_torch.core.quantize import QTensor
    sds = _meta_params(cfg)
    if quantized:
        sds = spec_like_quantized(sds, get_policy(policy_name))
    total = 0.0
    for _, leaf in _flatten_paths(sds):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes
        else:
            total += float(math.prod(leaf.shape)) * 2   # bf16 residual
    return total


def memory_model(cfg: ModelConfig, shape: ShapeConfig, *, n_chips: int,
                 model_par: int, serve_quantized: bool = True,
                 policy_name: str = "default_serve_mix",
                 fused_weights: bool = True,
                 kv_cache_bits: int = 16) -> Dict[str, float]:
    """Per-chip HBM bytes per step (see module comment).

    fused_weights=False models the dequantize-then-matmul baseline
    (the paper's CPU-framework analogue): packed weights are read AND the
    dequantized bf16 copy is written + read back. fused_weights=True is
    the F-BFQ datapath: packed bytes only. kv_cache_bits=8 models the
    int8-quantized KV cache (beyond-paper §Perf option).
    """
    pc = param_counts(cfg)
    B, S = shape.global_batch, shape.seq_len
    dp = max(n_chips // model_par, 1)
    L = cfg.n_layers

    if shape.kind == "train":
        tokens_local = B * S / dp
        w = pc["total"] * (_TRAIN_WEIGHT_B + _TRAIN_OPT_B) / n_chips
        act = (tokens_local * L
               * _act_bytes_per_token_layer(cfg) / model_par
               * _REMAT_FACTOR)
        act += (tokens_local * L
                * _kv_reread_bytes_per_token_layer(cfg, S,
                                                   cfg.attn_q_chunk))
        V_local = cfg.vocab_size / model_par
        loss = tokens_local * (V_local * 4 * 2 + cfg.d_model * 2 * 2)
        cache = 0.0
    elif shape.kind == "prefill":
        tokens_local = B * S / dp
        w = serve_param_bytes(cfg, serve_quantized) / model_par
        if not fused_weights and serve_quantized:
            w += pc["total"] * 2 * 2 / model_par   # bf16 copy write + read
        act = tokens_local * L * _act_bytes_per_token_layer(cfg) / model_par
        act += (tokens_local * L
                * _kv_reread_bytes_per_token_layer(cfg, S,
                                                   cfg.attn_q_chunk))
        loss = B / dp * cfg.vocab_size / model_par * 4
        cache = (tokens_local * L * 2 * cfg.n_kv_heads * cfg.d_head
                 * (kv_cache_bits / 8.0)
                 / model_par) if cfg.family != "ssm" else 0.0
    else:                                        # decode
        w = serve_param_bytes(cfg, serve_quantized) / model_par
        if not fused_weights and serve_quantized:
            w += pc["total"] * 2 * 2 / model_par   # bf16 copy write + read
        # cache shards over dp via batch when divisible, else via the cache
        # sequence dim (B=1 long-context; see sharding.cache_specs)
        B_local = B / dp
        cache = 0.0
        if cfg.family in ("dense", "vlm", "audio", "moe", "gpt2", "hybrid"):
            Tc = min(S, cfg.sliding_window or S)
            napp = L
            if cfg.family == "hybrid":
                napp = sum(1 for g in T._hybrid_groups(cfg)
                           if g == cfg.hybrid_attn_every)
            cache += (B_local * napp * Tc * 2 * cfg.n_kv_heads
                      * (2 * cfg.d_model // cfg.n_heads
                         if cfg.family == "hybrid" else cfg.d_head)
                      * (kv_cache_bits / 8.0) / model_par)
        if cfg.family in ("ssm", "hybrid"):
            dd = M2.ssm_dims(cfg)
            cache += (B_local * L * dd["n_heads"] * dd["head_dim"]
                      * dd["state"] * 4 * 2 / model_par)
        act = B_local * L * _act_bytes_per_token_layer(cfg) / model_par / 2
        loss = B_local * cfg.vocab_size / model_par * 4
    total = w + act + loss + cache
    return dict(weights=w, activations=act, loss=loss, cache=cache,
                total=total)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    pc = param_counts(cfg)
    B, S = shape.global_batch, shape.seq_len
    N = pc["active"]
    if shape.kind == "train":
        base = 6.0 * N * B * S
        mult = 3.0                       # fwd + bwd on seq terms
        tokens_seq = S
    elif shape.kind == "prefill":
        # serve_prefill computes head logits for the last position only
        base = 2.0 * (N - pc["head"]) * B * S + 2.0 * pc["head"] * B
        mult = 1.0
        tokens_seq = S
    else:                                # decode: one token, cache of S
        base = 2.0 * N * B
        mult = 1.0
        tokens_seq = None

    extra = 0.0
    if cfg.family in ("dense", "vlm", "audio", "moe", "gpt2"):
        if tokens_seq is None:
            ctx = min(S, cfg.sliding_window or S)
            extra = 4.0 * B * cfg.n_heads * cfg.d_head * ctx * cfg.n_layers
        else:
            extra = mult * _attn_flops_seq(cfg, B, S, cfg.n_layers,
                                           cfg.n_heads, cfg.d_head)
    elif cfg.family == "ssm":
        if tokens_seq is None:
            dd = M2.ssm_dims(cfg)
            extra = (4.0 * B * dd["n_heads"] * dd["head_dim"] * dd["state"]
                     * cfg.n_layers)
        else:
            extra = mult * _ssd_flops_seq(cfg, B, S, cfg.n_layers)
    elif cfg.family == "hybrid":
        napp = sum(1 for g in T._hybrid_groups(cfg)
                   if g == cfg.hybrid_attn_every)
        Dh2 = 2 * cfg.d_model // cfg.n_heads
        if tokens_seq is None:
            dd = M2.ssm_dims(cfg)
            extra = (4.0 * B * dd["n_heads"] * dd["head_dim"] * dd["state"]
                     * cfg.n_layers)
            extra += 4.0 * B * cfg.n_heads * Dh2 * min(S, S) * napp
        else:
            extra = mult * _ssd_flops_seq(cfg, B, S, cfg.n_layers)
            extra += mult * _attn_flops_seq(cfg, B, S, napp, cfg.n_heads,
                                            Dh2)
    return base + extra
