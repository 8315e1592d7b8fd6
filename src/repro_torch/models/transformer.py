"""Model assembly: init, chunked prefill and decode against a cache.

Counterpart of ``repro.models.transformer`` for the dense llama family
(RMSNorm, split-half RoPE, GQA, SwiGLU; optionally qk-norm, a sliding
window and an LM head tied to the embedding), the gpt2 family
(LayerNorm, learned positions, fused qkv with biases, GELU MLP), the
MoE family (the dense block with a top-k expert layer, ``models/moe.py``,
in place of the MLP), and the recurrent families: ssm (Mamba2 blocks,
``models/mamba2.py``) and hybrid (Zamba2: a Mamba2 backbone with one
shared attention block over concat(hidden, initial embedding) at width
2d after every ``hybrid_attn_every`` layers), and the two families
that take embeddings instead of tokens (``cfg.embed_input`` False, no
``wte``): vlm (the dense block with M-RoPE over (3, B, S) position
streams) and audio (LayerNorm/GELU with sinusoidal positions).
Parameters are a plain dict tree with the reference's paths and stacked
layer axis; a weight may be a packed ``QTensor`` whose payloads carry
that axis too.
The reference's layer ``scan`` is a Python loop over layers that indexes
the stacked tensors.

``forward_seq`` is the full-sequence forward that calibration, the
quality metrics, training and the serve steps (``training/steps.py``)
run; under ``want_cache`` it returns the payload that
``cache_from_prefill`` turns into a decode cache. Caches: ``k``/``v`` of
shape ``(L, B, T, KH, Dh)`` and ``pos`` ``(B, T)`` int32 with -1 for an
empty slot, as in the reference; under ``cfg.kv_cache_quant``
``k``/``v`` hold int8 codes and ``k_scale``/``v_scale`` ``(L, B, T,
KH)`` their f32 per-row scales. A recurrent cache holds ``conv`` ``(L,
B, W-1, C)`` in the cache dtype and ``state`` ``(L, B, H, P, N)`` in
f32; hybrid adds one bf16 ring a shared-block application, ``k``/``v``
``(napp, B, T, KH, 2d/H)``, and ``pos``. Where the reference returns an
updated copy, ``decode_step``, ``prefill_chunk``, ``verify_chunk``,
``verify_scan``, ``cache_set_slots``, ``cache_scatter_pages``,
``cache_ring_rewind``, ``cache_scatter_checkpoints`` and
``cache_insert_checkpoints`` update the tensors in place (saving a copy
of the whole cache per step) and return the same dict.

The speculative-decoding pieces (``verify_chunk``, ``verify_scan``,
``cache_ring_snapshot``/``cache_ring_rewind``) and the prefix cache's page
and checkpoint copies (``cache_page_pool``, ``cache_gather_pages``,
``cache_scatter_pages``, ``cache_scatter_checkpoints``,
``cache_insert_checkpoints``) are the reference's.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core import calibrate as CAL
from repro_torch.core.quantize import QTensor, _div, _safe_inv
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE

_RECURRENT = ("ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    """Every family of the reference is ported (``ModelConfig`` refuses an
    unknown one); an activation or position embedding outside the
    reference's set raises."""
    unknown = [f for f, on in (
        (f"act {cfg.act!r}", cfg.act not in ("swiglu", "gelu")),
        (f"pos_emb {cfg.pos_emb!r}",
         cfg.pos_emb not in ("rope", "mrope", "sincos", "learned"))
    ) if on]
    if unknown:
        raise NotImplementedError(
            f"outside the reference's set: {', '.join(unknown)}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                dtype=torch.float32, device="cuda") -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and scales
    (normal / sqrt(fan_in)), drawn from ``generator`` in a fixed order. The
    generator must live on ``device``. The values differ from the
    reference's (a jax.random key); tests move the reference's parameters
    over with ``repro_torch.bridge`` instead."""
    _check_family(cfg)
    dev = resolve_device(device)
    d, Lc, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    H, KH, Dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff

    def dense_init(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w / math.sqrt(fan_in)).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(shape, dt=dtype):
        return torch.ones(shape, dtype=dt, device=dev)

    def norm_p(width, stacked=True):
        shape = (Lc, width) if stacked else (width,)
        out = {"w": ones(shape)}
        if cfg.norm_type == "layernorm":
            out["b"] = zeros(shape)
        return out

    p: Dict[str, Any] = {}
    if cfg.embed_input:
        p["wte"] = dense_init((V, d), d)
    if cfg.pos_emb == "learned":
        p["wpe"] = dense_init((cfg.max_position, d), 1.0) * 0.02
    if cfg.family in _RECURRENT:
        dd = M2.ssm_dims(cfg)
        Hs, f32 = dd["n_heads"], torch.float32
        p["layers"] = {"ln1": norm_p(d), "ssm": {
            "in_proj": dense_init((Lc, d, dd["d_proj"]), d),
            "out_proj": dense_init((Lc, dd["d_inner"], d), dd["d_inner"]),
            "conv_w": dense_init((Lc, cfg.ssm_conv_width, dd["conv_ch"]),
                                 4.0),
            "conv_b": zeros((Lc, dd["conv_ch"])),
            "A_log": torch.zeros((Lc, Hs), dtype=f32, device=dev),
            "D": ones((Lc, Hs), f32),
            "dt_bias": torch.zeros((Lc, Hs), dtype=f32, device=dev),
            "norm_w": ones((Lc, dd["d_inner"]))}}
        if cfg.family == "hybrid":
            d2, fh = 2 * d, cfg.hybrid_attn_d_ff or cfg.d_ff
            Dh2 = d2 // H
            p["shared"] = {
                "ln1": {"w": ones((d2,))}, "ln2": {"w": ones((d2,))},
                "attn": {"wq": dense_init((d2, H * Dh2), d2),
                         "wk": dense_init((d2, KH * Dh2), d2),
                         "wv": dense_init((d2, KH * Dh2), d2),
                         "wo": dense_init((H * Dh2, d2), H * Dh2)},
                "mlp": {"w_gate": dense_init((d2, fh), d2),
                        "w_up": dense_init((d2, fh), d2),
                        "w_down": dense_init((fh, d2), fh)},
                "proj_out": dense_init((d2, d), d2)}
    else:
        if cfg.fused_qkv:
            attn = {"c_attn": dense_init((Lc, d, 3 * d), d),
                    "b_attn": zeros((Lc, 3 * d)),
                    "c_proj": dense_init((Lc, d, d), d),
                    "b_proj": zeros((Lc, d))}
        else:
            attn = {"wq": dense_init((Lc, d, H * Dh), d),
                    "wk": dense_init((Lc, d, KH * Dh), d),
                    "wv": dense_init((Lc, d, KH * Dh), d),
                    "wo": dense_init((Lc, H * Dh, d), H * Dh)}
            if cfg.qk_norm:
                attn["q_norm"] = ones((Lc, Dh))
                attn["k_norm"] = ones((Lc, Dh))
        blk = {"ln1": norm_p(d), "ln2": norm_p(d), "attn": attn}
        if cfg.family == "moe":
            E, fe = cfg.n_experts, cfg.moe_d_ff
            blk["moe"] = {"router": dense_init((Lc, d, E), d),
                          "w_gate": dense_init((Lc, E, d, fe), d),
                          "w_up": dense_init((Lc, E, d, fe), d),
                          "w_down": dense_init((Lc, E, fe, d), fe)}
        elif cfg.act == "gelu":
            blk["mlp"] = {"c_fc": dense_init((Lc, d, f), d),
                          "b_fc": zeros((Lc, f)),
                          "c_proj": dense_init((Lc, f, d), f),
                          "b_proj": zeros((Lc, d))}
        else:
            blk["mlp"] = {"w_gate": dense_init((Lc, d, f), d),
                          "w_up": dense_init((Lc, d, f), d),
                          "w_down": dense_init((Lc, f, d), f)}
        p["layers"] = blk
    p["ln_f"] = norm_p(d, stacked=False)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((d, V), d)
    return p


def _layer(tree, i: int):
    """Layer ``i`` of the stacked layer tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.layer(i)
    return tree[i]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens=None, positions=None,
           embeds=None):
    """Token embeddings in ``cfg.dtype``, or the caller's ``embeds`` as
    they are: the reference does not cast them, so f32 embeddings into a
    bf16 config keep an f32 residual stream until a matmul rounds its
    input. Then the learned or sinusoidal positions (B, S) are added."""
    if embeds is not None:
        h = embeds
    else:
        # the embedding is never packed (qlinear never quantizes ``wte``)
        h = params["wte"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.pos_emb == "learned":
        # JAX clamps an out-of-range gather index, and the reference reads
        # past max_position (the padding columns of a prefill chunk, which
        # the engine pads to whole chunks); torch would raise, so clamp
        pos = positions.clamp(0, cfg.max_position - 1)
        h = h + params["wpe"][pos].to(h.dtype)
    elif cfg.pos_emb == "sincos":
        h = h + L.sincos_pos_emb(positions, cfg.d_model).to(h.dtype)
    return h


def _rope(cfg: ModelConfig, positions):
    """cos/sin tables for rotary archs, None otherwise. Under M-RoPE,
    (B, S) positions are text: the same position on all three streams."""
    if cfg.pos_emb == "rope":
        return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)
    if cfg.pos_emb != "mrope":
        return None
    if positions.dim() == 2:
        positions = positions[None].expand(3, *positions.shape)
    return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta,
                          cfg.mrope_sections)


def _mlp(m_in, lp, cfg: ModelConfig, impl):
    """The block's MLP and its MoE aux loss (None outside MoE; decode and
    prefill drop it, as the reference's do): the MoE layer, GELU or
    SwiGLU."""
    if cfg.family == "moe":
        return MOE.moe_block(m_in, lp["moe"], cfg)
    if cfg.act == "gelu":
        return L.gelu_mlp(m_in, lp["mlp"], impl=impl), None
    return L.swiglu_mlp(m_in, lp["mlp"], impl=impl), None


def _logits(params, cfg: ModelConfig, h, impl="auto"):
    if cfg.tie_embeddings:
        # the f32 product with the float embedding, as the reference's
        # einsum (no packed head, no kernel, no calibration tap); ``.to``
        # copies nothing where ``wte`` is f32 already
        wte = SH.gather_dp(params["wte"])
        return torch.matmul(h.to(torch.float32),
                            wte.to(torch.float32).t())
    CAL.tap("lm_head", h)
    return L.dense(h, params["lm_head"], impl=impl).to(torch.float32)


def _tp_attn_shards(cfg: ModelConfig) -> int:
    """Serve-TP shard count over attention heads (1 when inactive)."""
    plan = SH.serve_tp_plan()
    return plan.size if (plan is not None and plan.attn) else 1


def _qkv(a_in, lp, cfg: ModelConfig, impl):
    B, S, _ = a_in.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    # serve TP: wq/wk/wv are lane-sharded, so this rank's projection block
    # is its contiguous run of whole heads (no collective); the KV cache
    # holds the same kv heads and attention runs on the local counts
    s = _tp_attn_shards(cfg)
    H, KH = H // s, KH // s
    attn = lp["attn"]
    if cfg.fused_qkv:
        CAL.tap("attn/c_attn", a_in)
        qkv = L.dense(a_in, attn["c_attn"], impl=impl)
        qkv = qkv + attn["b_attn"].to(qkv.dtype)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
    elif s > 1:
        q, k, v = (L.tp_lane_dense(a_in, attn[w], "local", impl=impl)
                   for w in ("wq", "wk", "wv"))
    else:
        CAL.tap(("attn/wq", "attn/wk", "attn/wv"), a_in)
        q = L.dense(a_in, attn["wq"], impl=impl)
        k = L.dense(a_in, attn["wk"], impl=impl)
        v = L.dense(a_in, attn["wv"], impl=impl)
    q = SH.constrain(q.reshape(B, S, H, Dh), "dp", None, "model", None)
    k = SH.constrain(k.reshape(B, S, KH, Dh), "dp", None, "model", None)
    v = SH.constrain(v.reshape(B, S, KH, Dh), "dp", None, "model", None)
    if cfg.qk_norm:
        # per-head RMSNorm on q and k, before RoPE
        q = L.rmsnorm(q, attn["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, attn["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_out(o, lp, cfg, impl):
    B, S = o.shape[:2]
    o = SH.constrain(o, "dp", None, "model", None)
    o = o.reshape(B, S, o.shape[2] * o.shape[3])    # local heads * Dh
    attn = lp["attn"]
    if _tp_attn_shards(cfg) > 1:
        plan = SH.serve_tp_plan()
        if plan.attn_row:
            # this rank's heads are a contiguous K-row slice of wo: a
            # partial product and one all-reduce
            return L.tp_row_dense(o, attn["wo"], plan.attn_row, impl=impl)
        if plan.matmul == "sliced_row":
            # no row layout for wo: the ring matmul
            return L.tp_ring_dense(o, attn["wo"], impl=impl)
        # lane path: gather the head outputs, then wo's d_model lanes
        return L.tp_lane_dense(kops.tp_gather_lanes(o), attn["wo"], "full",
                               impl=impl)
    if cfg.fused_qkv:
        CAL.tap("attn/c_proj", o)
        out = SH.constrain(L.dense(o, attn["c_proj"], impl=impl),
                           "dp", None, None)
        return out + attn["b_proj"].to(out.dtype)
    CAL.tap("attn/wo", o)
    return SH.constrain(L.dense(o, attn["wo"], impl=impl), "dp", None, None)


def _full_heads(cfg: ModelConfig, fn, q, *kv, **kw):
    """``fn(q, *kv, **kw)``, a plain attention (naive, blockwise, decode,
    verify), at the single-device head counts under serve TP: this rank's
    q heads and the kv heads among ``kv`` (tensors of 4 dims, heads at
    dim 2) are zero-embedded into all H and KH heads, and this rank's
    heads of the output are returned. Its products batch over the heads,
    and the BLAS picks their kernel, and so their bits, by that count: on
    the CPU a decode over one kv head (a tp=4 rank of a 4-kv-head model)
    rounded otherwise than the same head among four. At the full counts
    every product keeps tp=1's shape, as the "padded" matmul does (the
    attention work is replicated; the KV ring stays sharded). The fused
    kernel runs each head alone and takes the local heads as they are."""
    s = _tp_attn_shards(cfg)
    if s == 1:
        return fn(q, *kv, **kw)
    i = SH.serve_tp_rank()

    def embed(t):
        if t.dim() != 4:
            return t
        n = t.shape[2]
        full = t.new_zeros(t.shape[:2] + (n * s,) + t.shape[3:])
        full[:, :, i * n:(i + 1) * n] = t
        return full
    h = q.shape[2]
    o = fn(embed(q), *(embed(t) for t in kv), **kw)
    return o[:, :, i * h:(i + 1) * h]


def _apply_rope(q, k, cos_sin):
    if cos_sin is None:
        return q, k
    cos, sin = cos_sin
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------

# ring-payload entries: the int8 ring adds per-row scales. A prefix-cache
# page carries these (``pos`` is stamped from the page's start position
# at scatter time, never stored)
_PAGE_KEYS = ("k", "v", "k_scale", "v_scale")
# recurrent checkpoint payload: one pool row holds the whole conv/SSM
# state after the page's last token (not per-position data), so a warm
# admission restores it and recomputes only the suffix
_STATE_KEYS = ("conv", "state")


def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer length: sliding-window archs only keep the window."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, B: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Zero/empty decode cache sized for contexts up to ``seq_len``; an
    int8 ring under ``cfg.kv_cache_quant``. Under a serve-TP plan that
    shards attention the KV payloads hold this rank's kv heads (axis 3,
    ``sharding.serve_cache_specs``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    T = attn_cache_len(cfg, seq_len)
    if cfg.family in _RECURRENT:
        return _recurrent_cache(cfg, B, T, dtype, dev)
    # under serve TP the ring holds this rank's kv heads only
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads // _tp_attn_shards(cfg),
             cfg.d_head)
    kdt = torch.int8 if cfg.kv_cache_quant else dtype
    cache = {"k": torch.zeros(shape, dtype=kdt, device=dev),
             "v": torch.zeros(shape, dtype=kdt, device=dev)}
    if cfg.kv_cache_quant:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
    cache["pos"] = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    return cache


def _recurrent_cache(cfg: ModelConfig, B: int, T: int, dtype, dev):
    """conv (L, B, W-1, C) in ``dtype`` and state (L, B, H, P, N) in f32;
    hybrid adds a bf16 ring of T positions for each application of the
    shared block (no int8 ring: the reference's hybrid cache has none)."""
    dd = M2.ssm_dims(cfg)
    Lc = cfg.n_layers
    cache = {
        "conv": torch.zeros((Lc, B, cfg.ssm_conv_width - 1, dd["conv_ch"]),
                            dtype=dtype, device=dev),
        "state": torch.zeros((Lc, B, dd["n_heads"], dd["head_dim"],
                              dd["state"]), dtype=torch.float32, device=dev)}
    if cfg.family == "hybrid":
        shape = (len(_shared_apps(cfg)), B, T, cfg.n_kv_heads,
                 2 * cfg.d_model // cfg.n_heads)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["pos"] = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    return cache


def _cache_batch(cache) -> int:
    """Batch slots of a decode cache (a ring-less ssm cache has no pos)."""
    return cache["pos"].shape[0] if "pos" in cache else cache["conv"].shape[1]


def _quantize_kv(x):
    """x: (..., Dh) -> (int8 codes, per-row f32 scale (...)): symmetric
    absmax over the head dim, as the reference. The scale divides by a
    tensor on x's device, so the card's codes equal the CPU's."""
    xf = x.to(torch.float32)
    scale = _div(xf.abs().amax(dim=-1), 127.0)
    q = torch.clamp(torch.round(xf * _safe_inv(scale)[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _ring_layer(cache, li: int) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s ring payloads (views, written in place)."""
    return {k: cache[k][li] for k in _PAGE_KEYS if k in cache}


def _ring_values(ring):
    """The K/V attention reads from a ring: the dequantized f32
    reconstruction of an int8 ring, else the ring itself."""
    if "k_scale" in ring:
        return (ring["k"].to(torch.float32) * ring["k_scale"][..., None],
                ring["v"].to(torch.float32) * ring["v_scale"][..., None])
    return ring["k"], ring["v"]


def _ring_entries(ring, k, v):
    """New K/V (..., KH, Dh) in the ring's storage form, and the values
    attention sees for them: ring-dtype rounding, or the int8 codes'
    reconstruction (so results do not depend on chunk bounds)."""
    if "k_scale" in ring:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return ({"k": kq, "v": vq, "k_scale": ks, "v_scale": vs},
                (kq.to(torch.float32) * ks[..., None],
                 vq.to(torch.float32) * vs[..., None]))
    store = {"k": k.to(ring["k"].dtype), "v": v.to(ring["v"].dtype)}
    return store, (store["k"], store["v"])


def _ring_store(ring, store, bidx, slot, keep) -> None:
    """In place: ``ring[e][bidx, slot] = store[e]`` for every entry, where
    ``keep`` (the index shape) is True; elsewhere the row is written back
    with what it held -- the reference's out-of-range "drop" without a
    host sync. The (bidx, slot) pairs must be distinct."""
    for name, val in store.items():
        r = ring[name]
        if keep is not None:
            m = keep.reshape(keep.shape + (1,) * (val.dim() - keep.dim()))
            val = torch.where(m, val, r[bidx, slot])
        r[bidx, slot] = val


def cache_set_slots(cache: Dict[str, Any], group_cache: Dict[str, Any],
                    indices) -> Dict[str, Any]:
    """Scatter a G-row group cache into batch slots ``indices`` (G,) of a
    multi-slot decode cache, in place. An index >= B drops that row (the
    scheduler points padding rows out of range)."""
    B = _cache_batch(cache)
    idx = torch.as_tensor(indices, dtype=torch.long).cpu()
    keep = idx < B
    rows = keep.nonzero()[:, 0]
    dst = idx[keep]
    if dst.numel() == 0:
        return cache
    dev = next(iter(cache.values())).device
    rows, dst = rows.to(dev), dst.to(dev)
    for k, v in cache.items():
        upd = group_cache[k].to(v.dtype)
        if k == "pos":
            v[dst] = upd[rows]
        else:
            v[:, dst] = upd[:, rows]
    return cache


def _ring_axis(key: str) -> int:
    """Axis of the ring (cache position) dimension of a cache entry:
    ``pos`` is (B, T), every payload (L, B, T, ...)."""
    return 1 if key == "pos" else 2


def cache_ring_snapshot(cache: Dict[str, Any], slots) -> Dict[str, Any]:
    """Copies of ring rows ``slots`` (B, S) of every cache entry (k/v,
    int8 scales, pos), taken before a speculative verify pass writes
    them."""
    return {k: kops.ring_gather(v, slots, ring_axis=_ring_axis(k))
            for k, v in cache.items()}


def cache_ring_rewind(cache: Dict[str, Any], snapshot: Dict[str, Any],
                      slots, keep) -> Dict[str, Any]:
    """Un-write rejected speculative entries, in place: restore snapshot
    column j into ring row ``slots[b, j]`` for every j >= keep[b]
    (columns below ``keep`` hold accepted tokens and stay). ``keep`` (B,)
    is a device tensor. Exact through ring wrap: a rejected draft that
    overwrote a still-in-window entry gets that entry back."""
    for k, snap in snapshot.items():
        kops.ring_restore(cache[k], snap, slots, keep,
                          ring_axis=_ring_axis(k))
    return cache


# ---------------------------------------------------------------------------
# page-granular cache copy (prefix cache)
# ---------------------------------------------------------------------------

def cache_page_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    """Pool entries a prefix-cache page carries: the ring payloads of the
    family's cache, and for the recurrent families the whole-state
    checkpoints (ssm has no ring; hybrid pages its shared-block ring and
    its conv/SSM checkpoints)."""
    if cfg.family == "ssm":
        return _STATE_KEYS
    if cfg.family == "hybrid":
        return _PAGE_KEYS[:2] + _STATE_KEYS
    return _PAGE_KEYS if cfg.kv_cache_quant else _PAGE_KEYS[:2]


def cache_page_pool(cfg: ModelConfig, n_pages: int, page: int,
                    dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Page pool for the prefix cache: every ring payload with the batch
    axis read as a page index and the ring axis ``page`` rows long, e.g.
    ``k`` (L, n_pages, page, KH, Dh). The live ring's dtypes (int8 + f32
    scales under kv_cache_quant), so page copies are bit for bit.
    Recurrent families add per-page checkpoints ``conv`` (L, n_pages,
    W-1, C) and ``state`` (L, n_pages, H, P, N): the state after the
    page's last token, indexed by page like a batch row. Under a serve-TP
    plan that shards attention the pool holds this rank's kv heads, as
    the ring does."""
    tmpl = init_cache(cfg, n_pages, page, dtype=dtype, device=device)
    return {k: tmpl[k] for k in cache_page_keys(cfg)}


def cache_page_bytes(cfg: ModelConfig, page: int,
                     dtype=torch.bfloat16) -> int:
    """Device bytes one page occupies (all payloads, all layers)."""
    pool = cache_page_pool(cfg, 1, page, dtype=dtype, device="meta")
    return sum(v.numel() * v.element_size() for v in pool.values())


def cache_gather_pages(cache: Dict[str, Any], rows, cols) -> Dict[str, Any]:
    """Copy page-shaped row blocks out of a decode cache: ``rows`` (n,)
    batch slots and ``cols`` (n, page) ring slots, both host arrays.
    Returns pool-layout payloads ((batch, ring) become (n, page))."""
    return {k: kops.page_gather(cache[k], rows, cols,
                                ring_axis=_ring_axis(k))
            for k in _PAGE_KEYS if k in cache}


def cache_scatter_pages(cache: Dict[str, Any], pages: Dict[str, Any], rows,
                        cols, positions) -> Dict[str, Any]:
    """Scatter pool pages into a decode cache in place and stamp their
    absolute ``positions`` (n, page) into ``pos``. ``rows``, ``cols`` and
    ``positions`` are host arrays; an entry of ``cols`` >= T drops that
    element, on the host: batch padding, and the copy-on-write path (a
    partial-page hit scatters only its matched leading rows)."""
    for k, pg in pages.items():
        kops.page_scatter(cache[k], pg, rows, cols, ring_axis=_ring_axis(k))
    kops.page_scatter(cache["pos"], positions, rows, cols, ring_axis=1)
    return cache


def cache_scatter_checkpoints(cache: Dict[str, Any], pool: Dict[str, Any],
                              idx, rows) -> Dict[str, Any]:
    """Restore recurrent checkpoints, in place: pool page rows ``idx``
    (n,) into batch rows ``rows`` (n,) of the cache's conv/state entries
    (whole-state row copies: checkpoints are not positional pages), both
    host arrays. A row >= B drops that element, filtered on the host
    (batch padding; its ``idx`` may be out of range). Destinations must
    be distinct."""
    idx, rows = kops._host_index(idx, "idx"), kops._host_index(rows, "rows")
    keep = rows < _cache_batch(cache)
    if not keep.any():
        return cache
    dev = cache["conv"].device
    i = torch.as_tensor(idx[keep], device=dev)
    r = torch.as_tensor(rows[keep], device=dev)
    for k in _STATE_KEYS:
        cache[k][:, r] = pool[k][:, i].to(cache[k].dtype)
    return cache


def cache_insert_checkpoints(pool: Dict[str, Any], cache: Dict[str, Any],
                             rows, idx) -> Dict[str, Any]:
    """Record recurrent checkpoints, in place: the cache's batch rows
    ``rows`` (n,) of conv/state into pool page rows ``idx`` (n,). The
    source is the inter-chunk state the scheduler's chunk loop holds, so
    a checkpoint is bit for bit the state a cold run carries at that page
    boundary. Both are host arrays; an ``idx`` >= n_pages drops (padding),
    filtered on the host."""
    idx, rows = kops._host_index(idx, "idx"), kops._host_index(rows, "rows")
    keep = idx < pool["conv"].shape[1]
    if not keep.any():
        return pool
    dev = pool["conv"].device
    i = torch.as_tensor(idx[keep], device=dev)
    r = torch.as_tensor(rows[keep], device=dev)
    for k in _STATE_KEYS:
        pool[k][:, i] = cache[k][:, r].to(pool[k].dtype)
    return pool


# ---------------------------------------------------------------------------
# decode (single new token against the cache)
# ---------------------------------------------------------------------------

def _attn_layer_decode(h, lp, ring, slot_pos, position, slot, cfg,
                       cos_sin, impl, live):
    """h: (B,1,d); ring: this layer's ring payloads (B,T,...), updated
    in place; position/slot: (B,); live: (B,) bool or None -- dead slots
    leave the cache untouched (their logits are garbage)."""
    B = h.shape[0]
    a_in = L.norm(h, lp["ln1"], cfg.norm_type, cfg.norm_eps)
    q, k, v = _qkv(a_in, lp, cfg, impl)
    q, k = _apply_rope(q, k, cos_sin)
    bidx = torch.arange(B, device=h.device)
    store, _ = _ring_entries(ring, k[:, 0], v[:, 0])
    _ring_store(ring, store, bidx, slot, live)  # in place: one row a slot
    k_eff, v_eff = _ring_values(ring)
    o = _full_heads(cfg, L.decode_attention, q, k_eff, v_eff, slot_pos,
                    position, window=cfg.sliding_window,
                    softcap=cfg.attn_logit_softcap)
    h = h + _attn_out(o, lp, cfg, impl)
    m_in = L.norm(h, lp["ln2"], cfg.norm_type, cfg.norm_eps)
    return h + _mlp(m_in, lp, cfg, impl)[0]


def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any], *,
                tokens=None, embeds=None, position, live=None):
    """One decode step. tokens: (B,) int, or embeds: (B, d) for a family
    without a token embedding; position: (B,) absolute position of the new
    token, its ring slot ``position % T`` and, on all three M-RoPE streams,
    its rotary position. Returns (logits (B, V) f32, cache), the cache
    updated in place.

    live: optional (B,) bool slot mask for continuous batching -- dead
    slots run the math but do NOT mutate their cache or position
    book-keeping, so a freed slot can be re-admitted without stale state."""
    _check_family(cfg)
    impl = cfg.kernel_impl
    B = position.shape[0]
    h = SH.constrain(_embed(params, cfg, tokens, position, embeds),
                     "dp", None)[:, None, :]               # (B,1,d)
    if cfg.family in _RECURRENT:
        h = _recurrent_decode(params, cfg, cache, h, position, live, impl)
        h = L.norm(h, params["ln_f"], cfg.norm_type, cfg.norm_eps)
        return _logits(params, cfg, h[:, 0], impl=impl), cache
    cos_sin = _rope(cfg, position[:, None])

    T = cache["k"].shape[2]
    slot = position % T
    bidx = torch.arange(B, device=h.device)
    pos_new = position.to(torch.int32)
    if live is not None:
        pos_new = torch.where(live, pos_new, cache["pos"][bidx, slot])
    cache["pos"][bidx, slot] = pos_new      # in place
    slot_pos = cache["pos"]
    for li in range(cfg.n_layers):
        h = _attn_layer_decode(h, _layer(params["layers"], li),
                               _ring_layer(cache, li), slot_pos, position,
                               slot, cfg, cos_sin, impl, live)
    h = L.norm(h, params["ln_f"], cfg.norm_type, cfg.norm_eps)
    return _logits(params, cfg, h[:, 0], impl=impl), cache


def lm_logits(params, cfg: ModelConfig, h):
    """LM head on final-norm hidden states h (..., d) -> logits f32. The
    scheduler gathers the few rows it needs (each sequence's last prompt
    token) and runs the vocab matmul on just those."""
    return _logits(params, cfg, h, impl=cfg.kernel_impl)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def prefill_chunk(params, cfg: ModelConfig, cache: Dict[str, Any], *,
                  tokens, start: int, lengths):
    """One batched prefill chunk against a decode cache.

    tokens: (B, C) int, right-padded; start: absolute position of column
    0 (shared by every row); lengths: (B,) true prompt lengths. Columns at
    positions >= lengths are padding: they run the math but never write
    the KV ring and never win attention. A row with length 0 is a group
    padding dummy. Each chunk's queries attend the pre-chunk ring plus the
    chunk's own keys, then the chunk's K/V land in the ring at
    ``position % T`` -- the same semantics as ``decode_step`` once per
    token, with MatMul-shaped batches. Requires C <= ring length.
    ``cfg.attn_impl == "fused"`` takes the fused prefill attention (the
    CUDA kernel on the card); any other value the naive path.

    A warm admission (prefix cache) scatters a prompt's cached positions
    below ``start`` into the ring first; the chunk then attends them
    there, as a later chunk of a cold prefill attends earlier chunks.

    The recurrent families run the same masked-chunk contract through
    ``_recurrent_chunk``: invalid columns are identity on the conv/SSM
    state, so trailing pads never reach it. A warm admission restores a
    checkpoint and starts the chunk grid at its horizon.

    Returns (final-norm hidden (B, C, d), cache updated in place)."""
    _check_family(cfg)
    B, C = tokens.shape
    positions = (start + torch.arange(C, dtype=torch.long,
                                      device=tokens.device))[None].expand(B, C)
    valid = positions < lengths[:, None]
    if cfg.family in _RECURRENT:
        return _recurrent_chunk(params, cfg, cache, tokens, positions, valid)
    attn_impl = "fused" if cfg.attn_impl == "fused" else "naive"
    attn = functools.partial(L.prefill_attention, impl=attn_impl)
    if attn_impl == "naive":
        attn = functools.partial(_full_heads, cfg, attn)
    return _masked_chunk(params, cfg, cache, tokens, positions, valid, attn)


def verify_chunk(params, cfg: ModelConfig, cache: Dict[str, Any], *,
                 tokens, positions, valid):
    """Score a per-slot block of tokens against the decode cache in one
    batched forward (the speculative-decoding verify pass): the masked
    chunk of ``prefill_chunk`` with explicit per-row ``positions`` (B, C)
    and ``valid`` (B, C), its attention ``layers.verify_attention``
    (decode's dataflow column by column). Writes for drafts that turn out
    rejected are undone by ``cache_ring_rewind``. Returns (final-norm
    hidden (B, C, d), cache updated in place)."""
    _check_family(cfg)
    return _masked_chunk(params, cfg, cache, tokens, positions, valid,
                         functools.partial(_full_heads, cfg,
                                           L.verify_attention))


def verify_scan(params, cfg: ModelConfig, cache: Dict[str, Any], *,
                tokens, positions, valid):
    """Bit-exact verify: ``decode_step`` once per column of the block,
    each with ``live = valid[:, j]``, so every column's logits are plain
    decode's. Same arguments as ``verify_chunk``; returns (logits
    (B, C, V) f32, cache updated in place)."""
    logits = []
    for j in range(tokens.shape[1]):
        lg, cache = decode_step(params, cfg, cache, tokens=tokens[:, j],
                                position=positions[:, j], live=valid[:, j])
        logits.append(lg)
    return torch.stack(logits, dim=1), cache


def _masked_chunk(params, cfg: ModelConfig, cache, tokens, positions, valid,
                  attn_fn):
    """Shared body of prefill_chunk / verify_chunk: one (B, C) masked
    chunk forward against the ring, writing valid columns at
    ``positions % T``; ``attn_fn`` is the chunk attention."""
    if cfg.family in _RECURRENT:
        raise NotImplementedError(
            f"the ring-masked chunk body is KV-cache-only; family "
            f"{cfg.family!r} prefills through _recurrent_chunk and cannot "
            f"verify drafts (a dense recurrent state has no ring rewind)")
    impl = cfg.kernel_impl
    B, C = tokens.shape
    T = cache["k"].shape[2]
    if C > T:
        raise ValueError(f"chunk of {C} columns exceeds the ring ({T})")
    h = _embed(params, cfg, tokens, positions)
    cos_sin = _rope(cfg, positions)

    # a row's C positions are distinct mod T (C <= T), so each column owns
    # its ring slot: invalid columns write back what the slot held, which
    # is the reference's out-of-range "drop" without a host sync
    bidx = torch.arange(B, device=tokens.device)[:, None]
    slot = positions % T
    old_pos = cache["pos"].clone()          # every layer attends pre-chunk
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        ring = _ring_layer(cache, li)
        a_in = L.norm(h, lp["ln1"], cfg.norm_type, cfg.norm_eps)
        q, k, v = _qkv(a_in, lp, cfg, impl)
        q, k = _apply_rope(q, k, cos_sin)
        store, (k_chunk, v_chunk) = _ring_entries(ring, k, v)
        k_ring, v_ring = _ring_values(ring)
        o = attn_fn(q, k_ring, v_ring, old_pos, k_chunk, v_chunk, positions,
                    valid, window=cfg.sliding_window,
                    softcap=cfg.attn_logit_softcap)
        # in place, after the attention above read the pre-write ring
        _ring_store(ring, store, bidx, slot, valid)
        h = h + _attn_out(o, lp, cfg, impl)
        m_in = L.norm(h, lp["ln2"], cfg.norm_type, cfg.norm_eps)
        h = h + _mlp(m_in, lp, cfg, impl)[0]
    cache["pos"][bidx, slot] = torch.where(
        valid, positions.to(torch.int32), old_pos[bidx, slot])
    h = L.norm(h, params["ln_f"], cfg.norm_type, cfg.norm_eps)
    return h, cache


# ---------------------------------------------------------------------------
# full-sequence forward (calibration and quality evaluation)
# ---------------------------------------------------------------------------

# the longest sequence the "auto" attention takes naive, as the reference
NAIVE_MAX_SEQ = 2048


def _seq_attention(q, k, v, cfg: ModelConfig, S: int):
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "naive" if S <= NAIVE_MAX_SEQ else "blockwise"
    if impl == "naive":
        return _full_heads(cfg, L.naive_attention, q, k, v, causal=True,
                           window=cfg.sliding_window,
                           softcap=cfg.attn_logit_softcap)
    if impl == "fused":
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "attn_impl='fused' has no backward pass: the CUDA prefill "
                "attention kernel cannot be differentiated (nor can the "
                "reference's Pallas kernel); train with attn_impl='naive' "
                "or 'blockwise'")
        B, S2 = q.shape[:2]
        pos = torch.arange(S2, dtype=torch.int32, device=q.device)
        pos = pos[None].expand(B, S2).contiguous()
        return L.prefill_attn_fused(q, k, v, pos, pos,
                                    window=cfg.sliding_window,
                                    softcap=cfg.attn_logit_softcap)
    if impl == "blockwise":
        return _full_heads(cfg, L.blockwise_attention, q, k, v, causal=True,
                           window=cfg.sliding_window,
                           softcap=cfg.attn_logit_softcap,
                           q_chunk=cfg.attn_q_chunk,
                           kv_chunk=cfg.attn_kv_chunk)
    raise ValueError(f"unknown attention impl {impl!r}; known: naive, "
                     "blockwise, fused, auto")


def _attn_layer_seq(h, lp, cfg: ModelConfig, cos_sin, impl):
    """One block over the whole sequence: (h, its MoE aux loss or None,
    its post-RoPE (k, v) (B, S, KH, Dh), the layer's cache payload)."""
    a_in = L.norm(h, lp["ln1"], cfg.norm_type, cfg.norm_eps)
    q, k, v = _qkv(a_in, lp, cfg, impl)
    q, k = _apply_rope(q, k, cos_sin)
    o = _seq_attention(q, k, v, cfg, h.shape[1])
    h = h + _attn_out(o, lp, cfg, impl)
    m_in = L.norm(h, lp["ln2"], cfg.norm_type, cfg.norm_eps)
    out, aux = _mlp(m_in, lp, cfg, impl)
    return h + out, aux, (k, v)


def _layers(tree, n: int):
    """The stacked layer tree as ``n`` per-layer trees of views. A tensor
    is split by one ``unbind``, whose backward stacks the layers'
    gradients once; indexing a layer at a time would give every layer a
    zero gradient the size of the whole stack."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    if isinstance(tree, QTensor):
        return [tree.layer(i) for i in range(n)]
    return list(torch.unbind(tree, 0))


def forward_seq(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                positions=None, want_cache=False, return_hidden=False,
                with_aux=False):
    """Full-sequence causal forward of tokens (B, S), or of ``embeds``
    (B, S, d) for a family without a token embedding (vlm, audio), taken
    as they are (not cast to ``cfg.dtype``, as in the reference).
    ``positions`` defaults to 0..S-1 on every row (and every M-RoPE
    stream); it may be (B, S), or (3, B, S) under M-RoPE, and feeds the
    learned or sinusoidal embedding (stream 0) and the rotary tables. The
    attention is causal in sequence order whatever the positions, as the
    reference's (the fused kernel is given 0..S-1), and hybrid's shared
    block rotates by 0..S-1.

    Returns logits (B, S, V) in f32, the reference's first output, or
    under ``return_hidden`` the final-norm hidden states (B, S, d), from
    which the chunked loss computes its own head product. ``with_aux``
    returns (that, the MoE aux loss summed over layers, an f32 scalar; 0
    for the other families), as training reads it; ``want_cache`` returns
    (that, aux, the cache payload), as the reference's triple, for
    ``cache_from_prefill``: post-RoPE (k, v) (L, B, S, KH, Dh) for the
    attention families, the final (conv (L, B, W-1, C), state (L, B, H,
    P, N)) for ssm, and for hybrid those plus its shared-block (k, v)
    (napp, B, S, KH, 2d/H).

    Under ``cfg.remat``, where autograd records, each layer runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass (the
    reference's ``jax.checkpoint`` on its scan body: the Mamba2 layers,
    not hybrid's shared block). The forward bits are the same either
    way."""
    _check_family(cfg)
    impl = cfg.kernel_impl
    x = tokens if tokens is not None else embeds
    B, S = x.shape[:2]
    dev = x.device
    seq_pos = torch.arange(S, device=dev)[None].expand(B, S)
    if positions is None:
        positions = seq_pos
    pos2d = positions[0] if positions.dim() == 3 else positions
    # the residual stream over the batch (sharding.constrain: the
    # identity outside a dry run, where it anchors DTensor's layout)
    h = SH.constrain(_embed(params, cfg, tokens, pos2d, embeds),
                     "dp", None, None)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, x):
        if remat:
            return torch.utils.checkpoint.checkpoint(fn, x,
                                                     use_reentrant=False)
        return fn(x)

    layers = _layers(params["layers"], cfg.n_layers)
    payload = []
    if cfg.family in _RECURRENT:
        emb0, apps, shared = h, _shared_apps(cfg), []
        for li, lp in enumerate(layers):
            h, states = run(lambda x, lp=lp: _ssm_layer(x, lp, cfg, impl), h)
            if want_cache:
                payload.append(states)
            if li in apps:
                h, kv = _shared_block_seq(h, emb0, params["shared"], cfg,
                                          seq_pos, impl)
                if want_cache:
                    shared.append(kv)
        if want_cache:
            caches = tuple(torch.stack(t) for t in zip(*payload))
            if cfg.family == "hybrid":
                caches += (tuple(torch.stack(t) for t in zip(*shared))
                           if shared else None,)
    else:
        cos_sin = _rope(cfg, positions)
        for lp in layers:
            h, a, kv = run(functools.partial(_attn_layer_seq, lp=lp, cfg=cfg,
                                             cos_sin=cos_sin, impl=impl), h)
            if a is not None:
                aux = aux + a
            if want_cache:
                payload.append(kv)
        if want_cache:
            caches = tuple(torch.stack(t) for t in zip(*payload))
    h = L.norm(h, params["ln_f"], cfg.norm_type, cfg.norm_eps)
    out = h if return_hidden else _logits(params, cfg, h, impl=impl)
    if want_cache:
        return out, aux, caches
    return (out, aux) if with_aux else out


def cache_from_prefill(cfg: ModelConfig, caches, seq_len: int,
                       cache_len=None, dtype=torch.bfloat16
                       ) -> Dict[str, Any]:
    """A decode cache from ``forward_seq(want_cache=True)``'s payload of
    a ``seq_len``-token prefill, as the reference's: a ring of ``T =
    cache_len`` (default ``attn_cache_len(cfg, seq_len)``) slots. With
    S >= T the last T positions stay, rolled so that position p sits in
    slot p % T; otherwise the ring is padded with empty (pos -1) slots.
    Under ``cfg.kv_cache_quant`` the ring is int8 with per-row scales
    (absmax over the head dim, as ``decode_step`` writes them). ssm keeps
    its final conv (in ``dtype``) and f32 state; hybrid adds its
    shared-block rings, which must hold the whole prefill. The tensors
    lie on the payload's device."""
    _check_family(cfg)
    T = cache_len or attn_cache_len(cfg, seq_len)
    if cfg.family == "ssm":
        conv, state = caches
        return {"conv": conv.to(dtype), "state": state}
    if cfg.family == "hybrid":
        conv, state, (k, v) = caches
        S = k.shape[2]
        if S > T:
            raise ValueError(f"hybrid prefill of {S} positions is longer "
                             f"than the cache ({T})")
        k, v, pos = _ring_pad(k, v, T)
        return {"conv": conv.to(dtype), "state": state, "k": k.to(dtype),
                "v": v.to(dtype), "pos": pos}
    k, v = caches                                       # (L, B, S, KH, Dh)
    B, S = k.shape[1:3]
    if S >= T:
        # keep the last T positions; position p goes to slot p % T
        shift = (S - T) % T
        k = torch.roll(k[:, :, S - T:], shift, dims=2)
        v = torch.roll(v[:, :, S - T:], shift, dims=2)
        pos = torch.roll(torch.arange(S - T, S, dtype=torch.int32,
                                      device=k.device), shift)
        pos = pos[None].expand(B, T).contiguous()
    else:
        k, v, pos = _ring_pad(k, v, T)
    if cfg.kv_cache_quant:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "pos": pos}
    return {"k": k.to(dtype), "v": v.to(dtype), "pos": pos}


def _ring_pad(k, v, T: int):
    """(k, v) (n, B, S, KH, Dh) padded with zeros to T ring slots, and
    ``pos`` (B, T): 0..S-1, then -1 for the empty slots."""
    n, B, S = k.shape[:3]
    pad = (0, 0, 0, 0, 0, T - S)
    pos = torch.full((B, T), -1, dtype=torch.int32, device=k.device)
    pos[:, :S] = torch.arange(S, dtype=torch.int32, device=k.device)
    return (torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad), pos)


# ---------------------------------------------------------------------------
# the recurrent families: Mamba2 layers and zamba2's shared block
# ---------------------------------------------------------------------------

def _hybrid_groups(cfg: ModelConfig):
    """Layer-group sizes between shared-block applications."""
    k, n = cfg.hybrid_attn_every, cfg.n_layers
    groups = []
    while n > 0:
        groups.append(min(k, n))
        n -= k
    return groups


def _shared_apps(cfg: ModelConfig) -> Dict[int, int]:
    """Layer index -> shared-block application that follows it: one after
    each full group (a short last group has none); empty for ssm."""
    if cfg.family != "hybrid":
        return {}
    apps, i0 = {}, 0
    for g in _hybrid_groups(cfg):
        i0 += g
        if g == cfg.hybrid_attn_every:
            apps[i0 - 1] = len(apps)
    return apps


def _ssm_layer(h, lp, cfg: ModelConfig, impl, **kw):
    """h + mamba2_forward(ln1(h)); returns (h, (conv, state))."""
    a_in = L.norm(h, lp["ln1"], cfg.norm_type, cfg.norm_eps)
    out, states = M2.mamba2_forward(a_in, lp["ssm"], cfg, impl=impl, **kw)
    return h + out, states


def _shared_qkv(h, emb0, sp, cfg: ModelConfig, positions, impl):
    """The shared block's input u = concat(h, emb0) (B, S, 2d) and its
    rotated q, k and v at head dim 2d / H."""
    B, S, d = h.shape
    u = torch.cat([h, emb0], dim=-1)
    a_in = L.rmsnorm(u, sp["ln1"]["w"], cfg.norm_eps)
    Dh2 = 2 * d // cfg.n_heads
    q = L.dense(a_in, sp["attn"]["wq"], impl=impl)
    k = L.dense(a_in, sp["attn"]["wk"], impl=impl)
    v = L.dense(a_in, sp["attn"]["wv"], impl=impl)
    q = q.reshape(B, S, cfg.n_heads, Dh2)
    k = k.reshape(B, S, cfg.n_kv_heads, Dh2)
    v = v.reshape(B, S, cfg.n_kv_heads, Dh2)
    cos, sin = L.rope_cos_sin(positions, Dh2, cfg.rope_theta)
    return u, L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def _shared_out(h, u, o, sp, cfg: ModelConfig, impl):
    """o-projection, SwiGLU and proj_out of the shared block, added to h."""
    B, S = o.shape[:2]
    u = u + L.dense(o.reshape(B, S, -1), sp["attn"]["wo"], impl=impl)
    m_in = L.rmsnorm(u, sp["ln2"]["w"], cfg.norm_eps)
    u = u + L.swiglu_mlp(m_in, sp["mlp"], impl=impl)
    return h + L.dense(u, sp["proj_out"], impl=impl)


def _shared_block_seq(h, emb0, sp, cfg: ModelConfig, positions, impl):
    """Zamba2's shared attention block over (h ++ initial embedding),
    causal over the whole sequence: (h, its post-RoPE (k, v))."""
    u, q, k, v = _shared_qkv(h, emb0, sp, cfg, positions, impl)
    o = _seq_attention(q, k, v, cfg, h.shape[1])
    return _shared_out(h, u, o, sp, cfg, impl), (k, v)


def _store_state(cache, li: int, conv, state, live) -> None:
    """In place: layer ``li``'s conv/state rows, cast to the cache's
    dtypes, where ``live`` (B,) is True (every row when None); dead rows
    keep what they held."""
    if live is not None:
        conv = torch.where(live[:, None, None], conv, cache["conv"][li])
        state = torch.where(live[:, None, None, None], state,
                            cache["state"][li])
    cache["conv"][li] = conv
    cache["state"][li] = state


def _shared_ring(cache, app: int) -> Dict[str, torch.Tensor]:
    """Application ``app``'s ring payloads (views, written in place)."""
    return {"k": cache["k"][app], "v": cache["v"][app]}


def _recurrent_decode(params, cfg: ModelConfig, cache, h, position, live,
                      impl):
    """decode_step's ssm and hybrid body: one token through every Mamba2
    layer's recurrence (and hybrid's shared block against its rings),
    the cache updated in place. h: (B, 1, d)."""
    apps = _shared_apps(cfg)
    if apps:
        B = h.shape[0]
        T = cache["k"].shape[2]
        slot = position % T
        bidx = torch.arange(B, device=h.device)
        pos_new = position.to(torch.int32)
        if live is not None:
            pos_new = torch.where(live, pos_new, cache["pos"][bidx, slot])
        cache["pos"][bidx, slot] = pos_new
        emb0 = h
    for li in range(cfg.n_layers):
        lp = _layer(params["layers"], li)
        a_in = L.norm(h, lp["ln1"], cfg.norm_type, cfg.norm_eps)
        out, (cs, ss) = M2.mamba2_decode(a_in[:, 0], lp["ssm"], cfg,
                                         cache["conv"][li],
                                         cache["state"][li], impl=impl)
        _store_state(cache, li, cs, ss, live)
        h = h + out[:, None]
        if li in apps:
            sp = params["shared"]
            ring = _shared_ring(cache, apps[li])
            u, q, k, v = _shared_qkv(h, emb0, sp, cfg, position[:, None],
                                     impl)
            store, _ = _ring_entries(ring, k[:, 0], v[:, 0])
            _ring_store(ring, store, bidx, slot, live)
            o = L.decode_attention(q, ring["k"], ring["v"], cache["pos"],
                                   position, window=cfg.sliding_window)
            h = _shared_out(h, u, o, sp, cfg, impl)
    return h


def _recurrent_chunk(params, cfg: ModelConfig, cache, tokens, positions,
                     valid):
    """Masked (B, C) prefill chunk for the recurrent families: the
    counterpart of ``_masked_chunk``. ``valid`` is a contiguous prefix of
    each row. Invalid columns run the math but are identity on the
    recurrent state (``mamba2_forward(valid=...)``), so a row whose prompt
    ended mid-chunk, or a group-padding dummy of length 0, carries the
    state of an exact-length run. Hybrid's shared block takes the KV
    families' chunk semantics against its rings: queries attend the
    pre-chunk ring plus the chunk's own ring-dtype keys, then valid
    columns land at ``position % T``. Returns (final-norm hidden, cache
    updated in place)."""
    impl = cfg.kernel_impl
    B, C = tokens.shape
    h = _embed(params, cfg, tokens, positions)
    apps = _shared_apps(cfg)
    if apps:
        T = cache["k"].shape[2]
        if C > T:
            raise ValueError(f"chunk of {C} columns exceeds the ring ({T})")
        bidx = torch.arange(B, device=tokens.device)[:, None]
        slot = positions % T
        old_pos = cache["pos"].clone()      # every application attends
        emb0 = h                            # the pre-chunk ring
    for li in range(cfg.n_layers):
        h, (cs, ss) = _ssm_layer(h, _layer(params["layers"], li), cfg, impl,
                                 conv_state=cache["conv"][li],
                                 ssm_state=cache["state"][li], valid=valid)
        _store_state(cache, li, cs, ss, None)
        if li in apps:
            sp = params["shared"]
            ring = _shared_ring(cache, apps[li])
            u, q, k, v = _shared_qkv(h, emb0, sp, cfg, positions, impl)
            store, (k_chunk, v_chunk) = _ring_entries(ring, k, v)
            o = L.prefill_attention(q, ring["k"], ring["v"], old_pos,
                                    k_chunk, v_chunk, positions, valid,
                                    window=cfg.sliding_window)
            _ring_store(ring, store, bidx, slot, valid)
            h = _shared_out(h, u, o, sp, cfg, impl)
    if apps:
        cache["pos"][bidx, slot] = torch.where(
            valid, positions.to(torch.int32), old_pos[bidx, slot])
    h = L.norm(h, params["ln_f"], cfg.norm_type, cfg.norm_eps)
    return h, cache
