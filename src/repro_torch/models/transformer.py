"""Transformer: init, chunked prefill and decode against a KV ring.

Counterpart of ``repro.models.transformer`` for the dense llama family
(RMSNorm, split-half RoPE, GQA, SwiGLU; optionally qk-norm, a sliding
window and an LM head tied to the embedding), the gpt2 family
(LayerNorm, learned positions, fused qkv with biases, GELU MLP) and the
MoE family (the dense block with a top-k expert layer, ``models/moe.py``,
in place of the MLP).
Parameters are a plain dict tree with the reference's paths and stacked
layer axis; a weight may be a packed ``QTensor`` whose payloads carry
that axis too.
The reference's layer ``scan`` is a Python loop over layers that indexes
the stacked tensors.

``forward_seq`` is the cache-free full-sequence forward that calibration
and the quality metrics run. Caches: ``k``/``v`` of shape
``(L, B, T, KH, Dh)`` and ``pos`` ``(B, T)`` int32 with -1 for an empty
slot, as in the reference; under ``cfg.kv_cache_quant`` ``k``/``v`` hold
int8 codes and ``k_scale``/``v_scale`` ``(L, B, T, KH)`` their f32
per-row scales. Where the reference returns an updated copy,
``decode_step``, ``prefill_chunk``, ``verify_chunk``, ``verify_scan``,
``cache_set_slots``, ``cache_scatter_pages`` and ``cache_ring_rewind``
update the cache tensors in place (saving a copy of the whole cache per
step) and return the same dict.

The speculative-decoding pieces (``verify_chunk``, ``verify_scan``,
``cache_ring_snapshot``/``cache_ring_rewind``) and the prefix cache's page
copies (``cache_page_pool``, ``cache_gather_pages``,
``cache_scatter_pages``) are the reference's.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core import calibrate as CAL
from repro_torch.core.quantize import QTensor, _div, _safe_inv
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

_PORTED_FAMILIES = ("dense", "gpt2", "moe")


def _check_family(cfg: ModelConfig) -> None:
    """The port has the dense llama family, gpt2 and MoE; vlm, audio,
    ssm and hybrid are ROADMAP queue 1 item 5."""
    unported = [f for f, on in (
        (f"family {cfg.family!r} (ROADMAP queue 1 item 5)",
         cfg.family not in _PORTED_FAMILIES),
        (f"act {cfg.act!r}", cfg.act not in ("swiglu", "gelu")),
        (f"pos_emb {cfg.pos_emb!r}", cfg.pos_emb not in ("rope", "learned"))
    ) if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")


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

    def norm_p(width, stacked=True):
        shape = (Lc, width) if stacked else (width,)
        out = {"w": torch.ones(shape, dtype=dtype, device=dev)}
        if cfg.norm_type == "layernorm":
            out["b"] = zeros(shape)
        return out

    p: Dict[str, Any] = {"wte": dense_init((V, d), d)}
    if cfg.pos_emb == "learned":
        p["wpe"] = dense_init((cfg.max_position, d), 1.0) * 0.02
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
            attn["q_norm"] = torch.ones((Lc, Dh), dtype=dtype, device=dev)
            attn["k_norm"] = torch.ones((Lc, Dh), dtype=dtype, device=dev)
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

def _embed(params, cfg: ModelConfig, tokens, positions):
    # the embedding is never packed (qlinear never quantizes ``wte``)
    h = params["wte"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.pos_emb == "learned":
        # JAX clamps an out-of-range gather index, and the reference reads
        # past max_position (the padding columns of a prefill chunk, which
        # the engine pads to whole chunks); torch would raise, so clamp
        pos = positions.clamp(0, cfg.max_position - 1)
        h = h + params["wpe"][pos].to(h.dtype)
    return h


def _rope(cfg: ModelConfig, positions):
    """cos/sin tables for rotary archs, None for learned positions."""
    if cfg.pos_emb != "rope":
        return None
    return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)


def _mlp(m_in, lp, cfg: ModelConfig, impl):
    """The block's MLP: the MoE layer (its aux loss dropped, as the
    reference's decode and prefill drop it), GELU or SwiGLU."""
    if cfg.family == "moe":
        return MOE.moe_block(m_in, lp["moe"], cfg)[0]
    if cfg.act == "gelu":
        return L.gelu_mlp(m_in, lp["mlp"], impl=impl)
    return L.swiglu_mlp(m_in, lp["mlp"], impl=impl)


def _logits(params, cfg: ModelConfig, h, impl="auto"):
    if cfg.tie_embeddings:
        # the f32 product with the float embedding, as the reference's
        # einsum (no packed head, no kernel, no calibration tap); ``.to``
        # copies nothing where ``wte`` is f32 already
        wte = params["wte"]
        return torch.matmul(h.to(torch.float32),
                            wte.to(torch.float32).t())
    CAL.tap("lm_head", h)
    return L.dense(h, params["lm_head"], impl=impl).to(torch.float32)


def _qkv(a_in, lp, cfg: ModelConfig, impl):
    B, S, _ = a_in.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = lp["attn"]
    if cfg.fused_qkv:
        CAL.tap("attn/c_attn", a_in)
        qkv = L.dense(a_in, attn["c_attn"], impl=impl)
        qkv = qkv + attn["b_attn"].to(qkv.dtype)
        q, k, v = torch.chunk(qkv, 3, dim=-1)
    else:
        CAL.tap(("attn/wq", "attn/wk", "attn/wv"), a_in)
        q = L.dense(a_in, attn["wq"], impl=impl)
        k = L.dense(a_in, attn["wk"], impl=impl)
        v = L.dense(a_in, attn["wv"], impl=impl)
    q, k = q.reshape(B, S, H, Dh), k.reshape(B, S, KH, Dh)
    if cfg.qk_norm:
        # per-head RMSNorm on q and k, before RoPE
        q = L.rmsnorm(q, attn["q_norm"], cfg.norm_eps)
        k = L.rmsnorm(k, attn["k_norm"], cfg.norm_eps)
    return q, k, v.reshape(B, S, KH, Dh)


def _attn_out(o, lp, cfg, impl):
    B, S = o.shape[:2]
    o = o.reshape(B, S, o.shape[2] * o.shape[3])
    attn = lp["attn"]
    if cfg.fused_qkv:
        CAL.tap("attn/c_proj", o)
        out = L.dense(o, attn["c_proj"], impl=impl)
        return out + attn["b_proj"].to(out.dtype)
    CAL.tap("attn/wo", o)
    return L.dense(o, attn["wo"], impl=impl)


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


def attn_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer length: sliding-window archs only keep the window."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_cache(cfg: ModelConfig, B: int, seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Zero/empty decode cache sized for contexts up to ``seq_len``; an
    int8 ring under ``cfg.kv_cache_quant``."""
    _check_family(cfg)
    dev = resolve_device(device)
    T = attn_cache_len(cfg, seq_len)
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.d_head)
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
    B = cache["pos"].shape[0]
    idx = torch.as_tensor(indices, dtype=torch.long).cpu()
    keep = idx < B
    rows = keep.nonzero()[:, 0]
    dst = idx[keep]
    if dst.numel() == 0:
        return cache
    dev = cache["pos"].device
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
    """Pool entries a prefix-cache page carries: the ring payloads."""
    return _PAGE_KEYS if cfg.kv_cache_quant else _PAGE_KEYS[:2]


def cache_page_pool(cfg: ModelConfig, n_pages: int, page: int,
                    dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """Page pool for the prefix cache: every ring payload with the batch
    axis read as a page index and the ring axis ``page`` rows long, e.g.
    ``k`` (L, n_pages, page, KH, Dh). The live ring's dtypes (int8 + f32
    scales under kv_cache_quant), so page copies are bit for bit."""
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
    o = L.decode_attention(q, k_eff, v_eff, slot_pos, position,
                           window=cfg.sliding_window,
                           softcap=cfg.attn_logit_softcap)
    h = h + _attn_out(o, lp, cfg, impl)
    m_in = L.norm(h, lp["ln2"], cfg.norm_type, cfg.norm_eps)
    return h + _mlp(m_in, lp, cfg, impl)


def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any], *,
                tokens, position, live=None):
    """One decode step. tokens: (B,) int; position: (B,) absolute position
    of the new token. Returns (logits (B, V) f32, cache), the cache updated
    in place.

    live: optional (B,) bool slot mask for continuous batching -- dead
    slots run the math but do NOT mutate their cache or position
    book-keeping, so a freed slot can be re-admitted without stale state."""
    _check_family(cfg)
    impl = cfg.kernel_impl
    B = tokens.shape[0]
    h = _embed(params, cfg, tokens, position)[:, None, :]   # (B,1,d)
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

    Returns (final-norm hidden (B, C, d), cache updated in place)."""
    _check_family(cfg)
    B, C = tokens.shape
    positions = (start + torch.arange(C, dtype=torch.long,
                                      device=tokens.device))[None].expand(B, C)
    valid = positions < lengths[:, None]
    attn_impl = "fused" if cfg.attn_impl == "fused" else "naive"
    return _masked_chunk(params, cfg, cache, tokens, positions, valid,
                         functools.partial(L.prefill_attention,
                                           impl=attn_impl))


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
                         L.verify_attention)


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
        h = h + _mlp(m_in, lp, cfg, impl)
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
        return L.naive_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window,
                                 softcap=cfg.attn_logit_softcap)
    if impl == "fused":
        B, S2 = q.shape[:2]
        pos = torch.arange(S2, dtype=torch.int32, device=q.device)
        pos = pos[None].expand(B, S2).contiguous()
        return L.prefill_attn_fused(q, k, v, pos, pos,
                                    window=cfg.sliding_window,
                                    softcap=cfg.attn_logit_softcap)
    if impl == "blockwise":
        return L.blockwise_attention(q, k, v, causal=True,
                                     window=cfg.sliding_window,
                                     softcap=cfg.attn_logit_softcap,
                                     q_chunk=cfg.attn_q_chunk,
                                     kv_chunk=cfg.attn_kv_chunk)
    raise ValueError(f"unknown attention impl {impl!r}; known: naive, "
                     "blockwise, fused, auto")


def _attn_layer_seq(h, lp, cfg: ModelConfig, cos_sin, impl):
    a_in = L.norm(h, lp["ln1"], cfg.norm_type, cfg.norm_eps)
    q, k, v = _qkv(a_in, lp, cfg, impl)
    q, k = _apply_rope(q, k, cos_sin)
    o = _seq_attention(q, k, v, cfg, h.shape[1])
    h = h + _attn_out(o, lp, cfg, impl)
    m_in = L.norm(h, lp["ln2"], cfg.norm_type, cfg.norm_eps)
    return h + _mlp(m_in, lp, cfg, impl)


def forward_seq(params, cfg: ModelConfig, *, tokens):
    """Full-sequence causal forward of tokens (B, S) at positions 0..S-1,
    with no cache. Returns logits (B, S, V) in f32 (the reference's first
    output; the port returns no MoE aux loss, which only training reads,
    and has no ``want_cache``)."""
    _check_family(cfg)
    impl = cfg.kernel_impl
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    h = _embed(params, cfg, tokens, positions)
    cos_sin = _rope(cfg, positions)
    for li in range(cfg.n_layers):
        h = _attn_layer_seq(h, _layer(params["layers"], li), cfg, cos_sin,
                            impl)
    h = L.norm(h, params["ln_f"], cfg.norm_type, cfg.norm_eps)
    return _logits(params, cfg, h, impl=impl)
