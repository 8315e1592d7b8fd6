"""Family adapters: the engine <-> model contract as an explicit object.

Counterpart of ``repro.models.state``. ``FamilyCaps`` is one row of the
per-family capability table (KV ring or recurrent state, speculation,
prefix caching mode, tensor and expert parallelism), consulted by one
validation pass, ``validate_serve_features``, when an engine is built.
``DecodeState`` is the adapter the engine drives a family's decode cache
through: init, slot scatter, ring snapshot and rewind, page and
checkpoint copies. Every method delegates to ``models.transformer``.

The table is the reference's, all seven rows, whether or not the port
serves the family yet (``transformer._check_family`` says which it does:
vlm and audio are ROADMAP queue 1 item 5). Capability semantics:

* ``kv_ring``: the decode cache is a position-addressed KV ring; pages,
  speculation rollback and attention-head TP key off it.
* ``recurrent``: the cache carries dense conv/SSM state. It is
  positional, so prefix caching stores whole-state checkpoints at page
  boundaries, and speculation is impossible (no rewind un-writes it).
* ``prefix_mode``: "pages" (per-position ring payload) or "checkpoints"
  (full pages only, the page pinned to the prefill chunk).
* ``ring_bounded_context``: prompt + budget must fit the ring (ssm has no
  ring and decodes unbounded contexts).
* ``expert_parallel``: MoE expert stacks may shard over the model axis.
* ``capacity_follows_chunk`` (the port's own, not in the reference's
  row): a layer's per-row capacity depends on the prefill chunk's length
  (MoE), so a warm prefix group keeps the cold prefill's whole chunks
  (``Engine._group_shape``) instead of a chunk cut to its suffix.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import FAMILIES, ModelConfig
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class FamilyCaps:
    """One row of the family capability table."""
    family: str
    kv_ring: bool                 # position-addressed KV ring cache
    recurrent: bool               # dense conv/SSM state in the cache
    chunked_prefill: bool = True  # batched masked (B, C) prefill chunks
    speculative: bool = False     # draft/verify with ring rewind
    prefix_cache: bool = False    # shared-prefix reuse supported
    prefix_mode: str = "none"     # "pages" | "checkpoints" | "none"
    tensor_parallel: bool = False  # serve-TP over attention heads
    expert_parallel: bool = False  # experts shardable over the model axis
    ring_bounded_context: bool = True  # prompt+budget must fit the ring
    capacity_follows_chunk: bool = False  # the port's: chunk-sized capacity


_KV = dict(kv_ring=True, recurrent=False, speculative=True,
           prefix_cache=True, prefix_mode="pages", tensor_parallel=True)
_RECURRENT = dict(kv_ring=False, recurrent=True, speculative=False,
                  prefix_cache=True, prefix_mode="checkpoints",
                  tensor_parallel=False)

CAPS: Dict[str, FamilyCaps] = {
    "dense": FamilyCaps(family="dense", **_KV),
    "gpt2": FamilyCaps(family="gpt2", **_KV),
    "vlm": FamilyCaps(family="vlm", **_KV),
    "audio": FamilyCaps(family="audio", **_KV),
    "moe": FamilyCaps(family="moe", expert_parallel=True,
                      capacity_follows_chunk=True, **_KV),
    # ssm has no attention ring at all: context is unbounded
    "ssm": FamilyCaps(family="ssm", ring_bounded_context=False,
                      **_RECURRENT),
    # hybrid's shared-attention ring bounds its context like a KV family
    "hybrid": FamilyCaps(family="hybrid", **_RECURRENT),
}

# every registered family must carry a capability row: a family added to
# configs/base.FAMILIES without one fails here at import, not at runtime
assert set(CAPS) == set(FAMILIES), \
    f"capability table out of sync with FAMILIES: {set(CAPS) ^ set(FAMILIES)}"

KV_FAMILIES: Tuple[str, ...] = tuple(f for f, c in CAPS.items() if c.kv_ring)


def family_caps(cfg: ModelConfig) -> FamilyCaps:
    caps = CAPS.get(cfg.family)
    if caps is None:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return caps


# feature -> (FamilyCaps attribute, reason an unsupported family raises).
# Every reason mentions the recurrent state: the only families outside
# the KV-ring set are the recurrent ones.
FEATURES: Dict[str, Tuple[str, str]] = {
    "tensor-parallel serving": (
        "tensor_parallel",
        "recurrent state sharding is a training-side concern"),
    "speculative decoding": (
        "speculative",
        "a dense recurrent state cannot be rolled back when drafts are "
        "rejected"),
    # every family supports prefix caching (KV families page the ring,
    # recurrent families checkpoint state at chunk boundaries); the row
    # keeps the validation pass total over the feature matrix
    "prefix caching": (
        "prefix_cache",
        "the decode cache has no page- or checkpoint-granular export"),
}


def validate_serve_features(cfg: ModelConfig, *, tp: int = 1,
                            drafter: bool = False,
                            prefix_cache: bool = False) -> FamilyCaps:
    """One validation pass over the family x feature matrix.

    Raises ValueError of one shape -- ``"<feature> needs a KV-ring family
    (got <family>); <why>"`` -- for any requested feature the family's
    capability row does not support. Returns the capability row."""
    caps = family_caps(cfg)
    requested = {"tensor-parallel serving": tp > 1,
                 "speculative decoding": drafter,
                 "prefix caching": prefix_cache}
    for feature, (attr, why) in FEATURES.items():
        if requested.get(feature) and not getattr(caps, attr):
            raise ValueError(
                f"{feature} needs a KV-ring family (got {cfg.family!r}); "
                f"{why}")
    return caps


class DecodeState:
    """Adapter the engine drives a family's decode cache through.

    Stateless: the cache tensors live with the engine. Methods that make
    sense for one side of the kv_ring/recurrent split assert on the
    capability row, not on ``cfg.family`` strings."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.caps = family_caps(cfg)

    # -- lifecycle ---------------------------------------------------------
    def init(self, B: int, seq_len: int, dtype=torch.bfloat16,
             device="cuda") -> Dict[str, Any]:
        return T.init_cache(self.cfg, B, seq_len, dtype=dtype, device=device)

    def set_slots(self, cache, group_cache, indices) -> Dict[str, Any]:
        return T.cache_set_slots(cache, group_cache, indices)

    # -- speculation (KV ring only) ----------------------------------------
    def ring_snapshot(self, cache, slots) -> Dict[str, Any]:
        assert self.caps.speculative, self.caps.family
        return T.cache_ring_snapshot(cache, slots)

    def ring_rewind(self, cache, snapshot, slots, keep) -> Dict[str, Any]:
        assert self.caps.speculative, self.caps.family
        return T.cache_ring_rewind(cache, snapshot, slots, keep)

    # -- prefix cache pages / checkpoints ----------------------------------
    def page_pool(self, n_pages: int, page: int, dtype=torch.bfloat16,
                  device="cuda") -> Dict[str, Any]:
        assert self.caps.prefix_cache, self.caps.family
        return T.cache_page_pool(self.cfg, n_pages, page, dtype=dtype,
                                 device=device)

    def page_bytes(self, page: int) -> int:
        return T.cache_page_bytes(self.cfg, page)

    def gather_pages(self, cache, rows, cols) -> Dict[str, Any]:
        return T.cache_gather_pages(cache, rows, cols)

    def scatter_pages(self, cache, pages, rows, cols,
                      positions) -> Dict[str, Any]:
        return T.cache_scatter_pages(cache, pages, rows, cols, positions)

    def scatter_checkpoints(self, cache, pool, idx, rows) -> Dict[str, Any]:
        assert self.caps.prefix_mode == "checkpoints", self.caps.family
        return T.cache_scatter_checkpoints(cache, pool, idx, rows)

    def insert_checkpoints(self, pool, cache, rows, idx) -> Dict[str, Any]:
        assert self.caps.prefix_mode == "checkpoints", self.caps.family
        return T.cache_insert_checkpoints(pool, cache, rows, idx)
