"""Host-side radix tree over token-ID prefixes for the paged KV prefix
cache (SGLang-style RadixAttention, adapted to this engine's contiguous
slot rings). The port's own copy of ``repro.serving.prefix_cache``, line
for line in its logic: the port imports nothing of the JAX package.

The device side is a fixed-capacity page pool (``transformer.
cache_page_pool``): every cached page is ``page`` consecutive positions'
worth of KV rows (all layers, int8 scales included), copied bit-for-bit
out of a freshly prefilled group cache and copied back into a later
request's ring at admission. Because slot caches receive page COPIES
(gather -> scatter, never aliases), attention kernels are untouched and
greedy output stays token-identical to a cold prefill.

This module owns everything host-side:

* the radix tree: one node per page, keyed by that page's token tuple,
  so a lookup descends page by page along the longest cached prefix.
  Position is implicit (a node at depth d covers positions
  [d*page, (d+1)*page)) -- prefixes always start at position 0.
* partial-page hits: when the longest match ends mid-page, the best
  child's leading rows are still reusable (``take < page``); the engine
  scatters just those rows and recomputes the divergent tail --
  copy-on-write at row granularity (the pool page is never mutated).
* refcounts + LRU eviction: a node's refcount is its child count, so
  only childless nodes (tree leaves) are evictable; under pool-capacity
  pressure the least-recently-touched evictable leaf is freed. Evicting
  never breaks an in-flight admission: matched pages are device-copied
  before any insertion can evict them.
* the byte budget: capacity is ``prefix_bytes // cache_page_bytes``,
  fixed at engine construction, so device memory for the pool is bounded
  and allocated once.

Matching is capped at ``len(tokens) - 1``: the last prompt token always
recomputes, because its logits seed the first sampled token (the same
rule vLLM/SGLang apply).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class _Node:
    __slots__ = ("key", "page_idx", "children", "parent", "stamp")

    def __init__(self, key: Tuple[int, ...], page_idx: int,
                 parent: "_Node"):
        self.key = key                  # this page's token ids
        self.page_idx = page_idx        # row in the device page pool
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.parent = parent
        self.stamp = 0                  # LRU clock value at last touch

    @property
    def refcount(self) -> int:
        return len(self.children)


class PrefixCache:
    """Radix tree + page-pool accounting. Pure host state: device copies
    are the engine's job (it owns the pool arrays)."""

    def __init__(self, page: int, capacity: int):
        if page < 1:
            raise ValueError(f"page must be >= 1, got {page}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.page = page
        self.capacity = capacity
        self._root = _Node((), -1, None)
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._clock = 0
        self.evictions = 0              # lifetime counter
        self.insert_drops = 0           # lifetime counter: full pages an
                                        # insert() dropped because the pool
                                        # was exhausted and nothing was
                                        # evictable (saturated-pool signal)

    # -- introspection ------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    # -- lookup -------------------------------------------------------------
    def match(self, tokens: List[int]) -> Tuple[int, List[Tuple[int, int, int]]]:
        """Longest cached prefix of ``tokens``, capped at len(tokens)-1.

        Returns (matched_len, pages) with pages a list of
        (pool_idx, start_pos, take): ``take == page`` for full pages, and
        at most one trailing partial page (``take < page``) when the
        match ends inside a cached page. Touches every matched node's LRU
        stamp."""
        page = self.page
        cap = len(tokens) - 1
        node = self._root
        pages: List[Tuple[int, int, int]] = []
        m = 0
        while m + page <= cap:
            child = node.children.get(tuple(tokens[m:m + page]))
            if child is None:
                break
            self._touch(child)
            pages.append((child.page_idx, m, page))
            node = child
            m += page
        # partial-page hit: longest common prefix with any child's page
        want = tokens[m:min(m + page, cap)]
        best_r, best_child = 0, None
        for key, child in node.children.items():
            r = 0
            for a, b in zip(key, want):
                if a != b:
                    break
                r += 1
            if r > best_r:
                best_r, best_child = r, child
        if best_child is not None:
            self._touch(best_child)
            pages.append((best_child.page_idx, m, best_r))
            m += best_r
        return m, pages

    def match_len(self, tokens: List[int]) -> int:
        """Overlap score for router probes: the length ``match`` would
        return, WITHOUT touching LRU stamps -- a router scoring one
        request against every worker's tree must not distort the eviction
        order of the workers it does not pick."""
        page = self.page
        cap = len(tokens) - 1
        node = self._root
        m = 0
        while m + page <= cap:
            child = node.children.get(tuple(tokens[m:m + page]))
            if child is None:
                break
            node = child
            m += page
        want = tokens[m:min(m + page, cap)]
        best_r = 0
        for key in node.children:
            r = 0
            for a, b in zip(key, want):
                if a != b:
                    break
                r += 1
            best_r = max(best_r, r)
        return m + best_r

    def page_chain(self, tokens: List[int]) -> List[Tuple[int, int]]:
        """The FULL-page chain cached for ``tokens``: [(pool_idx,
        start_pos), ...] for every whole page resident from position 0,
        stopping at the first miss. Unlike ``match`` there is no len-1
        cap and no partial-page entry -- this is the export granularity
        for cross-engine KV hand-off (pool pages only exist whole).
        Touches LRU stamps: an exported page was genuinely used."""
        page = self.page
        node = self._root
        chain: List[Tuple[int, int]] = []
        m = 0
        while m + page <= len(tokens):
            child = node.children.get(tuple(tokens[m:m + page]))
            if child is None:
                break
            self._touch(child)
            chain.append((child.page_idx, m))
            node = child
            m += page
        return chain

    # -- insertion / eviction ------------------------------------------------
    def _evict_one(self, protect: set) -> Optional[int]:
        """Free the least-recently-touched childless node not in
        ``protect`` (the current insertion batch's paths). Returns its
        pool index, or None if nothing is evictable. The DFS is
        O(pages_in_use) host-side python; it only runs once the pool is
        full and per page actually allocated, and the pool capacity is
        bounded by the byte budget -- negligible next to the device
        prefill it rides behind."""
        victim = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif id(n) not in protect and (victim is None
                                           or n.stamp < victim.stamp):
                victim = n
        if victim is None:
            return None
        del victim.parent.children[victim.key]
        self.evictions += 1
        return victim.page_idx

    def _alloc(self, protect: set) -> Optional[int]:
        if self._free:
            return self._free.pop()
        return self._evict_one(protect)

    def insert(self, tokens: List[int],
               protect: Optional[set] = None) -> List[Tuple[int, int]]:
        """Record ``tokens``'s full pages, allocating pool rows for pages
        not already cached (evicting LRU leaves under capacity pressure).
        Returns [(pool_idx, start_pos), ...] for the NEW pages -- the
        engine must copy those rows out of its freshly prefilled cache.
        Stops early (dropping the tail) if the pool is exhausted and
        nothing is evictable; the dropped page count accumulates in
        ``insert_drops`` so saturated pools are diagnosable. Matched
        pages are LRU-touched, so a re-hit after eviction re-inserts and
        re-ranks naturally.

        ``protect``: nodes eviction must not free. The caller batching
        SEVERAL insertions into one device copy passes a shared set so a
        later insertion can never evict (and recycle the pool index of) a
        page an earlier insertion in the same batch just allocated --
        duplicate destinations in one batched copy would race. Each
        call adds its own path to the set."""
        page = self.page
        node = self._root
        path: set = set() if protect is None else protect
        new: List[Tuple[int, int]] = []
        for q in range(len(tokens) // page):
            key = tuple(tokens[q * page:(q + 1) * page])
            child = node.children.get(key)
            if child is None:
                idx = self._alloc(path)
                if idx is None:
                    self.insert_drops += len(tokens) // page - q
                    break
                child = _Node(key, idx, node)
                node.children[key] = child
                new.append((idx, q * page))
            self._touch(child)
            path.add(id(child))
            node = child
        return new

    def clear(self) -> None:
        self._root = _Node((), -1, None)
        self._free = list(range(self.capacity - 1, -1, -1))
