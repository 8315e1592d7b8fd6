"""KV-aware request router for disaggregated prefill/decode serving.

Counterpart of ``repro.serving.router`` (the port keeps its own copy:
it imports nothing of the JAX package). The router sits in front of N
prefill-worker and M decode-worker engines (``serving/disagg.py``) and
answers two questions a request:

* **which prefill worker?** Score the prompt against every prefill
  worker's radix tree (``Engine.prefix_match_len``: host state only, no
  LRU side effects) and route to the longest cached prefix, so a shared
  system prompt concentrates where its KV already lives. Ties break to
  the shallowest queue, then the lowest worker index: deterministic, so
  routed output can be pinned token for token.
* **which decode worker?** The least outstanding requests, ties to the
  lowest index. Decode placement needs no KV affinity: the migrated
  pages travel with the request (``export_kv_pages``/``import_kv_pages``).

It also keeps the counts: requests and overlap hits a prefill worker,
pages migrated a decode worker, queue depths (live and peak), in
``snapshot()``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence


class KVRouter:
    """Host-side scoring and bookkeeping. The router never touches device
    state: migration itself is the DisaggEngine's job (it owns the
    export/import calls); the router only decides placement and counts
    what happened."""

    def __init__(self, prefill_workers: Sequence, decode_workers: Sequence):
        if not prefill_workers or not decode_workers:
            raise ValueError("router needs >= 1 prefill and >= 1 decode "
                             "worker")
        self._pw = list(prefill_workers)
        self._dw = list(decode_workers)
        nP, nD = len(self._pw), len(self._dw)
        # live queue depths (outstanding requests per worker) + peaks
        self._p_depth = [0] * nP
        self._d_depth = [0] * nD
        self._p_peak = [0] * nP
        self._d_peak = [0] * nD
        # lifetime counters
        self.prefill_requests = [0] * nP
        self.prefill_overlap_hits = [0] * nP
        self.prefill_overlap_tokens = [0] * nP
        self.decode_requests = [0] * nD
        self.migrated_pages = [0] * nD
        self.direct_decode = 0          # requests too small to page
        # double-done / done-without-pick calls used to drive a depth
        # negative and bias least-loaded placement toward that worker
        # forever after; they now clamp at 0 and count here
        self.depth_underflows = 0

    # -- placement ----------------------------------------------------------
    def pick_prefill(self, prompt: List[int]) -> int:
        """Route a prompt to the prefill worker with maximal radix-tree
        overlap (ties: shallowest queue, then lowest index)."""
        scores = [w.prefix_match_len(prompt) for w in self._pw]
        best = max(range(len(self._pw)),
                   key=lambda i: (scores[i], -self._p_depth[i], -i))
        self.prefill_requests[best] += 1
        if scores[best] > 0:
            self.prefill_overlap_hits[best] += 1
            self.prefill_overlap_tokens[best] += scores[best]
        self._p_depth[best] += 1
        self._p_peak[best] = max(self._p_peak[best], self._p_depth[best])
        return best

    def pick_decode(self) -> int:
        """Least-loaded decode worker (ties: lowest index)."""
        best = max(range(len(self._dw)),
                   key=lambda i: (-self._d_depth[i], -i))
        self.decode_requests[best] += 1
        self._d_depth[best] += 1
        self._d_peak[best] = max(self._d_peak[best], self._d_depth[best])
        return best

    # -- bookkeeping --------------------------------------------------------
    def note_prefill_done(self, worker: int) -> None:
        """Mark one outstanding prefill finished. A depth can never go
        below zero: a stray extra done (double-done, or done without a
        matching pick) would otherwise make that worker look permanently
        shallower than it is, silently corrupting every future
        least-loaded tie-break. Clamp and count instead."""
        if self._p_depth[worker] <= 0:
            self.depth_underflows += 1
            self._p_depth[worker] = 0
            return
        self._p_depth[worker] -= 1

    def note_decode_done(self, worker: int) -> None:
        """Decode twin of note_prefill_done (same clamp rationale)."""
        if self._d_depth[worker] <= 0:
            self.depth_underflows += 1
            self._d_depth[worker] = 0
            return
        self._d_depth[worker] -= 1

    def note_migrated(self, worker: int, n_pages: int) -> None:
        self.migrated_pages[worker] += n_pages

    def note_direct_decode(self) -> None:
        self.direct_decode += 1

    # -- observability ------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Router stats for engine stats / benchmark rows: per-worker
        request counts, overlap-hit rates, migrated pages, and queue
        depths (live + peak)."""
        rate = lambda h, n: round(h / n, 4) if n else 0.0
        return dict(
            prefill_workers=len(self._pw),
            decode_workers=len(self._dw),
            prefill_requests=list(self.prefill_requests),
            prefill_overlap_hits=list(self.prefill_overlap_hits),
            prefill_overlap_tokens=list(self.prefill_overlap_tokens),
            prefill_hit_rate=[rate(h, n) for h, n in
                              zip(self.prefill_overlap_hits,
                                  self.prefill_requests)],
            decode_requests=list(self.decode_requests),
            migrated_pages=list(self.migrated_pages),
            migrated_pages_total=sum(self.migrated_pages),
            direct_decode=self.direct_decode,
            depth_underflows=self.depth_underflows,
            prefill_queue_depth=list(self._p_depth),
            decode_queue_depth=list(self._d_depth),
            prefill_peak_depth=list(self._p_peak),
            decode_peak_depth=list(self._d_peak),
        )
