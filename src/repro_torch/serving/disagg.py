"""Disaggregated prefill/decode serving: N prefill-worker and M
decode-worker engines behind a KV-aware router.

Counterpart of ``repro.serving.disagg``. Monolithic serving makes prefill
and decode take turns on the same slots: every admission stalls the
decode loop for a whole chunked-prefill group. Disaggregation splits the
phases onto separate engines: prefill workers only run admissions, and
decode workers only see prompts whose KV is already resident. Every
worker is a port ``Engine`` on the same device, sharing the one
``params`` tree already there (no worker copies the weights); on one
card the tiers take turns, in waves.

The hand-off rides the paged prefix cache end to end:

1. **route**: the router (``serving/router.py``) scores the prompt against
   every prefill worker's radix tree and routes to the longest overlap.
2. **prefill**: the chosen worker admits the prompt with a 1-token budget
   (pure prefill; the sampled token is discarded, the decode worker
   samples its own), and its prefix cache copies the prompt's full KV
   pages into its page pool.
3. **migrate**: ``Engine.export_kv_pages`` copies those pool pages to host
   memory bit for bit (int8 codes and scales included) and
   ``Engine.import_kv_pages`` copies them into the routed decode worker's
   pool and radix tree: one device-to-host and one host-to-device copy.
4. **decode**: the request is submitted to the decode worker, whose
   ordinary prefix-cache admission matches the imported pages, scatters
   them into its ring, prefills only the rest (from the match rounded
   down to a prefill-chunk boundary, the port's warm grid) and decodes.

**The parity contract.** The decode worker samples every token, the first
included, from its own stream with the draw discipline a monolithic
engine uses, and warm admission gives cold prefill's tokens
(``tests/test_torch_prefix_cache.py``). So with one decode worker, routed
output is token-identical to one monolithic ``Engine`` with the same
ServeConfig, greedy and at a temperature, across causal, windowed and
int8-KV rings, with speculation and the prefix cache on the workers.
With M decode workers greedy output stays token-identical; temperature
splits into per-worker streams. Prefill-token stats count each tier's
own prefill (the decode tier recomputes up to one chunk past the pages).

``poll`` (``run(poll=)``) is called once a wave, as in the reference, and
also at every scheduler iteration of every worker's run, so a front end's
arrivals, cancels and timeouts land between chunks in the middle of a
wave too (arrivals join the next wave); ``cancel`` reaches a request at
any stage.

**Over tensor-parallel engines** (``ServeConfig.tp`` = N > 1). Both
tiers have the same degree, as in the reference, which builds every
worker from one ServeConfig. All N + M workers open on **one**
``TPGroup`` of N ranks (made here, or passed in as ``group=``), as the
reference's engines all shard over the same ``devs[:tp]``: rank 0 is
this process and its one scheduler thread issues every engine's device
programs in turn, each rank runs them on its own shards. The weights are
sharded once (``TPGroup.put_shards``) and every worker opens on that one
shard set, so a rank holds one copy of them whatever N and M are. The
hand-off keeps its protocol: the prefill worker's export gathers the kv
heads of every rank into host memory (one all-gather a payload), and the
decode worker's import ships the payload to its ranks with the program
(CPU tensors cross by shared memory, not through the pipe), each of
which copies its own kv heads into its pool. With the "padded" datapath
each rank's products keep the single-device shapes, so greedy and
temperature tokens equal the tp = 1 ``DisaggEngine``'s and the
monolithic ``Engine``'s (same ServeConfig, same seed). A program that
fails on any rank aborts the group, and the ``DisaggEngine`` with it: it
raises and counts as closed, never carrying on at tp = 1 or on fewer
workers. ``close()`` (or ``with``) drops every worker, then the shard
set, then the group if this engine made it; a group passed in stays
open.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.group import TPGroup
from repro_torch.models.state import KV_FAMILIES
from repro_torch.serving.engine import (Engine, EngineSaturated, Request,
                                        ServeConfig)
from repro_torch.serving.router import KVRouter


class DisaggEngine:
    """N prefill + M decode engines, one router, page migration through
    host memory. Its surface mirrors ``Engine``: submit/cancel/run/
    generate/close and a ``stats`` dict (summed over the workers, plus
    the router's ``snapshot()`` under ``router``). ``params`` must
    already lie on ``device`` (rank 0's, at tp > 1); with no GPU the
    default device raises, pass ``device="cpu"`` for the CPU path.

    At ``serve_cfg.tp`` = N > 1 every worker is an N-rank engine on one
    group: ``group``, a ``TPGroup`` of N ranks that outlives this engine,
    or one made here with its ranks placed by ``device`` as ``Engine``
    places them (``distributed.group.rank_devices``: "cuda" puts rank r
    on cuda:r and raises with fewer cards, a list such as
    ``["cuda:0"] * N`` shares a card, "cpu" takes any N)."""

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 prefill_workers: int = 1, decode_workers: int = 1,
                 device="cuda", *, group: Optional[TPGroup] = None):
        tp = serve_cfg.tp
        if prefill_workers < 1 or decode_workers < 1:
            raise ValueError(
                f"need >= 1 prefill and >= 1 decode worker, got "
                f"{prefill_workers}P + {decode_workers}D")
        if cfg.family not in KV_FAMILIES:
            raise ValueError(
                f"disaggregated serving needs a KV-ring family (got "
                f"{cfg.family!r}): recurrent state is not positional and "
                "cannot be handed off as pages")
        if tp > 1 and group is not None:
            if group.size != tp or group.closed:
                raise ValueError(f"group of {group.size} ranks (closed: "
                                 f"{group.closed}) for tp={tp}")
        elif group is not None:
            raise ValueError(f"group= serves tp > 1 engines, got tp={tp}")
        # the plan validates tp_matmul before any worker starts
        plan = SH.make_serve_tp_plan(cfg, tp, matmul=serve_cfg.tp_matmul,
                                     params=params, ep=serve_cfg.tp_ep)
        self.cfg = cfg
        self.scfg = serve_cfg
        self.group: Optional[TPGroup] = None
        self._own_group, self._sid, self._closed = False, None, False
        self.prefill_engines: List[Engine] = []
        self.decode_engines: List[Engine] = []
        if tp > 1:
            self._own_group = group is None
            self.group = group or TPGroup(tp, device)
            self.device = self.group.device
        else:
            self.device = resolve_device(device)
        # decode workers are the serving engines: the same config (seed,
        # slots, drafter, sampling: the parity contract), the prefix cache
        # on because imported pages land in it
        dcfg = dataclasses.replace(serve_cfg, prefix_cache=True)
        # prefill workers never decode (1-token budgets finish at the first
        # token), so they need no drafter; their prefix cache is the
        # router's scoring state and the export source
        pcfg = dataclasses.replace(serve_cfg, prefix_cache=True,
                                   drafter=None)
        try:
            kw = {}
            if tp > 1:
                # one weight shard set a rank for every worker
                self._sid = self.group.put_shards(params, plan)
                kw = dict(group=self.group, shards=self._sid)
            for _ in range(decode_workers):
                self.decode_engines.append(
                    Engine(cfg, params, dcfg, device=self.device, **kw))
            for _ in range(prefill_workers):
                self.prefill_engines.append(
                    Engine(cfg, params, pcfg, device=self.device, **kw))
        except BaseException:
            self.close()
            raise
        self.router = KVRouter(self.prefill_engines, self.decode_engines)
        self._page = self.prefill_engines[0]._page
        self._T = self.decode_engines[0]._T
        self._queue: collections.deque = collections.deque()
        self._wave: List[Request] = []      # taken from the queue, not yet
                                            # handed to a decode worker
        self._results: Dict[int, Request] = {}
        self._handoff: Dict[Any, Request] = {}  # (worker, worker_req_id)
        self._next_id = 0
        self._run_t0: Optional[float] = None
        self.stats: Dict[str, Any] = self._fresh_stats()

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        """Closed by ``close()``, or by a program that failed and aborted
        the group."""
        return self._closed or (self.group is not None and self.group.closed)

    def _check_open(self) -> None:
        if self.closed:
            self.close()
            raise RuntimeError("the disaggregated engine is closed (closed, "
                               "or its TP group was aborted by a failure)")

    def close(self) -> None:
        """Drop every worker engine, then the shard set, then the group
        if this engine made it (a ``group`` passed in stays open and only
        forgets them). Idempotent; stats and results stay readable."""
        if self._closed:
            return
        self._closed = True
        for eng in self.prefill_engines + self.decode_engines:
            eng.close()
        if self.group is not None:
            if self._sid is not None:
                self.group.drop_shards(self._sid)
            if self._own_group:
                self.group.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- stats ---------------------------------------------------------------
    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        s = Engine._fresh_stats()
        s.update(migrated_pages=0, migrated_requests=0,
                 prefill_prefix_hits=0, prefill_prefix_tokens_reused=0,
                 handoff_s=0.0, handoff_bytes=0, handoff_pipe_bytes=0,
                 router={})
        return s

    def _absorb(self, ws: Dict[str, float], decode: bool) -> None:
        """Fold one worker's cycle stats into the sum. Both tiers add their
        prefill counters and forwards (a decode worker still prefills each
        request's uncached tail); only decode workers add the decode,
        token, speculation and prefix-serving counters. A prefill worker's
        radix hits are reported apart: they measure routing locality, not
        serving reuse."""
        for k in ("prefill_s", "prefill_tokens", "prefill_groups",
                  "host_syncs", "forwards", "prefill_forwards"):
            self.stats[k] += ws[k]
        if decode:
            for k in ("decode_s", "tokens", "chunks", "admissions",
                      "draft_tokens", "draft_accepted", "spec_rounds",
                      "draft_forwards", "prefix_hits",
                      "prefix_tokens_reused", "prefix_evictions",
                      "prefix_insert_drops", "deadline_misses",
                      "preemptions"):
                self.stats[k] += ws[k]
        else:
            self.stats["prefill_prefix_hits"] += ws["prefix_hits"]
            self.stats["prefill_prefix_tokens_reused"] += \
                ws["prefix_tokens_reused"]
            self.stats["prefix_insert_drops"] += ws["prefix_insert_drops"]

    # -- submission ----------------------------------------------------------
    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               speculate: Optional[bool] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               on_done: Optional[Callable[[Request], None]] = None,
               arrival_t: Optional[float] = None) -> int:
        """Queue a request; ``Engine.submit``'s contract (the ring bound and
        the SLO fields included), checked here so a bad request fails at
        submission, not mid-hand-off. The arrival stamp taken here crosses
        the hand-off (the decode worker's ``arrival_t``), so its TTFT and
        queue wait count from the request's arrival."""
        self._check_open()
        if not prompt:
            raise ValueError("empty prompt")
        budget = (self.scfg.max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        if speculate and self.scfg.drafter is None:
            raise ValueError("speculate=True needs ServeConfig.drafter")
        if (not self.cfg.sliding_window
                and len(prompt) + budget > self._T):
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({budget}) "
                f"exceeds cache_len {self._T}; raise ServeConfig.cache_len")
        if (self.scfg.max_queue > 0
                and len(self._queue) >= self.scfg.max_queue):
            raise EngineSaturated(
                "queue_full",
                f"queue holds {len(self._queue)} requests "
                f"(ServeConfig.max_queue={self.scfg.max_queue})")
        req = Request(id=self._next_id, prompt=list(prompt),
                      max_new_tokens=budget, on_token=on_token,
                      speculate=speculate, priority=int(priority),
                      deadline_s=deadline_s, on_done=on_done,
                      submit_t=(time.perf_counter() if arrival_t is None
                                else arrival_t))
        req._route = None               # the prefill worker, or None
        self._next_id += 1
        self._queue.append(req)
        return req.id

    def _complete(self, req: Request) -> None:
        """The disagg-level completion point: records the result and fires
        ``on_done`` once (as ``Engine._finish``)."""
        already = req.done
        req.done = True
        self._results[req.id] = req
        if req.on_done is not None and not already:
            req.on_done(req)

    def cancel(self, request_id: int) -> bool:
        """Cancel a request. Still queued: it never routes. In the current
        wave before its hand-off: it is not handed off and completes with
        no tokens. Handed to a decode worker: cancelled there (its slot
        frees at the next chunk boundary, streamed tokens kept)."""
        for req in self._queue:
            if req.id == request_id:
                self._queue.remove(req)
                req.cancelled = True
                self._complete(req)
                return True
        for req in self._wave:
            if req.id == request_id and not req.cancelled:
                req.cancelled = True
                return True
        for (dw, wid), req in self._handoff.items():
            if req.id == request_id and not req.done:
                if self.decode_engines[dw].cancel(wid):
                    req.cancelled = True
                    return True
        return False

    # -- the serving loop ----------------------------------------------------
    def _prefill_route(self, req: Request) -> Optional[int]:
        """A prefill worker, or None where prefill cannot help: a prompt
        without one full page exports nothing, and a prompt longer than
        the ring (windowed archs) skips insertion; both go straight to a
        decode worker, which prefills them cold."""
        if len(req.prompt) < self._page or len(req.prompt) > self._T:
            self.router.note_direct_decode()
            return None
        return self.router.pick_prefill(req.prompt)

    def _emit_cb(self, req: Request):
        """The user's on_token, re-keyed to the disagg request id; stamps
        the disagg-level TTFT (from arrival) at the first token."""
        def cb(_wid: int, tok: int) -> None:
            if req.ttft_s is None:
                if req.submit_t is not None:
                    req.ttft_s = time.perf_counter() - req.submit_t
                elif self._run_t0 is not None:
                    req.ttft_s = time.perf_counter() - self._run_t0
            if req.on_token is not None:
                req.on_token(req.id, tok)
        return cb

    @staticmethod
    def _copy_back_cb(req: Request):
        """on_done of the decode-tier request: copy its queue wait and
        deadline verdict back onto the disagg request."""
        def cb(wreq: Request) -> None:
            req.queue_wait_s = wreq.queue_wait_s
            req.deadline_missed = wreq.deadline_missed
        return cb

    def run(self, poll: Optional[Callable[[], None]] = None
            ) -> Dict[int, List[int]]:
        """Drain the queue in waves: route, prefill, migrate, decode.
        Requests submitted mid-wave (from ``on_token`` or ``poll``) join
        the next wave. Returns {request_id: tokens} for this cycle; stats
        cover this cycle only. A failure in a worker's program (at tp > 1
        it aborts the group) closes this engine and raises."""
        self._check_open()
        try:
            return self._run(poll)
        except BaseException:
            if self.closed:
                self.close()
            raise

    def _handoff_pages(self, req: Request, dw: int) -> None:
        """Migrate ``req``'s prompt pages from its prefill worker to decode
        worker ``dw``: export (device to host; under TP the kv heads of
        every rank gathered) then import (host to device; under TP each
        rank its own heads), timed, with the payload bytes and the bytes
        written to the group's pipes."""
        deng = self.decode_engines[dw]
        pipe0 = self.group.pipe_bytes if self.group is not None else 0
        t0 = time.perf_counter()
        kv = self.prefill_engines[req._route].export_kv_pages(req.prompt)
        n = deng.import_kv_pages(kv)
        self.stats["handoff_s"] += time.perf_counter() - t0
        self.stats["handoff_bytes"] += sum(
            v.numel() * v.element_size() for v in kv.payload.values())
        if self.group is not None:
            self.stats["handoff_pipe_bytes"] += self.group.pipe_bytes - pipe0
        self.router.note_migrated(dw, n)
        self.stats["migrated_pages"] += n
        self.stats["migrated_requests"] += n > 0

    def _run(self, poll) -> Dict[int, List[int]]:
        self.stats = self._fresh_stats()
        self._run_t0 = time.perf_counter()
        while True:
            if poll is not None:
                poll()
            if not self._queue:
                break
            self._wave = list(self._queue)
            self._queue.clear()
            # -- route and prefill (each worker's batched admission)
            assigned: Dict[int, List[Request]] = {}
            for req in self._wave:
                req._route = self._prefill_route(req)
                if req._route is not None:
                    assigned.setdefault(req._route, []).append(req)
            for pw, reqs in assigned.items():
                eng = self.prefill_engines[pw]
                for req in reqs:
                    eng.submit(list(req.prompt), max_new_tokens=1)
                eng.run(poll=poll)          # pure prefill: 1-token budgets
                self._absorb(eng.stats, decode=False)
                for _ in reqs:
                    self.router.note_prefill_done(pw)
            # -- migrate and hand off, in submission order (with one decode
            # worker this is the admission order a monolithic engine sees:
            # the temperature-parity leg)
            batches: Dict[int, List[int]] = {}
            for req in self._wave:
                if req.cancelled:
                    self._complete(req)
                    continue
                dw = self.router.pick_decode()
                deng = self.decode_engines[dw]
                if req._route is not None:
                    self._handoff_pages(req, dw)
                wid = deng.submit(list(req.prompt),
                                  max_new_tokens=req.max_new_tokens,
                                  on_token=self._emit_cb(req),
                                  speculate=req.speculate,
                                  priority=req.priority,
                                  deadline_s=req.deadline_s,
                                  on_done=self._copy_back_cb(req),
                                  arrival_t=req.submit_t)
                self._handoff[(dw, wid)] = req
                batches.setdefault(dw, []).append(wid)
            self._wave = []
            # -- decode (continuous batching inside each worker)
            for dw, wids in batches.items():
                deng = self.decode_engines[dw]
                res = deng.run(poll=poll)
                self._absorb(deng.stats, decode=True)
                for wid in wids:
                    req = self._handoff.pop((dw, wid))
                    req.tokens = list(res.get(wid, []))
                    self._complete(req)
                    self.router.note_decode_done(dw)
        done = {rid: req.tokens for rid, req in self._results.items()}
        self._finalize_stats(done)
        self._results = {}
        self._run_t0 = None
        return done

    def _finalize_stats(self, done: Dict[int, List[int]]) -> None:
        s = self.stats
        s["requests"] = s["admissions"]
        s["tokens"] = sum(len(t) for t in done.values())
        s["tok_per_s"] = (s["tokens"] / s["decode_s"]
                          if s["decode_s"] > 0 else 0.0)
        s["prefill_tok_per_s"] = (s["prefill_tokens"] / s["prefill_s"]
                                  if s["prefill_s"] > 0 else 0.0)
        ttfts = [r.ttft_s for r in self._results.values()
                 if r.ttft_s is not None]
        s["ttft_s"] = sum(ttfts) / len(ttfts) if ttfts else 0.0
        s["ttft_p50_s"] = float(np.percentile(ttfts, 50)) if ttfts else 0.0
        s["ttft_p99_s"] = float(np.percentile(ttfts, 99)) if ttfts else 0.0
        waits = [r.queue_wait_s for r in self._results.values()
                 if r.queue_wait_s is not None]
        s["queue_wait_s"] = sum(waits) / len(waits) if waits else 0.0
        s["accept_rate"] = (s["draft_accepted"] / s["draft_tokens"]
                            if s["draft_tokens"] > 0 else 0.0)
        s["router"] = self.router.snapshot()

    # -- public API ----------------------------------------------------------
    def generate(self, prompts: List[List[int]]) -> List[List[int]]:
        """Generate completions through the disaggregated path. Resets every
        worker's scheduler and sampling stream (the discipline under which
        routed output equals ``Engine.generate`` with the same
        ServeConfig); radix trees and page pools persist, so a repeated
        queue stays warm."""
        self._check_open()
        if self._queue:
            raise RuntimeError(
                f"{len(self._queue)} submitted request(s) pending; call "
                "run() to drain them before generate() (which resets)")
        for eng in self.prefill_engines + self.decode_engines:
            eng._reset()
        ids = [self.submit(list(p)) for p in prompts]
        res = self.run()
        return [res[i] for i in ids]
