"""Continuous-batching serving engine with batched chunked prefill.

Counterpart of ``repro.serving.engine`` for this slice: greedy or
temperature sampling, the dense KV-ring family, one device (``tp=1``).
Its scheduling is the reference's:

* ``batched chunked prefill``: at each chunk boundary the scheduler drains
  up to ``prefill_batch`` queued requests into the free slots at once,
  right-pads their prompts to a shared bucketed length and feeds them
  through ``transformer.prefill_chunk`` chunk by chunk. A length mask keeps
  padding out of the KV ring and out of the sampled first token. All
  resulting caches scatter into their slots with one
  ``transformer.cache_set_slots``. Admission costs one host sync per group.
* ``decode chunk``: up to ``decode_chunk`` eager decode steps per host
  sync. Sampling, per-slot budgets, EOS and positions stay on the device
  between syncs. Where the reference's jitted ``while_loop`` exits once
  every slot is dead, this loop runs the steps the host knows are needed:
  the largest remaining budget among live slots, capped at
  ``decode_chunk``. Dead slots run the math but a live mask keeps them
  from touching their cache.
* ``continuous batching``: a finished (EOS, budget, ``cancel``) sequence
  frees its slot, and queued requests are admitted between chunks.
* ``streaming``: ``on_token`` callbacks get each token after its chunk
  (the first token at admission).

Batched admission is token-identical to sequential admission because
every matmul computes each output row on its own (see
``kernels/bfp_matmul.py``). ``generate_reference`` keeps the host-driven
loop (one step per token, same math) as the parity oracle.

Temperature sampling is Gumbel-max, ``argmax(logits / T + g)``, which is
how the reference's ``jax.random.categorical`` samples. The noise follows
the reference's draw discipline over one stream of numbered draws: one
(V,) draw per admitted request for its first token, in queue order
(padding rows of a group consume none), then one (B, V) draw per decode
step that has a live slot. Draw ``n`` comes from a generator on the
engine's device seeded from (``seed``, n), so a decode chunk that runs
past the step at which every slot died (the host sizes chunks without
seeing EOS) consumes nothing: after the chunk's sync the host advances
the count by the steps that had a live slot. JAX's threefry and torch's
Philox differ, so the tokens are not the reference's; they equal this
engine's own ``generate_reference`` and do not depend on
``prefill_batch``.

Not ported yet, and rejected at construction: speculative decoding
(``drafter``), the prefix cache, tensor parallelism (``tp > 1``) and SLO
admission (``max_queue``, ``preempt``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32            # per-request default token budget
    temperature: float = 0.0            # <= 0 -> greedy
    eos_id: Optional[int] = None
    cache_len: int = 256                # KV ring length
    seed: int = 0
    max_slots: int = 4                  # concurrent batch slots
    decode_chunk: int = 32              # decode steps per host sync
    prefill_bucket: int = 16            # prompt pad granularity
    prefill_batch: int = 8              # max requests per prefill group
    prefill_chunk: int = 64             # tokens per prefill chunk
    # the reference's further features, not ported yet: every field below
    # must stay at its default
    drafter: Optional[str] = None
    draft_k: int = 4
    draft_layers: int = 2
    draft_ngram: int = 2
    draft_hist: int = 64
    draft_verify: str = "scan"
    prefix_cache: bool = False
    prefix_page: int = 16
    prefix_bytes: int = 64 << 20
    max_queue: int = 0
    preempt: bool = False
    tp: int = 1
    tp_matmul: str = "padded"
    tp_ep: bool = True


# features of the reference engine this port does not have yet, with the
# value that leaves each one off
_NOT_PORTED = {"drafter": None, "prefix_cache": False, "tp": 1,
               "max_queue": 0, "preempt": False}

_M64 = (1 << 64) - 1


def _draw_seed(seed: int, draw: int) -> int:
    """The generator seed of draw ``draw`` of the stream seeded ``seed``:
    splitmix64 of the pair, so every (seed, draw) starts its own Philox
    stream."""
    z = (((seed & 0xFFFFFFFF) << 32) | (draw & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1             # torch seeds below 2**63


@dataclasses.dataclass
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int
    on_token: Optional[Callable[[int, int], None]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    submit_t: Optional[float] = None    # perf_counter at submit(): arrival
    ttft_s: Optional[float] = None      # first token - submit_t
    queue_wait_s: Optional[float] = None  # submit -> prefill start

    def _emit(self, tok: int) -> None:
        self.tokens.append(tok)
        if self.on_token is not None:
            self.on_token(self.id, tok)


class Engine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 device="cuda"):
        """``params`` must already lie on ``device``. With no GPU the
        default device raises; pass ``device="cpu"`` for the CPU path."""
        self.device = resolve_device(device)
        for field in ("max_slots", "decode_chunk", "max_new_tokens",
                      "cache_len", "prefill_batch", "prefill_chunk", "tp"):
            if getattr(serve_cfg, field) < 1:
                raise ValueError(f"ServeConfig.{field} must be >= 1, got "
                                 f"{getattr(serve_cfg, field)}")
        for field, off in _NOT_PORTED.items():
            if getattr(serve_cfg, field) != off:
                raise NotImplementedError(
                    f"ServeConfig.{field}={getattr(serve_cfg, field)!r} is "
                    "not ported yet; this engine serves on one device "
                    f"without it (leave it at {off!r})")
        T._check_family(cfg)
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self._B = serve_cfg.max_slots
        self._T = T.attn_cache_len(cfg, serve_cfg.cache_len)
        self._chunk = max(1, min(serve_cfg.prefill_chunk, self._T))
        self._cache = None
        self._gen = torch.Generator(device=self.device)
        self.stats: Dict[str, float] = {}
        self._reset()

    # -- device programs -----------------------------------------------------
    def _new_cache(self, B: int):
        return T.init_cache(self.cfg, B, self._T, device=self.device)

    def _prefill_chunk_impl(self, gcache, tokens, start, lengths,
                            last_logits):
        """One (G, C) prefill chunk + ragged last-token logit capture: the
        LM head runs on one gathered row per sequence (its last prompt
        token), never on the full (G, C, V) block. Rows whose last token
        is not in this chunk keep ``last_logits``."""
        C = tokens.shape[1]
        h, gcache = T.prefill_chunk(self.params, self.cfg, gcache,
                                    tokens=tokens, start=start,
                                    lengths=lengths)
        last = lengths - 1
        off = torch.clamp(last - start, 0, C - 1)
        hr = h[torch.arange(h.shape[0], device=h.device), off]
        logits = T.lm_logits(self.params, self.cfg, hr)     # (G, V) f32
        sel = (last >= start) & (last < start + C)
        self.stats["forwards"] += 1
        self.stats["prefill_forwards"] += 1
        return gcache, torch.where(sel[:, None], logits, last_logits)

    def _gumbel(self, draw: int, shape) -> torch.Tensor:
        """Standard Gumbel noise of draw ``draw`` of this engine's stream."""
        self._gen.manual_seed(_draw_seed(self.scfg.seed, draw))
        u = torch.rand(shape, generator=self._gen, dtype=torch.float32,
                       device=self.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def _sample(self, logits, draw: int = 0):
        """logits (B, V) -> token ids (B,): greedy ``argmax``, or under a
        temperature ``argmax(logits / T + g)`` with ``g`` the Gumbel noise
        of draw ``draw``."""
        if self.scfg.temperature > 0:
            logits = (logits / self.scfg.temperature
                      + self._gumbel(draw, logits.shape))
        return torch.argmax(logits, dim=-1)

    def _sample_first(self, last_logits, G: int):
        """First tokens of a prefill group of ``G`` requests (and padding
        rows past them): one (V,) draw per request, in queue order, as
        one-at-a-time admission would take them."""
        if self.scfg.temperature > 0:
            noise = torch.zeros_like(last_logits)
            for i in range(G):
                noise[i] = self._gumbel(self._draw + i, last_logits.shape[1:])
            self._draw += G
            return torch.argmax(
                last_logits / self.scfg.temperature + noise, dim=-1)
        return self._sample(last_logits)

    def _bind_slots(self, first: np.ndarray, budgets: np.ndarray,
                    free_arr: np.ndarray) -> np.ndarray:
        """Slot binding for a prefill group: rows that finish at their first
        token (budget 1, instant EOS; dummy rows carry budget 0) take no
        slot, and survivors pack into ``free_arr`` in group order -- the
        layout one-at-a-time admission gives. Returns scatter indices,
        out of range (B) where unbound."""
        fin = budgets <= 1
        if self.scfg.eos_id is not None:
            fin = fin | (first == self.scfg.eos_id)
        alive = ~fin
        rank = np.cumsum(alive.astype(np.int32)) - 1
        nfree = free_arr.shape[0]
        return np.where(alive, free_arr[np.clip(rank, 0, nfree - 1)],
                        self._B)

    def _decode_chunk_impl(self, tok, pos, live, n_gen, budget, steps):
        """Run ``steps`` decode steps on the device tensors (B,) and return
        (out (B, decode_chunk) with -1 where a slot was dead, tok, pos,
        live, n_gen), all still on the device. Step ``i`` samples with
        draw ``self._draw + i``; the caller advances ``self._draw``."""
        C = self.scfg.decode_chunk
        B = tok.shape[0]
        out = torch.full((B, C), -1, dtype=torch.long, device=self.device)
        for step in range(steps):
            logits, self._cache = T.decode_step(
                self.params, self.cfg, self._cache, tokens=tok,
                position=pos, live=live)
            self.stats["forwards"] += 1
            nxt = torch.where(live, self._sample(logits, self._draw + step),
                              tok)
            out[:, step] = torch.where(live, nxt, torch.full_like(nxt, -1))
            n_gen = n_gen + live.to(n_gen.dtype)
            new_live = live & (n_gen < budget)
            if self.scfg.eos_id is not None:
                new_live = new_live & (nxt != self.scfg.eos_id)
            pos = pos + live.to(pos.dtype)
            tok, live = nxt, new_live
        return out, tok, pos, live, n_gen

    # -- host-side scheduler -------------------------------------------------
    def _reset(self) -> None:
        B = self._B
        self._queue: collections.deque = collections.deque()
        self._slots: List[Optional[Request]] = [None] * B
        self._admitting: List[Request] = []
        self._results: Dict[int, Request] = {}
        self._next_id = 0
        self._tok = np.zeros(B, np.int64)
        self._pos = np.zeros(B, np.int64)
        self._live = np.zeros(B, bool)
        self._ngen = np.zeros(B, np.int64)
        self._budget = np.full(B, self.scfg.max_new_tokens, np.int64)
        self._run_t0: Optional[float] = None
        self._draw = 0                          # next draw of the stream
        self.stats = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, float]:
        return dict(prefill_s=0.0, decode_s=0.0, tokens=0, tok_per_s=0.0,
                    host_syncs=0, admissions=0, chunks=0, forwards=0,
                    prefill_forwards=0,
                    requests=0, prefill_groups=0, prefill_tokens=0,
                    prefill_tok_per_s=0.0, ttft_s=0.0,
                    ttft_p50_s=0.0, ttft_p99_s=0.0, queue_wait_s=0.0)

    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None) -> int:
        """Queue a request; returns its id. Tokens stream via ``on_token``
        (called as on_token(request_id, token)) if given."""
        if not prompt:
            raise ValueError("empty prompt")
        budget = (self.scfg.max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        if not self.cfg.sliding_window and len(prompt) + budget > self._T:
            # full-attention archs must not wrap the KV ring (that would
            # silently truncate context)
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({budget}) "
                f"exceeds cache_len {self._T}; raise ServeConfig.cache_len")
        req = Request(id=self._next_id, prompt=list(prompt),
                      max_new_tokens=budget, on_token=on_token,
                      submit_t=time.perf_counter())
        self._next_id += 1
        self._queue.append(req)
        return req.id

    def cancel(self, request_id: int) -> bool:
        """Cancel a request. Still queued: it never runs. Already in a
        slot: the slot is freed at the next chunk boundary and tokens
        emitted so far are kept. Returns False for ids that are unknown or
        already finished."""
        for req in self._queue:
            if req.id == request_id:
                self._queue.remove(req)
                self._finish(req, cancelled=True)
                return True
        for i, req in enumerate(self._slots):
            if req is not None and req.id == request_id:
                self._live[i] = False
                self._slots[i] = None
                self._finish(req, cancelled=True)
                return True
        for req in self._admitting:
            if req.id == request_id and not req.done:
                self._finish(req, cancelled=True)
                return True
        return False

    def _finish(self, req: Request, cancelled: bool = False) -> None:
        if req.done:
            return
        req.done = True
        if cancelled:
            req.cancelled = True
        self._results[req.id] = req

    def _note_first_token(self, req: Request) -> None:
        now = time.perf_counter()
        if req.submit_t is not None:
            req.ttft_s = now - req.submit_t
        elif self._run_t0 is not None:
            req.ttft_s = now - self._run_t0

    def _start_slot(self, slot: int, req: Request, first_tok: int,
                    prompt_len: int) -> None:
        """Record a freshly prefilled request. The slot is bound BEFORE the
        token is emitted so cancel() inside on_token can free it."""
        self._note_first_token(req)
        self._slots[slot] = req
        self._tok[slot] = first_tok
        self._pos[slot] = prompt_len
        self._live[slot] = True
        self._ngen[slot] = 1
        self._budget[slot] = req.max_new_tokens
        req._emit(first_tok)

    def _group_shape(self, lens: List[int]):
        """(padded len P, chunk len C, padded group size Gp). P is the group
        max rounded up to ``prefill_bucket`` and, past the chunk length, to
        a multiple of it; the group pads to a power of two capped at
        ``prefill_batch``."""
        b = max(self.scfg.prefill_bucket, 1)
        maxb = max(-(-n // b) * b for n in lens)
        C = self._chunk
        if maxb > C:
            P = -(-maxb // C) * C
        else:
            P = C = maxb
        Gp = 1 << max(len(lens) - 1, 0).bit_length()
        return P, C, min(max(Gp, 1), max(self.scfg.prefill_batch, 1))

    def _admit_group(self, slots: List[int], reqs: List[Request]) -> None:
        """Prefill ``reqs`` as one right-padded batch and scatter their
        caches into ``slots`` with one cache_set_slots call."""
        t0 = time.perf_counter()
        for r in reqs:
            if r.submit_t is not None:
                r.queue_wait_s = t0 - r.submit_t
        G = len(reqs)
        lens = [len(r.prompt) for r in reqs]
        P, C, Gp = self._group_shape(lens)
        toks = np.zeros((Gp, P), np.int64)
        lengths = np.zeros(Gp, np.int64)            # dummy rows: length 0
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.prompt
            lengths[i] = lens[i]
        if self._cache is None:
            self._cache = self._new_cache(self._B)
        gcache = self._new_cache(Gp)
        last_logits = torch.zeros((Gp, self.cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        lengths_d = torch.as_tensor(lengths, device=self.device)
        toks_d = torch.as_tensor(toks, device=self.device)
        for start in range(0, P, C):
            gcache, last_logits = self._prefill_chunk_impl(
                gcache, toks_d[:, start:start + C], start, lengths_d,
                last_logits)
        firsts = self._sample_first(last_logits, G).cpu().numpy()  # 1 sync
        budgets = np.zeros(Gp, np.int64)            # dummies: 0 -> unbound
        budgets[:G] = [r.max_new_tokens for r in reqs]
        free_arr = np.full(Gp, self._B, np.int64)
        free_arr[:G] = slots
        idx = self._bind_slots(firsts, budgets, free_arr)
        T.cache_set_slots(self._cache, gcache, idx)
        self.stats["host_syncs"] += 1
        self.stats["prefill_groups"] += 1
        self.stats["admissions"] += G
        self.stats["prefill_tokens"] += sum(lens)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self._admitting = reqs
        for i, req in enumerate(reqs):
            if req.cancelled:
                # cancelled from a group-mate's on_token callback after its
                # prefill but before its slot bound: never binds or emits
                continue
            if idx[i] >= self._B:
                self._note_first_token(req)
                req._emit(int(firsts[i]))
                self._finish(req)
            else:
                self._start_slot(int(idx[i]), req, int(firsts[i]), lens[i])
        self._admitting = []

    def _admit_pending(self) -> None:
        while self._queue:
            free = [i for i in range(self._B) if self._slots[i] is None]
            if not free:
                return
            n = min(len(free), max(self.scfg.prefill_batch, 1),
                    len(self._queue))
            picked = [self._queue.popleft() for _ in range(n)]
            self._admit_group(free[:n], picked)

    def _run_chunk(self) -> None:
        t0 = time.perf_counter()
        # the steps this chunk needs: without EOS every live slot dies
        # exactly when its budget runs out, so the host knows the count
        remaining = np.where(self._live, self._budget - self._ngen, 0)
        steps = int(min(self.scfg.decode_chunk, remaining.max()))
        dev = self.device
        out_d, tok_d, pos_d, live_d, ngen_d = self._decode_chunk_impl(
            torch.as_tensor(self._tok, device=dev),
            torch.as_tensor(self._pos, device=dev),
            torch.as_tensor(self._live, device=dev),
            torch.as_tensor(self._ngen, device=dev),
            torch.as_tensor(self._budget, device=dev), steps)
        out, tok, pos, live, ngen = (t.cpu().numpy() for t in (
            out_d, tok_d, pos_d, live_d, ngen_d))           # THE chunk sync
        self._tok, self._pos, self._live, self._ngen = tok, pos, live, ngen
        # the steps with a live slot drew noise; a step after every slot
        # died (past an EOS the host could not see) did not
        self._draw += int((out >= 0).any(axis=0).sum())
        self.stats["host_syncs"] += 1
        self.stats["chunks"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        self._emit_chunk(out)

    def _emit_chunk(self, out: np.ndarray) -> None:
        """Stream each slot's dense token prefix; free finished slots."""
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            for tok in out[i][out[i] >= 0].tolist():
                req._emit(tok)
                if self._slots[i] is None:      # on_token cancelled us
                    break
            if self._slots[i] is not None and not self._live[i]:
                self._finish(req)
                self._slots[i] = None

    def _finalize_stats(self, done: Dict[int, List[int]]) -> None:
        """Rate stats with zero-denominator guards (a run whose every
        request is cancelled at its first token never decodes)."""
        self.stats["requests"] = self.stats["admissions"]
        ntok = sum(len(t) for t in done.values())
        self.stats["tokens"] = ntok
        self.stats["tok_per_s"] = (
            ntok / self.stats["decode_s"]
            if self.stats["decode_s"] > 0 else 0.0)
        self.stats["prefill_tok_per_s"] = (
            self.stats["prefill_tokens"] / self.stats["prefill_s"]
            if self.stats["prefill_s"] > 0 else 0.0)
        ttfts = [r.ttft_s for r in self._results.values()
                 if r.ttft_s is not None]
        self.stats["ttft_s"] = sum(ttfts) / len(ttfts) if ttfts else 0.0
        self.stats["ttft_p50_s"] = (
            float(np.percentile(ttfts, 50)) if ttfts else 0.0)
        self.stats["ttft_p99_s"] = (
            float(np.percentile(ttfts, 99)) if ttfts else 0.0)
        waits = [r.queue_wait_s for r in self._results.values()
                 if r.queue_wait_s is not None]
        self.stats["queue_wait_s"] = (
            sum(waits) / len(waits) if waits else 0.0)

    def run(self) -> Dict[int, List[int]]:
        """Drive batched admission + decode chunks until queue and slots
        are drained. Returns {request_id: tokens} for THIS cycle; stats
        cover this cycle only (a request submitted from an ``on_token``
        callback is served by this cycle)."""
        self.stats = self._fresh_stats()
        self._run_t0 = time.perf_counter()
        while True:
            if not (self._queue or any(r is not None for r in self._slots)):
                break
            self._admit_pending()
            if not self._live.any():
                continue
            self._run_chunk()
        done = {rid: req.tokens for rid, req in self._results.items()}
        self._finalize_stats(done)
        self._results = {}
        self._run_t0 = None
        return done

    # -- public API ----------------------------------------------------------
    def generate(self, prompts: List[List[int]]) -> List[List[int]]:
        """Generate completions for a batch of prompts. Prompts beyond
        ``max_slots`` are continuously batched into freed slots."""
        if self._queue:
            raise RuntimeError(
                f"{len(self._queue)} submitted request(s) pending; call "
                "run() to drain them before generate() (which resets)")
        self._reset()
        ids = [self.submit(list(p)) for p in prompts]
        res = self.run()
        return [res[i] for i in ids]

    def generate_reference(self,
                           prompts: List[List[int]]) -> List[List[int]]:
        """Host-driven reference: same admission/prefill/sampling math but
        one host round-trip per token. The parity oracle for the chunked
        decode loop, not a serving path."""
        if len(prompts) > self._B:
            raise ValueError("reference path has no queue; "
                             f"need <= {self._B} prompts")
        if self._queue:
            raise RuntimeError(
                f"{len(self._queue)} submitted request(s) pending; call "
                "run() to drain them before generate_reference()")
        self._reset()
        ids = [self.submit(list(p)) for p in prompts]
        self._run_t0 = time.perf_counter()
        self._admit_pending()
        t0 = time.perf_counter()
        dev = self.device
        while self._live.any():
            tok = torch.as_tensor(self._tok, device=dev)
            live = torch.as_tensor(self._live, device=dev)
            logits, self._cache = T.decode_step(
                self.params, self.cfg, self._cache, tokens=tok,
                position=torch.as_tensor(self._pos, device=dev), live=live)
            self.stats["forwards"] += 1
            nxt = torch.where(live, self._sample(logits, self._draw),
                              tok).cpu().numpy()
            self._draw += 1
            self.stats["host_syncs"] += 1
            for i, req in enumerate(self._slots):
                if req is None or not self._live[i]:
                    continue
                t = int(nxt[i])
                req._emit(t)
                self._ngen[i] += 1
                self._pos[i] += 1
                self._tok[i] = t
                if (self._ngen[i] >= self._budget[i]
                        or (self.scfg.eos_id is not None
                            and t == self.scfg.eos_id)):
                    self._live[i] = False
                    self._finish(req)
                    self._slots[i] = None
        self.stats["decode_s"] += time.perf_counter() - t0
        res = {rid: req.tokens for rid, req in self._results.items()}
        self._finalize_stats(res)
        self._results = {}
        self._run_t0 = None
        return [res[i] for i in ids]
