"""Continuous-batching serving engine with batched chunked prefill.

Counterpart of ``repro.serving.engine``: greedy or temperature sampling,
speculative decoding, the prefix cache, SLO admission and tensor and
expert parallelism, for the families the port has (dense, gpt2, MoE, and
the recurrent ssm and hybrid, which serve at ``tp=1`` only, as in the
reference). As in the reference,
construction runs one validation pass over the family x feature matrix
(``models/state.py``'s ``validate_serve_features``) and every cache
operation goes through the family's ``DecodeState`` adapter. Its
scheduling is the reference's:

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
* ``speculative decoding`` (``drafter``, ``serving/drafters.py``): the
  decode chunk becomes draft -> verify -> accept rounds. Each round
  drafts k tokens per speculating slot, snapshots the ring rows the block
  will write, scores [cur, d_1..d_k] in one verify pass (``"scan"``:
  ``decode_step`` per column, plain decode's logits bit for bit;
  ``"batched"``: one masked forward at M = B * (k + 1)), accepts a
  per-slot prefix (greedy: the longest prefix equal to the argmax;
  temperature: rejection sampling) and restores the rejected rows from
  the snapshot. Every decision is per slot, so speculating and plain
  requests share a batch (``submit(speculate=)``). The reference's
  device ``while_loop`` exits when no slot is active; this eager loop
  cannot see acceptance without a read, so it reads one device flag (any
  slot active) before each round: ``rounds + 1`` host syncs a chunk
  beyond the chunk's own, all counted in ``host_syncs``.
* ``prefix cache`` (``prefix_cache=True``): a host radix tree over
  token-ID pages (``serving/prefix_cache.py``) maps to a device page pool
  of bit-for-bit ring copies. Admission matches each request's longest
  cached prefix, scatters its pages below the group's warm horizon into
  the group-cache row (a partial page copies only its matched rows) and
  prefills from that horizon on: the group's smallest match rounded down
  to a prefill-chunk boundary, so every key sits where a cold prefill
  puts it and the first tokens' logits equal the cache-off engine's bit
  for bit, fused attention included (the reference starts at the
  smallest match and masks the cached columns past it, which moves the
  fused kernel's sums). Fresh prompt pages are copied into the pool,
  with LRU eviction under the byte budget.
* ``recurrent families`` (ssm, hybrid): the same batched chunked prefill
  on a fixed chunk grid. The chunk is clamped down to a divisor of the
  ring and a group always prefills whole chunks, so every prompt, batched
  or alone, warm or cold, sees the same absolute chunk boundaries, which
  the SSD scan's numbers depend on. Their prefix cache stores whole-state
  checkpoints: the page is pinned to the chunk, only full pages match,
  the group reuses up to its smallest full-page match s0 (one cold row
  makes the group cold), a warm row restores the conv/SSM state of the
  page ending at s0 (hybrid also scatters its ring pages below s0), and
  the chunk loop starts at s0. New pages take their checkpoints chunk by
  chunk, copies of the inter-chunk state the loop holds. Speculation is
  refused (no rewind un-writes a dense state).
* ``KV page hand-off`` (``export_kv_pages``/``import_kv_pages``, with
  the prefix cache on): a prompt's cached full pages copied to host
  memory and into another engine's pool and radix tree, bit for bit,
  where its ordinary warm admission reuses them (``serving/disagg.py``).
* ``tensor parallelism`` (``tp=N``): one process a rank
  (``distributed/group.py``); this process is rank 0 and the only
  scheduler. Every device program below (admission, the decode and
  speculative chunks, the reference loops' steps, the page hand-off) runs
  through ``_program``, which ships its name and host arguments to the
  other ranks; each rank runs the same body on its own shard under the
  plan (``distributed/sharding.py``): weights lane-sharded (K rows whole),
  the KV ring and the page pool over kv heads, expert stacks over experts
  (EP), and each projection assembled by its collective. Under the
  default "padded" datapath the products keep the single-device shape,
  so tokens equal tp=1's; "sliced" and "sliced_row" agree to the
  reference's tolerances. The pool's page budget counts whole pages, as
  at tp=1, so eviction is the same at every degree.
* ``SLO admission``: ``priority`` strata, then the earliest TTFT
  deadline, then submission order drain the queue (uniform priority and
  no deadlines is FIFO); ``max_queue`` bounds the queue
  (``EngineSaturated``); ``preempt`` lets a strictly higher-priority
  request cancel the lowest-priority running one; ``on_done`` fires once
  per request.

Batched admission is token-identical to sequential admission because
every matmul computes each output row on its own (see
``kernels/bfp_matmul.py``), and the naive attention, the MoE layer and
the SSD scan's products (``models/mamba2.py``) run a batch row at a
time. For the MoE family this holds where the
groups pad to the same chunk length: the layer's capacity follows the
chunk length, so prompts of different lengths grouped otherwise can
drop other token choices, as in the reference. ``generate_reference``
keeps the host-driven loop (one step per token, same math) as the
parity oracle, and
``generate_spec_reference`` does the same for speculation, with the
acceptance re-implemented in numpy on the host.

Temperature sampling is Gumbel-max, ``argmax(logits / T + g)``, which is
how the reference's ``jax.random.categorical`` samples. The noise follows
the reference's draw discipline over one stream of numbered draws: one
(V,) draw per admitted request for its first token, in queue order
(padding rows of a group consume none), then one (B, V) draw per decode
step that has a live slot; a speculative round with an active slot takes
one draw for its (B, k) acceptance uniforms and the next for the (B, V)
Gumbel noise of its final token, and a round with no active slot none.
Draw ``n`` comes from a generator on the engine's device seeded from
(``seed``, n), so a decode chunk that runs past the step at which every
slot died (the host sizes chunks without seeing EOS) consumes nothing:
after the chunk's sync the host advances the count by the steps that had
a live slot. JAX's threefry and torch's Philox differ, so the tokens are
not the reference's; they equal this engine's own ``generate_reference``
(``generate_spec_reference`` with a drafter) and do not depend on
``prefill_batch``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import _div
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.group import TPGroup, rank_devices
from repro_torch.models import transformer as T
from repro_torch.models.state import DecodeState, validate_serve_features
from repro_torch.serving.drafters import make_drafter
from repro_torch.serving.prefix_cache import PrefixCache


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
    # speculative decoding (None = off; "ngram" | "self", drafters.py)
    drafter: Optional[str] = None
    draft_k: int = 4                    # drafted tokens per verify round
    draft_layers: int = 2               # "self": target-model prefix depth
    draft_ngram: int = 2                # "ngram": match gram length
    draft_hist: int = 64                # "ngram": history ring length
    draft_verify: str = "scan"          # "scan" (bit-exact vs plain decode)
                                        # | "batched" (one masked forward)
    # prefix cache: admission reuses the longest cached token prefix and
    # prefills only the suffix (greedy output stays the cache-off engine's)
    prefix_cache: bool = False
    prefix_page: int = 16               # positions per page (clamped to a
                                        # divisor of the KV ring length)
    prefix_bytes: int = 64 << 20        # device byte budget for the pool
    # SLO admission: with max_queue > 0, submit() rejects instead of
    # growing the queue without bound (EngineSaturated "queue_full"); with
    # the prefix cache on it also rejects when the queued prompts' pages
    # exceed the whole pool ("page_pool_saturated"). 0 = unbounded.
    max_queue: int = 0
    # preempt-by-slot: when every slot is busy and the queue head has a
    # strictly higher priority than some running request, cancel the
    # lowest-priority (then youngest) one to free its slot
    preempt: bool = False
    # tensor parallelism: ranks, one process each (distributed/group.py)
    tp: int = 1
    tp_matmul: str = "padded"           # "padded" (tp=1's bits: the
                                        # single-device product shape,
                                        # weights and KV sharded) |
                                        # "sliced" (1/tp of the work a
                                        # rank, within an f32 ulp) |
                                        # "sliced_row" (+ row-parallel
                                        # o-/down-proj: half the
                                        # collectives, within a few
                                        # activation-dtype ulps)
    tp_ep: bool = True                  # MoE expert parallelism under tp
                                        # where n_experts divides it (the
                                        # same bits as replicated experts)

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
class KVPages:
    """Host-memory snapshot of a prompt's full KV pages, the hand-off unit
    of disaggregated serving (``serving/disagg.py``): bit-for-bit copies
    of page-pool rows (all layers, int8 codes and f32 scales included) and
    the token ids they cover, so the receiving engine can key them in its
    own radix tree. ``payload`` holds CPU tensors in the pool's dtypes
    with the page axis at dim 1, e.g. ``k`` (L, n_pages, page, KH, Dh),
    page q covering positions [q*page, (q+1)*page). (The reference holds
    numpy arrays; numpy has no bfloat16.)"""
    page: int
    tokens: List[int]
    payload: Dict[str, torch.Tensor]

    @property
    def n_pages(self) -> int:
        return len(self.tokens) // self.page


class EngineSaturated(RuntimeError):
    """submit() backpressure rejection (ServeConfig.max_queue > 0).

    ``reason`` is machine-readable -- "queue_full" (the bounded queue is
    at capacity) or "page_pool_saturated" (the queued prompts' pages
    already exceed the prefix-cache pool) -- and ``detail`` the
    explanation."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


@dataclasses.dataclass
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int
    on_token: Optional[Callable[[int, int], None]] = None
    speculate: bool = False
    priority: int = 0                   # higher drains first
    deadline_s: Optional[float] = None  # TTFT SLO, relative to submit_t
    on_done: Optional[Callable[["Request"], None]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    preempted: bool = False             # cancelled to free its slot for a
                                        # strictly higher-priority request
    deadline_missed: bool = False       # first token landed past deadline
    submit_t: Optional[float] = None    # perf_counter at arrival
    ttft_s: Optional[float] = None      # first token - submit_t
    queue_wait_s: Optional[float] = None  # submit -> prefill start

    def _emit(self, tok: int) -> None:
        self.tokens.append(tok)
        if self.on_token is not None:
            self.on_token(self.id, tok)


class Engine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 device="cuda", *, group: Optional[TPGroup] = None,
                 shards: Optional[int] = None):
        """``params`` must already lie on ``device``. With no GPU the
        default device raises; pass ``device="cpu"`` for the CPU path.

        At ``serve_cfg.tp`` = N > 1 the engine starts N - 1 worker ranks
        (or opens on ``group``, a ``TPGroup`` of N ranks that outlives
        it) and hands each its local shard of ``params``. ``device``
        places the ranks (``distributed.group.rank_devices``): "cuda"
        puts rank r on cuda:r and raises with fewer cards, a list such as
        ``["cuda:0"] * N`` shares cards, "cpu" takes any N. ``shards``
        names a weight shard set already on ``group``
        (``TPGroup.put_shards`` of ``params`` under this engine's plan):
        the engine opens on it instead of making its own, so engines on
        one set hold one copy of the weights a rank. Every rendezvous and
        collective waits at most the group's timeout. Close the engine
        (``close()``, or use it as a context manager) to stop its
        workers."""
        for field in ("max_slots", "decode_chunk", "max_new_tokens",
                      "cache_len", "prefill_batch", "prefill_chunk", "tp"):
            if getattr(serve_cfg, field) < 1:
                raise ValueError(f"ServeConfig.{field} must be >= 1, got "
                                 f"{getattr(serve_cfg, field)}")
        tp = serve_cfg.tp
        self._caps = validate_serve_features(
            cfg, tp=tp, drafter=serve_cfg.drafter is not None,
            prefix_cache=serve_cfg.prefix_cache)
        # the plan validates tp_matmul at every degree, as the reference's
        self._plan = SH.make_serve_tp_plan(cfg, tp,
                                           matmul=serve_cfg.tp_matmul,
                                           params=params, ep=serve_cfg.tp_ep)
        if shards is not None and (tp == 1 or group is None):
            raise ValueError("shards= names a shard set on a group: it "
                             "needs tp > 1 and group=")
        if tp == 1:
            devices = [resolve_device(device)]
        elif group is not None:
            if group.size != tp or group.closed:
                raise ValueError(f"group of {group.size} ranks (closed: "
                                 f"{group.closed}) for tp={tp}")
            devices = group.devices
        else:
            devices = rank_devices(device, tp)
        self._setup(cfg, serve_cfg, devices[0])
        self.params = params
        self._rank, self._group, self._eid = 0, None, None
        self._own_group, self._closed = False, False
        self.tp_backend: Optional[str] = None
        if tp == 1:
            return
        self._cspecs = SH.serve_cache_specs(
            T.init_cache(cfg, 1, self._T, device="meta"), self._plan)
        self._own_group = group is None
        self._own_shards = shards is None
        self._group = group or TPGroup(tp, devices)
        try:
            if shards is None:
                shards = self._group.put_shards(params, self._plan)
            self._sid = shards
            self._eid = self._group.open_engine(cfg, serve_cfg, self._plan,
                                                shards)
        except BaseException:
            if self._own_group:
                self._group.abort()
            raise
        self.params = self._group.local_shards(shards)
        self.tp_backend = self._group.backend
        print(f"[tp] {self._group.describe()}", flush=True)

    @classmethod
    def _mirror(cls, cfg, params, serve_cfg, device, plan, rank, group):
        """A worker rank's copy of an engine: the same device programs on
        this rank's shard ``params``, driven by rank 0 (``_run_mirrored``);
        it never schedules."""
        self = cls.__new__(cls)
        self._caps = validate_serve_features(
            cfg, tp=serve_cfg.tp, drafter=serve_cfg.drafter is not None,
            prefix_cache=serve_cfg.prefix_cache)
        self._plan = plan
        self._setup(cfg, serve_cfg, torch.device(device))
        self.params = params
        self._rank, self._group, self._eid = rank, group, None
        self._own_group, self._closed = False, False
        return self

    def _setup(self, cfg: ModelConfig, serve_cfg: ServeConfig,
               device: torch.device) -> None:
        """The host state every rank's engine has."""
        self.device = device
        T._check_family(cfg)
        if not cfg.embed_input:
            raise ValueError(
                f"{cfg.name} has a stub modality frontend: the engine serves "
                "token ids, and this family takes embeddings (serve it "
                "through training.steps.make_serve_steps)")
        self._state = DecodeState(cfg)
        self.cfg = cfg
        self.scfg = serve_cfg
        self._B = serve_cfg.max_slots
        self._T = T.attn_cache_len(cfg, serve_cfg.cache_len)
        # the recurrent families pin a fixed chunk grid, clamped down to a
        # divisor of the ring: the SSD scan's numbers depend on where the
        # chunk bounds fall, so batched and sequential, warm and cold
        # admission must all see the same absolute bounds
        chunk = max(1, min(serve_cfg.prefill_chunk, self._T))
        if self._caps.recurrent:
            while self._T % chunk:
                chunk -= 1
        self._chunk = chunk
        self._drafter = None
        if serve_cfg.drafter is not None:
            k = serve_cfg.draft_k
            if k < 1:
                raise ValueError("draft_k must be >= 1")
            if k + 1 > serve_cfg.decode_chunk:
                raise ValueError(
                    f"decode_chunk ({serve_cfg.decode_chunk}) must fit a "
                    f"whole verify round (draft_k + 1 = {k + 1}) or "
                    "speculating slots can never emit")
            if k + 1 > self._T:
                raise ValueError(
                    f"draft_k + 1 ({k + 1}) exceeds the KV ring "
                    f"({self._T}); draft positions must map to distinct "
                    "ring rows")
            if serve_cfg.draft_verify not in ("scan", "batched"):
                raise ValueError(
                    f"draft_verify must be 'scan' or 'batched', got "
                    f"{serve_cfg.draft_verify!r}")
            self._drafter = make_drafter(serve_cfg.drafter, cfg, serve_cfg)
        self._prefix: Optional[PrefixCache] = None
        self._page: Optional[int] = None
        self._pool = None                   # device page pool, at 1st use
        if serve_cfg.prefix_cache:
            if serve_cfg.prefix_page < 1:
                raise ValueError("prefix_page must be >= 1")
            if self._caps.prefix_mode == "checkpoints":
                # a checkpoint page is the chunk: every checkpoint is an
                # inter-chunk state the chunk loop holds anyway
                page = self._chunk
            else:
                # pages tile the ring exactly, so a page never wraps inside
                page = max(1, min(serve_cfg.prefix_page, self._T))
                while self._T % page:
                    page -= 1
            self._page = page
            cap = max(2, int(serve_cfg.prefix_bytes)
                      // self._state.page_bytes(page))
            self._prefix = PrefixCache(page, cap)
        self._cache = None
        self._gen = torch.Generator(device=self.device)
        self.stats: Dict[str, float] = {}
        self._reset()

    # -- tensor parallelism: program dispatch ------------------------------
    def _program(self, name: str, *args):
        """Run device program ``name`` on host arguments ``args``: here
        alone at tp=1; at tp > 1 its name, arguments and the sampling draw
        counter go to every worker first and each rank runs the same body
        on its shard under the plan. Rank 0's result is returned. A
        failure in the body closes the group (the others would wait in a
        collective), and the engine with it."""
        if self._closed:
            raise RuntimeError("the engine is closed")
        if self._group is None:
            return getattr(self, name)(*args)
        self._group.call(self._eid, name, args, {"draw": self._draw})
        try:
            with SH.serve_tp(self._plan, 0, self._group):
                return getattr(self, name)(*args)
        except BaseException:
            self._group.abort()
            self._closed = True
            raise

    def _run_mirrored(self, name: str, args: tuple, host: dict) -> None:
        """A worker rank's side of ``_program``."""
        self._draw = host["draw"]
        with SH.serve_tp(self._plan, self._rank, self._group):
            getattr(self, name)(*args)

    def close(self) -> None:
        """Stop this engine's worker ranks (tp > 1; a ``group`` passed in
        stays open and only forgets the engine, and the shard set the
        engine made). Idempotent; stats and results stay readable."""
        if self._closed:
            return
        self._closed = True
        if self._group is not None and self._rank == 0:
            if self._own_group:
                self._group.close()
            else:
                self._group.drop_engine(self._eid)
                if self._own_shards:
                    self._group.drop_shards(self._sid)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- device programs -----------------------------------------------------
    def _new_cache(self, B: int):
        return self._state.init(B, self._T, device=self.device)

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

    def _uniform(self, draw: int, shape) -> torch.Tensor:
        """U[0, 1) f32 of draw ``draw`` of this engine's stream."""
        self._gen.manual_seed(_draw_seed(self.scfg.seed, draw))
        return torch.rand(shape, generator=self._gen, dtype=torch.float32,
                          device=self.device)

    def _gumbel(self, draw: int, shape) -> torch.Tensor:
        """Standard Gumbel noise of draw ``draw`` of this engine's stream."""
        u = self._uniform(draw, shape)
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

    # -- speculative decode (draft -> verify -> accept -> rewind) ------------
    def _verify_impl(self, tokens, positions, valid):
        """One verify pass over a (B, k+1) block -> logits (B, k+1, V),
        the cache updated in place. ``"scan"`` replays decode_step per
        column (plain decode's logits bit for bit); ``"batched"`` scores
        the block in one masked forward at M = B * (k + 1)."""
        if self.scfg.draft_verify == "scan":
            logits, self._cache = T.verify_scan(
                self.params, self.cfg, self._cache, tokens=tokens,
                positions=positions, valid=valid)
            self.stats["forwards"] += tokens.shape[1]
            return logits
        h, self._cache = T.verify_chunk(
            self.params, self.cfg, self._cache, tokens=tokens,
            positions=positions, valid=valid)
        self.stats["forwards"] += 1
        return T.lm_logits(self.params, self.cfg, h)

    def _accept_impl(self, logits, drafts, spec_eff, draw: int):
        """Per-slot draft acceptance. logits (B, k+1, V) scored over
        [cur_tok, d_1..d_k]; drafts (B, k); spec_eff (B,) marks the slots
        that speculated this round (others accept no draft and their final
        token is a plain column-0 sample). Returns (accepted count (B,),
        final token (B,)).

        Greedy: accept the longest prefix where d_j == argmax; the final
        token is the argmax after the last accepted draft -- the chain
        plain greedy decode emits.

        Temperature: rejection sampling against the point-mass draft
        distribution: accept d_j with probability p_j(d_j), the (B, k)
        uniforms from draw ``draw``; on the first rejection sample from p
        without the rejected draft's mass (renormalized), on full
        acceptance the bonus from p_k, as ``argmax(log resid + g)`` with
        ``g`` the Gumbel noise of draw ``draw + 1``."""
        B, S, V = logits.shape
        k = S - 1
        if self.scfg.temperature > 0:
            lt = _div(logits.to(torch.float32), self.scfg.temperature)
            p = torch.softmax(lt[:, :k], dim=-1)            # (B, k, V)
            pd = p.gather(2, drafts[:, :, None])[..., 0]
            ok = (self._uniform(draw, (B, k)) < pd) & spec_eff[:, None]
            acc = torch.cumprod(ok.to(torch.long), dim=1).sum(dim=1)
            pl = lt.gather(1, acc[:, None, None].expand(B, 1, V))[:, 0]
            pcol = torch.softmax(pl, dim=-1)                # (B, V)
            dcol = drafts.gather(1, acc.clamp(0, k - 1)[:, None])[:, 0]
            rejected = spec_eff & (acc < k)
            vocab = torch.arange(V, device=logits.device)
            resid = torch.where(rejected[:, None]
                                & (vocab[None] == dcol[:, None]),
                                torch.zeros_like(pcol), pcol)
            lr = torch.where(resid > 0, torch.log(resid),
                             torch.full_like(resid, -float("inf")))
            fin = torch.argmax(lr + self._gumbel(draw + 1, (B, V)), dim=-1)
            # degenerate guard: p put (numerically) all mass on the draft
            fin = torch.where((resid > 0).any(dim=-1), fin, dcol)
            return acc, fin
        g = torch.argmax(logits, dim=-1)                    # (B, S)
        ok = (drafts == g[:, :k]) & spec_eff[:, None]
        acc = torch.cumprod(ok.to(torch.long), dim=1).sum(dim=1)
        return acc, g.gather(1, acc[:, None])[:, 0]

    def _spec_chunk_impl(self, tok, pos, live, spec, n_gen, budget, dstate):
        """Speculative decode chunk: verify rounds until no slot is active.

        A slot is active while it is live and a whole round (k + 1 columns
        if it speculates, 1 if not) still fits its chunk capacity. Before
        each round the host reads one flag, whether any slot is active
        (counted in ``host_syncs``). Returns (out (B, decode_chunk) with -1
        past each slot's cursor, tok, pos, live, n_gen, dstate, drafted,
        accepted, rounds); all but ``rounds`` still on the device."""
        C = self.scfg.decode_chunk
        k = self.scfg.draft_k
        S = k + 1
        B = tok.shape[0]
        eos = self.scfg.eos_id
        dev = self.device
        cols = torch.arange(S, device=dev)[None]
        bidx = torch.arange(B, device=dev)[:, None]
        # S spare columns: an inactive slot's masked writes land past C
        out = torch.full((B, C + S), -1, dtype=torch.long, device=dev)
        nout = torch.zeros(B, dtype=torch.long, device=dev)
        drafted = torch.zeros((), dtype=torch.long, device=dev)
        accepted = torch.zeros((), dtype=torch.long, device=dev)
        rounds = 0
        while True:
            # full-attention archs must not let draft positions wrap the
            # ring; slots within k of the ring end take plain steps
            spec_ok = (spec if self.cfg.sliding_window
                       else spec & (pos + k < self._T))
            need = torch.where(spec_ok, S, 1)
            act = live & (nout + need <= C)
            self.stats["host_syncs"] += 1
            if not bool(act.any()):             # the round's one flag read
                break
            spec_eff = act & spec_ok
            drafts, dstate = self._drafter.propose(
                self.params, self.cfg, self._cache, dstate, tok, pos,
                spec_eff)
            self.stats["draft_forwards"] += self._drafter.draft_forwards
            x = torch.cat([tok[:, None], drafts], dim=1)    # (B, S)
            positions = pos[:, None] + cols
            valid = act[:, None] & ((cols == 0) | spec_eff[:, None])
            slots = positions % self._T
            snap = self._state.ring_snapshot(self._cache, slots)
            logits = self._verify_impl(x, positions, valid)
            acc, fin = self._accept_impl(logits, drafts, spec_eff,
                                         self._draw)
            if self.scfg.temperature > 0:
                self._draw += 2
            # emitted block: accepted drafts, then the final token
            draftsp = torch.cat([drafts, drafts[:, -1:]], dim=1)
            emit = torch.where(cols < acc[:, None], draftsp, fin[:, None])
            e = torch.minimum(acc + 1, budget - n_gen)
            if eos is not None:
                hit = (emit == eos) & (cols < e[:, None])
                first = torch.argmax(hit.to(torch.int32), dim=1)
                e = torch.where(hit.any(dim=1), torch.minimum(e, first + 1),
                                e)
            e = torch.where(act, e, torch.zeros_like(e))
            # each row's block at its own cursor
            oidx = nout[:, None] + cols
            out[bidx, oidx] = torch.where(cols < e[:, None], emit,
                                          out[bidx, oidx])
            # un-write the rejected drafts (the accepted 1 + acc stay)
            keep = torch.where(act, 1 + acc, torch.zeros_like(acc))
            self._state.ring_rewind(self._cache, snap, slots, keep)
            n_gen = n_gen + e
            pos = pos + e
            last = emit.gather(1, (e - 1).clamp(0, S - 1)[:, None])[:, 0]
            tok = torch.where(e > 0, last, tok)
            died = n_gen >= budget
            if eos is not None:
                died = died | ((emit == eos) & (cols < e[:, None])).any(dim=1)
            live = torch.where(act, live & ~died, live)
            nout = nout + e
            dstate = self._drafter.update(dstate, emit, e)
            drafted = drafted + torch.where(spec_eff, k, 0).sum()
            accepted = accepted + torch.where(spec_eff, acc, 0).sum()
            rounds += 1
        return (out[:, :C], tok, pos, live, n_gen, dstate, drafted,
                accepted, rounds)

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
        self._spec = np.zeros(B, bool)
        self._dstate: Dict[str, np.ndarray] = (
            self._drafter.init_state_np(B) if self._drafter else {})
        self._run_t0: Optional[float] = None
        self._draw = 0                          # next draw of the stream
        self.stats = self._fresh_stats()

    @staticmethod
    def _fresh_stats() -> Dict[str, float]:
        return dict(prefill_s=0.0, decode_s=0.0, tokens=0, tok_per_s=0.0,
                    host_syncs=0, admissions=0, chunks=0, forwards=0,
                    prefill_forwards=0, draft_forwards=0,
                    requests=0, prefill_groups=0, prefill_tokens=0,
                    prefill_tok_per_s=0.0, ttft_s=0.0,
                    ttft_p50_s=0.0, ttft_p99_s=0.0, queue_wait_s=0.0,
                    deadline_misses=0, preemptions=0,
                    draft_tokens=0, draft_accepted=0, accept_rate=0.0,
                    spec_rounds=0, prefix_hits=0, prefix_tokens_reused=0,
                    prefix_evictions=0, prefix_insert_drops=0)

    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               speculate: Optional[bool] = None,
               priority: int = 0,
               deadline_s: Optional[float] = None,
               on_done: Optional[Callable[[Request], None]] = None,
               arrival_t: Optional[float] = None) -> int:
        """Queue a request; returns its id. Tokens stream via ``on_token``
        (called as on_token(request_id, token)) if given. ``speculate``
        toggles speculative decoding per request (default: on whenever
        the engine has a drafter).

        SLO fields: ``priority`` (higher drains first; strictly higher may
        preempt under ServeConfig.preempt), ``deadline_s`` (TTFT deadline
        relative to arrival: orders the queue within a priority stratum
        and feeds the ``deadline_misses`` stat), ``on_done`` (called once
        with the Request when it finishes, is cancelled or is preempted)
        and ``arrival_t`` (the arrival stamp on the perf_counter clock,
        default now). Raises EngineSaturated when ServeConfig.max_queue >
        0 and the queue (or the prefix-cache page pool) is saturated."""
        if not prompt:
            raise ValueError("empty prompt")
        budget = (self.scfg.max_new_tokens if max_new_tokens is None
                  else max_new_tokens)
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        if speculate is None:
            speculate = self._drafter is not None
        elif speculate and self._drafter is None:
            raise ValueError("speculate=True needs ServeConfig.drafter")
        if (self._caps.ring_bounded_context and not self.cfg.sliding_window
                and len(prompt) + budget > self._T):
            # full-attention archs must not wrap the KV ring (that would
            # silently truncate context)
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({budget}) "
                f"exceeds cache_len {self._T}; raise ServeConfig.cache_len")
        if self.scfg.max_queue > 0:
            if len(self._queue) >= self.scfg.max_queue:
                raise EngineSaturated(
                    "queue_full",
                    f"queue holds {len(self._queue)} requests "
                    f"(ServeConfig.max_queue={self.scfg.max_queue})")
            if self._prefix is not None:
                pages = lambda n: -(-n // self._page)
                demand = pages(len(prompt)) + sum(
                    pages(len(r.prompt)) for r in self._queue)
                if demand > self._prefix.capacity:
                    raise EngineSaturated(
                        "page_pool_saturated",
                        f"queued prompts need {demand} KV pages, pool "
                        f"capacity is {self._prefix.capacity} "
                        "(raise ServeConfig.prefix_bytes or shed load)")
        req = Request(id=self._next_id, prompt=list(prompt),
                      max_new_tokens=budget, on_token=on_token,
                      speculate=speculate, priority=int(priority),
                      deadline_s=deadline_s, on_done=on_done,
                      submit_t=(time.perf_counter() if arrival_t is None
                                else arrival_t))
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
        """The one completion point -- finish, cancel and preemption all
        land here, so ``on_done`` fires once."""
        if req.done:
            return
        req.done = True
        if cancelled:
            req.cancelled = True
        self._results[req.id] = req
        if req.on_done is not None:
            req.on_done(req)

    def _note_first_token(self, req: Request) -> None:
        now = time.perf_counter()
        if req.submit_t is not None:
            req.ttft_s = now - req.submit_t
        elif self._run_t0 is not None:
            req.ttft_s = now - self._run_t0
        if (req.deadline_s is not None and req.submit_t is not None
                and now - req.submit_t > req.deadline_s):
            req.deadline_missed = True
            self.stats["deadline_misses"] += 1

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
        self._spec[slot] = req.speculate
        if self._drafter is not None:
            # every slot's history covers prompt + first token, so the
            # per-request toggle stays honest
            self._drafter.admit_np(self._dstate, slot,
                                   req.prompt + [first_tok])
        req._emit(first_tok)

    def _group_shape(self, lens: List[int], whole: bool = False):
        """(padded len P, chunk len C, padded group size Gp). P is the group
        max rounded up to ``prefill_bucket`` and, past the chunk length, to
        a multiple of it; the group pads to a power of two capped at
        ``prefill_batch``.

        ``whole`` keeps whole chunks. The engine asks for it for every
        group of a recurrent family (its chunk grid is fixed), and for a
        warm group (``lens`` past a horizon s0 > 0, a multiple of the
        chunk) of a family whose capacity follows the chunk length (MoE),
        as a cold prefill of the same prompts has past its first chunk: a
        shorter chunk could drop token choices the cold one keeps. Other
        families prefill a short suffix in a short chunk."""
        b = max(self.scfg.prefill_bucket, 1)
        maxb = max(-(-n // b) * b for n in lens)
        C = self._chunk
        if whole or maxb > C:
            P = -(-maxb // C) * C
        else:
            P = C = maxb
        Gp = 1 << max(len(lens) - 1, 0).bit_length()
        return P, C, min(max(Gp, 1), max(self.scfg.prefill_batch, 1))

    # -- prefix cache --------------------------------------------------------
    def _match_prefixes(self, reqs: List[Request]):
        """Radix-match every request's longest cached prefix. Returns
        (the group's warm horizon s0, page-scatter jobs), each job
        (group_row, pool_idx, start_pos, take): rows [0, take) of that
        page land in the ring (take < page: a partial page).

        s0 is the smallest match rounded down to a multiple of the prefill
        chunk, the boundary a cold prefill's chunk grid also has there.
        Only positions below s0 are scattered, and the chunk loop
        recomputes every column from s0 on, so each query finds each key
        where a cold prefill puts it (ring or chunk): a fused attention
        sums keys in the order of that layout, and any other layout (the
        reference's grid at the smallest match, with the cached columns
        past it masked) moves its f32 sums by an ulp and can flip a
        greedy token. ``prefix_hits`` and ``prefix_tokens_reused`` count
        the matches, as the reference does."""
        matches, found = [], []
        for i, r in enumerate(reqs):
            m, pages = self._prefix.match(r.prompt)
            # insertion is gated at prompt <= ring length, so every matched
            # position has its own ring row
            if m > self._T:
                raise RuntimeError(f"prefix match {m} exceeds the ring "
                                   f"({self._T})")
            matches.append(m)
            if m:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += m
                found += [(i, pidx, p0, take) for pidx, p0, take in pages]
        s0 = min(matches) // self._chunk * self._chunk
        jobs = [(i, pidx, p0, min(take, s0 - p0))
                for i, pidx, p0, take in found if p0 < s0]
        return s0, jobs

    def _scatter_prefix_pages(self, gcache, jobs) -> None:
        """Copy the matched pool pages into the group cache (the copy of
        copy-on-write: slot rings only hold page copies, so later suffix
        writes never touch the pool). The job arrays are built on the
        host, a partial page's unmatched rows marked out of range (T)."""
        self._ensure_pool()
        page, n = self._page, len(jobs)
        idx = np.zeros(n, np.int64)
        rows = np.zeros(n, np.int64)
        cols = np.full((n, page), self._T, np.int64)    # T = drop
        pos = np.zeros((n, page), np.int64)
        ar = np.arange(page)
        for j, (row, pidx, p0, take) in enumerate(jobs):
            idx[j], rows[j] = pidx, row
            cols[j] = np.where(ar < take, (p0 + ar) % self._T, self._T)
            pos[j] = p0 + ar
        idx_d = torch.as_tensor(idx, device=self.device)
        pages = {k: v[:, idx_d] for k, v in self._pool.items()
                 if k in T._PAGE_KEYS}
        self._state.scatter_pages(gcache, pages, rows, cols, pos)

    def _plan_prefix_inserts(self, reqs, lens):
        """Record every request's full prompt pages in the radix tree and
        return the copy jobs (group_row, pool_idx, start_pos) of the newly
        allocated ones, which the admission program copies out of the
        freshly prefilled group cache. Prompts longer than the ring skip
        insertion: ring wrap overwrote their early pages. It runs before
        the prefill (no tree operation comes between the match and this
        insert, so its choices are the ones an insert after the prefill
        makes; the device still reads matched pages before it writes
        recycled ones)."""
        ev0 = self._prefix.evictions
        dr0 = self._prefix.insert_drops
        jobs = []
        protect: set = set()        # shared across the group: one request's
        for i, r in enumerate(reqs):  # eviction must not recycle a pool
            if lens[i] <= self._T:    # index a group-mate just allocated
                jobs += [(i, pidx, p0)
                         for pidx, p0 in self._prefix.insert(r.prompt,
                                                             protect)]
        self.stats["prefix_evictions"] += self._prefix.evictions - ev0
        self.stats["prefix_insert_drops"] += (self._prefix.insert_drops
                                              - dr0)
        return jobs

    def _copy_ring_pages(self, gcache, jobs) -> None:
        """Copy the ring payload of pages just recorded in the radix tree,
        jobs (group_row, pool_idx, start_pos), out of the prefilled group
        cache into the pool."""
        if not jobs:
            return
        self._ensure_pool()
        page, n = self._page, len(jobs)
        idx = np.zeros(n, np.int64)
        rows = np.zeros(n, np.int64)
        cols = np.zeros((n, page), np.int64)
        ar = np.arange(page)
        for j, (row, pidx, p0) in enumerate(jobs):
            idx[j], rows[j] = pidx, row
            cols[j] = p0 + ar           # full in-ring pages never wrap
        pages = self._state.gather_pages(gcache, rows, cols)
        idx_d = torch.as_tensor(idx, device=self.device)
        for k, pg in pages.items():
            self._pool[k][:, idx_d] = pg

    # -- prefix cache, recurrent families: checkpoint pages ------------------
    def _match_checkpoints(self, reqs: List[Request]):
        """Checkpoint matching: only full pages count (a checkpoint is the
        state after a whole page), and the group shares one horizon s0,
        the smallest full-page match: the chunk grid is group-wide, so a
        single cold row makes the whole group cold. Returns (s0, per-row
        full-page match lengths, hybrid ring-page scatter jobs (row,
        pool_idx, start_pos, take) below s0, checkpoint restore jobs
        (row, pool_idx) of each row's page ending at s0)."""
        page = self._page
        raw = [self._prefix.match(r.prompt) for r in reqs]
        fulls = [m // page * page for m, _ in raw]
        s0 = min(fulls)
        if s0 == 0:
            return 0, fulls, [], []
        # of the recurrent families only hybrid has a ring
        has_ring = self._caps.ring_bounded_context
        pjobs, ckpt_jobs = [], []
        for i, (_, pages) in enumerate(raw):
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += s0
            for pidx, p0, take in pages:
                if take != page or p0 + page > s0:
                    continue            # a partial page, or past s0
                if has_ring:
                    pjobs.append((i, pidx, p0, take))
                if p0 + page == s0:
                    ckpt_jobs.append((i, pidx))
        return s0, fulls, pjobs, ckpt_jobs

    def _plan_checkpoint_inserts(self, reqs, lens, fulls, s0: int):
        """Record the group's prompt pages in the radix tree before the
        chunk loop runs: a page's checkpoint is the state after one chunk
        of the loop, which the next chunk overwrites, so its copy is taken
        right after that chunk. Returns ({chunk index -> [(row,
        pool_idx)]}, hybrid ring-page copy jobs (row, pool_idx,
        start_pos) of the same new pages)."""
        page = self._page
        ev0 = self._prefix.evictions
        dr0 = self._prefix.insert_drops
        protect: set = set()
        # every row's matched chain joins the protect set first, so no
        # row's insert evicts a page a group-mate matched: a re-inserted
        # page below s0 would have no checkpoint in this run's grid
        for i, r in enumerate(reqs):
            if fulls[i]:
                self._prefix.insert(r.prompt[:fulls[i]], protect)
        by_chunk: Dict[int, list] = {}
        ring_jobs: List = []
        has_ring = self._caps.ring_bounded_context
        for i, r in enumerate(reqs):
            if has_ring and lens[i] > self._T:
                continue        # hybrid: ring wrap overwrote early pages
            for pidx, p0 in self._prefix.insert(r.prompt, protect):
                by_chunk.setdefault((p0 - s0) // page, []).append((i, pidx))
                if has_ring:
                    ring_jobs.append((i, pidx, p0))
        self.stats["prefix_evictions"] += self._prefix.evictions - ev0
        self.stats["prefix_insert_drops"] += (self._prefix.insert_drops
                                              - dr0)
        return by_chunk, ring_jobs

    def _scatter_checkpoints(self, gcache, jobs) -> None:
        """Restore each warm row's conv/SSM state from the checkpoint of
        the page ending at the group's horizon, jobs (row, pool_idx)."""
        self._ensure_pool()
        rows, idx = zip(*jobs)
        self._state.scatter_checkpoints(gcache, self._pool, idx, rows)

    def _insert_checkpoints(self, gcache, jobs) -> None:
        """Copy the group cache's inter-chunk conv/SSM state rows into
        pool checkpoint rows, jobs (row, pool_idx)."""
        self._ensure_pool()
        rows, idx = zip(*jobs)
        self._state.insert_checkpoints(self._pool, gcache, rows, idx)

    def _ensure_pool(self) -> None:
        if self._pool is None:
            self._pool = self._state.page_pool(self._prefix.capacity,
                                               self._page, device=self.device)

    @property
    def prefix_page(self) -> Optional[int]:
        """Positions per KV page (None when the prefix cache is off)."""
        return self._page if self._prefix is not None else None

    def prefix_match_len(self, tokens: List[int]) -> int:
        """How many leading tokens of ``tokens`` the radix tree holds (0
        with the cache off); pure host state, no LRU side effects."""
        if self._prefix is None:
            return 0
        return self._prefix.match_len(list(tokens))

    # -- cross-engine KV hand-off (disaggregated serving) --------------------
    def export_kv_pages(self, tokens: List[int]) -> KVPages:
        """Copy the full pages this engine has cached for ``tokens`` to host
        memory, bit for bit: the chain of whole pages from position 0 to
        the first miss (a prompt this engine just prefilled with the cache
        on exports every full page of itself). The sending half of the
        hand-off; ``import_kv_pages`` is the receiving half."""
        if self._prefix is None:
            raise RuntimeError(
                "export_kv_pages needs ServeConfig.prefix_cache=True: the "
                "page pool is the export source")
        tokens = list(tokens)
        chain = self._prefix.page_chain(tokens)
        if not chain:
            return KVPages(page=self._page, tokens=[], payload={})
        payload = self._program("_export_device",
                                np.array([i for i, _ in chain], np.int64))
        return KVPages(page=self._page,
                       tokens=tokens[:len(chain) * self._page],
                       payload=payload)

    def _export_device(self, idx):
        """Pool rows ``idx`` of every payload on the host; under TP the kv
        heads of every rank, gathered in rank order (axis 3)."""
        self._ensure_pool()
        idx_d = torch.as_tensor(idx, device=self.device)
        rules = SH.serve_cache_specs(self._pool, self._plan)
        out = {}
        for k, v in self._pool.items():
            pg = v[:, idx_d]
            if rules[k] is not None:
                pg = self._group.all_gather(pg, dim=rules[k])
            out[k] = pg.cpu()
        return out

    def import_kv_pages(self, kv: KVPages) -> int:
        """Adopt another engine's exported pages: key their token chain in
        this engine's radix tree and copy the payloads into the matching
        pool rows. Returns the number of pages imported. A chain prefix
        already resident is deduplicated (same weights, same tokens, same
        bits), a saturated pool drops the tail as a local insert does
        (counted in ``prefix_insert_drops``), and a chain longer than the
        ring imports nothing (the local insert skips such prompts). A
        request with that prompt then hits the prefix cache as if this
        engine had prefilled it."""
        if self._prefix is None:
            raise RuntimeError(
                "import_kv_pages needs ServeConfig.prefix_cache=True: the "
                "page pool is the import destination")
        if kv.page != self._page:
            raise ValueError(
                f"page geometry mismatch: exported pages hold {kv.page} "
                f"positions, this engine's pool holds {self._page}")
        n = kv.n_pages
        if n == 0 or len(kv.tokens) > self._T:
            return 0
        drops0 = self._prefix.insert_drops
        new = self._prefix.insert(list(kv.tokens[:n * self._page]))
        self.stats["prefix_insert_drops"] += (self._prefix.insert_drops
                                              - drops0)
        if not new:
            return 0
        self._program("_import_device",
                      np.array([p0 // self._page for _, p0 in new], np.int64),
                      np.array([i for i, _ in new], np.int64), kv.payload)
        return len(new)

    def _import_device(self, src, dst, payload):
        """Payload pages ``src`` into pool rows ``dst``; under TP each rank
        takes its own kv heads (axis 3)."""
        self._ensure_pool()
        rules = SH.serve_cache_specs(self._pool, self._plan)
        src_t = torch.as_tensor(src)
        dst_d = torch.as_tensor(dst, device=self.device)
        for k, pool in self._pool.items():
            if k not in payload:
                continue
            pg = payload[k][:, src_t]
            if rules[k] is not None:
                n = pg.shape[rules[k]] // self._plan.size
                pg = pg.narrow(rules[k], self._rank * n, n)
            pool[:, dst_d] = pg.to(self.device, pool.dtype)

    # -- admission -----------------------------------------------------------
    def _admit_group(self, slots: List[int], reqs: List[Request]) -> None:
        """Prefill ``reqs`` as one right-padded batch and scatter their
        caches into ``slots`` with one cache_set_slots call. With the
        prefix cache, each request's cached positions below the warm
        horizon s0 (``_match_prefixes``) are scattered into its
        group-cache row first and the chunk loop covers only [s0, padded
        max): the lengths past s0 pick the group shape.

        A recurrent family runs the same path on its fixed chunk grid:
        warm rows restore the checkpoint at the group's full-page horizon
        s0 (``_match_checkpoints``; hybrid also scatters its ring pages
        below s0), the chunk loop starts at s0, and the pages recorded
        before the loop take their checkpoints chunk by chunk.

        The host plans everything (matches, inserts, the group shape) and
        the device part is one program, ``_admit_device``."""
        t0 = time.perf_counter()
        for r in reqs:
            if r.submit_t is not None:
                r.queue_wait_s = t0 - r.submit_t
        G = len(reqs)
        lens = [len(r.prompt) for r in reqs]
        caps = self._caps
        s0, jobs, ckpt_jobs, ins_by_chunk, copy_jobs = 0, [], [], {}, []
        if self._prefix is not None and caps.recurrent:
            s0, fulls, jobs, ckpt_jobs = self._match_checkpoints(reqs)
            ins_by_chunk, copy_jobs = self._plan_checkpoint_inserts(
                reqs, lens, fulls, s0)
        elif self._prefix is not None:
            s0, jobs = self._match_prefixes(reqs)
            copy_jobs = self._plan_prefix_inserts(reqs, lens)
        P, C, Gp = self._group_shape(
            [n - s0 for n in lens],
            whole=caps.recurrent or (s0 > 0 and caps.capacity_follows_chunk))
        toks = np.zeros((Gp, s0 + P), np.int64)
        lengths = np.zeros(Gp, np.int64)            # dummy rows: length 0
        for i, r in enumerate(reqs):
            toks[i, :lens[i]] = r.prompt
            lengths[i] = lens[i]
        budgets = np.zeros(Gp, np.int64)            # dummies: 0 -> unbound
        budgets[:G] = [r.max_new_tokens for r in reqs]
        free_arr = np.full(Gp, self._B, np.int64)
        free_arr[:G] = slots
        firsts, idx = self._program(
            "_admit_device", toks, lengths, s0, P, C, G, jobs, ckpt_jobs,
            ins_by_chunk, copy_jobs, budgets, free_arr)
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

    def _admit_device(self, toks, lengths, s0, P, C, G, jobs, ckpt_jobs,
                      ins_by_chunk, copy_jobs, budgets, free_arr):
        """Admission's device program: the group cache (checkpoints and
        matched pages scattered in), the chunk loop from s0, the first
        tokens (one host sync), the slot binding, the scatter into the
        decode cache and the copies of new pages into the pool. Returns
        (first tokens, scatter indices), host arrays."""
        if self._cache is None:
            self._cache = self._new_cache(self._B)
        gcache = self._new_cache(toks.shape[0])
        if ckpt_jobs:
            self._scatter_checkpoints(gcache, ckpt_jobs)
        if jobs:
            self._scatter_prefix_pages(gcache, jobs)
        gcache, last_logits = self._prefill_group(gcache, toks, lengths, s0,
                                                  P, C, ins_by_chunk)
        firsts = self._sample_first(last_logits, G).cpu().numpy()  # 1 sync
        idx = self._bind_slots(firsts, budgets, free_arr)
        self._state.set_slots(self._cache, gcache, idx)
        self._copy_ring_pages(gcache, copy_jobs)
        return firsts, idx

    def prefill_logits(self, prompts: List[List[int]]) -> np.ndarray:
        """The last-prompt-token logits (G, V) f32 of one group prefill of
        ``prompts`` (at most ``prefill_batch``), the numbers admission
        samples the first tokens from; the decode cache, the prefix cache
        and the sampling stream are left as they were. The probe that
        holds a datapath's numbers against another's."""
        if not 0 < len(prompts) <= self.scfg.prefill_batch:
            raise ValueError(f"need 1 to prefill_batch="
                             f"{self.scfg.prefill_batch} prompts, got "
                             f"{len(prompts)}")
        lens = [len(p) for p in prompts]
        P, C, Gp = self._group_shape(lens, whole=self._caps.recurrent)
        toks = np.zeros((Gp, P), np.int64)
        lengths = np.zeros(Gp, np.int64)
        for i, p in enumerate(prompts):
            toks[i, :lens[i]] = p
            lengths[i] = lens[i]
        out = self._program("_prefill_logits_device", toks, lengths, P, C)
        return out[:len(prompts)]

    def _prefill_logits_device(self, toks, lengths, P, C):
        return self._prefill_group(self._new_cache(toks.shape[0]), toks,
                                   lengths, 0, P, C)[1].cpu().numpy()

    def _prefill_group(self, gcache, toks, lengths, s0, P, C,
                       ins_by_chunk=None):
        """The chunk loop of a group prefill over [s0, s0 + P): (the group
        cache, the last-prompt-token logits (G, V) f32). Checkpoint pages
        ``ins_by_chunk`` are copied after their chunk."""
        last = torch.zeros((toks.shape[0], self.cfg.vocab_size),
                           dtype=torch.float32, device=self.device)
        lengths_d = torch.as_tensor(lengths, device=self.device)
        toks_d = torch.as_tensor(toks, device=self.device)
        for j, start in enumerate(range(s0, s0 + P, C)):
            gcache, last = self._prefill_chunk_impl(
                gcache, toks_d[:, start:start + C], start, lengths_d, last)
            if ins_by_chunk and j in ins_by_chunk:
                # before the next chunk overwrites the state in place
                self._insert_checkpoints(gcache, ins_by_chunk[j])
        return gcache, last

    @staticmethod
    def _admit_key(req: Request):
        """Queue drain order: priority strata (higher first), the earliest
        absolute TTFT deadline within a stratum, then submission order --
        so a queue of one priority and no deadlines drains FIFO."""
        dl = (req.submit_t + req.deadline_s
              if req.deadline_s is not None and req.submit_t is not None
              else float("inf"))
        return (-req.priority, dl, req.id)

    def _pop_pending(self, n: int) -> List[Request]:
        picked = sorted(self._queue, key=self._admit_key)[:n]
        for r in picked:
            self._queue.remove(r)
        return picked

    def _preempt_for(self, head: Request) -> bool:
        """Free one slot for ``head`` by cancelling the lowest-priority
        (then youngest) running request, only when head's priority is
        strictly higher. The victim keeps its emitted tokens and completes
        with cancelled=True, preempted=True."""
        victims = [(req.priority, -req.id, i)
                   for i, req in enumerate(self._slots) if req is not None]
        if not victims:
            return False
        prio, _, i = min(victims)
        if head.priority <= prio:
            return False
        victim = self._slots[i]
        self._live[i] = False
        self._slots[i] = None
        victim.preempted = True
        self.stats["preemptions"] += 1
        self._finish(victim, cancelled=True)
        return True

    def _admit_pending(self) -> None:
        while self._queue:
            free = [i for i in range(self._B) if self._slots[i] is None]
            if not free:
                if not self.scfg.preempt:
                    return
                head = min(self._queue, key=self._admit_key)
                if not self._preempt_for(head):
                    return
                free = [i for i in range(self._B)
                        if self._slots[i] is None]
            n = min(len(free), max(self.scfg.prefill_batch, 1),
                    len(self._queue))
            self._admit_group(free[:n], self._pop_pending(n))

    # -- decode --------------------------------------------------------------
    def _run_chunk(self) -> None:
        t0 = time.perf_counter()
        if self._drafter is not None:
            (out, tok, pos, live, ngen, self._dstate, drafted, accepted,
             rounds) = self._program(
                "_spec_chunk_device", self._tok, self._pos, self._live,
                self._spec, self._ngen, self._budget, self._dstate)
            self.stats["draft_tokens"] += drafted
            self.stats["draft_accepted"] += accepted
            self.stats["spec_rounds"] += rounds
        else:
            # the steps this chunk needs: without EOS every live slot dies
            # exactly when its budget runs out, so the host knows the count
            remaining = np.where(self._live, self._budget - self._ngen, 0)
            steps = int(min(self.scfg.decode_chunk, remaining.max()))
            out, tok, pos, live, ngen = self._program(
                "_decode_chunk_device", self._tok, self._pos, self._live,
                self._ngen, self._budget, steps)
        self._tok, self._pos, self._live, self._ngen = tok, pos, live, ngen
        if self._drafter is None:
            # the steps with a live slot drew noise; a step after every
            # slot died (past an EOS the host could not see) did not
            self._draw += int((out >= 0).any(axis=0).sum())
        self.stats["host_syncs"] += 1
        self.stats["chunks"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        self._emit_chunk(out)

    def _decode_chunk_device(self, tok, pos, live, ngen, budget, steps):
        """The decode chunk's program: host state in, ``steps`` decode
        steps, host state out (THE chunk sync)."""
        state = [torch.as_tensor(a, device=self.device)
                 for a in (tok, pos, live, ngen, budget)]
        res = self._decode_chunk_impl(*state, steps)
        return tuple(np.array(t.cpu()) for t in res)

    def _spec_chunk_device(self, tok, pos, live, spec, ngen, budget,
                           dstate):
        """The speculative chunk's program (``_spec_chunk_impl``)."""
        dev = self.device
        tok_d, pos_d, live_d, spec_d, ngen_d, budget_d = (
            torch.as_tensor(a, device=dev)
            for a in (tok, pos, live, spec, ngen, budget))
        ds = {k: torch.as_tensor(v, device=dev) for k, v in dstate.items()}
        (out, tok_d, pos_d, live_d, ngen_d, ds, drafted, accepted,
         rounds) = self._spec_chunk_impl(tok_d, pos_d, live_d, spec_d,
                                         ngen_d, budget_d, ds)
        return (*(np.array(t.cpu()) for t in (out, tok_d, pos_d, live_d,
                                              ngen_d)),
                {k: np.array(v.cpu()) for k, v in ds.items()},
                int(drafted), int(accepted), rounds)

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
        self.stats["accept_rate"] = (
            self.stats["draft_accepted"] / self.stats["draft_tokens"]
            if self.stats["draft_tokens"] > 0 else 0.0)

    def run(self, poll: Optional[Callable[[], None]] = None
            ) -> Dict[int, List[int]]:
        """Drive batched admission + decode chunks until queue and slots
        are drained. Returns {request_id: tokens} for THIS cycle; stats
        cover this cycle only (a request submitted from an ``on_token``
        callback is served by this cycle). ``poll``, if given, is called
        once per scheduler iteration before the drain check: arrivals and
        cancels injected there land between chunks."""
        self.stats = self._fresh_stats()
        self._run_t0 = time.perf_counter()
        while True:
            if poll is not None:
                poll()
            if not (self._queue or any(r is not None for r in self._slots)):
                break
            self._admit_pending()
            if not self._live.any():
                continue
            self._run_chunk()
        return self._end_cycle()

    def _end_cycle(self) -> Dict[int, List[int]]:
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

    def _start_reference(self, prompts: List[List[int]]) -> List[int]:
        if len(prompts) > self._B:
            raise ValueError("reference path has no queue; "
                             f"need <= {self._B} prompts")
        if self._queue:
            raise RuntimeError(
                f"{len(self._queue)} submitted request(s) pending; call "
                "run() to drain them before a reference run")
        self._reset()
        ids = [self.submit(list(p)) for p in prompts]
        self._run_t0 = time.perf_counter()
        self._admit_pending()
        return ids

    def generate_reference(self,
                           prompts: List[List[int]]) -> List[List[int]]:
        """Host-driven reference: same admission/prefill/sampling math but
        one host round-trip per token. The parity oracle for the chunked
        decode loop, not a serving path."""
        ids = self._start_reference(prompts)
        t0 = time.perf_counter()
        while self._live.any():
            nxt = self._program("_ref_step", self._tok, self._pos,
                                self._live)
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
        res = self._end_cycle()
        return [res[i] for i in ids]

    def _ref_step(self, tok, pos, live):
        """One decode step and its samples (``generate_reference``)."""
        dev = self.device
        tok = torch.as_tensor(tok, device=dev)
        live = torch.as_tensor(live, device=dev)
        logits, self._cache = T.decode_step(
            self.params, self.cfg, self._cache, tokens=tok,
            position=torch.as_tensor(pos, device=dev), live=live)
        self.stats["forwards"] += 1
        return torch.where(live, self._sample(logits, self._draw),
                           tok).cpu().numpy()

    def generate_spec_reference(self,
                                prompts: List[List[int]]) -> List[List[int]]:
        """Host-driven speculative oracle: one verify round per host trip,
        with acceptance, rejection sampling, truncation and rollback
        bookkeeping re-implemented in numpy against the raw logits. The
        same draws as the device loop (the uniforms of draw n and the
        Gumbel noise of draw n + 1 a round), so the two agree token for
        token: the validation target for temperature mode. A parity tool,
        not a serving path."""
        if self._drafter is None:
            raise RuntimeError("generate_spec_reference needs a drafter")
        ids = self._start_reference(prompts)
        C = self.scfg.decode_chunk
        k = self.scfg.draft_k
        S = k + 1
        B = self._B
        eos = self.scfg.eos_id
        temp = self.scfg.temperature
        cols = np.arange(S)[None]
        t0 = time.perf_counter()
        while self._live.any():
            nout = np.zeros(B, np.int64)            # fresh chunk capacity
            progressed = False
            while True:
                spec_ok = (self._spec if self.cfg.sliding_window
                           else self._spec & (self._pos + k < self._T))
                need = np.where(spec_ok, S, 1)
                act = self._live & (nout + need <= C)
                if not act.any():
                    break
                progressed = True
                spec_eff = act & spec_ok
                drafts, logits = self._program(
                    "_spec_ref_verify", self._tok, self._pos, act, spec_eff,
                    self._dstate)
                self.stats["host_syncs"] += 1
                # -- host acceptance (an independent numpy implementation)
                if temp > 0:
                    u = self._uniform(self._draw, (B, k)).cpu().numpy()
                    g = self._gumbel(self._draw + 1,
                                     (B, logits.shape[-1])).cpu().numpy()
                    self._draw += 2
                    lt = logits / np.float32(temp)
                    pm = np.exp(lt[:, :k] - lt[:, :k].max(-1, keepdims=True))
                    pm = pm / pm.sum(-1, keepdims=True)
                    pd = np.take_along_axis(pm, drafts[:, :, None], 2)[..., 0]
                    ok = (u < pd) & spec_eff[:, None]
                    acc = np.cumprod(ok, axis=1).sum(axis=1)
                    pl = np.take_along_axis(lt, acc[:, None, None], 1)[:, 0]
                    pcol = np.exp(pl - pl.max(-1, keepdims=True))
                    pcol = pcol / pcol.sum(-1, keepdims=True)
                    dcol = np.take_along_axis(
                        drafts, np.clip(acc, 0, k - 1)[:, None], 1)[:, 0]
                    rejected = spec_eff & (acc < k)
                    resid = pcol.copy()
                    resid[np.arange(B), dcol] = np.where(
                        rejected, 0.0, resid[np.arange(B), dcol])
                    with np.errstate(divide="ignore"):
                        lr = np.where(resid > 0, np.log(resid), -np.inf)
                    fin = (lr + g).argmax(-1)
                    fin = np.where((resid > 0).any(-1), fin, dcol)
                else:
                    gm = logits.argmax(-1)
                    ok = (drafts == gm[:, :k]) & spec_eff[:, None]
                    acc = np.cumprod(ok, axis=1).sum(axis=1)
                    fin = np.take_along_axis(gm, acc[:, None], 1)[:, 0]
                draftsp = np.concatenate([drafts, drafts[:, -1:]], axis=1)
                emit = np.where(cols < acc[:, None], draftsp, fin[:, None])
                e = np.minimum(acc + 1, self._budget - self._ngen)
                if eos is not None:
                    hit = (emit == eos) & (cols < e[:, None])
                    first = hit.argmax(1)
                    e = np.where(hit.any(1), np.minimum(e, first + 1), e)
                e = np.where(act, e, 0)
                keep = np.where(act, 1 + acc, 0)
                self._dstate = self._program("_spec_ref_commit", keep, emit,
                                             e)
                self.stats["draft_tokens"] += int(spec_eff.sum()) * k
                self.stats["draft_accepted"] += int(acc[spec_eff].sum())
                self.stats["spec_rounds"] += 1
                for i, req in enumerate(self._slots):
                    if req is None or e[i] == 0:
                        continue
                    for t in emit[i, :e[i]].tolist():
                        req._emit(int(t))
                    self._ngen[i] += int(e[i])
                    self._pos[i] += int(e[i])
                    self._tok[i] = int(emit[i, e[i] - 1])
                    died = self._ngen[i] >= self._budget[i]
                    if eos is not None:
                        died = died or eos in emit[i, :e[i]].tolist()
                    if died:
                        self._live[i] = False
                        self._finish(req)
                        self._slots[i] = None
                nout = nout + e
            if not progressed:
                break
        self.stats["decode_s"] += time.perf_counter() - t0
        res = self._end_cycle()
        return [res[i] for i in ids]

    def _spec_ref_verify(self, tok, pos, act, spec_eff, dstate):
        """``generate_spec_reference``'s device half of a round: drafts,
        the ring snapshot (kept for ``_spec_ref_commit``) and the verify
        pass. Returns (drafts, logits (B, k+1, V) f32), host arrays."""
        dev = self.device
        ds = {k: torch.as_tensor(v.copy(), device=dev)
              for k, v in dstate.items()}
        drafts_d, ds = self._drafter.propose(
            self.params, self.cfg, self._cache, ds,
            torch.as_tensor(tok, device=dev), torch.as_tensor(pos, device=dev),
            torch.as_tensor(spec_eff, device=dev))
        drafts = drafts_d.cpu().numpy()
        cols = np.arange(drafts.shape[1] + 1)[None]
        x = np.concatenate([tok[:, None], drafts], axis=1)
        positions = pos[:, None] + cols
        valid = act[:, None] & ((cols == 0) | spec_eff[:, None])
        slots_d = torch.as_tensor(positions % self._T, device=dev)
        self._ref_round = (self._state.ring_snapshot(self._cache, slots_d),
                           slots_d, ds)
        logits = self._verify_impl(torch.as_tensor(x, device=dev),
                                   torch.as_tensor(positions, device=dev),
                                   torch.as_tensor(valid, device=dev))
        return drafts, logits.cpu().numpy().astype(np.float32)

    def _spec_ref_commit(self, keep, emit, e):
        """The round's rewind of rejected drafts and the drafter's update;
        returns the drafter state as host arrays."""
        dev = self.device
        snap, slots_d, ds = self._ref_round
        self._ref_round = None
        self._state.ring_rewind(self._cache, snap, slots_d,
                                torch.as_tensor(keep, device=dev))
        ds = self._drafter.update(ds, torch.as_tensor(emit, device=dev),
                                  torch.as_tensor(e, device=dev))
        return {k: np.array(v.cpu()) for k, v in ds.items()}
