"""Draft-token proposers for speculative decoding.

Counterpart of ``repro.serving.drafters``. A ``Drafter`` proposes k
tokens per slot; the engine scores them against the target model in one
verify pass and accepts the longest correct prefix (greedy: the tokens of
plain decode; temperature: rejection sampling). Neither drafter needs a
second checkpoint:

* ``ngram`` -- prompt-lookup drafting: match the sequence's most recent
  n-gram against its own history (prompt + generated tokens) and propose
  the continuation of the latest earlier occurrence. No model cost.
* ``self`` -- truncated-layer self-drafting: the first ``draft_layers``
  layers of the same model (the same packed weights, so every draft step
  runs the hand-written dequant-matmul), greedy for k steps over a draft
  cache, then the shared final norm and LM head.

The port updates caches in place, so the self drafter's draft cache is a
copy of the main cache's leading layers and of ``pos``: a view, as the
reference's ``v[:dl]`` would be here, would let the draft's writes land
in the main ring. The copy is dropped after proposing, so rejected draft
state never needs unwinding.

Proposing and updating are torch ops on the engine's device and cost no
host sync. Host-side state (admission fills) is numpy, uploaded with the
rest of the chunk state; ``update`` returns new tensors and never writes
its inputs, which may share memory with that numpy state on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


class NGramDrafter:
    """Prompt-lookup drafter: n-gram match over a per-slot rolling history
    ring of the last ``draft_hist`` tokens."""

    name = "ngram"
    draft_forwards = 0              # model forwards a propose runs

    def __init__(self, cfg: ModelConfig, scfg):
        self.k = scfg.draft_k
        self.n = scfg.draft_ngram
        self.H = scfg.draft_hist
        if self.H < self.n + 1:
            raise ValueError(
                f"draft_hist ({self.H}) must exceed draft_ngram ({self.n})")

    # -- host-side state ----------------------------------------------------
    def init_state_np(self, B: int) -> Dict[str, np.ndarray]:
        return dict(hist=np.full((B, self.H), -1, np.int64),
                    hpos=np.full((B, self.H), -1, np.int64),
                    hcnt=np.zeros((B,), np.int64))

    def admit_np(self, state: Dict[str, np.ndarray], slot: int,
                 tokens) -> None:
        """Fill a freshly admitted slot's history with prompt + first
        token (in place; admission is a host sync point already)."""
        H = self.H
        toks = np.asarray(tokens, np.int64)
        n = len(toks)
        state["hist"][slot] = -1
        state["hpos"][slot] = -1
        pos = np.arange(max(0, n - H), n)
        state["hist"][slot, pos % H] = toks[pos]
        state["hpos"][slot, pos % H] = pos
        state["hcnt"][slot] = n

    # -- device-side propose/update ------------------------------------------
    def propose(self, params, cfg, cache, state, tok, pos,
                act) -> Tuple[torch.Tensor, Any]:
        """Latest earlier occurrence of the trailing n-gram; propose its
        continuation. No match (or a history shorter than n): repeat the
        last token -- cheap, and verify fixes everything."""
        hist, hpos, hcnt = state["hist"], state["hpos"], state["hcnt"]
        H = hist.shape[1]
        n, k = self.n, self.k
        dev = hist.device
        # trailing query gram: absolute positions hcnt-n .. hcnt-1
        qpos = hcnt[:, None] - n + torch.arange(n, device=dev)[None]
        qtok = hist.gather(1, qpos % H)                         # (B, n)
        # a candidate gram ends at every ring slot's absolute position
        m = (hpos >= 0) & (hpos <= hcnt[:, None] - 2)           # strictly
        for j in range(n):                                      # earlier
            cpos = hpos - (n - 1 - j)
            ctok = hist.gather(1, cpos % H)
            cchk = hpos.gather(1, cpos % H)
            m = m & (cchk == cpos) & (ctok == qtok[:, j:j + 1])
        m = m & (hcnt[:, None] >= n)                            # query valid
        best = torch.where(m, hpos, torch.full_like(hpos, -1)).amax(dim=1)
        prop_pos = best[:, None] + 1 + torch.arange(k, device=dev)[None]
        ptok = hist.gather(1, prop_pos % H)
        ok = (best[:, None] >= 0) & (hpos.gather(1, prop_pos % H) == prop_pos)
        return torch.where(ok, ptok, tok[:, None]), state

    def update(self, state, emit, e) -> Any:
        """Append each slot's e accepted tokens (emit[:, :e]) to its
        history ring: one masked column write at a time, so a ring shorter
        than the block keeps the last write."""
        hist, hpos = state["hist"].clone(), state["hpos"].clone()
        hcnt = state["hcnt"]
        H = hist.shape[1]
        bidx = torch.arange(hist.shape[0], device=hist.device)
        for j in range(emit.shape[1]):
            wp = hcnt + j
            sl = wp % H
            m = j < e
            hist[bidx, sl] = torch.where(m, emit[:, j].to(hist.dtype),
                                         hist[bidx, sl])
            hpos[bidx, sl] = torch.where(m, wp, hpos[bidx, sl])
        return dict(hist=hist, hpos=hpos, hcnt=hcnt + e)


class SelfDrafter:
    """Truncated-layer self-drafter: the first ``draft_layers`` of the
    target model (sharing its packed weights), greedy for k steps over a
    draft cache copied from the main cache's leading layers."""

    name = "self"

    def __init__(self, cfg: ModelConfig, scfg):
        self.k = scfg.draft_k
        self.dl = scfg.draft_layers
        if not 1 <= self.dl <= cfg.n_layers:
            raise ValueError(
                f"draft_layers ({self.dl}) must be in [1, {cfg.n_layers}]")
        self.cfg_draft = cfg.replace(n_layers=self.dl)
        self.draft_forwards = self.k

    def init_state_np(self, B: int) -> Dict[str, np.ndarray]:
        return {}

    def admit_np(self, state, slot, tokens) -> None:
        pass

    def propose(self, params, cfg, cache, state, tok, pos,
                act) -> Tuple[torch.Tensor, Any]:
        from repro_torch.models import transformer as T
        dl = self.dl
        # a copy, never a view: decode_step writes the draft cache in place
        dcache = {k: (v.clone() if k == "pos" else v[:dl].clone())
                  for k, v in cache.items()}
        cur, p = tok, pos
        outs = []
        for _ in range(self.k):
            # the stacked layer params serve as they are: a dl-layer
            # config reads their first dl layers
            logits, dcache = T.decode_step(params, self.cfg_draft, dcache,
                                           tokens=cur, position=p, live=act)
            cur = torch.argmax(logits, dim=-1)
            p = p + 1
            outs.append(cur)
        return torch.stack(outs, dim=1), state

    def update(self, state, emit, e) -> Any:
        return state


DRAFTERS = {"ngram": NGramDrafter, "self": SelfDrafter}


def make_drafter(name: str, cfg: ModelConfig, scfg):
    try:
        cls = DRAFTERS[name]
    except KeyError:
        raise ValueError(f"unknown drafter {name!r}; "
                         f"known: {sorted(DRAFTERS)}") from None
    return cls(cfg, scfg)
