"""Deterministic token data pipeline: synthetic LM stream + file-backed.

Counterpart of ``repro.data.pipeline``, in numpy only: ``batch(step)``
gives the reference's bytes in both modes. Synthetic mode generates a
structured pseudo-language (Zipf-ish unigram with short-range bigram
structure) so tiny models have something learnable. File mode
memory-maps a flat uint16 token file and serves fixed-length windows.
Batches are a pure function of (seed, step), so a restart resumes
bit-identically from a checkpointed step. Multi-process: where
``torch.distributed`` is initialized, each process keeps its own rows of
the global batch (by rank and world size); otherwise all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.device import processes


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None       # file-backed if set
    dtype: str = "int32"


class DataPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        # bigram transition structure for the synthetic language
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        self._uni = (1.0 / (np.arange(V) + 10.0))
        self._uni /= self._uni.sum()
        self._shift = rng.integers(1, max(2, V // 2), size=16)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) & 0x7FFFFFFF)

    def _synthetic(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng(step)
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._uni)
        # inject learnable bigram structure: with p=0.5, next token is a
        # deterministic function of the current one
        mask = rng.random((B, S)) < 0.5
        nxt = (toks[:, :-1] + self._shift[toks[:, :-1] % 16]) % cfg.vocab_size
        toks[:, 1:][mask] = nxt[mask]
        return toks.astype(np.int32)

    def _from_file(self, step: int) -> np.ndarray:
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        n = len(self._mm) - (S + 1)
        starts = self._rng(step).integers(0, n, size=B)
        return np.stack([self._mm[s:s + S + 1] for s in starts]).astype(
            np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._from_file(step) if self._mm is not None \
            else self._synthetic(step)
        i, nproc = processes()
        if nproc > 1:
            per = toks.shape[0] // nproc
            toks = toks[i * per:(i + 1) * per]
        return dict(tokens=toks[:, :-1], labels=toks[:, 1:])
