"""Activation calibration for the quantization policy search.

Counterpart of ``repro.core.calibrate``. A small token budget runs through
the float model, and every matmul input records the statistics that drive
format selection:

  * per-K-column activation abs-max   -> outlier rows for q3_k_o
  * per-K-column mean square          -> activation-weighted quant error
  * outlier-column fraction           -> which layers want the sidecar

The model's matmul call sites call :func:`tap` with a stable projection
suffix name (``"attn/wq"``, ``"mlp/w_down"``, ...) and the matmul input.
Outside :func:`collecting` the tap returns at once. Inside, it reduces the
input on its device and folds the result into device tensors; nothing
leaves the device until :func:`run_calibration` returns, which copies all
statistics to the host in one transfer. The layer loop taps once per
layer, so the stacked layers accumulate into one aggregate per suffix, as
the reference's once-per-scan-iteration callback does: ``rows`` sums over
the layers, and ``tokens`` is the largest ``rows``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import quantize as Q
from repro_torch.device import tree_device

# the active collector; None outside ``collecting()``
_COLLECTOR: Optional["_Collector"] = None


class _Collector:
    def __init__(self):
        self.absmax: Dict[str, torch.Tensor] = {}
        self.sumsq: Dict[str, torch.Tensor] = {}
        self.rows: Dict[str, float] = {}

    def record(self, name: str, absmax: torch.Tensor, sumsq: torch.Tensor,
               rows: float) -> None:
        if name in self.absmax:
            torch.maximum(self.absmax[name], absmax, out=self.absmax[name])
            self.sumsq[name].add_(sumsq)
            self.rows[name] += rows
        else:
            # own copies: names that share one input accumulate apart
            self.absmax[name] = absmax.clone()
            self.sumsq[name] = sumsq.clone()
            self.rows[name] = rows


def tap(name, x: torch.Tensor) -> None:
    """Record activation stats for matmul input ``x`` (..., K) feeding the
    weight(s) whose parameter path ends with ``name`` (a str, or a tuple of
    suffixes sharing this input, e.g. wq/wk/wv). No-op unless inside
    :func:`collecting`."""
    col = _COLLECTOR
    if col is None:
        return
    names = (name,) if isinstance(name, str) else tuple(name)
    K = x.shape[-1]
    xf = x.to(torch.float32).reshape(-1, K)
    absmax = xf.abs().amax(dim=0)
    sumsq = (xf * xf).sum(dim=0)
    rows = float(xf.shape[0])               # from the shape: no sync
    for n in names:
        col.record(n, absmax, sumsq, rows)


@contextlib.contextmanager
def collecting():
    """Activate a stats collector for the taps run within the block."""
    global _COLLECTOR
    prev = _COLLECTOR
    col = _Collector()
    _COLLECTOR = col
    try:
        yield col
    finally:
        _COLLECTOR = prev


# ---------------------------------------------------------------------------
# calibration results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibStats:
    """Aggregated activation statistics, keyed by tap suffix name."""
    absmax: Dict[str, np.ndarray]     # name -> (K,) column abs-max
    mean_sq: Dict[str, np.ndarray]    # name -> (K,) column mean square
    tokens: int                       # total calibration rows observed

    def names(self):
        return sorted(self.absmax)

    def outlier_fraction(self, name: str, z: float = 6.0) -> float:
        """Fraction of K columns whose abs-max exceeds z * median abs-max
        (the d-Matrix outlier-block criterion, column granularity)."""
        a = self.absmax[name]
        med = float(np.median(a))
        if med <= 0:
            return 0.0
        return float(np.mean(a > z * med))

    def for_paths(self, paths: Sequence[str]) -> Dict[str, np.ndarray]:
        """Map tap suffixes onto full parameter paths by suffix match --
        the shape ``quantize_params(calib=...)`` expects."""
        out = {}
        for path in paths:
            for name, a in self.absmax.items():
                if path == name or path.endswith("/" + name):
                    out[path] = a
                    break
        return out


def _stats_from(col: _Collector) -> CalibStats:
    names = sorted(col.absmax)
    if not names:
        return CalibStats({}, {}, 0)
    # one device -> host copy for every statistic
    flat = torch.cat([t for n in names
                      for t in (col.absmax[n], col.sumsq[n])]).cpu().numpy()
    absmax, sumsq, off = {}, {}, 0
    for n in names:
        K = col.absmax[n].numel()
        absmax[n] = flat[off:off + K]
        sumsq[n] = flat[off + K:off + 2 * K]
        off += 2 * K
    mean_sq = {n: sumsq[n] / max(col.rows[n], 1.0) for n in names}
    tokens = int(max(col.rows.values()))
    return CalibStats(absmax, mean_sq, tokens)


def run_calibration(params, cfg, *, tokens=None, batch: int = 2,
                    seq: int = 64, n_batches: int = 2,
                    seed: int = 0) -> CalibStats:
    """Run the float model over a small token budget and collect stats.

    ``tokens``: optional (B, S) int array, or a list of them; otherwise
    ``n_batches`` random (batch, seq) batches are drawn from a
    ``torch.Generator`` seeded with ``seed`` on the parameters' device
    (the search needs the activations' distribution shape, not a
    dataset). The model runs on the device its parameters lie on."""
    from repro_torch.models import transformer as T

    dev = tree_device(params)
    if tokens is not None:
        batches = [torch.as_tensor(np.asarray(t)).to(dev) for t in
                   (tokens if isinstance(tokens, (list, tuple)) else
                    [tokens])]
    else:
        g = torch.Generator(device=dev).manual_seed(seed)
        batches = [torch.randint(0, cfg.vocab_size, (batch, seq),
                                 generator=g, device=dev)
                   for _ in range(n_batches)]
    with collecting() as col:
        for b in batches:
            T.forward_seq(params, cfg, tokens=b)
    return _stats_from(col)


# ---------------------------------------------------------------------------
# offline per-format quantization error (no model run needed)
# ---------------------------------------------------------------------------

def format_mse(params, stats: Optional[CalibStats],
               candidates: Sequence[str],
               paths: Optional[Sequence[str]] = None
               ) -> Dict[str, Dict[str, float]]:
    """Activation-weighted quantization MSE per (path, candidate format).

    For each quantizable weight W (K, N) and candidate variant v:
        mse = mean_k,n [ (W - deq(quant_v(W)))^2 * E[x_k^2] / mean E[x^2] ]
    i.e. reconstruction error weighted by how hard each K row is driven
    by the calibration activations. The numbers only rank candidates per
    path."""
    from repro_torch.core.qlinear import _flatten_paths, _is_quantizable_path

    want = set(paths) if paths is not None else None
    out: Dict[str, Dict[str, float]] = {}
    for path, arr in _flatten_paths(params):
        if want is not None and path not in want:
            continue
        if arr.dim() < 2 or not _is_quantizable_path(path):
            continue
        K, N = arr.shape[-2], arr.shape[-1]
        if K % 256 != 0:
            continue
        w = arr.to(torch.float32).reshape(-1, K, N)
        wk = None
        if stats is not None:
            m = None
            for name in stats.mean_sq:
                if path == name or path.endswith("/" + name):
                    m = stats.mean_sq[name]
                    break
            if m is not None and K % m.size == 0:
                wk = np.tile(np.asarray(m, np.float32), K // m.size)
                mean = float(wk.mean())
                wk = wk / mean if mean > 0 else None
        per = {}
        for v in candidates:
            if v == "q3_k_o" and wk is not None:
                a = torch.from_numpy(np.sqrt(wk)).to(w.device)
                qd = Q.dequantize(Q.quantize_q3_k_o(w, act_absmax=a))
            else:
                qd = Q.dequantize(Q.quantize_fn(v)(w))
            err = (w - qd) ** 2
            if wk is not None:
                err = err * torch.from_numpy(wk).to(w.device)[None, :, None]
            per[v] = float(err.mean())
        out[path] = per
    return out
