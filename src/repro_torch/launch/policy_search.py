"""Auto quantization-policy search: greedy Pareto hill-climb over the
per-layer format assignment.

Counterpart of ``repro.launch.policy_search``, with the same three phases
and the same guarantee. Pipeline (calibrate -> search -> serve):

  1. ``core/calibrate.py`` runs a small token budget through the float
     model and records per-matmul activation stats.
  2. This module searches the per-path format assignment, seeded from
     ``default_serve_mix``, against the quality-vs-bytes Pareto measured
     by ``core/quality.py`` (teacher-logit KL on a fixed eval batch):
     (a) probe every single-path move once for its KL and byte delta;
     (b) sweep a Lagrangian trade-off over those first-order estimates to
     propose byte-feasible assignments, plus the best-estimated paired
     upgrade+downgrade swaps, verifying each with a true eval; (c) greedy
     single-move hill-climb refinement. The RETURNED assignment is the
     best verified state that weakly dominates the seed on both axes (the
     seed itself always qualifies), so the final policy is never worse
     than ``default_serve_mix`` on KL or bytes.
  3. The searched assignment serializes to JSON (exact-path rules; see
     ``core.policy.policy_to_dict``) and loads back through
     ``serve --policy auto --policy-json <file>``.

Every probe of the outlier-aware q3_k_o runs its matmuls through the CUDA
kernel's q3_k_o variant on the card.

  PYTHONPATH=src python -m repro_torch.launch.policy_search \
      --arch tinyllama-1.1b --out results/auto_tinyllama.json
  (add --reduced --device cpu for a small run on the CPU)
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import calibrate as C
from repro_torch.core import formats as F
from repro_torch.core import policy as P
from repro_torch.core import quality as QY
from repro_torch.core.qlinear import (_flatten_paths, quantize_params,
                                      quantized_param_bytes, to_device)
from repro_torch.device import resolve_device

# search candidates: the paper's two native variants, our outlier-aware
# extension, and two fallback-quality tiers ("none" = keep fp)
DEFAULT_CANDIDATES = ("q2_k", "q3_k", "q3_k_o", "q4_k", "q6_k", "none")


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root


def _exact_policy(name: str, assignment: Dict[str, Optional[str]]):
    rules = tuple((path, v or "none") for path, v in sorted(assignment.items()))
    return P.QuantPolicy(name, rules, default="none")


def _nearest_candidate(variant: Optional[str], available) -> Optional[str]:
    """Map a seed-report variant onto the searched candidate set.

    ``quantize_params``'s report goes through ``pick_fallback``, so a
    shape with K % 32 == 0 but K % 256 != 0 reports a 32-block fallback
    (q8_0) that need not be in ``candidates``; pick the candidate closest
    in bits/weight so every seed leaf stays addressable in ``_Searcher``
    (the assembled leaf goes through the same fallback at that shape, so
    the evaluation matches what serving would pack)."""
    if variant is None or variant in available:
        return variant
    bits = F.get_format(variant).bits_per_weight
    return min(sorted(available),
               key=lambda c: abs(F.get_format(c).bits_per_weight - bits))


class _Searcher:
    """Caches one full-model quantization per candidate variant, then
    assembles assignment trees leaf-wise (each eval costs one student
    forward, not a re-quantization)."""

    def __init__(self, cfg, params, candidates, stats, *,
                 eval_batch=2, eval_seq=64, eval_seed=1234):
        self.cfg = cfg
        self.flat = dict(_flatten_paths(params))
        self.stats = stats
        self.qleaves: Dict[str, Dict[str, Any]] = {}   # variant -> path -> leaf
        self.paths: List[str] = []
        calib = None
        for v in [c for c in candidates if c != "none"]:
            pol = P.pure(v)
            if calib is None:
                probe, report = quantize_params(params, pol)
                self.paths = sorted(p for p, var in report.items() if var)
                calib = (stats.for_paths(self.paths)
                         if stats is not None else {})
                qp = probe if v != "q3_k_o" or not calib else None
            else:
                qp = None
            if qp is None:
                qp, _ = quantize_params(params, pol, calib=calib)
            self.qleaves[v] = dict(_flatten_paths(qp))
        self.inputs, self.teacher = QY.teacher_logits_for(
            params, cfg, batch=eval_batch, seq=eval_seq, seed=eval_seed)
        self._cache: Dict[Tuple, Dict[str, float]] = {}

    def assemble(self, assignment: Dict[str, Optional[str]]):
        flat = dict(self.flat)
        for path, v in assignment.items():
            if v:
                flat[path] = self.qleaves[v][path]
        return _unflatten(flat)

    def evaluate(self, assignment: Dict[str, Optional[str]]):
        key = tuple(sorted(assignment.items()))
        if key in self._cache:
            return self._cache[key]
        tree = self.assemble(assignment)
        m = QY.quality_eval(None, tree, self.cfg, inputs=self.inputs,
                            teacher_logits=self.teacher)
        m["bytes"] = quantized_param_bytes(tree)["total"]
        self._cache[key] = m
        return m


def search_policy(cfg, params, *, arch: str = "model",
                  candidates=DEFAULT_CANDIDATES,
                  seed_policy: str = "default_serve_mix",
                  rounds: int = 6, stats: Optional[C.CalibStats] = None,
                  calib_batches: int = 2, calib_seq: int = 64,
                  eval_seq: int = 64, swap_budget: int = 12,
                  verbose: bool = True, device="cuda"):
    """Returns (QuantPolicy, info dict). ``info['meta']`` carries the
    seed/final metrics and the pure_q2_k / pure_q6_k anchors (only for
    anchor variants present in ``candidates``); ``info['stats']`` carries
    the :class:`~repro_torch.core.calibrate.CalibStats` the search used,
    so callers can quantize the returned policy with the same activation
    stats its verified evals saw; ``info['evaluations']`` counts the
    distinct assignments scored (one student forward each).

    Every forward runs on ``device`` (the parameters are moved there if
    they lie elsewhere); where no GPU is present the default raises."""
    log = print if verbose else (lambda *a, **k: None)
    params = to_device(params, resolve_device(device))
    if stats is None:
        t0 = time.time()
        stats = C.run_calibration(params, cfg, n_batches=calib_batches,
                                  seq=calib_seq)
        log(f"[calibrate] {stats.tokens} rows over {len(stats.names())} "
            f"tap sites in {time.time() - t0:.1f}s")
    s = _Searcher(cfg, params, candidates, stats, eval_seq=eval_seq)

    _, seed_report = quantize_params(params, P.get_policy(seed_policy))
    assignment = {p: _nearest_candidate(seed_report.get(p), s.qleaves)
                  for p in s.paths}
    cur = s.evaluate(assignment)
    kl0, bytes0 = cur["kl"], cur["bytes"]
    log(f"[seed {seed_policy}] kl={kl0:.4f} bytes={bytes0}")

    # metric-only anchors, computed only for anchor variants actually
    # searched (consumers treat an absent anchor as "not measured")
    anchors = {}
    for v in ("q2_k", "q6_k"):
        if v not in s.qleaves:
            continue
        m = s.evaluate({p: v for p in s.paths})
        anchors[f"pure_{v}"] = dict(kl=m["kl"], bytes=m["bytes"],
                                    pseudo_ppl=m["pseudo_ppl"])

    def score(m):
        return ((m["kl"] - kl0) / max(kl0, 1e-9)
                + (m["bytes"] - bytes0) / max(bytes0, 1))

    def dominates_seed(m):
        return m["kl"] <= kl0 * (1 + 1e-6) and m["bytes"] <= bytes0

    # incumbent: best verified assignment weakly dominating the seed on
    # both axes. The seed itself qualifies, so the returned policy can
    # never be worse than default_serve_mix.
    incumbent = (score(cur), dict(assignment), dict(cur))

    def consider(trial, m):
        nonlocal incumbent
        if dominates_seed(m) and score(m) < incumbent[0] - 1e-9:
            incumbent = (score(m), dict(trial), dict(m))

    # phase (a): probe each single-path move once; its byte delta is
    # exact (only that leaf changed) and its KL delta seeds the
    # first-order additive estimate the sweep optimizes over
    trajectory = [dict(round=0, kl=kl0, bytes=bytes0)]
    deltas: Dict[str, Dict[Optional[str], Tuple[float, int]]] = {}
    for path in s.paths:
        deltas[path] = {assignment[path]: (0.0, 0)}
        for v in candidates:
            vv = None if v == "none" else v
            if vv in deltas[path]:
                continue
            trial = dict(assignment, **{path: vv})
            m = s.evaluate(trial)
            consider(trial, m)
            deltas[path][vv] = (m["kl"] - kl0, m["bytes"] - bytes0)

    # phase (b): Lagrangian sweep -- per path pick
    # argmin(dKL + lam * dbytes); feasible totals get a true eval
    lams = [0.0] + [10.0 ** e / 4 ** f
                    for e in range(-9, -2) for f in range(2)]
    proposed = set()
    for lam in sorted(lams):
        trial = {}
        est_bytes = 0
        for path in s.paths:
            vv = min(deltas[path],
                     key=lambda c: (deltas[path][c][0]
                                    + lam * deltas[path][c][1]))
            trial[path] = vv
            est_bytes += deltas[path][vv][1]
        key = tuple(sorted(trial.items()))
        if est_bytes > 0 or key in proposed:
            continue
        proposed.add(key)
        m = s.evaluate(trial)
        consider(trial, m)
        log(f"[sweep lam={lam:.2e}] kl={m['kl']:.4f} bytes={m['bytes']}"
            f"{'  *' if dict(incumbent[1]) == trial else ''}")

    # phase (b'): explicit paired upgrade+downgrade swaps. First-order
    # additivity is roughest exactly where the sweep leans on it, so
    # directly verify the best-estimated byte-feasible pairs too.
    pairs = []
    for pu in s.paths:
        for vu, (ku, bu) in deltas[pu].items():
            if ku >= 0:
                continue                      # not a quality upgrade
            for pd in s.paths:
                if pd == pu:
                    continue
                for vd, (kd, bd) in deltas[pd].items():
                    if bd >= 0 or bu + bd > 0 or ku + kd >= 0:
                        continue              # pair infeasible on est.
                    pairs.append((ku + kd, pu, vu, pd, vd))
    pairs.sort(key=lambda t: t[0])
    for est, pu, vu, pd, vd in pairs[:swap_budget]:
        trial = dict(assignment, **{pu: vu, pd: vd})
        key = tuple(sorted(trial.items()))
        if key in proposed:
            continue
        proposed.add(key)
        m = s.evaluate(trial)
        consider(trial, m)
        log(f"[swap {pu}->{vu or 'none'} / {pd}->{vd or 'none'}] "
            f"kl={m['kl']:.4f} bytes={m['bytes']}"
            f"{'  *' if dict(incumbent[1]) == trial else ''}")

    # phase (c): greedy single-move hill-climb from the incumbent under
    # strict dominance of the seed
    for r in range(1, rounds + 1):
        _, assignment, cur = incumbent
        best = None
        for path in s.paths:
            for v in candidates:
                vv = None if v == "none" else v
                if vv == assignment[path]:
                    continue
                trial = dict(assignment, **{path: vv})
                m = s.evaluate(trial)
                consider(trial, m)
        if incumbent[2]["kl"] >= cur["kl"] - 1e-9 \
                and incumbent[2]["bytes"] >= cur["bytes"]:
            log(f"[refine {r}] no improving move; stopping")
            break
        trajectory.append(dict(round=r, kl=incumbent[2]["kl"],
                               bytes=incumbent[2]["bytes"]))
        log(f"[refine {r}] kl={incumbent[2]['kl']:.4f} "
            f"bytes={incumbent[2]['bytes']}")

    _, assignment, cur = incumbent
    log(f"[final] kl={cur['kl']:.4f} bytes={cur['bytes']} "
        f"(seed kl={kl0:.4f} bytes={bytes0})")
    policy = _exact_policy(f"auto_{arch}", assignment)
    info = dict(
        meta=dict(arch=arch, seed_policy=seed_policy,
                  calib_tokens=stats.tokens,
                  seed=dict(kl=kl0, bytes=bytes0),
                  final=dict(kl=cur["kl"], bytes=cur["bytes"],
                             pseudo_ppl=cur["pseudo_ppl"],
                             top1=cur["top1"]),
                  anchors=anchors,
                  outlier_fractions={n: stats.outlier_fraction(n)
                                     for n in stats.names()},
                  trajectory=trajectory),
        assignment={p: (v or "none") for p, v in sorted(assignment.items())},
        stats=stats, evaluations=len(s._cache))
    return policy, info


def save_searched_policy(path: str, policy: P.QuantPolicy, info: Dict):
    d = P.policy_to_dict(policy)
    d["meta"] = info["meta"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=2, sort_keys=True)
        f.write("\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", required=True,
                    help="searched-policy JSON output path")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed-policy", default="default_serve_mix")
    ap.add_argument("--candidates",
                    default=",".join(DEFAULT_CANDIDATES))
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--calib-seq", type=int, default=64)
    ap.add_argument("--eval-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import get_arch
    from repro_torch.models import transformer as T

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    params = T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    policy, info = search_policy(
        cfg, params, arch=args.arch,
        candidates=tuple(args.candidates.split(",")),
        seed_policy=args.seed_policy, rounds=args.rounds,
        calib_batches=args.calib_batches, calib_seq=args.calib_seq,
        eval_seq=args.eval_seq, device=dev)
    save_searched_policy(args.out, policy, info)
    meta = info["meta"]
    print(f"wrote {args.out}: kl {meta['seed']['kl']:.4f} -> "
          f"{meta['final']['kl']:.4f}, bytes {meta['seed']['bytes']} -> "
          f"{meta['final']['bytes']}")


if __name__ == "__main__":
    main()
