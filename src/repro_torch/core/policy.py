"""Per-tensor mixed-quantization policies (the paper's Fig. 1 motivation).

Counterpart of ``repro.core.policy``. A ``QuantPolicy`` is an ordered
list of (glob-ish pattern -> variant) rules applied to parameter paths
(e.g. ``layers/attn/wv``); first match wins. The presets are the
reference's, copied as data.

``paper_llama_mix`` on the dense llama family gives the paper's Table III
layout: Q2_K on ``wk``, ``wv`` and ``lm_head`` (2*L + 1 MatMuls) and Q3_K
on the other five projections (5*L). Its ``*embed*`` rule matches no
parameter path of this family (the embedding is ``wte``, which
``qlinear`` never quantizes), so the embedding stays float.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core import formats as F

# tensors smaller than this along K (or 1-D tensors) stay unquantized,
# mirroring llama.cpp (norm weights / biases / tiny projections stay f32)
MIN_QUANT_K = 256
MIN_QUANT_N = 32


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    name: str
    rules: Tuple[Tuple[str, str], ...]   # (pattern, variant|"none")
    default: str = "q3_k"

    def variant_for(self, path: str, K: int, N: int) -> Optional[str]:
        """Variant for parameter at `path` with logical shape (K, N); None
        means keep unquantized (small or ragged K never raises)."""
        if K < MIN_QUANT_K or K % 32 != 0:
            return None
        if N < MIN_QUANT_N:
            return None
        chosen = self.default
        for pat, variant in self.rules:
            if fnmatch.fnmatch(path, pat):
                chosen = variant
                break
        if chosen == "none":
            return None
        return F.pick_fallback(chosen, K)


def make_policy(name: str, rules: Sequence[Tuple[str, str]],
                default: str = "q3_k") -> QuantPolicy:
    return QuantPolicy(name, tuple(rules), default)


def pure(variant: str) -> QuantPolicy:
    """Everything at one variant (embeddings/head included)."""
    return QuantPolicy(f"pure_{variant}", (), default=variant)


PAPER_LLAMA_MIX = make_policy("paper_llama_mix", (
    ("*attn/wk", "q2_k"),
    ("*attn/wv", "q2_k"),
    ("*lm_head*", "q2_k"),
    ("*embed*", "q2_k"),
), default="q3_k")

PAPER_GPT2_MIX = make_policy("paper_gpt2_mix", (
    ("*attn/c_attn", "q2_k"),
    ("*mlp/c_fc", "q2_k"),
    ("*lm_head*", "q2_k"),
    ("*wte*", "q6_k"),
    ("*wpe*", "none"),
), default="q3_k")

DEFAULT_SERVE_MIX = make_policy("default_serve_mix", (
    ("*attn/wk", "q2_k"),
    ("*attn/wv", "q2_k"),
    ("*lm_head*", "q2_k"),
    ("*embed*", "q2_k"),
    ("*ssm/dt*", "none"),
    ("*ssm/A*", "none"),
    ("*ssm/D*", "none"),
    ("*conv*", "none"),
    ("*norm*", "none"),
), default="q3_k")

EXTENDED_MIX = make_policy("extended_mix", (
    ("*attn/wv", "q4_k"),
    ("*mlp/w_down", "q4_k"),
    ("*lm_head*", "q6_k"),
    ("*embed*", "q4_k"),
    ("*norm*", "none"),
), default="q3_k")

POLICIES = {
    p.name: p for p in (
        PAPER_LLAMA_MIX, PAPER_GPT2_MIX, DEFAULT_SERVE_MIX, EXTENDED_MIX,
        pure("q2_k"), pure("q3_k"), pure("q4_0"), pure("q4_k"),
        pure("q6_k"))
}


def get_policy(name: str) -> QuantPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; known: "
                       f"{sorted(POLICIES)}") from None


# --------------------------------------------------------------------------
# policy files (``launch/policy_search.py`` writes them; ``serve --policy
# auto`` loads them back). The schema is the reference's, so a file
# written by either package loads in the other to the same rules.
# --------------------------------------------------------------------------

def policy_to_dict(policy: QuantPolicy) -> dict:
    """JSON-ready form: {"name", "rules": [[pattern, variant], ...],
    "default"}. Searched policies use exact paths as patterns (fnmatch
    treats a glob with no metacharacters as an exact match), so the same
    schema covers hand-written and searched policies."""
    return {"name": policy.name,
            "rules": [list(r) for r in policy.rules],
            "default": policy.default}


def policy_from_dict(d: dict) -> QuantPolicy:
    rules = tuple((str(p), str(v)) for p, v in d.get("rules", ()))
    for _, v in rules:
        if v != "none" and v not in F.FORMATS:
            raise ValueError(f"unknown variant {v!r} in policy rules")
    default = str(d.get("default", "q3_k"))
    if default != "none" and default not in F.FORMATS:
        raise ValueError(f"unknown default variant {default!r}")
    return QuantPolicy(str(d.get("name", "searched")), rules, default)


def save_policy(policy: QuantPolicy, path) -> None:
    with open(path, "w") as f:
        json.dump(policy_to_dict(policy), f, indent=2, sort_keys=True)
        f.write("\n")


def load_policy(path) -> QuantPolicy:
    with open(path) as f:
        return policy_from_dict(json.load(f))


# --------------------------------------------------------------------------
# accounting (Fig. 1 / Table III): layers, parameters and bytes a variant
# --------------------------------------------------------------------------

def summarize(policy: QuantPolicy,
              matmuls: Sequence[Tuple[str, int, int]],
              extra_f16: Sequence[Tuple[str, int]] = ()) -> Dict[str, object]:
    """Given MatMul tensors [(path, K, N)] and non-matmul fp16 tensors
    [(path, numel)], return per-variant layer counts (``counts``, an
    unquantized MatMul under "f16"), parameter counts (``params``) and the
    total size in bytes, in this layout's bits (``size_bytes``) and in
    gguf's (``size_bytes_gguf``): an unquantized tensor counts 2 bytes a
    value. Pure arithmetic over the shapes, as the reference's; the
    inventory is the caller's (``benchmarks/shapes.py::model_matmuls``,
    whose MoE and mamba2 shapes are the reference's as they stand)."""
    counts: Dict[str, int] = {}
    params: Dict[str, int] = {}
    size_ours = 0.0
    size_gguf = 0.0
    for path, K, N in matmuls:
        v = policy.variant_for(path, K, N)
        key = v or "f16"
        counts[key] = counts.get(key, 0) + 1
        params[key] = params.get(key, 0) + K * N
        if v is None:
            size_ours += K * N * 2
            size_gguf += K * N * 2
        else:
            fmt = F.get_format(v)
            size_ours += K * N * fmt.bits_per_weight / 8.0
            size_gguf += K * N * fmt.bits_per_weight_gguf / 8.0
    for _, numel in extra_f16:
        size_ours += numel * 2
        size_gguf += numel * 2
    return dict(counts=counts, params=params,
                size_bytes=int(size_ours), size_bytes_gguf=int(size_gguf))
