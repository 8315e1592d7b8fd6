"""Serve-time parameter quantization: float params -> packed QTensors.

Counterpart of ``repro.core.qlinear``. ``quantize_params`` walks the
parameter tree, asks the ``QuantPolicy`` for each matmul weight's variant
and packs it. A stacked layer weight ``(L, K, N)`` becomes one QTensor
whose payloads keep the leading ``L`` axis, as the reference's ``vmap``
gives (reduced tinyllama ``wq``: ``QTensor(q3_k, (256, 256))`` with
``qs`` of shape ``(2, 64, 256)``). An MoE expert stack ``(L, E, K, N)``
packs along E*K, as the reference's: one QTensor of logical shape
``(E*K, N)`` whose payloads keep the leading ``L`` axis, so the expert
products dequantize each layer's stack at once (``models/moe.py``).
Either stack packs one layer at a time, so the packer's temporaries are
one layer's (mamba2-2.7b's ``in_proj`` stack is 6.9 GB in f32); the
packers work per (super-block, column), so the bytes are the whole
stack's.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import quantize as Q
from repro_torch.core.policy import QuantPolicy

# parameter-path fragments that are never quantized at serve time
_NEVER = ("ln", "norm", "wpe", "b_", "bias", "router", "conv", "A_log", "D",
          "dt_bias", "pos", "wte")
# the path fragment of the MoE expert stacks, packed along E*K
_EXPERT_STACK = "moe/w_"


def _is_quantizable_path(path: str) -> bool:
    parts = path.split("/")
    leaf = parts[-1]
    for frag in _NEVER:
        if leaf == frag or leaf.startswith(frag):
            return False
    if any(p.startswith("ln") or p == "norm" for p in parts[:-1]):
        return False
    return True


def _flatten_paths(tree, prefix="") -> List[Tuple[str, Any]]:
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten_paths(tree[k], f"{prefix}{k}/"))
    else:
        out.append((prefix[:-1], tree))
    return out


def quantize_params(params: Dict[str, Any], policy: QuantPolicy,
                    calib: Optional[Dict[str, Any]] = None
                    ) -> Tuple[Dict[str, Any], Dict[str, Optional[str]]]:
    """Returns (qparams, report). report: path -> variant|None. Packing
    runs on the device the weights lie on.

    ``calib`` optionally maps parameter path -> per-K-column activation
    abs-max (``core.calibrate``); a path packed as q3_k_o picks its
    sidecar rows with it, tiled to K (to E*K for an expert stack) and
    shared by the stacked layers, as the reference does. The policy picks
    an expert stack's variant from one expert's (K, N), as the
    reference's."""
    report: Dict[str, Optional[str]] = {}

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        path = prefix[:-1]
        if node.dim() < 2 or not _is_quantizable_path(path):
            report[path] = None
            return node
        K, N = node.shape[-2], node.shape[-1]
        variant = policy.variant_for(path, K, N)
        report[path] = variant
        if variant is None:
            return node
        expert = _EXPERT_STACK in path and node.dim() >= 3
        keff = node.shape[-3] * K if expert else K
        qfn = Q.quantize_fn(variant)
        stats = calib.get(path) if calib is not None else None
        if variant == "q3_k_o" and stats is not None:
            a = torch.as_tensor(stats, dtype=torch.float32).reshape(-1)
            if keff % a.numel() == 0:
                a = a.repeat(keff // a.numel()).to(node.device)
                qfn = functools.partial(Q.quantize_q3_k_o, act_absmax=a)
        if node.dim() >= 3:
            return _pack_stack(qfn, node, expert)
        return qfn(node)

    return walk(params), report


def _pack_stack(qfn, w: torch.Tensor, expert: bool) -> Q.QTensor:
    """(..., K, N), or an expert stack (..., E, K, N), -> one QTensor of
    logical shape (K, N), (E*K, N) for the experts, its payloads keeping
    the leading axes. Packed one leading index (layer) at a time, so the
    temporaries are one layer's: the packers work per (super-block,
    column), and the bytes equal packing the whole stack."""
    *lead, K, N = w.shape
    if expert:
        *lead, E = lead
        K *= E
    flat = w.reshape(-1, K, N)
    layers = [qfn(flat[i]) for i in range(flat.shape[0])]
    data = {k: torch.stack([t.data[k] for t in layers]).reshape(
        *lead, *layers[0].data[k].shape) for k in layers[0].data}
    return Q.QTensor(layers[0].variant, (K, N), data)


def quantized_param_bytes(qparams) -> Dict[str, int]:
    """Device footprint by leaf kind (packed vs residual float)."""
    packed = unpacked = 0
    for _, leaf in _flatten_paths(qparams):
        if isinstance(leaf, Q.QTensor):
            packed += leaf.nbytes
        else:
            unpacked += leaf.numel() * leaf.element_size()
    return dict(packed=packed, unpacked=unpacked, total=packed + unpacked)


def variant_counts(report: Dict[str, Optional[str]], qparams) -> Dict[str, int]:
    """MatMul layers per variant, counting each stacked layer (the paper's
    Table III count: tinyllama under paper_llama_mix is 45 q2_k + 110 q3_k)."""
    counts: Dict[str, int] = {}
    leaves = dict(_flatten_paths(qparams))
    for path, v in report.items():
        if v is not None:
            counts[v] = counts.get(v, 0) + leaves[path].num_layers
    return counts


def to_device(tree, device: torch.device):
    """Move a (possibly quantized) parameter tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
