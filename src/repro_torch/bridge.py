"""Move a reference parameter tree into the port.

``from_jax_params`` takes the reference's parameter tree with every array
already converted to numpy (``jax.tree.map(np.asarray, params)``) and
returns the same tree of torch tensors. A packed reference ``QTensor``
(any object with ``variant``, ``shape`` and ``data``) becomes the port's
``QTensor`` with its payloads moved byte for byte, with no repacking: a
stacked layer weight keeps its leading ``L`` axis on every payload, and
an MoE expert stack its E*K-packed logical shape ``(E*K, N)`` beside
it, as the port's ``quantize_params`` lays both out. The port never sees
JAX: numpy is the only thing the two packages share.

``torch.from_numpy`` rejects the ml_dtypes bfloat16 that JAX hands numpy,
so bf16 arrays move as a ``uint16`` view and are viewed back as bf16.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.quantize import QTensor


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # owned and writable: the port
                                            # updates caches in place
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(tree: Any, device="cpu") -> Any:
    """numpy reference tree (dicts, QTensor-like leaves, arrays) -> torch."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if all(hasattr(tree, a) for a in ("variant", "shape", "data")):
        return QTensor(str(tree.variant), tuple(int(s) for s in tree.shape),
                       {k: _tensor(v, device) for k, v in tree.data.items()})
    return _tensor(tree, device)
