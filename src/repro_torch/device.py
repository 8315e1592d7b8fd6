"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. Where no GPU is present they
raise instead of carrying on on the CPU; a caller that wants the CPU (the
tests) passes ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def tree_device(tree) -> Optional[torch.device]:
    """The device of the first tensor in a parameter tree (dicts of
    tensors and packed QTensors): where a model with these weights runs."""
    if isinstance(tree, dict):
        for v in tree.values():
            dev = tree_device(v)
            if dev is not None:
                return dev
        return None
    if isinstance(tree, torch.Tensor):
        return tree.device
    data = getattr(tree, "data", None)      # a packed QTensor
    if isinstance(data, dict):
        return tree_device(data)
    return None
