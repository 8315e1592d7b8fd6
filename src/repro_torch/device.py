"""Device selection for the port's entry points.

Entry points default to ``device="cuda"``. Where no GPU is present they
raise instead of carrying on on the CPU; a caller that wants the CPU (the
tests) passes ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
