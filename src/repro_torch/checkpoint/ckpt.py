"""Fault-tolerant checkpointing: atomic, step-tagged, async, auto-resume.

Counterpart of ``repro.checkpoint.ckpt``, with its layout:
``<dir>/step_<N>/process_<rank>.npz`` + ``MANIFEST`` (written last -- a
checkpoint without MANIFEST is torn and ignored). Writes go to
``step_<N>.tmp`` and are renamed into place, so a preemption mid-save
never corrupts the newest valid checkpoint; ``keep`` bounds how many
stay. ``save_async`` copies the tree to host numpy on the calling thread
(as the reference does before its next step), then writes it on a
background thread; ``wait()`` joins that thread. ``restore_latest`` finds
the newest valid step: the restart path after a failure.

The npz keys are the tree's paths joined by ``\\x1d`` in sorted key order,
as the reference's, so an f32 train state written by either package
restores in the other. numpy has no bfloat16 (bf16 moments,
``AdamWConfig.moment_dtype``): a bf16 leaf is stored as a 2-byte void
array (``|V2``) of its bits, which is what ``np.savez`` makes of the
reference's own ml_dtypes bfloat16 leaves, and ``restore`` reads every
2-byte void leaf back as bf16. ``restore`` returns a tree of tensors on
the device asked for. The rank and the process count come from
``torch.distributed`` where it is initialized (0 and 1 otherwise). As in
the reference, processes do not coordinate: each renames its own
``step_<N>.tmp`` over ``step_<N>``, so several processes need a
directory each (a host's local disk), not one shared directory.
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import processes

_SEP = "\x1d"


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array that shares no memory with it."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.kind == "V" and a.itemsize == 2:     # bf16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[:-1]] = _host(tree)
    return out


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def _write(self, step: int, flat: Dict[str, np.ndarray]):
        rank, nproc = processes()
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"process_{rank}.npz"), **flat)
        with open(os.path.join(tmp, "MANIFEST"), "w") as f:
            f.write(f"step={step}\nprocesses={nproc}\n"
                    f"time={time.time()}\n")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def save(self, step: int, tree) -> None:
        self.wait()
        self._write(step, _flatten(tree))

    def save_async(self, step: int, tree) -> None:
        self.wait()
        flat = _flatten(tree)           # the host copy, on this thread
        self._thread = threading.Thread(target=self._write,
                                        args=(step, flat), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        steps = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "MANIFEST"))):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def restore(self, step: int, device="cpu"):
        rank, _ = processes()
        path = os.path.join(self.dir, f"step_{step}", f"process_{rank}.npz")
        with np.load(path) as z:
            flat = {k: _tensor(z[k], device) for k in z.files}
        return _unflatten(flat)

    def restore_latest(self, device="cpu") -> Tuple[Optional[int],
                                                     Optional[Any]]:
        steps = self.all_steps()
        if not steps:
            return None, None
        return steps[-1], self.restore(steps[-1], device)
