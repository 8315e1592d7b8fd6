"""One rank's step, counted: FLOPs, bytes, collective bytes, memory, and
the roofline built on them.

Counterpart of ``repro.launch.analysis``. The rates are one card's: an
NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, 989 TFLOP/s dense
bf16 on the tensor cores, 3.35 TB/s of HBM3, and NVLink 4 at 450 GB/s a
direction. The link term assumes the "model" axis lies inside one
NVLink domain; a 16-wide axis spans two 8-GPU nodes, which the dry run's
record flags (``link_domain_exceeded``).

  compute term    = FLOPs_per_rank / PEAK_FLOPS
  memory term     = the analytic HBM bytes (``flops.memory_model``), or the
                    counted bytes, / HBM_BW
  collective term = collective result bytes per rank / LINK_BW

Where the reference parses XLA's HLO text (``shape_bytes``,
``collective_bytes``, ``hlo_collective_summary``), the port counts what
the rank's step issues: ``RankTracker`` is a dispatch mode that sees every
local op of the rank once DTensor has lowered it, and sums

* FLOPs of the matmul-like ops (``torch.utils.flop_counter``'s formulas)
  on the rank's local shapes, so replicated work counts on every rank,
  as XLA's per-device module counts it;
* bytes read and written by every op that is not a view, unfused, as the
  HLO count is fusion-blind;
* collective result bytes under the reference's kind names (all-gather,
  all-reduce, reduce-scatter, all-to-all, collective-permute). The CPU
  process group has no all-to-all and DTensor falls back to an
  all-gather and a chunk there; that call is counted as the all-to-all
  that was asked for, at its result's bytes;
* live memory: every local storage from its first op to its release, and
  the peak (``memory_stats``).

The reference's ``total_corrected`` (halving f32 collectives that XLA's
CPU backend promoted from bf16) has no counterpart: the port's
collectives run in the dtype the step asks for.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

# NVIDIA H100 80GB HBM3 (SXM5), 700 W power limit
PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s a direction, NVLink 4
NVLINK_DOMAIN = 8            # GPUs joined by NVLink in one node

# op-name fragments of c10d's functional collectives, by the reference's
# kind names
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("permute", "collective-permute"))


def _collective_kind(func) -> Optional[str]:
    ns = func.namespace
    if "c10d" not in ns and ns != "_dtensor":
        return None
    name = func._overloadpacket.__name__
    for frag, kind in _KIND_OF:
        if frag in name:
            return kind
    return None


def _in_frames(prefixes, depth: int) -> bool:
    """Whether one of the ``depth`` callers above this one is a function
    whose name starts with one of ``prefixes``."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name.startswith(prefixes):
            return True
        f = f.f_back
    return False


def _in_alltoall_fallback() -> bool:
    """Whether this collective is DTensor's all-gather standing in for an
    all-to-all on a CPU process group."""
    return _in_frames(("shard_dim_alltoall",), 20)


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, a packed
    QTensor's payloads included."""
    out = []
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(getattr(t, "data", None), dict):    # a QTensor
            out.extend(_tensors(t.data))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RankTracker(TorchDispatchMode):
    """Counts one rank's local ops (module note). Enter it inside the
    ``FakeTensorMode`` the step runs under; DTensor ops pass through to
    DTensor, whose local ops come back here."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, int] = {}
        self.coll_ops: List[Tuple[int, str, str]] = []
        self.live = 0
        self.peak = 0
        self._sizes = WeakIdKeyDictionary()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------
    def _release(self, n: int, _ref=None) -> None:
        self.live -= n

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live, each once,
        until the storage is freed."""
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            st = t.untyped_storage()
            if st in self._sizes:
                continue
            n = st.nbytes()
            self._sizes[st] = (n, weakref.ref(
                st, lambda r, n=n: self._release(n)))
            self.live += n
        self.peak = max(self.peak, self.live)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is torch.ops._c10d_functional.wait_tensor.default:
            return args[0]              # an in-place wait, no new buffer
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs each op once more on fake
        # tensors of the global shapes to learn the output's; that is not
        # the rank's work
        if _in_frames(("_propagate_tensor_meta",), 20):
            return out
        kind = _collective_kind(func)
        if kind is not None:
            b = sum(_nbytes(t) for t in _tensors(out))
            if kind == "all-gather" and _in_alltoall_fallback():
                kind = "all-to-all"     # counted at the chunk it returns
                b //= max(1, self._alltoall_group(args))
            self._count_collective(kind, b, _tensors(out))
        else:
            fn = _flop_formula(func)
            if fn is not None:
                self.flops += float(fn(*args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes += sum(_nbytes(t) for t in
                                  _tensors((args, kwargs)) + _tensors(out))
        if not func.is_view:
            self.track(out)
        return out

    def _count_collective(self, kind: str, b: int, outs) -> None:
        self.coll[kind] = self.coll.get(kind, 0) + b
        self.coll_ops.append((b, kind, f"{outs[0].dtype} "
                              f"{[tuple(t.shape) for t in outs]}"))

    def collective(self, kind: str, result: torch.Tensor,
                   track: bool = True) -> None:
        """Count a collective made outside DTensor, at its result buffer
        (a fake tensor of the rank's mode, tracked as live memory unless
        an op of the step made it)."""
        self._count_collective(kind, _nbytes(result), [result])
        if track:
            self.track(result)

    @staticmethod
    def _alltoall_group(args) -> int:
        """The group size of an all_gather_into_tensor call: its second
        argument."""
        return int(args[1]) if len(args) > 1 and isinstance(
            args[1], int) else 1

    def top_collectives(self, top: int = 8):
        return sorted(self.coll_ops, reverse=True)[:top]


_ACTIVE: List["RankTracker"] = []


def active_tracker() -> Optional["RankTracker"]:
    """The tracker of the dry run in progress, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def _flop_formula(func):
    from torch.utils.flop_counter import flop_registry
    return flop_registry.get(func._overloadpacket)


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float         # counted op bytes (unfused)
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, int]
    model_flops: float = 0.0      # analytic useful FLOPs (global)
    n_chips: int = 1
    bytes_analytic_per_chip: float = 0.0   # flops.memory_model

    @property
    def compute_s(self):
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self):
        """The analytic HBM model when there is one (the counted bytes
        know no fusion and overcount; kept as memory_s_hlo)."""
        b = self.bytes_analytic_per_chip or self.bytes_per_chip
        return b / HBM_BW

    @property
    def memory_s_hlo(self):
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_s(self):
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def dominant(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """The largest of the three terms (perfect overlap; the sum is the
        no-overlap bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        total = self.flops_per_chip * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        denom = self.step_time_s * PEAK_FLOPS * self.n_chips
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return dict(
            flops_per_chip=self.flops_per_chip,
            bytes_per_chip=self.bytes_per_chip,
            bytes_analytic_per_chip=self.bytes_analytic_per_chip,
            coll_bytes_per_chip=self.coll_bytes_per_chip,
            coll_breakdown=self.coll_breakdown,
            compute_s=self.compute_s, memory_s=self.memory_s,
            memory_s_hlo=self.memory_s_hlo,
            collective_s=self.collective_s, dominant=self.dominant,
            step_time_s=self.step_time_s, model_flops=self.model_flops,
            useful_flops_fraction=self.useful_flops_fraction,
            mfu=self.mfu, n_chips=self.n_chips)


def roofline(tracker: RankTracker, n_chips: int,
             model_flops: float = 0.0) -> Roofline:
    coll = dict(tracker.coll)
    coll["total"] = sum(tracker.coll.values())
    return Roofline(flops_per_chip=tracker.flops,
                    bytes_per_chip=tracker.bytes,
                    coll_bytes_per_chip=float(coll["total"]),
                    coll_breakdown=coll, model_flops=model_flops,
                    n_chips=n_chips)


def memory_stats(tracker: RankTracker, *, argument: int, output: int,
                 alias: int) -> Dict[str, int]:
    """The reference's keys: ``argument_size_in_bytes`` the rank's input
    shards, ``output_size_in_bytes`` its outputs, ``alias_size_in_bytes``
    the donated state or cache, ``temp_size_in_bytes`` the tracked peak
    above the arguments; ``total_hbm_bytes`` as the reference sums it."""
    out = dict(argument_size_in_bytes=int(argument),
               output_size_in_bytes=int(output),
               temp_size_in_bytes=int(max(0, tracker.peak - argument)),
               alias_size_in_bytes=int(alias),
               generated_code_size_in_bytes=0)
    out["total_hbm_bytes"] = (out["argument_size_in_bytes"]
                              + out["output_size_in_bytes"]
                              + out["temp_size_in_bytes"]
                              - out["alias_size_in_bytes"])
    return out
