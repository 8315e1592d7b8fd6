"""Tensor-parallel serving groups: one process a rank, one controller.

Counterpart of the reference's ("model",) device mesh, which JAX builds
in the engine's own process and which needs no module there. Here each
shard is a process of its own, joined to the others by one
``torch.distributed`` group:

* rank 0 is the caller's process (the ``Engine``, the only scheduler);
  ``TPGroup(size, devices)`` starts ranks 1..size-1 with
  ``torch.multiprocessing`` (spawn) and joins them through a
  ``FileStore`` in a fresh temporary directory (no TCP port to pick);
* rank 0 drives the workers over a pipe each: it ships a weight shard
  set (``put_shards``: each worker gets its own local shard of the
  weights, which ``torch.multiprocessing`` passes by CUDA IPC or shared
  host memory, not by copying, and keeps it under the set's id), opens
  engines on a set (``open_engine``: the config, the plan and the set's
  id; any number of engines share one set, so a rank holds one copy of
  the weights however many engines it serves) and then ships every
  device program of an engine as its name and host arguments (``call``);
  every rank runs the same body on its own shard, and the collectives
  inside the model code keep them in step. The outputs a host reads are
  replicated by those collectives, so every rank makes the same control
  decisions and rank 0 reads its own copy. Engines on one group run
  their programs in the order rank 0 issues them: one scheduler thread
  drives them all (``serving/disagg.py`` opens both of its tiers on one
  group);
* ``map`` runs any module-level function on every rank under the plan
  and returns every rank's result (the tests and the smoke run hold
  single layers and kernels at their TP shapes through it).

The backend follows a rule, fixed before ``init_process_group``: NCCL
where every rank has a card of its own, gloo otherwise (the CPU, or
ranks that share one card). gloo takes CUDA tensors for broadcast and
all-reduce only, so on gloo every collective here stages its CUDA
operand through host memory, explicitly, and copies the result back.

Every rendezvous and collective has the group's timeout, and joins have
one too. A worker exits when rank 0 closes the group, when its pipe
closes (rank 0 died) or when a program raises in it; rank 0 then fails
at its next collective or call, never falls back.

One group lives in a process at a time: it is the process's default
``torch.distributed`` group (``dist.batch_isend_irecv``, the ring
matmul's ``ppermute``, takes no other).
"""
from __future__ import annotations

import datetime
import gc
import os
import shutil
import sys
import tempfile
import traceback
from multiprocessing.reduction import ForkingPickler
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.core.quantize import QTensor
from repro_torch.distributed import sharding as SH

DEFAULT_TIMEOUT_S = 300.0


def rank_devices(device: Union[str, torch.device, Sequence], size: int
                 ) -> List[torch.device]:
    """The device of each of ``size`` ranks. ``"cpu"``: every rank on the
    CPU. ``"cuda"`` (no index): rank r on ``cuda:r``, which needs ``size``
    cards. A list names each rank's device (``["cuda:0"] * 4`` puts four
    ranks on one card)."""
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if len(devs) != size:
            raise ValueError(f"tp={size} needs one device a rank, got "
                             f"{len(devs)}: {devs}")
    else:
        dev = torch.device(device)
        if dev.type == "cpu":
            devs = [dev] * size
        elif dev.type == "cuda":
            if dev.index is not None and size > 1:
                raise ValueError(
                    f"device {dev} names one card for tp={size}; pass "
                    "'cuda' (rank r on cuda:r) or a list of devices, one a "
                    "rank")
            devs = [torch.device("cuda", r) for r in range(size)]
        else:
            raise ValueError(f"unsupported device {dev}")
    for d in devs:
        if d.type == "cuda":
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if (d.index or 0) >= n:
                raise ValueError(
                    f"tp={size} needs the devices {[str(x) for x in devs]} "
                    f"but torch sees {n} CUDA device(s); put ranks on one "
                    "card with a list such as ['cuda:0'] * tp, or serve on "
                    "the CPU")
        elif d.type != "cpu":
            raise ValueError(f"unsupported device {d}")
    return devs


def choose_backend(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    cuda = [d for d in devices if d.type == "cuda"]
    if len(cuda) == len(devices) and len({d.index for d in cuda}) == len(cuda):
        return "nccl"
    return "gloo"


def tree_to(tree, device: torch.device):
    """A parameter tree (dicts of tensors and QTensors) on ``device``;
    leaves already there are kept as they are (views stay views)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.variant, tree.shape,
                       {k: tree_to(v, device) for k, v in tree.data.items()})
    return tree if tree.device == device else tree.to(device)


def tree_storages(tree) -> List[int]:
    """The sorted distinct storage addresses of a parameter tree's
    tensors (two trees that share their weights give the same list)."""
    out = set()

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, QTensor):
            walk(node.data)
        elif isinstance(node, torch.Tensor):
            out.add(node.untyped_storage().data_ptr())
    walk(tree)
    return sorted(out)


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """The bytes of ``x`` as a uint8 tensor (its last dim times the item
    size): the data-movement collectives send bytes, which every backend
    takes whatever the dtype (gloo has no int16 and, in some versions, no
    bfloat16)."""
    x = x.contiguous()
    if x.dim() == 0:
        x = x.reshape(1)
    return x.view(torch.uint8)


class TPGroup:
    """A process group of ``size`` ranks on ``devices`` (one a rank).

    Built in the controller it is rank 0 and starts the workers; the
    workers build their own (``_join``). The collectives are the ones the
    model code calls on every rank: ``all_gather`` (tiled, along a dim),
    ``all_reduce`` (sum) and ``ring_shift`` (send to the next rank,
    receive from the previous one). ``counts`` and ``wire_bytes`` record
    what this rank sent through them; ``pipe_bytes`` the pickled bytes
    rank 0 wrote to the workers' pipes (tensors cross by CUDA IPC or
    shared memory and add only their handles)."""

    def __init__(self, size: int, devices, *,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if size < 2:
            raise ValueError(f"a TP group needs >= 2 ranks, got {size}")
        if dist.is_initialized():
            raise RuntimeError(
                "this process already has a torch.distributed group (a TP "
                "group still open?); close it first: one group a process")
        devices = rank_devices(devices, size)
        self.size, self.rank, self.devices = size, 0, devices
        self.backend = choose_backend(devices)
        self.timeout_s = float(timeout_s)
        self._dir = tempfile.mkdtemp(prefix="tp-group-")
        store = os.path.join(self._dir, "store")
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        self._next_eid = self._next_sid = 0
        self._shard_sets: Dict[int, Any] = {}
        self.closed = False
        try:
            for r in range(1, size):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_worker_main, daemon=True, name=f"tp-rank{r}",
                    args=(r, size, store, self.backend,
                          [str(d) for d in devices], self.timeout_s, child))
                p.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(p)
            self._init(store)
        except BaseException:
            self.abort()
            raise
        self._reset_counts()

    @classmethod
    def _join(cls, rank, size, store, backend, devices, timeout_s):
        g = cls.__new__(cls)
        g.size, g.rank = size, rank
        g.devices = [torch.device(d) for d in devices]
        g.backend, g.timeout_s = backend, float(timeout_s)
        g._dir, g._conns, g._procs, g.closed = None, [], [], False
        g._shard_sets = {}
        g._init(store)
        g._reset_counts()
        return g

    def _init(self, store_path: str) -> None:
        dev = self.devices[self.rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, self.size)
        dist.init_process_group(
            self.backend, store=store, rank=self.rank, world_size=self.size,
            timeout=datetime.timedelta(seconds=self.timeout_s))

    def _reset_counts(self) -> None:
        self.counts = {"all_gather": 0, "all_reduce": 0, "ring_shift": 0}
        self.wire_bytes = 0
        self.pipe_bytes = 0

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def describe(self) -> str:
        how = ("one card a rank" if self.backend == "nccl" else
               "CPU ranks" if self.device.type == "cpu" else
               "ranks share a card: CUDA operands staged through host "
               "memory")
        return (f"tp={self.size} on {', '.join(map(str, self.devices))}: "
                f"backend {self.backend} ({how})")

    # -- collectives (every rank calls them in the same order) ------------
    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The operand as the backend takes it: gloo gets a host copy of a
        CUDA tensor."""
        if self.backend == "gloo" and t.is_cuda:
            return t.detach().cpu()
        return t.detach()

    def _note(self, what: str, x: torch.Tensor) -> None:
        self.counts[what] += 1
        self.wire_bytes += x.numel() * x.element_size()

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (a
        tiled all-gather: pure data movement)."""
        x = _to_wire(self._stage(t))
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        self._note("all_gather", x)
        out = torch.cat([p.view(t.dtype).reshape(t.shape) for p in parts],
                        dim=dim)
        return out.to(t.device)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor)."""
        x = self._stage(t).clone().contiguous()
        dist.all_reduce(x)
        self._note("all_reduce", x)
        return x.to(t.device)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` one hop around the ring (rank r to r + 1) and return
        the tensor that arrives from rank r - 1: ``ppermute`` with the
        permutation (s, s + 1 mod size), by ``dist.batch_isend_irecv``."""
        x = _to_wire(self._stage(t))
        buf = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (self.rank + 1) % self.size),
               dist.P2POp(dist.irecv, buf, (self.rank - 1) % self.size)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        self._note("ring_shift", x)
        return buf.view(t.dtype).reshape(t.shape).to(t.device)

    # -- control (rank 0) ----------------------------------------------------
    def _check_alive(self) -> None:
        if self.closed:
            raise RuntimeError("the TP group is closed")
        for r, p in enumerate(self._procs, start=1):
            if not p.is_alive():
                code = p.exitcode
                self.abort()
                raise RuntimeError(f"TP rank {r} exited (code {code}); the "
                                   "group is closed")

    def _send_all(self, msgs) -> None:
        """One message a worker, each pickled on its own (a tensor's
        shared-memory handle is taken once, by one receiver)."""
        self._check_alive()
        try:
            for conn, msg in zip(self._conns, msgs):
                data = ForkingPickler.dumps(msg)
                conn.send_bytes(data)
                self.pipe_bytes += len(data)
        except (BrokenPipeError, EOFError, OSError) as e:
            self.abort()
            raise RuntimeError(f"lost a TP worker: {e}") from e

    def put_shards(self, params, plan: SH.ServeTPPlan) -> int:
        """Make one weight shard set: every rank's local views of
        ``params`` under ``plan`` (``sharding.localize_serve_params``),
        moved to the rank's device (no copy where ``params`` already lie
        there), each worker sent its own. Returns the set's id, which
        ``open_engine`` takes; rank 0 keeps every rank's shard alive (the
        workers map them by CUDA IPC or shared memory)."""
        specs = SH.serve_param_specs(params, plan)
        shards = [tree_to(SH.localize_serve_params(params, specs, self.size,
                                                   r), self.devices[r])
                  for r in range(self.size)]
        sid = self._next_sid
        self._next_sid += 1
        self._send_all([("shards", sid, shards[r])
                        for r in range(1, self.size)])
        self._shard_sets[sid] = (plan, shards)
        return sid

    def local_shards(self, sid: int):
        """Rank 0's tree of shard set ``sid``."""
        return self._shard_sets[sid][1][0]

    def drop_shards(self, sid: int) -> None:
        """Forget shard set ``sid`` on every rank (its engines first)."""
        self._shard_sets.pop(sid, None)
        if not self.closed:
            self._send_all([("drop_shards", sid)] * (self.size - 1))

    def open_engine(self, cfg, scfg, plan, sid: int) -> int:
        """Build a mirror of an engine on every worker, on the weights of
        shard set ``sid`` (made under the same plan). Returns the
        engine's id."""
        if sid not in self._shard_sets:
            raise ValueError(f"no shard set {sid} on this group")
        if self._shard_sets[sid][0] != plan:
            raise ValueError(f"shard set {sid} was made under "
                             f"{self._shard_sets[sid][0]}, not {plan}")
        eid = self._next_eid
        self._next_eid += 1
        self._send_all([("engine", eid, cfg, scfg, plan, sid)]
                       * (self.size - 1))
        return eid

    def call(self, eid: int, name: str, args: tuple, host: dict) -> None:
        """Ship one device program of engine ``eid`` to the workers: its
        name, its host arguments and rank 0's host state (``host``: the
        sampling draw counter), which each mirror takes before it runs."""
        msg = ("call", eid, name, args, host)
        self._send_all([msg] * (self.size - 1))

    def drop_engine(self, eid: int) -> None:
        if not self.closed:
            self._send_all([("drop", eid)] * (self.size - 1))

    def map(self, fn, per_rank_args: Sequence[tuple],
            plan: Optional[SH.ServeTPPlan] = None) -> List[Any]:
        """Run ``fn(*per_rank_args[r])`` on every rank r under ``plan``
        (default: a plan of this group's size that shards nothing) and
        return every rank's result. ``fn`` must be importable by name
        (a module-level function); results come back by pickle, so keep
        them small or on the CPU."""
        if len(per_rank_args) != self.size:
            raise ValueError(f"need {self.size} argument tuples")
        plan = plan or SH.ServeTPPlan(size=self.size)
        self._send_all([("map", fn, tuple(per_rank_args[r]), plan)
                        for r in range(1, self.size)])
        try:
            with SH.serve_tp(plan, 0, self):
                out = [fn(*per_rank_args[0])]
        except BaseException:
            self.abort()
            raise
        for r, conn in enumerate(self._conns, start=1):
            if not conn.poll(self.timeout_s):
                self.abort()
                raise RuntimeError(f"TP rank {r} gave no result in "
                                   f"{self.timeout_s:.0f}s")
            status, val = conn.recv()
            if status != "ok":
                self.abort()
                raise RuntimeError(f"TP rank {r} raised:\n{val}")
            out.append(val)
        return out

    def close(self) -> None:
        """Stop the workers (they leave the group and exit) and leave the
        group; joins wait at most the group's timeout."""
        if self.closed:
            return
        for conn in self._conns:
            try:
                conn.send(("close",))
            except (BrokenPipeError, EOFError, OSError):
                pass
        for p in self._procs:
            p.join(self.timeout_s)
        self._finish()

    def abort(self) -> None:
        """Kill the workers and leave the group, whatever state it is in
        (a rank that failed inside a program leaves the others waiting in
        a collective)."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(self.timeout_s)
        self._finish()

    def _finish(self) -> None:
        self.closed = True
        self._shard_sets.clear()
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(self.timeout_s)
        for conn in self._conns:
            conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class GroupCache:
    """At most one open ``TPGroup`` at a time (a process has one), reopened
    when another size is asked for: engines and ``map`` calls of one size
    in a row share its workers instead of starting their own. ``devices``
    gives each size's rank devices."""

    def __init__(self, devices, timeout_s: float = DEFAULT_TIMEOUT_S):
        self._devices, self.timeout_s = devices, timeout_s
        self.group: Optional[TPGroup] = None

    def get(self, size: int) -> TPGroup:
        if self.group is not None and (self.group.closed
                                       or self.group.size != size):
            self.close()
        if self.group is None:
            self.group = TPGroup(size, self._devices(size),
                                 timeout_s=self.timeout_s)
        return self.group

    def close(self) -> None:
        if self.group is not None:
            self.group.close()
            self.group = None


def imported_top_modules() -> List[str]:
    """The top-level packages this process has imported (the isolation
    test reads a worker's: no ``jax``, no ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules})


# a worker's engine mirrors and weight shard sets, by id
_MIRRORS: Dict[int, Any] = {}
_SHARDS: Dict[int, Any] = {}


def engine_weight_storages() -> Dict[int, List[int]]:
    """For each engine mirror in this worker, by engine id, the storages
    its weights live in (``tree_storages``): engines opened on one shard
    set list the same ones. Run it on every rank with ``TPGroup.map``;
    rank 0 holds no mirror and gives {}."""
    return {eid: tree_storages(m.params) for eid, m in _MIRRORS.items()}


def _worker_main(rank, size, store, backend, devices, timeout_s, conn):
    """A worker rank: join the group, then run what rank 0 sends until it
    closes the group or its pipe closes."""
    torch.set_num_threads(1)
    group = TPGroup._join(rank, size, store, backend, devices, timeout_s)
    device = group.device
    code = 0
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break                       # rank 0 is gone
            kind = msg[0]
            if kind == "close":
                break
            if kind == "shards":
                _SHARDS[msg[1]] = msg[2]
            elif kind == "engine":
                from repro_torch.serving.engine import Engine
                _, eid, cfg, scfg, plan, sid = msg
                _MIRRORS[eid] = Engine._mirror(cfg, _SHARDS[sid], scfg,
                                               device, plan, rank, group)
            elif kind == "call":
                _, eid, name, args, host = msg
                _MIRRORS[eid]._run_mirrored(name, args, host)
            elif kind == "drop":
                _MIRRORS.pop(msg[1], None)
            elif kind == "drop_shards":
                _SHARDS.pop(msg[1], None)
            elif kind == "map":
                _, fn, args, plan = msg
                try:
                    with SH.serve_tp(plan, rank, group):
                        conn.send(("ok", fn(*args)))
                except BaseException:
                    conn.send(("err", traceback.format_exc()))
                    raise
            else:
                raise RuntimeError(f"unknown TP message {kind!r}")
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        code = 1
    if code:
        os._exit(code)          # the group may be mid-collective: no
                                # orderly teardown
    _MIRRORS.clear()
    _SHARDS.clear()
    gc.collect()                # release the shared CUDA tensors rank 0
                                # counts before it may exit
    dist.destroy_process_group()
    conn.close()
