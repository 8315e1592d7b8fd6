"""Dry run on the production mesh: one rank's real step for every
(arch x shape x mesh) cell, counted without allocating the model.

Counterpart of ``repro.launch.dryrun``. For each cell this builds the
real step (``training/steps.py``: ``make_train_step``, or the serve steps
of ``make_serve_steps`` with packed weights), and runs it as rank 0 of
the cell's mesh:

* a ``torch.distributed`` world of 256 (one pod, (16, 16)) or 512 (two
  pods, (2, 16, 16)) ranks on the ``fake`` backend, and a ``DeviceMesh``
  with the reference's axis names. Its collectives return at once;
* parameters, optimizer state, batch and cache as DTensors placed by the
  specs of ``distributed/sharding.py``, their shards fake tensors (a
  shape, no memory), all under ``FakeTensorMode``, inside
  ``activation_axes(mesh)`` and, where asked, ``tp_off()``;
* the plain datapath (``kernel_impl="torch"``, ``attn_impl="blockwise"``,
  ``remat`` for training): the counterpart of the reference's XLA
  datapath, which its dry run takes because Pallas cannot lower there.

``analysis.RankTracker`` counts the rank's local ops as DTensor issues
them: FLOPs, bytes, collective bytes, and live memory. Eager execution
counts every layer, so the reference's two-depth probes and their
extrapolation are not needed: the record says ``"probes": "full
depth"``, and ``--no-probes`` is accepted and does nothing. The
functions DTensor cannot lay out op by op (the attention cores, the MoE
block, the SSD scan, the packed matmul) run on each rank's shards
(``launch/partition.py``). Where DTensor refuses an op as it is laid
out, its operands are gathered over the fewest mesh dims that let it run
(each gather counted); an op that is wrong on the global shapes raises.

The record keeps the reference's keys (``status``, ``reason``,
``n_chips``, ``mesh``, ``memory``, ``roofline``, ``memory_model``,
``top_collectives``); ``lower_s`` and ``compile_s`` become ``trace_s``,
and ``fallbacks`` counts the ops DTensor could not shard as asked.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR

A decode cell takes seconds on the host's CPU, a train or prefill cell
minutes (the recurrent families' train cells half an hour or more:
their SSD scan runs a batch row at a time); nothing runs on a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,
                                      get_arch, input_specs,
                                      shape_applicable)
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import spec_like_quantized
from repro_torch.core.quantize import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.launch import analysis as AN
from repro_torch.launch import flops as FL
from repro_torch.launch.mesh import (make_production_mesh, parse_mesh,
                                     validate_mesh)
from repro_torch.launch.partition import partitioned
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import steps as S


def _tune_for_dryrun(cfg, shape):
    """The plain datapath; attention is the memory-bounded blockwise one."""
    kw = dict(kernel_impl="torch", attn_impl="blockwise")
    if shape.kind == "train":
        kw["remat"] = True
    return cfg.replace(**kw)


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(mesh):
    """A fake-backend world of ``mesh.size`` ranks, this process rank 0,
    and a ``DeviceMesh`` of ``mesh``'s shape and axis names on it; torn
    down on exit. Refuses to start while another process group is open
    (a tensor-parallel engine's, ``distributed/group.py``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this "
                           "process; close it before a dry run")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.sizes),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def _is_mask_partial(p) -> bool:
    return type(p).__name__.endswith("MaskPartial")


class _Propagate(torch.utils._python_dispatch.TorchDispatchMode):
    """DTensor ops of the step, seen before DTensor runs them:

    * an output left partial by a masked gather (an embedding or a label
      lookup on a vocab-sharded tensor) is reduced at once, as XLA
      reduces it; DTensor cannot carry such a placement through a view
      that drops the gathered dim;
    * an op that DTensor cannot shard runs with its operands gathered
      over the fewest trailing mesh dims that let it (an in-place write,
      on the local shards). Its rules differ between torch releases, so
      an op that no gather helps runs on whole tensors.

    Only DTensor's refusals are retried: an op that fails on plain meta
    tensors of its operands' global shapes too (a wrong shape, an index
    out of range) raises its error. ``fallbacks`` counts each retried op
    by kind."""

    def __init__(self, tracker):
        super().__init__()
        self.tracker = tracker
        self.fallbacks: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            out = func(*args, **kwargs)
        except (NotImplementedError, RuntimeError, IndexError) as e:
            if not _globally_valid(func, args, kwargs):
                raise
            out = self._relaxed(func, args, kwargs, e)
        if isinstance(out, DTensor) and any(map(_is_mask_partial,
                                                out.placements)):
            fixed = [Replicate() if _is_mask_partial(p) else p
                     for p in out.placements]
            out = out.redistribute(out.device_mesh, fixed)
        return out

    def _relaxed(self, func, args, kwargs, err):
        """``func`` with its operands replicated over the last mesh dim,
        then the last two, ...: the fewest gathers that let DTensor shard
        it (a view that would split a sharded dim unevenly gathers that
        dim only). Past the whole mesh, ``_replicated``."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map
        if func._schema.is_mutable:
            return self._local_inplace(func, args, kwargs)
        ndim = next(a.device_mesh.ndim for a in
                    torch.utils._pytree.tree_leaves((args, kwargs))
                    if isinstance(a, DTensor))
        for n in range(1, ndim + 1):
            def relax(a, n=n):
                if not isinstance(a, DTensor):
                    return a
                pl = [Replicate() if i >= ndim - n else p
                      for i, p in enumerate(a.placements)]
                return a.redistribute(a.device_mesh, pl)
            try:
                out = func(*tree_map(relax, args), **tree_map(relax, kwargs))
            except (NotImplementedError, RuntimeError, IndexError):
                continue
            name = f"{func} (gathered over {n} mesh dims)"
            self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
            return out
        return self._replicated(func, args, kwargs, err)

    def _local_inplace(self, func, args, kwargs):
        """An in-place write DTensor cannot place (the decode cache's slot
        writes, whose operands it would have to move): each rank writes
        its own shards, so the op runs on the local tensors."""
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_map
        name = f"{func} (local in-place)"
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        local = tree_map(lambda a: a.to_local() if isinstance(a, DTensor)
                         else a, (args, kwargs))
        func(*local[0], **local[1])
        return args[0]

    def _replicated(self, func, args, kwargs, err):
        """``func`` on whole tensors: each sharded or partial argument is
        gathered (counted as its all-gather or all-reduce), the output is
        replicated. The gathered copies are fresh fake tensors: DTensor's
        own redistribution may be what failed."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map
        name = str(func)
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1
        mesh = None

        def full(a):
            nonlocal mesh
            if not isinstance(a, DTensor):
                return a
            mesh = a.device_mesh
            if all(p.is_replicate() for p in a.placements):
                return a.to_local()
            g = torch.empty(a.shape, dtype=a.dtype)
            kind = ("all-reduce" if any(p.is_partial() for p in a.placements)
                    else "all-gather")
            self.tracker.collective(kind, g)
            return g
        out = func(*tree_map(full, args), **tree_map(full, kwargs))
        rep = [Replicate()] * mesh.ndim
        return tree_map(lambda t: DTensor.from_local(
            t, mesh, rep, run_check=False) if isinstance(
                t, torch.Tensor) else t, out)


def _globally_valid(func, args, kwargs) -> bool:
    """Whether ``func`` runs on plain meta tensors of its operands' global
    shapes, strides and dtypes (outside every mode: nothing is counted)."""
    from torch.utils._pytree import tree_map
    from torch.utils._python_dispatch import _disable_current_modes

    def meta(a):
        if not isinstance(a, torch.Tensor):
            return a
        return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                   device="meta")
    with _disable_current_modes():
        try:
            func(*tree_map(meta, args), **tree_map(meta, kwargs))
        except (RuntimeError, IndexError, ValueError, TypeError,
                NotImplementedError):
            return False
    return True


def _distribute(tree, specs, mesh):
    """A tree of shape-only stand-ins -> DTensors on ``mesh`` (a
    ``DeviceMesh``) placed by ``specs``, their shards fake tensors of the
    rank's local shapes (call under the fake mode)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.variant, tree.shape,
                       {k: _distribute(v, specs.data[k], mesh)
                        for k, v in tree.data.items()})
    local = torch.empty(SH.local_shape(tree.shape, specs, mesh),
                        dtype=tree.dtype)
    stride = torch.empty(tree.shape, device="meta").stride()
    return DTensor.from_local(local, mesh, SH.named(specs, mesh),
                              run_check=False, shape=tree.shape,
                              stride=stride)


def _local_bytes(tree) -> int:
    """Bytes of the rank's shards of a tree, each storage once."""
    storages = {}
    for t in _leaves(tree):
        st = getattr(t, "_local_tensor", t).untyped_storage()
        storages[id(st)] = st
    return sum(st.nbytes() for st in storages.values())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, QTensor):
        yield from tree.data.values()
    elif isinstance(tree, torch.Tensor):
        yield tree


def _bf16(tree):
    """Every floating leaf as bf16, as the reference's serve cells take
    their parameters."""
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16) if tree.is_floating_point() else tree


def _meta_params(cfg, quantized: bool, quant_policy: str):
    params = _bf16(T.init_params(cfg, torch.Generator(), device="meta"))
    if quantized:
        params = spec_like_quantized(params, get_policy(quant_policy))
    return params


def cell_inputs(cfg, shape, mesh, *, quant_policy="default_serve_mix",
                kv_shard="auto", fsdp=True, microbatches=1,
                serve_quantized=True):
    """The cell's step and its arguments, as rank 0 of ``mesh`` (a
    ``DeviceMesh``) holds them: (step, args, alias bytes). Call it inside
    ``fake_world`` and a ``FakeTensorMode``, under the tp role the cell
    runs in."""
    specs = input_specs(cfg, shape)
    batch = _distribute(specs, SH.batch_specs(specs, mesh), mesh)
    if shape.kind == "train":
        opt = AdamWConfig()
        state = S.init_train_state(cfg, opt, torch.Generator(),
                                   device="meta")
        psp = SH.param_specs(state["params"], mesh, fsdp=fsdp)
        state = _distribute(state, dict(params=psp,
                                        opt=SH.opt_state_specs(psp),
                                        step=()), mesh)
        step = S.make_train_step(cfg, opt, microbatches=microbatches)
        return step, (state, batch), _local_bytes(state)
    params = _meta_params(cfg, serve_quantized, quant_policy)
    params = _distribute(params, SH.param_specs(params, mesh, fsdp=False),
                         mesh)
    prefill, decode = S.make_serve_steps(cfg)
    if shape.kind == "prefill":
        return prefill, (params, batch), 0
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device="meta")
    cache = _distribute(cache, SH.cache_specs(cache, mesh,
                                              kv_shard=kv_shard), mesh)
    return decode, (params, cache, batch), _local_bytes(cache)


def _run_cell(cfg, shape, mesh, **kw):
    """Run the cell's step as rank 0 of ``mesh`` (a ``DeviceMesh``, under
    the active tp role). Returns (tracker, argument bytes, output bytes,
    alias bytes, ops that DTensor could not shard as it was asked)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    with FakeTensorMode():
        fn, args, alias = cell_inputs(cfg, shape, mesh, **kw)
        argument = _local_bytes(args)
        tracker = AN.RankTracker()
        tracker.track(args)
        prop = _Propagate(tracker)
        grad = torch.enable_grad() if shape.kind == "train" \
            else torch.no_grad()
        with tracker, prop, SH.activation_axes(mesh), partitioned(), \
                implicit_replication(), grad:
            out = fn(*args)
        output = _local_bytes(out)
    return tracker, argument, output, alias, prop.fallbacks


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                quant_policy: str = "default_serve_mix",
                kv_shard: str = "auto", fsdp: bool = True,
                microbatches: int = 1,
                serve_quantized: bool = True,
                cost_probes: bool = True, tp: bool = True,
                mesh=None, config_override=None) -> Dict[str, Any]:
    """Run one cell; returns its record. ``shape_name`` names one of
    ``SHAPES`` or is a ``ShapeConfig`` of its own; ``mesh`` is a
    ``sharding.MeshShape`` (default: the production mesh);
    ``cost_probes`` is accepted for the reference's signature and does
    nothing (the step runs at full depth)."""
    del cost_probes
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    shape_name = shape.name
    cfg = _tune_for_dryrun(get_arch(arch), shape)
    if config_override:
        cfg = cfg.replace(**config_override)
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = dict(arch=arch, shape=shape_name,
                               multi_pod=multi_pod, kind=shape.kind,
                               kv_shard=kv_shard, fsdp=fsdp,
                               serve_quantized=serve_quantized)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    n_chips = mesh.size
    validate_mesh(mesh, shape.global_batch)
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if not tp:
            stack.enter_context(SH.tp_off())
        dmesh = stack.enter_context(fake_world(mesh))
        tracker, argument, output, alias, fallbacks = _run_cell(
            cfg, shape, dmesh, quant_policy=quant_policy,
            kv_shard=kv_shard, fsdp=fsdp, microbatches=microbatches,
            serve_quantized=serve_quantized)
    trace_s = time.time() - t0
    mem = AN.memory_stats(tracker, argument=argument, output=output,
                          alias=alias)
    roof = AN.roofline(tracker, n_chips,
                       model_flops=FL.model_flops(get_arch(arch), shape))
    model_par = mesh.shape.get("model", 1) if tp else 1
    mm = FL.memory_model(cfg, shape, n_chips=n_chips, model_par=model_par,
                         serve_quantized=serve_quantized,
                         policy_name=quant_policy,
                         kv_cache_bits=8 if cfg.kv_cache_quant else 16)
    roof.bytes_analytic_per_chip = mm["total"]
    rec["memory_model"] = {k: int(v) for k, v in mm.items()}
    rec.update(status="ok", n_chips=n_chips, mesh=dict(mesh.shape),
               probes="full depth", trace_s=round(trace_s, 2),
               link_domain_exceeded=model_par > AN.NVLINK_DOMAIN,
               memory=mem, roofline=roof.as_dict(),
               top_collectives=tracker.top_collectives(8),
               fallbacks=fallbacks)
    return rec


def print_record(rec: Dict[str, Any]) -> None:
    if rec["status"] == "skipped":
        print(f"[skip] {rec['arch']} x {rec['shape']}: {rec['reason']}")
        return
    r, m = rec["roofline"], rec["memory"]
    print(f"[ok] {rec['arch']} x {rec['shape']} "
          f"(multi_pod={rec['multi_pod']}, chips={rec['n_chips']})")
    print(f"     per-chip HBM: args {m['argument_size_in_bytes']/2**30:.2f} "
          f"GiB, temps {m['temp_size_in_bytes']/2**30:.2f} GiB, "
          f"out {m['output_size_in_bytes']/2**30:.2f} GiB, total "
          f"{m['total_hbm_bytes']/2**30:.2f} GiB")
    print(f"     roofline: compute {r['compute_s']*1e3:.2f} ms | memory "
          f"{r['memory_s']*1e3:.2f} ms (counted "
          f"{r.get('memory_s_hlo', 0)*1e3:.0f}) | collective "
          f"{r['collective_s']*1e3:.2f} ms -> {r['dominant']}-bound")
    print(f"     useful-flops ratio {r['useful_flops_fraction']:.3f}, "
          f"roofline MFU {r['mfu']:.3f} (trace {rec['trace_s']}s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--kv-shard", default="auto")
    ap.add_argument("--quant-policy", default="default_serve_mix")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted; the step always runs at full depth")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only-arch", default=None,
                    help="comma-separated arch filter for --all")
    ap.add_argument("--mesh", default=None,
                    help="a smaller mesh of the production shape, as 4x4 "
                         "or 2x2x4 (replaces --multi-pod/--both-meshes)")
    args = ap.parse_args(argv)

    if args.all:
        archs = (args.only_arch.split(",") if args.only_arch
                 else ARCH_IDS[:10])
        cells = [(a, s) for a in archs for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    small = parse_mesh(args.mesh) if args.mesh else None
    if small is not None:
        meshes = [len(small.sizes) == 3]

    records = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = dryrun_cell(
                    arch, shape, multi_pod=mp, kv_shard=args.kv_shard,
                    quant_policy=args.quant_policy,
                    serve_quantized=not args.no_quant,
                    fsdp=not args.no_fsdp,
                    microbatches=args.microbatches, mesh=small)
            except Exception as e:  # a failure here is a bug in the port
                rec = dict(arch=arch, shape=shape, multi_pod=mp,
                           status="error", error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-2000:])
            if rec["status"] == "error":
                print(f"[ERROR] {arch} x {shape}: {rec['error']}")
            else:
                print_record(rec)
            records.append(rec)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                tag = "multi" if mp else "single"
                path = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors ==")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
