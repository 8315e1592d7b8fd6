"""The dry run's per-rank partitioning: the model functions that DTensor
cannot lay out op by op, run on each rank's shards.

``launch/dryrun.py`` runs a cell's real step on DTensors. Most of it
DTensor shards op by op, anchored by the model code's ``constrain`` and
``gather_dp`` calls (``distributed/sharding.py``). Four functions it
cannot shard that way, because their layout is a property of the whole
function: the attention cores, the MoE block, the SSD chunk scan and the
packed matmul. An SPMD partitioner runs each on the rank's shards;
``partitioned()`` does the same for the length of a dry run, replacing
each module attribute with a wrapper that, given DTensors, runs the
function on the local shards and wraps the result back (given plain
tensors, it calls the function as it is):

* ``models.layers`` ``naive_attention``, ``blockwise_attention`` and
  ``decode_attention``: ``local_heads``;
* ``models.moe.moe_block``: ``local_moe``;
* ``models.mamba2._ssd_chunk_scan``: ``local_ssd``;
* ``kernels.ops.bfp_matmul_plain`` on a QTensor whose payloads are
  DTensors: ``local_matmul``.

The gathers that bring an operand to the layout a function needs are
DTensor redistributions, which ``analysis.RankTracker`` counts; a
collective that the local function stands for (the MoE aux loss's mean,
an expert-parallel output gather, a flash-decoding combine) is counted
at its result buffer. Outside ``partitioned()`` nothing here is used.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.distributed.sharding import (ServeTPPlan, gather_dp,
                                              serve_tp)
from repro_torch.launch.analysis import active_tracker


def _placement_dims(t) -> Dict[int, list]:
    """{tensor dim: [mesh dims sharding it]} of a DTensor."""
    out: Dict[int, list] = {}
    for i, p in enumerate(t.placements):
        if p.is_shard():
            out.setdefault(p.dim % t.dim(), []).append(i)
    return out


def _gathered(t, keep_dims=(), also=()):
    """``t``'s local tensor with every mesh dim that shards a dim outside
    ``keep_dims``, and the mesh dims ``also``, gathered (DTensor's
    all-gather, which the dry run's tracker counts); partial sums
    reduced. Returns (it, its placements); a plain tensor (made inside
    the step) is returned as it is."""
    if not isinstance(t, DTensor):
        return t, None
    pl = list(t.placements)
    for i, p in enumerate(pl):
        if (p.is_partial() or i in also
                or (p.is_shard() and p.dim % t.dim() not in keep_dims)):
            pl[i] = Replicate()
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return t.to_local(), pl


class _CountedGroup:
    """Stands in for a tensor-parallel group inside a dry run's rank: an
    all-gather returns the gathered shape (this rank's block, zeros for
    the others) and is counted by the dry run's tracker."""

    def __init__(self, size: int):
        self.size = size

    def all_gather(self, t, dim: int):
        pad = [0, 0] * (t.dim() - 1 - dim) + [0, t.shape[dim] * (self.size
                                                                - 1)]
        out = torch.nn.functional.pad(t, pad)
        tr = active_tracker()
        if tr is not None:
            tr.collective("all-gather", out, track=False)
        return out


def local_moe(block, x, p, cfg):
    """``block`` (``models.moe.moe_block``) under a dry run, on the rank's
    shards: its batch rows of ``x`` (replicated over "model"), the router
    whole, the expert stacks with their dp shards gathered (FSDP) and
    their "model" sharding kept. Expert-sharded stacks (EP) run through
    the serve-TP expert path, whose all-gather of the output buffers is
    counted; ffn-sharded stacks leave a partial sum over "model". A packed
    stack is gathered whole. Returns DTensors: the output with ``x``'s
    batch placement, the aux loss replicated (its mean over dp counted as
    an all-reduce)."""
    mesh = x.device_mesh
    x_l, x_pl = _gathered(x, keep_dims=(0,))

    def local(w, full=False):
        if isinstance(w, QTensor):
            return QTensor(w.variant, w.shape,
                           {k: _gathered(v)[0] for k, v in w.data.items()})
        if full:
            return _gathered(w)[0]
        return gather_dp(w).to_local()

    pl = {k: local(v, full=(k == "router")) for k, v in p.items()}
    E = cfg.n_experts
    gate = pl["w_gate"]
    ep = not isinstance(gate, QTensor) and gate.shape[-3] < E
    ffn_tp = not isinstance(gate, QTensor) and not ep and (
        gate.shape[-1] < p["w_gate"].shape[-1])
    if ep:
        size = E // gate.shape[-3]
        plan = ServeTPPlan(size=size, moe_ep=True)
        with serve_tp(plan, 0, _CountedGroup(size)):
            y, aux = block(x_l, pl, cfg)
    else:
        y, aux = block(x_l, pl, cfg)
    out_pl = list(x_pl)
    if ffn_tp:
        m = mesh.mesh_dim_names.index("model")
        out_pl[m] = Partial()
    tr = active_tracker()
    if tr is not None:
        tr.collective("all-reduce", aux, track=False)
    return (DTensor.from_local(y, mesh, out_pl, run_check=False),
            DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                               run_check=False))


def local_ssd(fn, x, dt, A, Bm, Cm, state0, chunk):
    """The SSD chunk scan ``fn`` (``models.mamba2._ssd_chunk_scan``) under
    a dry run, on the rank's shards: the scan is independent over (batch,
    head), so each rank runs its batch rows and x's heads (x (B, S, H, P)
    as ``constrain`` laid it out); dt (B, S, H), A (H,) and the state (B,
    H, P, N) are cut to those heads (the first H/|model| on rank 0), B
    and C (B, S, N) keep their batch rows. Returns y and the state with
    x's batch and head placements."""
    mesh = x.device_mesh
    x_l, x_pl = _gathered(x, keep_dims=(0, 2))
    Bl, Hl = x_l.shape[0], x_l.shape[2]

    batch = {i for i, p in enumerate(x_pl) if p.is_shard() and p.dim == 0}

    def rows(t):
        """``t``'s rows as x holds them; a plain operand (a zero state
        made inside the step) is whole, and sliced."""
        other = () if not isinstance(t, DTensor) else {
            i for i, p in enumerate(t.placements)
            if p.is_shard() and p.dim % t.dim() == 0 and i not in batch}
        return _gathered(t, keep_dims=(0,), also=other)[0][:Bl]
    dt_l = rows(dt)[:, :, :Hl]
    A_l = _gathered(A)[0][:Hl]
    Bm_l, Cm_l = rows(Bm), rows(Cm)
    st_l = rows(state0)[:, :Hl]
    y, st = fn(x_l, dt_l, A_l, Bm_l, Cm_l, st_l, chunk)
    st_pl = [Shard(1) if p.is_shard() and p.dim % 4 == 2 else p
             for p in x_pl]
    return (DTensor.from_local(y, mesh, x_pl, run_check=False),
            DTensor.from_local(st, mesh, st_pl, run_check=False))


def local_heads(fn, q, *rest, **kw):
    """An attention core ``fn(q, k, v, ...)`` under a dry run, run on the
    rank's shards: attention is independent over (batch, head), so each
    rank computes its own batch rows and q heads against the kv heads
    those need, as an SPMD partitioner lays it out. q (B, S, H, D) keeps
    its batch and head sharding. A 4-dim operand (the K/V, heads at dim
    2) keeps its batch sharding and its head sharding, where it has one;
    else the rank's q heads' kv heads are sliced from the whole. A mesh
    dim that shards q's heads gathers the K/V's sequence (each head needs
    all of it). A mesh dim that shards only the K/V's sequence (the
    flash-decoding layout, or B = 1 over dp) leaves the rank a partial
    attention, whose combination is counted as an all-reduce of the
    output. The other operands (slot positions) follow the batch and the
    K/V's local sequence."""
    mesh = q.device_mesh
    kv = [t for t in rest if isinstance(t, DTensor) and t.dim() == 4]
    # a mesh dim sharding both q's heads and the K/V's sequence: gather
    # the smaller of the two (a decode step's q: flash decoding)
    both = {i for i, p in enumerate(q.placements)
            if p.is_shard() and p.dim % 4 == 2 and any(
                t.placements[i].is_shard() and t.placements[i].dim % 4 == 1
                for t in kv)}
    q_first = both and q.numel() <= min(t.numel() for t in kv)
    q_l, q_pl = _gathered(q, keep_dims=(0, 2),
                          also=both if q_first else ())
    heads = {i for i, p in enumerate(q_pl)
             if p.is_shard() and p.dim % 4 == 2}
    H, Hl = q.shape[2], q_l.shape[2]
    seq_split, T_l, args = False, None, []
    for t in rest:
        if not isinstance(t, DTensor):
            args.append(t)
            continue
        if t.dim() == 4:
            kv_heads = 2 in _placement_dims(t)
            loc, pl = _gathered(t, keep_dims=(0, 1, 2), also={
                i for i in heads if t.placements[i].is_shard()
                and t.placements[i].dim % 4 == 1})
            seq_split = seq_split or any(p.is_shard() and p.dim % 4 == 1
                                         for p in pl)
            T_l = loc.shape[1]
            if not kv_heads and Hl < H:
                G = max(1, H // t.shape[2])
                loc = loc[:, :, :max(1, Hl // G)]
        else:
            loc, _ = _gathered(t, keep_dims=(0, 1))
        args.append(loc)
    # slot positions (B, T) follow the K/V's local sequence
    args = [a[:, :T_l] if (T_l is not None and a.dim() == 2
                           and a.shape[1] > T_l) else a for a in args]
    out = fn(q_l, *args, **kw)
    if seq_split:
        tr = active_tracker()
        if tr is not None:
            tr.collective("all-reduce", out, track=False)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def _dequantize_shards(t: QTensor, dtype) -> DTensor:
    """A QTensor whose payloads are DTensors (the specs of
    ``sharding.param_specs``: every payload sharded alike, on its lanes
    or on whole super-blocks of its K rows): each rank dequantizes its own
    payload shards, and the weight has the payloads' placements. The
    bit-unpacking has no DTensor sharding rule, and needs none: a shard
    holds whole super-blocks."""
    first = next(iter(t.data.values()))
    mesh, pl = first.device_mesh, first.placements
    K, N = t.shape
    for i, p in enumerate(pl):
        if p.is_shard():
            if p.dim % first.dim() == first.dim() - 1:
                N //= mesh.size(i)
            else:
                K //= mesh.size(i)
    local = QTensor(t.variant, (K, N),
                    {k: v.to_local() for k, v in t.data.items()})
    return DTensor.from_local(dequantize(local, dtype=dtype), mesh, pl,
                              run_check=False)


def local_matmul(plain, x, t, *, compute_dtype=torch.bfloat16,
                 out_dtype=None):
    """``plain`` (``kernels.bfp_matmul.bfp_matmul_plain``) on a QTensor
    with DTensor payloads: the weight dequantized shard by shard, then the
    rank's rows in one product, where ``plain`` takes a row at a time (its
    rounding; only shapes matter here)."""
    del plain
    out_dtype = out_dtype or x.dtype
    w = _dequantize_shards(t, torch.float32).to(compute_dtype).to(
        torch.float32)
    return (x.to(compute_dtype).to(torch.float32) @ w).to(out_dtype)


def _on_shards(fn, rule, operand=lambda args: args[0]):
    """``fn``, run through ``rule(fn, *args)`` when the operand that
    decides its layout is a DTensor."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if isinstance(operand(args), DTensor):
            return rule(fn, *args, **kw)
        return fn(*args, **kw)
    return wrapper


def _packed_payload(args):
    t = args[1]
    return next(iter(t.data.values())) if isinstance(t, QTensor) else None


@contextlib.contextmanager
def partitioned():
    """Replace the functions of the module note with their per-rank
    wrappers for the length of the block; every one is restored on exit.
    A dry run holds the only process group of its process
    (``dryrun.fake_world``), so no other step runs beside it."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, mamba2, moe
    sites = [(layers, name, _on_shards(getattr(layers, name), local_heads))
             for name in ("naive_attention", "blockwise_attention",
                          "decode_attention")]
    sites += [(moe, "moe_block", _on_shards(moe.moe_block, local_moe)),
              (mamba2, "_ssd_chunk_scan",
               _on_shards(mamba2._ssd_chunk_scan, local_ssd)),
              (ops, "bfp_matmul_plain",
               _on_shards(ops.bfp_matmul_plain, local_matmul,
                          _packed_payload))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    try:
        for mod, name, wrapper in sites:
            setattr(mod, name, wrapper)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
