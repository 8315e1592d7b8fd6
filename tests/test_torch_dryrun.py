"""The port's dry run against the reference's.

Holds ``repro_torch.launch.dryrun.dryrun_cell`` against
``repro.launch.dryrun.dryrun_cell`` (src/repro/launch/dryrun.py:139). The
reference runs in a subprocess on a 16-device host mesh of (4, 4) with
Auto axes (its production mesh's Explicit axes make ``constrain`` raise on
the installed JAX), with ``cost_probes=False``; the port runs the same
cells on a fake world of 16 ranks. On every compared cell the argument
bytes are equal, byte for byte, and so are ``memory_model`` and
``model_flops``; a skipped cell has the reference's status and reason.
The dense train cell's argument bytes are compared at full depth; its
step runs at 2 layers with a 65,536-token loss chunk (both packages, the
same override), where the useful-FLOPs ratio must lie in [0.5, 1.05].
Each compared cell's DTensor fallbacks are of the kinds listed for it
(``FALLBACKS``): a new kind fails. Also: the CLIs (dryrun, summarize,
hillclimb, optimized_sweep) on a (4, 4) mesh, the tracker's per-rank
counts on a DTensor product and an all-to-all, a wrong shape raising
inside a dry run rather than being gathered round, the refusal to start
beside an open process group, the model code's dry-run hooks
(constrain, gather_dp) inert outside a dry run, and
``partition.partitioned`` restoring what it replaces.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.distributed import sharding as SH
from repro_torch.launch import analysis as AN
from repro_torch.launch import dryrun as D
from repro_torch.launch import flops as FL
from repro_torch.launch import hillclimb, optimized_sweep, summarize
from repro_torch.launch.mesh import make_elastic_mesh, parse_mesh

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
MESH = SH.MeshShape(("data", "model"), (4, 4))
SMALL_TRAIN = {"n_layers": 2, "loss_chunk": 65536}
CELLS = [("llama3.2-1b", "decode_32k", {}),
         ("llama3.2-1b", "train_4k", {}),
         ("llama3.2-1b", "train_4k", {"config_override": SMALL_TRAIN}),
         ("olmoe-1b-7b", "decode_32k", {}),
         ("llama3.2-1b", "long_500k", {})]
# the kinds of op DTensor may refuse in each cell (torch 2.13 on the CPU):
# the decode cache's slot writes, run on each rank's shards
FALLBACKS = {("llama3.2-1b", "decode_32k"):
             {"aten.index_put_.default (local in-place)"},
             ("llama3.2-1b", "train_4k"): set(),
             ("olmoe-1b-7b", "decode_32k"):
             {"aten.index_put_.default (local in-place)"}}

REF = r"""
import json, os, sys
os.environ["REPRO_DRYRUN_DEVICES"] = "16"
sys.path.insert(0, "src")
from repro.launch import dryrun as D
import jax
from jax.sharding import AxisType
mesh = jax.make_mesh((4, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = []
for arch, shape, kw in json.loads(sys.argv[1]):
    rec = D.dryrun_cell(arch, shape, mesh=mesh, cost_probes=False, **kw)
    out.append({k: rec.get(k) for k in ("status", "reason", "memory",
                                        "memory_model", "roofline")})
with open(sys.argv[2], "w") as f:
    json.dump(out, f, default=str)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "cells.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", REF, json.dumps(CELLS), str(out)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out


def _ref_records(reference):
    proc, out = reference
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(out) as f:
        return json.load(f)


def _port(arch, shape, kw):
    if shape == "train_4k" and not kw:
        # the full-depth train step takes a minute here: its arguments
        # only (the specs and local shapes decide them)
        from torch._subclasses.fake_tensor import FakeTensorMode
        cfg = D._tune_for_dryrun(get_arch(arch), SHAPES[shape])
        with D.fake_world(MESH) as dm, FakeTensorMode():
            _, args, _ = D.cell_inputs(cfg, SHAPES[shape], dm)
            return dict(status="ok", memory=dict(
                argument_size_in_bytes=D._local_bytes(args)))
    return D.dryrun_cell(arch, shape, mesh=MESH, **kw)


def test_cells_against_reference(reference):
    ports = [_port(*c) for c in CELLS]
    refs = _ref_records(reference)
    for (arch, shape, kw), p, r in zip(CELLS, ports, refs):
        tag = f"{arch} x {shape} {kw}"
        assert p["status"] == r["status"], tag
        if r["status"] == "skipped":
            assert p["reason"] == r["reason"], tag
            continue
        assert p["memory"]["argument_size_in_bytes"] == \
            r["memory"]["argument_size_in_bytes"], tag
        if "roofline" not in p:
            continue
        assert p["memory_model"] == r["memory_model"], tag
        assert p["roofline"]["model_flops"] == pytest.approx(
            r["roofline"]["model_flops"], rel=1e-12), tag
        assert p["probes"] == "full depth"
        assert set(p["fallbacks"]) <= FALLBACKS[(arch, shape)], tag
        m = p["memory"]
        assert m["total_hbm_bytes"] == (
            m["argument_size_in_bytes"] + m["output_size_in_bytes"]
            + m["temp_size_in_bytes"] - m["alias_size_in_bytes"])
        assert p["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
        if shape == "train_4k":
            cfg = get_arch(arch).replace(**kw["config_override"])
            rf = p["roofline"]
            useful = FL.model_flops(cfg, SHAPES[shape]) / (
                rf["flops_per_chip"] * rf["n_chips"])
            assert 0.5 <= useful <= 1.05, useful
            assert m["alias_size_in_bytes"] > 0


def test_clis_on_a_small_mesh(tmp_path, capsys):
    D.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh",
            "4x4", "--out", str(tmp_path / "dry")])
    (rec,) = [json.loads(p.read_text())
              for p in (tmp_path / "dry").glob("*.json")]
    assert rec["status"] == "ok" and rec["mesh"] == {"data": 4, "model": 4}
    summarize.main([str(tmp_path / "dry")])
    text = capsys.readouterr().out
    assert "| llama3.2-1b | decode_32k | 4x4 | ok |" in text
    assert "### Roofline (single-pod)" in text
    hillclimb.main(["--cell", "h1b", "--mesh", "4x4", "--out",
                    str(tmp_path / "hc")])
    recs = {p.name: json.loads(p.read_text())
            for p in (tmp_path / "hc").glob("*.json")}
    assert sorted(recs) == ["h1b__base_auto.json", "h1b__kv_seq.json",
                            "h1b__kv_seq_int8kv.json"]
    assert all(r["status"] == "ok" for r in recs.values())
    optimized_sweep.main(["--kinds", "decode", "--only-arch", "llama3.2-1b",
                          "--mesh", "4x4", "--out", str(tmp_path / "opt")])
    (opt,) = [json.loads(p.read_text())
              for p in (tmp_path / "opt").glob("*.json")]
    assert opt["status"] == "ok" and opt["shape"] == "decode_32k"
    assert optimized_sweep.variant_for("qwen2-vl-72b", "train_4k") is None
    assert parse_mesh("2x2x4").axis_names == ("pod", "data", "model")
    assert make_elastic_mesh(16, 24).sizes == (2, 12)


def test_tracker_counts_local_work():
    """A (64, 32) @ (32, 48) DTensor product on a fake (2, 2) world, x
    sharded on its rows over "data", w on its lanes over "model": rank 0
    computes its (32, 24) block, 2 * 32 * 24 * 32 FLOPs, with no
    collective; the arguments' shards are live memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = SH.MeshShape(("data", "model"), (2, 2))
    with D.fake_world(mesh) as dm, FakeTensorMode():
        x = DTensor.from_local(torch.empty(32, 32), dm,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(32, 24), dm,
                               [Replicate(), Shard(1)], run_check=False)
        tr = AN.RankTracker()
        tr.track((x, w))
        with tr:
            y = x @ w
        assert tuple(y.to_local().shape) == (32, 24)
    assert tr.flops == 2 * 32 * 24 * 32
    assert tr.coll == {}
    assert tr.peak == (32 * 32 + 32 * 24 + 32 * 24) * 4


def test_tracker_counts_an_all_to_all():
    """A (64, 64) DTensor moved from rows to lanes over a 2-rank "model"
    axis is DTensor's all-to-all. The CPU process group runs it as an
    all-gather and a chunk; the tracker counts the all-to-all that was
    asked for, at the (64, 32) f32 block it returns, and no all-gather.
    (The tracker finds that fallback and DTensor's own shape propagation
    by their frames' names, which a torch release may change: this test
    and ``test_tracker_counts_local_work`` fail if it does.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = SH.MeshShape(("data", "model"), (2, 2))
    with D.fake_world(mesh) as dm, FakeTensorMode():
        x = DTensor.from_local(torch.empty(32, 64), dm,
                               [Replicate(), Shard(0)], run_check=False)
        tr = AN.RankTracker()
        tr.track((x,))
        with tr:
            y = x.redistribute(dm, [Replicate(), Shard(1)])
        assert tuple(y.to_local().shape) == (64, 32)
    assert tr.coll == {"all-to-all": 64 * 32 * 4}


def test_wrong_shape_raises_inside_a_dry_run():
    """An op that is wrong on the global shapes raises its own error in a
    dry run; it is not gathered round. A view that DTensor refuses only
    for its layout (it would unflatten a dim sharded unevenly) runs, with
    its operand gathered, and is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = SH.MeshShape(("data", "model"), (2, 2))
    with D.fake_world(mesh) as dm, FakeTensorMode():
        x = DTensor.from_local(torch.empty(32, 32), dm,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(24, 12), dm,
                               [Replicate(), Shard(1)], run_check=False)
        prop = D._Propagate(AN.RankTracker())
        with prop, pytest.raises(RuntimeError):
            x @ w
        assert prop.fallbacks == {}
        # rows over both mesh dims (4 ways) unflattened into 2 x 32
        x4 = DTensor.from_local(torch.empty(16, 32), dm,
                                [Shard(0), Shard(0)], run_check=False)
        with prop:
            y = x4.view(2, 32, 32)
        assert tuple(y.to_local().shape) == (1, 32, 32)
        assert prop.fallbacks == {
            "aten.view.default (gathered over 1 mesh dims)": 1}


def test_partitioned_restores_the_functions():
    """Inside ``partitioned()`` the four functions are wrappers that call
    the function itself on plain tensors (the same bits); on exit every
    module attribute is the original again."""
    from repro_torch.kernels import ops
    from repro_torch.launch.partition import partitioned
    from repro_torch.models import layers, mamba2, moe
    sites = [(layers, "naive_attention"), (layers, "blockwise_attention"),
             (layers, "decode_attention"), (moe, "moe_block"),
             (mamba2, "_ssd_chunk_scan"), (ops, "bfp_matmul_plain")]
    before = [getattr(m, n) for m, n in sites]
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 8, 4, 16, generator=g) for _ in range(3))
    ref = layers.naive_attention(q, k, v, causal=True)
    with partitioned():
        assert all(getattr(m, n) is not f
                   for (m, n), f in zip(sites, before))
        assert torch.equal(layers.naive_attention(q, k, v, causal=True),
                           ref)
    assert all(getattr(m, n) is f for (m, n), f in zip(sites, before))


def test_fake_world_refuses_an_open_group():
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already open"):
            with D.fake_world(MESH):
                pass
    finally:
        dist.destroy_process_group()
    with D.fake_world(MESH) as dm:
        assert dm.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()


def _run_reduced(cfg, torch_):
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.training import steps as S
    g = torch_.Generator().manual_seed(1)
    p = T.init_params(cfg, g, device="cpu")
    tok = torch_.randint(0, cfg.vocab_size, (2, 16), generator=g)
    fwd = T.forward_seq(p, cfg, tokens=tok)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    dec, _ = T.decode_step(p, cfg, cache, tokens=tok[:, 0],
                           position=torch_.tensor([0, 0]))
    st = S.init_train_state(cfg, AdamWConfig(),
                            torch_.Generator().manual_seed(2), device="cpu")
    new, _ = S.make_train_step(cfg, AdamWConfig(), microbatches=2)(
        st, {"tokens": tok, "labels": tok})
    return [fwd, dec] + tree_leaves(new["params"])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "zamba2-1.2b"])
def test_dry_run_hooks_inert_outside_a_dry_run(arch, monkeypatch):
    """Outside a dry run the hooks in the model code (``constrain``,
    ``gather_dp``) change no bit: a reduced forward, decode step and
    train step (the chunked loss included) give the same tensors with the
    hooks as with each hook replaced by the identity."""
    cfg = get_arch(arch, reduced=True).replace(vocab_size=8192,
                                               loss_chunk=8)
    with_hooks = _run_reduced(cfg, torch)
    monkeypatch.setattr(SH, "constrain", lambda x, *d: x)
    monkeypatch.setattr(SH, "gather_dp", lambda w: w)
    from repro_torch.models import layers, mamba2, moe
    for mod in (layers, mamba2, moe):
        for name in ("constrain", "gather_dp"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, getattr(SH, name))
    without = _run_reduced(cfg, torch)
    assert len(with_hooks) == len(without)
    for a, b in zip(with_hooks, without):
        assert torch.equal(a, b)


def _plain_peak(cfg, shape, **kw):
    """The tracked peak of the same step run on plain fake tensors (no
    DTensor, no fake world): what the card's caching allocator would
    count, minus its rounding."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    with D.fake_world(SH.MeshShape(("data", "model"), (1, 1))) as dm, \
            FakeTensorMode():
        fn, args, _ = D.cell_inputs(cfg, shape, dm, **kw)
        plain = _plain_tree(args, DTensor)
        tr = AN.RankTracker()
        tr.track(plain)
        grad = torch.enable_grad() if shape.kind == "train" \
            else torch.no_grad()
        with tr, grad:
            fn(*plain)
    return D._local_bytes(plain), tr.peak


def _plain_tree(tree, DTensor):
    from repro_torch.core.quantize import QTensor
    if isinstance(tree, dict):
        return {k: _plain_tree(v, DTensor) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_plain_tree(v, DTensor) for v in tree)
    if isinstance(tree, QTensor):
        return QTensor(tree.variant, tree.shape,
                       {k: v.to_local() for k, v in tree.data.items()})
    return tree.to_local() if isinstance(tree, DTensor) else tree


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_one_rank_dry_run_counts_the_plain_step(kind, monkeypatch):
    """On a (1, 1) mesh (chip_smoke phase 45's check, at reduced size):
    the dry run's argument bytes are the plain step's, and its argument +
    temp peak equals, byte for byte, the peak tracked over the same step
    on plain tensors, packed weights included."""
    from repro_torch.configs.base import ShapeConfig
    monkeypatch.setattr(D, "get_arch", lambda a: get_arch(a, reduced=True))
    shape = (ShapeConfig("t", 32, 4, "train") if kind == "train"
             else ShapeConfig("d", 64, 4, "decode"))
    kw = {"microbatches": 2} if kind == "train" else {}
    rec = D.dryrun_cell("tinyllama-1.1b", shape,
                        mesh=SH.MeshShape(("data", "model"), (1, 1)), **kw)
    m = rec["memory"]
    cfg = D._tune_for_dryrun(get_arch("tinyllama-1.1b", reduced=True), shape)
    args, peak = _plain_peak(cfg, shape, **kw)
    assert m["argument_size_in_bytes"] == args
    assert m["argument_size_in_bytes"] + m["temp_size_in_bytes"] == peak
