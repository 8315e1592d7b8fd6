"""The port's serve-TP plan and shard rules against the reference's.

No process group here (but one case, below): ``make_serve_tp_plan``
field by field for every registered arch (reduced and full) at sizes
1-4 under each datapath (with params for "sliced_row"), the per-leaf
rules of ``serve_param_specs``/``serve_cache_specs`` against the
reference's PartitionSpecs leaf by leaf, the lane and row shards of a
packed QTensor byte for byte against the reference's, the localized
shapes, and the reference's validation errors (which the engine raises
before it starts any worker). One case starts a worker: a tp = 2
``DisaggEngine`` opens and closes its group.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core import formats as JF
from repro.core import quantize as JQ
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.core.quantize import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import bfp_matmul as PB
from repro_torch.models import transformer as PT
from repro_torch.serving.disagg import DisaggEngine
from repro_torch.serving.engine import Engine, ServeConfig

BASE = dict(max_new_tokens=6, cache_len=64, decode_chunk=8, max_slots=3,
            prefill_bucket=4, prefill_chunk=8, prefill_batch=3)
DATAPATHS = ("padded", "sliced", "sliced_row")


def _meta_tree(shapes):
    """The port's tree of shape-only (meta) tensors for the reference's
    ``eval_shape`` tree."""
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(shapes.shape, device="meta")


def _ref_rule(spec, ndim):
    """The port's rule for a reference PartitionSpec of an ndim array."""
    dims = tuple(spec)
    for i, a in enumerate(dims):
        if a is not None:
            return i - ndim
    return None


def _ref_rules(specs, params):
    if isinstance(specs, dict):
        return {k: _ref_rules(specs[k], params[k]) for k in specs}
    if isinstance(specs, JQ.QTensor):
        rules = {_ref_rule(specs.data[k], params.data[k].ndim)
                 for k in specs.data}
        assert len(rules) == 1, rules           # one rule a QTensor
        return rules.pop()
    return _ref_rule(specs, len(params.shape))


@pytest.fixture(scope="module")
def packed():
    """Reduced tinyllama and gpt2 packed under their paper mixes on the
    reference (under jax.jit), and the port's bridged copies."""
    out = {}
    for arch, pol in (("tinyllama-1.1b", "paper_llama_mix"),
                      ("gpt2-paper", "paper_gpt2_mix")):
        cfg = JC.get_arch(arch, reduced=True)
        params = jax.jit(JT.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        qp = jax.jit(lambda p: j_quantize_params(p, j_get_policy(pol))[0])(
            params)
        out[arch] = (qp, bridge.from_jax_params(jax.tree.map(np.asarray,
                                                             qp)))
    return out


@pytest.mark.parametrize("reduced", (True, False))
def test_plan_matches_reference_every_arch(reduced, packed):
    n = 0
    for arch in JC.ARCH_IDS:
        jcfg = JC.get_arch(arch, reduced=reduced)
        pcfg = PC.get_arch(arch, reduced=reduced)
        shapes = jax.eval_shape(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(0)))
        trees = [(None, None), (shapes, _meta_tree(shapes))]
        if reduced and arch in packed:
            trees.append(packed[arch])
        for size in (1, 2, 3, 4):
            for mm in DATAPATHS:
                for ep in (True, False):
                    for jp, pp in trees:
                        ref = JSH.make_serve_tp_plan(jcfg, size, matmul=mm,
                                                     params=jp, ep=ep)
                        got = SH.make_serve_tp_plan(pcfg, size, matmul=mm,
                                                    params=pp, ep=ep)
                        assert (dataclasses.asdict(got)
                                == dataclasses.asdict(ref)), (arch, size, mm)
                        n += 1
    assert n > 0
    if reduced:     # the row modes both occur on the packed trees
        qp = packed["tinyllama-1.1b"][1]
        cfg = PC.get_arch("tinyllama-1.1b", reduced=True)
        plan = SH.make_serve_tp_plan(cfg, 2, matmul="sliced_row", params=qp)
        assert {plan.attn_row, plan.mlp_row} == {"dequant", "packed"}


def test_param_specs_match_reference_leaf_by_leaf(packed):
    cases = []
    for arch in JC.ARCH_IDS:
        jcfg = JC.get_arch(arch, reduced=True)
        shapes = jax.eval_shape(lambda: JT.init_params(
            jcfg, jax.random.PRNGKey(0)))
        cases.append((arch, shapes, _meta_tree(shapes)))
    cases += [(a, jp, pp) for a, (jp, pp) in packed.items()]
    for arch, jp, pp in cases:
        jcfg = JC.get_arch(arch, reduced=True)
        pcfg = PC.get_arch(arch, reduced=True)
        for size in (1, 2, 4):
            for mm in DATAPATHS:
                jplan = JSH.make_serve_tp_plan(jcfg, size, matmul=mm,
                                               params=jp)
                plan = SH.make_serve_tp_plan(pcfg, size, matmul=mm,
                                             params=pp)
                assert (SH.serve_param_specs(pp, plan)
                        == _ref_rules(JSH.serve_param_specs(jp, jplan), jp)
                        ), (arch, size, mm)


def test_param_specs_lane_only_and_expert_axis(packed):
    """The reference's own spot checks, read as the port's rules."""
    cfg = PC.get_arch("tinyllama-1.1b", reduced=True)
    specs = SH.serve_param_specs(packed["tinyllama-1.1b"][1],
                                 SH.make_serve_tp_plan(cfg, 2))
    lay = specs["layers"]
    assert lay["attn"]["wq"] == lay["attn"]["wo"] == SH.LANES
    assert lay["mlp"]["w_down"] == SH.LANES     # lanes, not K rows
    assert lay["ln1"]["w"] is None and specs["wte"] is None
    specs4 = SH.serve_param_specs(packed["tinyllama-1.1b"][1],
                                  SH.make_serve_tp_plan(cfg, 4))
    assert specs4["layers"]["attn"]["wq"] is None   # KH=2: replicated
    assert specs4["layers"]["mlp"]["w_up"] == SH.LANES
    moe = PC.get_arch("olmoe-1b-7b", reduced=True).replace(
        n_experts=4, n_experts_active=2)
    jmoe = JC.get_arch("olmoe-1b-7b", reduced=True).replace(
        n_experts=4, n_experts_active=2)
    shapes = jax.eval_shape(lambda: JT.init_params(jmoe,
                                                   jax.random.PRNGKey(0)))
    mspecs = SH.serve_param_specs(_meta_tree(shapes),
                                  SH.make_serve_tp_plan(moe, 2))
    for key in ("w_gate", "w_up", "w_down"):
        assert mspecs["layers"]["moe"][key] == SH.EXPERTS
    assert mspecs["layers"]["moe"]["router"] is None


@pytest.mark.parametrize("quant", (False, True))
def test_cache_specs_match_reference(quant):
    jcfg = JC.get_arch("llama3.2-1b", reduced=True).replace(
        kv_cache_quant=quant, dtype="float32")
    pcfg = PC.get_arch("llama3.2-1b", reduced=True).replace(
        kv_cache_quant=quant, dtype="float32")
    for size in (1, 2, 8):
        jplan = JSH.make_serve_tp_plan(jcfg, size)
        plan = SH.make_serve_tp_plan(pcfg, size)
        for jtree, ptree in (
                (jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 64)),
                 PT.init_cache(pcfg, 4, 64, device="meta")),
                (jax.eval_shape(lambda: JT.cache_page_pool(jcfg, 8, 8)),
                 PT.cache_page_pool(pcfg, 8, 8, device="meta"))):
            ref = JSH.serve_cache_specs(jtree, jplan)
            got = SH.serve_cache_specs(ptree, plan)
            assert set(got) == set(ref)
            for k in got:
                dims = tuple(ref[k])
                want = (dims.index(jplan.axis) if jplan.axis in dims
                        else None)
                assert got[k] == want, (size, k)
    plan2 = SH.make_serve_tp_plan(pcfg, 2)
    assert plan2.attn
    rules = SH.serve_cache_specs(PT.init_cache(pcfg, 4, 64, device="meta"),
                                 plan2)
    assert rules["k"] == SH.KV_HEADS and rules["pos"] is None


def _payload_bytes(t):
    return {k: np.ascontiguousarray(np.asarray(v)).tobytes()
            for k, v in t.data.items()}


def _port_bytes(t):
    return {k: v.contiguous().numpy().tobytes() for k, v in t.data.items()}


@pytest.mark.parametrize("variant", PB.VARIANTS)
def test_qtensor_shards_byte_equal_reference(variant):
    rng = np.random.default_rng(7)
    K, N = 1024, 256
    w = jnp.asarray(rng.standard_normal((K, N)).astype(np.float32) * 0.2)
    jt = JQ.quantize(variant, w)
    pt = bridge.from_jax_params(jax.tree.map(
        np.asarray, {"t": jt}))["t"]
    for n in (2, 4):
        for i in range(n):
            for fn_ref, fn in ((JSH.lane_shard_qtensor,
                                SH.lane_shard_qtensor),
                               (JSH.row_shard_qtensor, SH.row_shard_qtensor)):
                ref, got = fn_ref(jt, i, n), fn(pt, i, n)
                assert tuple(got.shape) == tuple(ref.shape)
                assert _port_bytes(got) == _payload_bytes(ref), (
                    fn.__name__, n, i)
    with pytest.raises(ValueError, match="divisible"):
        SH.lane_shard_qtensor(pt, 0, 3)
    if JF.get_format(variant).super_block == 256:
        with pytest.raises(ValueError, match="super-block"):
            SH.row_shard_qtensor(pt, 0, 8)


def test_localized_shapes(packed):
    """Every sharded leaf of a rank's local tree has its (K, N) cut as
    the reference's localize cuts it, and the views hold the bytes of the
    reference's shard of each payload."""
    jqp, pqp = packed["tinyllama-1.1b"]
    cfg = PC.get_arch("tinyllama-1.1b", reduced=True)
    jcfg = JC.get_arch("tinyllama-1.1b", reduced=True)
    for mm in DATAPATHS:
        plan = SH.make_serve_tp_plan(cfg, 2, matmul=mm, params=pqp)
        jplan = JSH.make_serve_tp_plan(jcfg, 2, matmul=mm, params=jqp)
        specs = SH.serve_param_specs(pqp, plan)
        jloc = JSH.localize_serve_params(
            jqp, JSH.serve_param_specs(jqp, jplan), 2)
        for r in range(2):
            loc = SH.localize_serve_params(pqp, specs, 2, r)
            for path in ("wq", "wk", "wv", "wo"):
                t, jt = loc["layers"]["attn"][path], jloc["layers"]["attn"][
                    path]
                assert tuple(t.shape) == tuple(jt.shape), (mm, path)
            for path in ("w_gate", "w_up", "w_down"):
                t, jt = loc["layers"]["mlp"][path], jloc["layers"]["mlp"][
                    path]
                assert tuple(t.shape) == tuple(jt.shape), (mm, path)
                rule = specs["layers"]["mlp"][path]
                for k, v in t.data.items():
                    a = np.asarray(jqp["layers"]["mlp"][path].data[k])
                    n = a.shape[rule] // 2
                    ref = np.take(a, range(r * n, (r + 1) * n), axis=rule)
                    assert v.contiguous().numpy().tobytes() == \
                        np.ascontiguousarray(ref).tobytes()
            assert loc["wte"] is pqp["wte"]         # replicated, not copied


def test_serve_tp_context_is_reentrant():
    plan = SH.ServeTPPlan(size=1)
    ctx = SH.serve_tp(plan)
    assert SH.serve_tp_plan() is None
    with ctx:
        with ctx:
            assert SH.serve_tp_plan() is plan
        assert SH.serve_tp_plan() is plan
    assert SH.serve_tp_plan() is None and SH.serve_tp_rank() == 0
    with pytest.raises(ValueError, match="group"):
        SH.serve_tp(SH.ServeTPPlan(size=2), 1)
    with pytest.raises(ValueError, match="rank"):
        SH.serve_tp(SH.ServeTPPlan(size=2), 2, group=object())


def test_validation_errors_match_reference():
    """Raised before any worker starts: the reference's messages."""
    cfg = PC.get_arch("tinyllama-1.1b", reduced=True)
    with pytest.raises(ValueError, match="padded.*sliced"):
        SH.make_serve_tp_plan(cfg, 2, matmul="megatron")
    with pytest.raises(ValueError, match="padded.*sliced"):
        Engine(cfg, {}, ServeConfig(tp_matmul="megatron", **BASE),
               device="cpu")
    with pytest.raises(ValueError, match="tp"):
        Engine(cfg, {}, ServeConfig(tp=0, **BASE), device="cpu")
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        rc = PC.get_arch(arch, reduced=True)
        with pytest.raises(ValueError, match="KV-ring family"):
            Engine(rc, {}, ServeConfig(tp=2, **BASE), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="device"):
            Engine(cfg, {}, ServeConfig(tp=2, **BASE), device="cuda")
    with pytest.raises(ValueError, match="one device a rank"):
        Engine(cfg, {}, ServeConfig(tp=2, **BASE), device=["cpu"] * 3)
    # DisaggEngine serves tp > 1 since slice 14: it opens its workers on
    # a group of its own and closes it (no weights are needed to open)
    with DisaggEngine(cfg, {}, ServeConfig(tp=2, **BASE),
                      device="cpu") as dis:
        assert dis.group.size == 2 and not dis.closed
        procs = list(dis.group._procs)
    assert dis.closed and not any(p.is_alive() for p in procs)
