"""Expert-parallel MoE serving on the CPU: sharded experts == replicated.

Mirrors ``tests/test_moe_ep.py`` (whose parity cases skip in this run):
greedy tokens with the expert stacks sharded over the ranks
(``ServeTPPlan.moe_ep``) equal the single-device engine's and the tp > 1
engine's with EP off (``tp_ep=False``), at tp 2 and 4; on plain stacks
(sharded by the rules) and on E*K-packed ones (replicated, each rank
cutting its experts' rows before it dequantizes). ``moe_block`` itself,
run on each rank under the plan, gives tp=1's output bit for bit.
Routing, dispatch and combine run replicated and each rank's products
keep the per-expert shapes, so no product changes its rounding.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.core.quantize import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.group import GroupCache
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, ServeConfig

BASE = dict(max_new_tokens=6, cache_len=64, decode_chunk=4, max_slots=2,
            prefill_bucket=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def groups():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = GroupCache(lambda n: ["cpu"] * n, timeout_s=120.0)
    yield cache
    cache.close()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def olmoe():
    # 4 experts so EP divides 2 and 4
    cfg = get_arch("olmoe-1b-7b", reduced=True).replace(
        n_experts=4, n_experts_active=2, capacity_factor=4.0)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


@pytest.fixture(scope="module")
def olmoe_packed(olmoe):
    cfg, params = olmoe
    qp, _ = quantize_params(params, get_policy("default_serve_mix"))
    return cfg, qp


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                          int(rng.integers(2, 24)))]
            for _ in range(n)]


def _gen(model, tp, groups, tp_ep=True, seed=3):
    cfg, params = model
    with Engine(cfg, params, ServeConfig(tp=tp, tp_ep=tp_ep, **BASE),
                device="cpu",
                group=groups.get(tp) if tp > 1 else None) as eng:
        if tp > 1:
            assert eng._plan.moe_ep == (tp_ep and cfg.n_experts % tp == 0)
        return eng.generate(_prompts(cfg, 4, seed=seed))


def test_plan_moe_ep_requires_divisible_experts(olmoe):
    cfg, _ = olmoe
    assert SH.make_serve_tp_plan(cfg, 1).moe_ep is False
    assert SH.make_serve_tp_plan(cfg, 2).moe_ep is True
    assert SH.make_serve_tp_plan(cfg, 2, ep=False).moe_ep is False
    e3 = cfg.replace(n_experts=3, n_experts_active=2)
    assert SH.make_serve_tp_plan(e3, 2).moe_ep is False
    dense = get_arch("tinyllama-1.1b", reduced=True)
    assert SH.make_serve_tp_plan(dense, 2).moe_ep is False


def test_param_specs_shard_expert_stacks(olmoe, olmoe_packed):
    cfg, params = olmoe
    plan = SH.make_serve_tp_plan(cfg, 2)
    specs = SH.serve_param_specs(params, plan)
    for key in ("w_gate", "w_up", "w_down"):
        assert specs["layers"]["moe"][key] == SH.EXPERTS
        loc = SH.localize_serve_params(params, specs, 2, 1)
        assert loc["layers"]["moe"][key].shape[1] == 2
    assert specs["layers"]["moe"]["router"] is None
    qmoe = olmoe_packed[1]["layers"]["moe"]
    qspecs = SH.serve_param_specs(olmoe_packed[1], plan)["layers"]["moe"]
    # packed stacks replicate (w_down, K = 128, stays a plain stack)
    assert isinstance(qmoe["w_gate"], QTensor)
    for key in ("w_gate", "w_up", "w_down"):
        packed = isinstance(qmoe[key], QTensor)
        assert qspecs[key] == (None if packed else SH.EXPERTS)


def test_moe_ep_tp2_matches_single_device(olmoe, groups):
    assert _gen(olmoe, 2, groups) == _gen(olmoe, 1, groups)


def test_moe_ep_matches_replicated_experts(olmoe, groups):
    """EP's expert products against the same ranks running every expert
    replicated: the same tokens."""
    assert _gen(olmoe, 2, groups, tp_ep=True) == _gen(olmoe, 2, groups,
                                                      tp_ep=False)


def test_moe_ep_packed_stacks_tp2(olmoe_packed, groups):
    """E*K-packed stacks stay replicated; each rank dequantizes only its
    experts' rows: the tokens of tp=1 and of EP off."""
    one = _gen(olmoe_packed, 1, groups)
    assert _gen(olmoe_packed, 2, groups) == one
    assert _gen(olmoe_packed, 2, groups, tp_ep=False) == one


def test_expert_weights_cut_before_dequant_is_exact(olmoe_packed):
    """Cutting a packed stack's expert rows before dequantizing gives the
    bits of cutting after."""
    cfg, qp = olmoe_packed
    E = cfg.n_experts
    for key in ("w_gate", "w_up"):
        t = qp["layers"]["moe"][key].layer(0)
        full = MOE.expert_weights(t, E)
        for lo, n in ((0, 2), (2, 2), (1, 1)):
            assert torch.equal(MOE.expert_weights(t, E, lo, n),
                               full[lo:lo + n])


def _moe_layer(x, lp, cfg):
    return MOE.moe_block(x, lp, cfg)[0]


def test_moe_block_ep_bits(olmoe, groups):
    """One layer's ``moe_block`` on each rank under the EP plan equals the
    single-device block bit for bit (every rank holds the gathered
    output)."""
    cfg, params = olmoe
    lp = T._layer(params["layers"], 0)["moe"]
    x = torch.randn(2, 12, cfg.d_model,
                    generator=torch.Generator().manual_seed(5)).to(
                        torch.bfloat16)
    ref = MOE.moe_block(x, lp, cfg)[0]
    plan = SH.make_serve_tp_plan(cfg, 2)
    specs = SH.serve_param_specs({"moe": lp}, plan)
    # the single layer's stacks are (E, K, N): the rule's axis is the same
    outs = groups.get(2).map(
        _moe_layer, [(x, SH.localize_serve_params({"moe": lp}, specs, 2,
                                                   r)["moe"], cfg)
                     for r in range(2)], plan)
    for o in outs:
        assert torch.equal(o, ref)


def test_moe_ep_tp4_matches_single_device(olmoe, groups):
    assert _gen(olmoe, 4, groups) == _gen(olmoe, 1, groups)
