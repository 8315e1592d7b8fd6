"""The port's analytic FLOPs, HBM model and roofline against the
reference's.

Holds ``repro_torch.launch.flops`` (``param_counts``, ``model_flops``,
``memory_model``, ``serve_param_bytes``) against ``repro.launch.flops``
(src/repro/launch/flops.py:26, :218, :146, :127) on every arch x shape x
mesh size to a relative 1e-12, and ``repro_torch.launch.analysis.Roofline``
against ``repro.launch.analysis.Roofline`` (src/repro/launch/analysis.py:
135) with the reference's rates replaced by the card's.
"""
import dataclasses

import pytest
import torch

from repro.configs import base as JC
from repro.launch import analysis as JAN
from repro.launch import flops as JFL
from repro_torch.configs import base as PC
from repro_torch.launch import analysis as AN
from repro_torch.launch import flops as FL

torch.set_num_threads(2)

# (n_chips, model_par): both production meshes, a small one, pure FSDP
MESH_SIZES = ((256, 16), (512, 16), (16, 4), (256, 1))


def _close(a, b, rel=1e-12):
    assert a == pytest.approx(b, rel=rel, abs=0.0), (a, b)


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_param_counts(arch):
    j = JFL.param_counts(JC.get_arch(arch))
    p = FL.param_counts(PC.get_arch(arch))
    assert sorted(j) == sorted(p)
    for k in j:
        _close(p[k], j[k])


def _memoized(fn):
    import functools
    return functools.lru_cache(maxsize=None)(fn)


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_model_flops_and_memory_model(arch, monkeypatch):
    """Every shape (the skipped long_500k cells included: the formulas do
    not skip), every mesh size, quantized and plain serve weights, the
    fused and unfused weight models, 16- and 8-bit KV. The packed bytes
    (``serve_param_bytes``, held to the reference's below) are memoized
    in both packages for the loop."""
    monkeypatch.setattr(JFL, "serve_param_bytes",
                        _memoized(JFL.serve_param_bytes))
    monkeypatch.setattr(FL, "serve_param_bytes",
                        _memoized(FL.serve_param_bytes))
    jcfg, pcfg = JC.get_arch(arch), PC.get_arch(arch)
    for name in PC.SHAPES:
        js, ps = JC.SHAPES[name], PC.SHAPES[name]
        _close(FL.model_flops(pcfg, ps), JFL.model_flops(jcfg, js))
        for n_chips, mp in MESH_SIZES:
            for quant in (True, False):
                for fused in (True, False):
                    for bits in (16, 8):
                        kw = dict(n_chips=n_chips, model_par=mp,
                                  serve_quantized=quant,
                                  fused_weights=fused, kv_cache_bits=bits)
                        j = JFL.memory_model(jcfg, js, **kw)
                        p = FL.memory_model(pcfg, ps, **kw)
                        assert sorted(j) == sorted(p)
                        for k in j:
                            _close(p[k], j[k])


@pytest.mark.parametrize("policy", ["default_serve_mix", "paper_llama_mix",
                                    "extended_mix"])
def test_serve_param_bytes(policy):
    for arch in PC.ARCH_IDS:
        for quant in (True, False):
            _close(FL.serve_param_bytes(PC.get_arch(arch), quant, policy),
                   JFL.serve_param_bytes(JC.get_arch(arch), quant, policy))


def test_roofline_matches_reference_at_card_rates(monkeypatch):
    """Every property of the reference's Roofline, the rates being the
    H100's (989 TFLOP/s, 3.35 TB/s, 450 GB/s)."""
    assert (AN.PEAK_FLOPS, AN.HBM_BW, AN.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    monkeypatch.setattr(JAN, "PEAK_FLOPS", AN.PEAK_FLOPS)
    monkeypatch.setattr(JAN, "HBM_BW", AN.HBM_BW)
    monkeypatch.setattr(JAN, "LINK_BW", AN.LINK_BW)
    cases = [
        dict(flops_per_chip=3.1e13, bytes_per_chip=2.0e11,
             coll_bytes_per_chip=4.0e9, coll_breakdown={"all-gather": 4},
             model_flops=7.0e15, n_chips=256, bytes_analytic_per_chip=9e9),
        dict(flops_per_chip=1e9, bytes_per_chip=5e10,
             coll_bytes_per_chip=0.0, coll_breakdown={}, model_flops=2e11,
             n_chips=16),
        dict(flops_per_chip=1e12, bytes_per_chip=1e6,
             coll_bytes_per_chip=9e11, coll_breakdown={}, model_flops=0.0,
             n_chips=512),
    ]
    for kw in cases:
        j, p = JAN.Roofline(**kw), AN.Roofline(**kw)
        jd, pd = j.as_dict(), p.as_dict()
        assert sorted(jd) == sorted(pd)
        for k in jd:
            if isinstance(jd[k], float):
                _close(pd[k], jd[k])
            else:
                assert pd[k] == jd[k], k
    assert [f.name for f in dataclasses.fields(AN.Roofline)] == [
        f.name for f in dataclasses.fields(JAN.Roofline)]


def test_memory_stats_total():
    """``total_hbm_bytes`` = argument + output + temp - alias, as the
    reference sums it; temp is the tracked peak above the arguments."""
    tr = AN.RankTracker()
    tr.peak = 1500
    m = AN.memory_stats(tr, argument=1000, output=300, alias=200)
    assert m["temp_size_in_bytes"] == 500
    assert m["total_hbm_bytes"] == 1000 + 300 + 500 - 200
