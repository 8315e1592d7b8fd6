"""Disaggregated serving over tensor-parallel engines
(``repro_torch.serving.disagg`` at ``ServeConfig.tp`` > 1), on CPU gloo
groups.

Every prefill and decode worker opens on one group, on one weight shard
set a rank; the page hand-off gathers the prefill worker's kv heads in
rank order and hands each decode rank its own. Held here: the 1P+1D
tp = 2 greedy matrix (causal, windowed and int8 KV rings, speculation off
and on) against the monolithic tp = 1 engine, cache off; temperature
1P+1D; 2P+2D; 1P+1D at tp = 4; "sliced" against the monolithic tp = 2
"sliced" engine; reduced olmoe at tp = 2 with expert parallelism against
tp = 1; the reference's ``DisaggEngine`` (tp = 1, its own weights moved
by the bridge) against the port's at tp = 2; one shard set a rank (the
workers' weights share storage on rank 0 and on every worker, read
through ``TPGroup.map``); the tp = 2 prefill tier's pages equal the
tp = 1 tier's bit for bit; ``close()`` with a group of its own (no worker
left) and with one passed in (left open); a failing program raising and
closing the engine; cancel mid-wave, the stats sums and the router
counts; the HTTP front end over a tp = 2 ``DisaggEngine``, a timeout
landing mid-wave.

Ranks rendezvous through a FileStore in a temporary directory, and
engines share one group of each size (``GroupCache``), closed when the
module ends. Ranks run one thread each, and so does this process.
"""
import http.client
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.serving.disagg import DisaggEngine as JDisaggEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.distributed import group as G
from repro_torch.distributed.group import GroupCache
from repro_torch.models import transformer as T
from repro_torch.serving.disagg import DisaggEngine
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.frontend import Frontend, FrontendConfig

BASE = dict(max_new_tokens=5, cache_len=64, decode_chunk=5, max_slots=2,
            prefill_bucket=4, prefill_chunk=16, prefix_page=8)
TIMEOUT_S = 120.0
MARGIN_TOL = 0.1


@pytest.fixture(scope="module")
def groups():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = GroupCache(lambda n: ["cpu"] * n, timeout_s=TIMEOUT_S)
    yield cache
    cache.close()
    torch.set_num_threads(threads)


def _model(arch, **cfg_kw):
    cfg = get_arch(arch, reduced=True).replace(**cfg_kw)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


@pytest.fixture(scope="module")
def causal():
    # four kv heads, so the pages shard at tp = 4 too
    return _model("tinyllama-1.1b", n_kv_heads=4)


@pytest.fixture(scope="module")
def windowed():
    return _model("h2o-danube-1.8b")               # window = 64


@pytest.fixture(scope="module")
def int8kv():
    return _model("llama3.2-1b", kv_cache_quant=True, dtype="float32")


def _prompts(vocab, n, shared_len=24, uniq=(3, 9), seed=0):
    """A shared-system-prompt queue plus one sub-page prompt (the
    router's direct-to-decode path)."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, vocab, shared_len)]
    ps = [shared + [int(t) for t in rng.integers(
        0, vocab, int(rng.integers(*uniq)))] for _ in range(n)]
    ps.append([int(t) for t in rng.integers(0, vocab, 4)])
    return ps


def _mono(model, **kw):
    """The monolithic tp = 1 engine's tokens (cache off)."""
    cfg, params = model
    return lambda prompts: Engine(cfg, params,
                                  ServeConfig(**dict(BASE, **kw)),
                                  device="cpu").generate(prompts)


def _disagg(model, groups, tp=2, p=1, d=1, **kw):
    cfg, params = model
    return DisaggEngine(cfg, params, ServeConfig(tp=tp, **dict(BASE, **kw)),
                        prefill_workers=p, decode_workers=d, device="cpu",
                        group=groups.get(tp) if tp > 1 else None)


@pytest.mark.parametrize("fixture", ["causal", "windowed", "int8kv"])
@pytest.mark.parametrize("spec", [False, True])
def test_greedy_parity_matrix_tp2(fixture, spec, request, groups):
    """1P+1D at tp = 2 serves the monolithic tp = 1 engine's tokens; the
    pages migrate, the decode tier reuses them, and a repeat run stays
    warm and equal."""
    model = request.getfixturevalue(fixture)
    kw = dict(drafter="ngram", draft_k=4) if spec else {}
    prompts = _prompts(model[0].vocab_size, 4, seed=1)
    expect = _mono(model, **kw)(prompts)
    with _disagg(model, groups, **kw) as dis:
        assert dis.generate(prompts) == expect
        s = dis.stats
        assert s["migrated_pages"] > 0 and s["prefix_hits"] > 0
        assert s["router"]["direct_decode"] == 1
        assert s["handoff_bytes"] > 0 and s["handoff_pipe_bytes"] > 0
        if spec:
            assert s["spec_rounds"] > 0
        assert dis.generate(prompts) == expect


def test_temperature_parity_1p1d_tp2(causal, groups):
    """Every rank draws from the numbered stream rank 0's engine ships
    with each program, so the sampled tokens are tp = 1's, monolithic or
    disaggregated."""
    prompts = _prompts(causal[0].vocab_size, 4, seed=2)
    kw = dict(temperature=0.7, seed=3)
    expect = _mono(causal, **kw)(prompts)
    assert expect != _mono(causal)(prompts)             # it sampled
    with _disagg(causal, groups, tp=1, **kw) as one:
        assert one.generate(prompts) == expect
    with _disagg(causal, groups, **kw) as dis:
        assert dis.generate(prompts) == expect


def test_multiworker_greedy_parity_tp2(causal, groups):
    """2P+2D at tp = 2: four engines on one group of two ranks."""
    prompts = _prompts(causal[0].vocab_size, 5, seed=4)
    with _disagg(causal, groups, p=2, d=2) as dis:
        assert dis.generate(prompts) == _mono(causal)(prompts)
        rt = dis.stats["router"]
        assert all(n > 0 for n in rt["decode_requests"])
        assert rt["migrated_pages_total"] > 0
        assert {e._group for e in dis.prefill_engines
                + dis.decode_engines} == {dis.group}


def test_greedy_parity_1p1d_tp4(causal, groups):
    prompts = _prompts(causal[0].vocab_size, 4, seed=3)
    with _disagg(causal, groups, tp=4) as dis:
        assert dis.decode_engines[0]._plan.attn
        assert dis.generate(prompts) == _mono(causal)(prompts)
        assert dis.stats["migrated_pages"] > 0


def test_sliced_disagg_equals_the_sliced_engine(causal, groups):
    """"sliced" agrees with tp = 1 only to a tolerance; through the tiers
    it serves what one "sliced" tp = 2 engine serves."""
    prompts = _prompts(causal[0].vocab_size, 4, seed=5)
    cfg, params = causal
    with Engine(cfg, params, ServeConfig(tp=2, tp_matmul="sliced", **BASE),
                device="cpu", group=groups.get(2)) as mono:
        expect = mono.generate(prompts)
    with _disagg(causal, groups, tp_matmul="sliced") as dis:
        assert dis.generate(prompts) == expect


def test_moe_ep_parity_1p1d_tp2(groups):
    """Reduced olmoe at tp = 2, each rank the products of 2 of the 4
    experts: the routed tokens are tp = 1's."""
    model = _model("olmoe-1b-7b")
    prompts = _prompts(model[0].vocab_size, 4, shared_len=40, seed=5)
    expect = _mono(model)(prompts)
    with _disagg(model, groups) as dis:
        assert dis.decode_engines[0]._plan.moe_ep
        assert dis.generate(prompts) == expect
        assert dis.stats["migrated_pages"] > 0


def test_prefill_pages_equal_tp1_bit_for_bit(int8kv, groups):
    """The tp = 2 prefill tier's exported pages (int8 codes and f32
    scales) are the tp = 1 tier's, the kv heads gathered in rank
    order."""
    prompts = _prompts(int8kv[0].vocab_size, 3, seed=7)
    with _disagg(int8kv, groups, tp=1) as one, \
            _disagg(int8kv, groups) as two:
        assert one.generate(prompts) == two.generate(prompts)
        for p in prompts[:-1]:
            want = one.prefill_engines[0].export_kv_pages(p)
            got = two.prefill_engines[0].export_kv_pages(p)
            assert got.tokens == want.tokens
            assert got.n_pages == want.n_pages == len(p) // 8 >= 3
            assert set(got.payload) == {"k", "v", "k_scale", "v_scale"}
            for k, v in want.payload.items():
                assert torch.equal(got.payload[k].view(torch.uint8),
                                   v.view(torch.uint8)), k


def test_one_weight_shard_set_a_rank(causal, groups):
    """2P+2D: every worker's weights on rank 0 are one tree of views, and
    on the worker rank the four engine mirrors list the same storages."""
    with _disagg(causal, groups, p=2, d=2) as dis:
        engines = dis.prefill_engines + dis.decode_engines
        mine = [G.tree_storages(e.params) for e in engines]
        assert all(m == mine[0] for m in mine)
        assert all(e.params is engines[0].params for e in engines)
        ranks = dis.group.map(G.engine_weight_storages, [()] * 2)
        assert ranks[0] == {}
        worker = ranks[1]
        eids = {e._eid for e in engines}
        assert eids <= set(worker)
        assert len({tuple(worker[i]) for i in eids}) == 1


def test_close_with_a_group_passed_in_leaves_it_open(causal, groups):
    group = groups.get(2)
    dis = _disagg(causal, groups)
    eids = [e._eid for e in dis.prefill_engines + dis.decode_engines]
    dis.close()
    dis.close()
    assert dis.closed and not group.closed
    assert all(e._closed for e in dis.prefill_engines + dis.decode_engines)
    assert not set(eids) & set(group.map(G.engine_weight_storages,
                                         [()] * 2)[1])
    with pytest.raises(RuntimeError, match="closed"):
        dis.generate([[1, 2, 3]])
    with pytest.raises(RuntimeError, match="closed"):
        dis.submit([1, 2, 3])
    with _disagg(causal, groups) as again:     # the group still serves
        assert again.generate([[1, 2, 3]]) == _mono(causal)([[1, 2, 3]])


def test_disagg_cancel_mid_wave_tp2(causal, groups):
    """A cancel from ``poll`` reaches a request in the current wave before
    its hand-off (no tokens, ``on_done`` once) and one being decoded (it
    keeps what it streamed), at tp = 2 as at tp = 1."""
    vocab = causal[0].vocab_size
    rng = np.random.default_rng(9)
    a, b = ([int(t) for t in rng.integers(0, vocab, 20)] for _ in range(2))
    with _disagg(causal, groups, max_new_tokens=20, decode_chunk=1) as dis:
        done = []
        ra = dis.submit(a, on_done=lambda r: done.append(r.id))
        rb = dis.submit(b, max_new_tokens=20,
                        on_done=lambda r: done.append(r.id))
        polls = []

        def poll():
            polls.append(len(polls))
            if len(polls) == 2:             # inside the prefill worker's run
                assert dis.cancel(ra)
            if len(dis.decode_engines[0]._results) == 0 and any(
                    r is not None and len(r.tokens) >= 3
                    for r in dis.decode_engines[0]._slots):
                dis.cancel(rb)
        res = dis.run(poll=poll)
        assert res[ra] == [] and 3 <= len(res[rb]) < 20
        assert sorted(done) == [ra, rb]


def test_stats_sum_the_tiers_and_the_router_counts_tp2(causal, groups):
    prompts = _prompts(causal[0].vocab_size, 4, seed=6)
    with _disagg(causal, groups) as dis:
        out = dis.generate(prompts)
        s = dis.stats
        pw, dw = dis.prefill_engines[0].stats, dis.decode_engines[0].stats
        assert s["forwards"] == pw["forwards"] + dw["forwards"]
        assert s["prefill_forwards"] == (pw["prefill_forwards"]
                                         + dw["prefill_forwards"])
        assert s["tokens"] == sum(len(t) for t in out) == 5 * len(prompts)
        assert s["prefill_prefix_hits"] == pw["prefix_hits"]
        rt = s["router"]
        assert rt["prefill_requests"] == [len(prompts) - 1]
        assert rt["decode_requests"] == [len(prompts)]
        assert rt["direct_decode"] == 1
        # every request exports its whole chain of full pages; the decode
        # worker imports each distinct page once
        chains = [p[:8 * (q + 1)] for p in prompts[:-1]
                  for q in range(len(p) // 8)]
        assert rt["migrated_pages_total"] == s["migrated_pages"] == len(
            {tuple(c) for c in chains})
        cfg = causal[0]         # a page: k and v of (L, page, KH, Dh), bf16
        page = 2 * cfg.n_layers * 8 * cfg.n_kv_heads * cfg.d_head * 2
        assert s["handoff_bytes"] == len(chains) * page
        json.dumps(s)


def _fail(*_a, **_k):
    raise RuntimeError("injected export failure")


def test_a_failing_program_closes_the_engine(causal, groups, monkeypatch):
    """A program that raises on rank 0 aborts the engine's own group: the
    run raises, the engine counts as closed, no worker is left, and
    nothing serves on at tp = 1."""
    groups.close()                  # this engine opens its own group
    dis = DisaggEngine(causal[0], causal[1], ServeConfig(tp=2, **BASE),
                       device=["cpu"] * 2)
    procs = list(dis.group._procs)
    monkeypatch.setattr(Engine, "_export_device", _fail)
    with pytest.raises(RuntimeError, match="injected"):
        dis.generate(_prompts(causal[0].vocab_size, 2, seed=8))
    assert dis.closed and dis.group.closed
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        dis.generate([[1, 2, 3]])
    monkeypatch.undo()
    with DisaggEngine(causal[0], causal[1], ServeConfig(tp=2, **BASE),
                      device=["cpu"] * 2) as own:
        procs = list(own.group._procs)
        assert own.generate([[1, 2, 3]]) == _mono(causal)([[1, 2, 3]])
    assert own.group.closed and not any(p.is_alive() for p in procs)


def test_front_end_over_a_tp2_disagg_engine(causal, groups):
    """The HTTP front end drives a tp = 2 ``DisaggEngine`` from its engine
    thread: a completion gives the engine's tokens, and a request timeout
    lands mid-wave ("timeout", fewer tokens than asked)."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    with _disagg(causal, groups, max_new_tokens=8, decode_chunk=1,
                 max_slots=1, cache_len=128) as dis:
        want = dis.generate([prompt])[0]
        front = Frontend(dis, FrontendConfig(model_name="tiny-tp",
                                             request_timeout_s=30.0)).start()
        try:
            body = _post(front.port, dict(prompt=prompt, max_tokens=8))
            assert body["choices"][0]["token_ids"] == want
            body = _post(front.port, dict(prompt=prompt, max_tokens=64,
                                          timeout_s=0.001))
            assert body["choices"][0]["finish_reason"] == "timeout"
            assert len(body["choices"][0]["token_ids"]) < 64
        finally:
            front.close()


def _post(port, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=90)
    conn.request("POST", "/v1/completions", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, body
    return body


def test_reference_disagg_tp1_equals_port_tp2(groups):
    """The reference's 1P+1D ``DisaggEngine`` (tp = 1) on its own weights
    and the port's at tp = 2 on the same weights, moved by the bridge
    (f32): the same tokens under the top-2 margin rule."""
    jcfg = j_get_arch("tinyllama-1.1b", reduced=True).replace(
        n_kv_heads=4, dtype="float32")
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(
        n_kv_heads=4, dtype="float32")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jp))
    prompts = _prompts(cfg.vocab_size, 3, seed=10)
    ref = JDisaggEngine(jcfg, jp, JServeConfig(**BASE)).generate(prompts)
    ref = [[int(t) for t in r] for r in ref]
    with _disagg((cfg, params), groups) as dis:
        got = dis.generate(prompts)
        assert dis.stats["migrated_pages"] > 0
    for prompt, want, have in zip(prompts, ref, got):
        assert len(have) == len(want)
        for t, (a, b) in enumerate(zip(want, have)):
            if a != b:
                logits, _, _ = JT.forward_seq(
                    jp, jcfg, tokens=np.asarray([prompt + want[:t]],
                                                np.int32))
                top = np.sort(np.asarray(logits[0, -1], np.float32))
                assert top[-1] - top[-2] < MARGIN_TOL
                break
