"""SLO admission in the port's engine: priorities, TTFT deadlines, the
bounded queue (``EngineSaturated``), preemption and ``on_done``.

Against the reference: one scripted sequence (fixed arrival stamps,
priorities, deadlines, a bounded queue, a preempting arrival injected
through ``run(poll=)``) gives the JAX engine's admission order, preempted
ids, ``on_done`` records, ``deadline_misses``, ``preemptions`` and
``EngineSaturated`` reasons. Admission is host bookkeeping, so these are
compared exactly; the model is reduced tinyllama in f32 packed with
``paper_llama_mix`` on both sides.

The reference's contracts (``tests/test_engine_scheduler.py``, the SLO
cases) run port against port.
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineSaturated as JEngineSaturated
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs.base import get_arch as p_get_arch
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Engine, EngineSaturated, ServeConfig

torch.set_num_threads(2)

SCRIPT_CFG = dict(max_new_tokens=6, cache_len=64, decode_chunk=2,
                  max_slots=2, prefill_batch=2, max_queue=3, preempt=True)


def _prompts(vocab, n, lo=2, hi=9, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, int(k))]
            for k in rng.integers(lo, hi, n)]


def _script(eng, saturated, vocab):
    """Drive one SLO scenario; returns what it observed."""
    t0 = time.perf_counter()
    p = _prompts(vocab, 8, seed=3)
    order, done, reasons = [], [], []

    def first(rid, tok):
        if rid not in order:
            order.append(rid)

    def on_done(r):
        done.append((r.id, r.cancelled, r.preempted, r.deadline_missed,
                     len(r.tokens)))

    def submit(i, **kw):
        try:
            return eng.submit(p[i], on_token=first, on_done=on_done, **kw)
        except saturated as e:
            reasons.append(e.reason)
            return None
    # a missed deadline (arrived 100 s ago, 1 s to first token), a met
    # one, a later arrival with an earlier deadline than the first two,
    # and a fourth that the bounded queue (3) rejects
    submit(0, arrival_t=t0 - 100.0, deadline_s=1.0)
    submit(1, arrival_t=t0 - 50.0, deadline_s=1e6)
    submit(2, arrival_t=t0, deadline_s=1e3)
    submit(3, arrival_t=t0)
    polls = [0]

    def poll():
        polls[0] += 1
        if polls[0] == 3:               # both slots busy: preempt one
            submit(4, priority=1, arrival_t=t0)
            submit(5, priority=1, arrival_t=t0, deadline_s=1e6)
        if polls[0] == 5:
            submit(6, priority=-1, arrival_t=t0)
    res = eng.run(poll=poll)
    s = eng.stats
    return dict(order=order, done=sorted(done), reasons=reasons,
                tokens={k: len(v) for k, v in res.items()},
                deadline_misses=s["deadline_misses"],
                preemptions=s["preemptions"])


@pytest.fixture(scope="module")
def bridged():
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(dtype="float32")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qp, _ = j_quantize_params(params, j_get_policy("paper_llama_mix"))
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    pcfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32")
    return cfg, qp, pcfg, pqp


@pytest.fixture(scope="module")
def jax_script(bridged):
    cfg, qp, _, _ = bridged
    return _script(JEngine(cfg, qp, JServeConfig(**SCRIPT_CFG)),
                   JEngineSaturated, cfg.vocab_size)


def test_scripted_slo_sequence_matches_reference(bridged, jax_script):
    _, _, pcfg, pqp = bridged
    got = _script(Engine(pcfg, pqp, ServeConfig(**SCRIPT_CFG), device="cpu"),
                  EngineSaturated, pcfg.vocab_size)
    assert got == jax_script
    # the script exercises what it claims
    assert got["reasons"] == ["queue_full"]
    assert got["preemptions"] >= 1 and got["deadline_misses"] >= 1
    assert any(pre for _, _, pre, _, _ in got["done"])


def test_page_pool_saturation_matches_reference(bridged):
    cfg, qp, pcfg, pqp = bridged
    kw = dict(max_queue=8, max_new_tokens=4, prefix_cache=True,
              prefix_page=8, prefix_bytes=1, cache_len=64)
    long_p = _prompts(cfg.vocab_size, 1, lo=20, hi=21)[0]   # 3 pages > 2
    reasons = []
    for eng, exc in ((JEngine(cfg, qp, JServeConfig(**kw)), JEngineSaturated),
                     (Engine(pcfg, pqp, ServeConfig(**kw), device="cpu"),
                      EngineSaturated)):
        with pytest.raises(exc) as ei:
            eng.submit(long_p)
        reasons.append((ei.value.reason, eng._prefix.capacity))
    assert reasons[0] == reasons[1] == ("page_pool_saturated", 2)


# ---------------------------------------------------------------------------
# the reference's contracts, port against port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = p_get_arch("tinyllama-1.1b", reduced=True)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def _engine(model, **kw):
    cfg, params = model
    base = dict(max_new_tokens=6, cache_len=64, decode_chunk=6, max_slots=2)
    base.update(kw)
    return Engine(cfg, params, ServeConfig(**base), device="cpu")


def test_ttft_percentiles_and_slo_stats(model):
    cfg, _ = model
    eng = _engine(model, max_slots=2)
    eng.generate(_prompts(cfg.vocab_size, 5))
    s = eng.stats
    assert 0 < s["ttft_p50_s"] <= s["ttft_p99_s"]
    assert s["ttft_s"] > 0 and s["queue_wait_s"] >= 0.0
    assert s["deadline_misses"] == 0 and s["preemptions"] == 0


def test_single_priority_parity_with_slo_features_enabled(model):
    cfg, _ = model
    prompts = _prompts(cfg.vocab_size, 5, seed=14)
    plain = _engine(model).generate(prompts)
    slo = _engine(model, preempt=True, max_queue=50)
    ids = [slo.submit(p, priority=0) for p in prompts]
    res = slo.run()
    assert [res[i] for i in ids] == plain


def test_deadline_ordered_admission_beats_fifo(model):
    cfg, _ = model
    a_p, b_p = _prompts(cfg.vocab_size, 2, seed=15)
    order_fifo, order_slo = [], []

    def first(order):
        return lambda rid, tok: (order.append(rid)
                                 if rid not in order else None)
    fifo = _engine(model, max_slots=1)
    fa = fifo.submit(a_p, on_token=first(order_fifo))
    fb = fifo.submit(b_p, on_token=first(order_fifo))
    fifo.run()
    assert order_fifo == [fa, fb]
    slo = _engine(model, max_slots=1)
    done = {}
    sa = slo.submit(a_p, on_token=first(order_slo))
    sb = slo.submit(b_p, on_token=first(order_slo), deadline_s=30.0,
                    on_done=lambda r: done.setdefault("b", r))
    slo.run()
    assert order_slo == [sb, sa]
    assert not done["b"].deadline_missed


def test_deadline_miss_accounting(model):
    cfg, _ = model
    eng = _engine(model)
    got = {}
    eng.submit(_prompts(cfg.vocab_size, 1, seed=22)[0], deadline_s=0.0,
               on_done=lambda r: got.setdefault("miss", r))
    eng.submit(_prompts(cfg.vocab_size, 1, seed=23)[0], deadline_s=1e9,
               on_done=lambda r: got.setdefault("ok", r))
    eng.run()
    assert got["miss"].deadline_missed and not got["ok"].deadline_missed
    assert eng.stats["deadline_misses"] == 1


def test_backpressure_structured_rejection(model):
    cfg, _ = model
    eng = _engine(model, max_queue=2)
    p = _prompts(cfg.vocab_size, 3)
    eng.submit(p[0])
    eng.submit(p[1])
    with pytest.raises(EngineSaturated) as ei:
        eng.submit(p[2])
    assert ei.value.reason == "queue_full"
    assert "max_queue=2" in ei.value.detail
    eng.run()
    rid = eng.submit(p[2])
    assert len(eng.run()[rid]) == 6


def test_backpressure_page_pool_saturation(model):
    cfg, _ = model
    eng = _engine(model, max_queue=8, max_new_tokens=4, prefix_cache=True,
                  prefix_page=8, prefix_bytes=1)
    with pytest.raises(EngineSaturated) as ei:
        eng.submit(_prompts(cfg.vocab_size, 1, lo=20, hi=21)[0])
    assert ei.value.reason == "page_pool_saturated"
    short = _prompts(cfg.vocab_size, 1, lo=4, hi=6)[0]
    assert len(eng.generate([short])[0]) == 4


def test_preemption_keeps_streamed_tokens(model):
    cfg, _ = model
    eng = _engine(model, max_slots=1, max_new_tokens=12, decode_chunk=2,
                  preempt=True)
    done, low_toks, hi = {}, [], []

    def low_cb(rid, tok):
        low_toks.append(tok)
        if len(low_toks) == 2:
            hi.append(eng.submit(
                _prompts(cfg.vocab_size, 1, seed=17)[0], priority=1,
                on_done=lambda r: done.setdefault("hi", r)))
    low = eng.submit(_prompts(cfg.vocab_size, 1, seed=16)[0],
                     on_token=low_cb,
                     on_done=lambda r: done.setdefault("low", r))
    res = eng.run()
    assert done["low"].preempted and done["low"].cancelled
    assert 2 <= len(res[low]) < 12
    assert res[low] == low_toks
    assert len(res[hi[0]]) == 12
    assert eng.stats["preemptions"] == 1
    assert not done["hi"].preempted


def test_equal_priority_never_preempts(model):
    cfg, _ = model
    eng = _engine(model, max_slots=1, preempt=True)
    ids = [eng.submit(p) for p in _prompts(cfg.vocab_size, 3, seed=18)]
    res = eng.run()
    assert eng.stats["preemptions"] == 0
    assert all(len(res[i]) == 6 for i in ids)


def test_on_done_fires_once_per_request(model):
    """Finish, cancel while queued, cancel in a slot and preemption each
    land in one on_done call."""
    cfg, _ = model
    eng = _engine(model, max_slots=2, decode_chunk=2, preempt=True)
    calls = []
    p = _prompts(cfg.vocab_size, 5, seed=19)
    on_done = lambda r: calls.append(r.id)

    def cancel_self(rid, tok):
        if tok is not None:
            eng.cancel(rid)
            eng.cancel(rid)
    ids = [eng.submit(p[0], on_done=on_done),
           eng.submit(p[1], on_done=on_done, on_token=cancel_self),
           eng.submit(p[2], on_done=on_done)]
    assert eng.cancel(ids[2])
    polls = [0]

    def poll():
        polls[0] += 1
        if polls[0] == 2:
            ids.append(eng.submit(p[3], priority=2, on_done=on_done))
    eng.run(poll=poll)
    assert sorted(calls) == sorted(ids)
