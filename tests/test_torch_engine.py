"""The port's serving engine against the reference engine.

The workload is ``examples/serve_quantized.py``'s (the paper's Table IV
scenario): reduced tinyllama in bf16 packed with ``paper_llama_mix``, six
requests of 6-token prompts, 10 new tokens each, 2 slots, ``cache_len``
32. Both engines get the same packed weights (the reference's, bridged)
and the same prompts, and must give the same greedy tokens.

Greedy decoding turns a logit difference into a token difference only on
a near-tie. The two frameworks round bf16 at different places, and the
LM head emits bf16 logits (steps of 2**-6 = 0.016 at magnitude 2 to 4), so
exact ties occur. A divergence is accepted only where the test shows that
the reference's own top-2 logit margin at that step is below
``MARGIN_TOL`` = 0.1, about six bf16 steps of such logits. After an
accepted divergence the rest of that request is not compared, since the
two continuations differ by construction. (On this workload one request
diverges at its 9th token, where the reference's top-2 logits tie
exactly.)
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs.base import get_arch as p_get_arch
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

MARGIN_TOL = 0.1
SCFG = dict(max_new_tokens=10, max_slots=2, decode_chunk=10, cache_len=32)


@pytest.fixture(scope="module")
def workload():
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qp, _ = j_quantize_params(params, j_get_policy("paper_llama_mix"))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 6)]
               for _ in range(6)]
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    return cfg, qp, pqp, prompts


def _port_engine(pqp, **kw):
    cfg = p_get_arch("tinyllama-1.1b", reduced=True)
    return Engine(cfg, pqp, ServeConfig(**{**SCFG, **kw}), device="cpu")


def _ref_margin(cfg, qp, seq):
    """The reference model's top-2 logit margin predicting the token after
    ``seq`` (a full-sequence forward, same packed weights)."""
    logits, _, _ = JT.forward_seq(qp, cfg, tokens=np.asarray([seq], np.int32))
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


def test_greedy_tokens_match_reference_engine(workload):
    cfg, qp, pqp, prompts = workload
    jeng = JEngine(cfg, qp, JServeConfig(**SCFG))
    streamed = {}
    for p in prompts:
        jeng.submit(p)
    jres = jeng.run()
    peng = _port_engine(pqp)
    ids = [peng.submit(p, on_token=lambda rid, t: streamed.setdefault(
        rid, []).append(t)) for p in prompts]
    pres = peng.run()
    assert streamed == pres                 # callbacks saw every token
    compared = 0
    for rid, prompt in zip(ids, prompts):
        ref, got = jres[rid], pres[rid]
        assert len(got) == len(ref) == SCFG["max_new_tokens"]
        for t, (a, b) in enumerate(zip(ref, got)):
            if a != b:
                margin = _ref_margin(cfg, qp, prompt + ref[:t])
                assert margin < MARGIN_TOL, (rid, t, a, b, margin)
                break
            compared += 1
    # ties are rare: nearly every token must have been compared
    assert compared >= 0.8 * len(prompts) * SCFG["max_new_tokens"]
    s = peng.stats
    assert s["requests"] == len(prompts) and s["tokens"] == 60
    assert s["host_syncs"] == s["prefill_groups"] + s["chunks"]


def test_batched_admission_equals_sequential(workload):
    _, _, pqp, prompts = workload
    prompts = prompts + [[5, 6, 7], list(range(1, 19))]   # ragged lengths
    batched = _port_engine(pqp, max_slots=4, prefill_batch=4,
                           cache_len=64).generate(prompts)
    seq = _port_engine(pqp, max_slots=4, prefill_batch=1,
                       cache_len=64).generate(prompts)
    assert batched == seq


def test_generate_equals_generate_reference(workload):
    _, _, pqp, prompts = workload
    eng = _port_engine(pqp, decode_chunk=3)     # several chunks per request
    got = eng.generate(prompts[:2])
    assert eng.stats["chunks"] >= 3
    assert got == eng.generate_reference(prompts[:2])


def test_budgets_eos_and_cancel(workload):
    _, _, pqp, prompts = workload
    eng = _port_engine(pqp)
    full = eng.generate(prompts[:2])
    eng = _port_engine(pqp, eos_id=full[0][3])
    assert eng.generate(prompts[:1])[0] == full[0][:4]   # stops at EOS
    eng = _port_engine(pqp)
    a = eng.submit(prompts[0], max_new_tokens=1)
    b = eng.submit(prompts[1], on_token=lambda rid, t: eng.cancel(rid))
    res = eng.run()
    assert res[a] == full[0][:1]
    assert res[b] == full[1][:1]            # cancelled at its first token
    with pytest.raises(ValueError, match="exceeds cache_len"):
        eng.submit(list(range(30)))


@pytest.mark.parametrize("field,value", [("drafter", "ngram"),
                                         ("prefix_cache", True), ("tp", 2),
                                         ("max_queue", 4), ("preempt", True)])
def test_unported_features_raise(workload, field, value):
    """No feature of the reference's engine is left unported (tensor
    parallelism was the last): each one, alone and beside tp=2 (two CPU
    ranks), serves the plain engine's tokens."""
    _, _, pqp, prompts = workload
    want = _port_engine(pqp).generate(prompts[:2])
    if field != "tp":
        assert _port_engine(pqp, **{field: value}).generate(
            prompts[:2]) == want
    with _port_engine(pqp, **{field: value, "tp": 2}) as eng:
        assert eng.tp_backend == "gloo"
        assert eng.generate(prompts[:2]) == want
