"""The port's engine on the MoE family against the reference's engine:
olmoe-1b-7b and granite-moe-3b-a800m, reduced.

The engines run the f32 model (packed under ``default_serve_mix``, the
ring bf16): in bf16 activations the reduced 4-expert router has near
ties (a 2nd/3rd-logit gap of 0.008 on a served prompt) that a one-ulp
difference upstream flips. Greedy tokens equal the reference engine's
under the top-2 margin rule of ``tests/test_torch_engine.py``, plain and
with the ngram drafter (against the reference's speculative engine), and
the prefix cache's cold and warm runs give the cache-off tokens; with
``capacity_factor=1.0`` (drops) warm equals cold too, since a warm MoE
group keeps the cold grid's whole chunks, where a dense group prefills
its suffix in a chunk of its own length.

Both sides serve the same packed bytes: the reference's tree, packed
under ``jax.jit`` (the packing's bytes are held against the reference's
eager packing in ``tests/test_torch_moe.py``), moved to the port by
``bridge``. The reference's compiles dominate the file's time.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
POLICY = "default_serve_mix"
MARGIN_TOL = 0.1        # tests/test_torch_engine.py's top-2 margin rule
SCFG = dict(max_new_tokens=8, max_slots=2, decode_chunk=8, cache_len=64,
            prefill_batch=4, prefill_chunk=8, prefill_bucket=4)


def _prompts(vocab, n=5, shared_len=12, own=8, seed=0):
    """A shared prefix plus ``own`` tokens each (the prefix cache's
    workload; one length keeps the reference engine's compiles few); the
    first prompt repeats a bigram (the ngram drafter's)."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, vocab, shared_len)]
    ps = [shared + [int(t) for t in rng.integers(0, vocab, own)]
          for _ in range(n)]
    ps[0] = shared + [7, 11] * (own // 2)
    return ps


def _packed_reference(cfg):
    """The reference's seeded f32 parameters packed under POLICY, both
    under ``jax.jit``."""
    params = jax.jit(JT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    return jax.jit(lambda p: j_quantize_params(p, j_get_policy(POLICY))[0])(
        params)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The f32 model packed under default_serve_mix on both sides, the
    prompts, the reference engine's tokens plain and with the ngram
    drafter, and the reference's top-2 margin oracle."""
    arch = request.param
    cfg = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    qp = _packed_reference(cfg)
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    pcfg = PC.get_arch(arch, reduced=True).replace(dtype="float32")
    prompts = _prompts(cfg.vocab_size)
    # one reference engine (its compiles dominate): speculating, then the
    # same queue submitted plain
    spec = JEngine(cfg, qp, JServeConfig(**SCFG, drafter="ngram"))
    spec_res = spec.generate(prompts)
    spec_stats = dict(spec.stats)
    ids = [spec.submit(p, speculate=False) for p in prompts]
    res = spec.run()
    plain = [res[i] for i in ids]

    def margin(seq):
        logits, _, _ = JT.forward_seq(qp, cfg,
                                      tokens=np.asarray([seq], np.int32))
        top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
        return float(top[1] - top[0])
    return pcfg, pqp, prompts, plain, (spec_res, spec_stats), margin


def _assert_margin_match(refs, gots, prompts, margin):
    compared = total = 0
    for prompt, ref, got in zip(prompts, refs, gots):
        assert len(got) == len(ref)
        total += len(ref)
        t = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                 None)
        if t is not None:
            m = margin(prompt + ref[:t])
            assert m < MARGIN_TOL, (t, ref[t], got[t], m)
        compared += len(ref) if t is None else t
    assert compared >= 0.8 * total


def test_engine_matches_reference_engine(served):
    pcfg, pqp, prompts, jres, _, margin = served
    eng = Engine(pcfg, pqp, ServeConfig(**SCFG), device="cpu")
    got = eng.generate(prompts)
    _assert_margin_match(jres, got, prompts, margin)
    assert eng.generate_reference(prompts[:2]) == got[:2]
    one = Engine(pcfg, pqp, ServeConfig(**dict(SCFG, prefill_batch=1)),
                 device="cpu")
    assert one.generate(prompts) == got


def test_ngram_engine_matches_reference_spec_engine(served):
    pcfg, pqp, prompts, _, (jres, jstats), margin = served
    eng = Engine(pcfg, pqp, ServeConfig(**SCFG, drafter="ngram"),
                 device="cpu")
    got = eng.generate(prompts)
    _assert_margin_match(jres, got, prompts, margin)
    assert eng.stats["spec_rounds"] > 0 and eng.stats["draft_accepted"] > 0
    if got == jres:                     # the acceptance bookkeeping too
        keys = ("draft_tokens", "draft_accepted", "spec_rounds")
        assert {k: eng.stats[k] for k in keys} == {k: jstats[k]
                                                   for k in keys}


def test_prefix_cache_warm_equals_cold(served):
    """Cache off, then on twice (cold, then warm): the same tokens, and
    the reference's under the margin rule."""
    pcfg, pqp, prompts, jres, _, margin = served
    scfg = dict(SCFG, prefix_page=4)
    off = Engine(pcfg, pqp, ServeConfig(**scfg), device="cpu").generate(
        prompts)
    on = Engine(pcfg, pqp, ServeConfig(**scfg, prefix_cache=True),
                device="cpu")
    assert on.generate(prompts) == off
    assert on.generate(prompts) == off
    assert on.stats["prefix_hits"] == len(prompts)
    assert on.stats["prefix_tokens_reused"] >= 8 * len(prompts)
    _assert_margin_match(jres, off, prompts, margin)


def test_prefix_cache_warm_keeps_the_cold_chunk_with_drops(served):
    """With drops (capacity_factor 1.0), a 32-token shared prefix and
    8-token suffixes in 32-token chunks: the warm group prefills [32, 64)
    as the cold one does, a whole chunk (capacity 17 a expert), not an
    8-column one (capacity 5), so it drops the same choices and gives the
    cache-off tokens."""
    pcfg, pqp, _, _, _, _ = served
    pcfg = pcfg.replace(capacity_factor=1.0)
    prompts = _prompts(pcfg.vocab_size, shared_len=32, seed=2)
    scfg = dict(SCFG, prefill_chunk=32, prefix_page=4)
    off = Engine(pcfg, pqp, ServeConfig(**scfg), device="cpu").generate(
        prompts)
    on = Engine(pcfg, pqp, ServeConfig(**scfg, prefix_cache=True),
                device="cpu")
    assert on.generate(prompts) == off
    assert on.generate(prompts) == off
    assert on.stats["prefix_hits"] == len(prompts)
    assert on.stats["prefix_tokens_reused"] >= 32 * len(prompts)


@pytest.mark.parametrize("arch, whole", [("tinyllama-1.1b", False),
                                         ("olmoe-1b-7b", True)])
def test_warm_group_chunk_follows_the_capability_row(arch, whole,
                                                     monkeypatch):
    """A warm group past a 32-token horizon with 8-token suffixes: MoE
    (``capacity_follows_chunk``) prefills a whole 32-column chunk, as its
    cold prefill does there; dense prefills an 8-column one."""
    cfg = PC.get_arch(arch, reduced=True).replace(dtype="float32")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    widths, chunk = [], PT.prefill_chunk

    def record(params, cfg, cache, *, tokens, **kw):
        widths.append(tokens.shape[1])
        return chunk(params, cfg, cache, tokens=tokens, **kw)
    monkeypatch.setattr(PT, "prefill_chunk", record)
    prompts = _prompts(cfg.vocab_size, n=2, shared_len=32, seed=2)
    eng = Engine(cfg, params, ServeConfig(**dict(
        SCFG, prefill_chunk=32, prefix_page=4), prefix_cache=True),
        device="cpu")
    eng.generate(prompts)
    assert widths == [32, 32]                   # cold: [0, 32), [32, 64)
    widths.clear()
    eng.generate(prompts)
    assert eng.stats["prefix_hits"] == len(prompts)
    assert widths == [32 if whole else 8]
