"""The port's engine on the recurrent families against the reference's
engine: mamba2-2.7b and zamba2-1.2b, reduced, in f32, both sides serving
the reference's tree packed under ``default_serve_mix`` (moved across
with ``bridge``).

Greedy tokens equal the reference engine's under the top-2 margin rule
of ``tests/test_torch_engine.py`` (a divergence only where the
reference's own top-2 logit margin is below 0.1). On the port alone,
the counterparts of the reference's recurrent scheduler tests:
batched admission gives one-request-at-a-time tokens
(``test_engine_scheduler.py::test_scheduler_recurrent_family``), and
prompt lengths 3 to 21 all prefill in chunks of one shape on the fixed
grid (``test_family_caps.py::
test_recurrent_prefill_compiles_once_across_lengths``). And the
checkpoint prefix cache (``test_prefix_cache.py``'s recurrent tests):
the page is pinned to the chunk; greedy and temperature outputs with
the cache on equal the cache-off engine's, cold then warm, on both
families; a three-page pool thrashed by four prompts evicts and re-hits
with the same tokens; and a checkpoint hit grouped with a cold request
runs cold (the group's horizon is its smallest full-page match) and
gives the same tokens.
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

ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
POLICY = "default_serve_mix"
MARGIN_TOL = 0.1        # tests/test_torch_engine.py's top-2 margin rule
# the reference's test_prefix_cache.py settings for the recurrent tests
SCFG = dict(max_new_tokens=4, cache_len=64, decode_chunk=4, max_slots=2,
            prefill_bucket=4, prefill_chunk=16)


def _shared_prompts(vocab, n, shared_len=24, uniq=(4, 8), seed=0):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, vocab, shared_len)]
    return [shared + [int(t) for t in rng.integers(
        0, vocab, int(rng.integers(*uniq)))] for _ in range(n)]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(port cfg, the packed tree in the port, the reference's packed
    tree and cfg), the f32 reduced model under default_serve_mix."""
    arch = request.param
    cfg = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    params = jax.jit(JT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    qp = jax.jit(lambda p: j_quantize_params(p, j_get_policy(POLICY))[0])(
        params)
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    return PC.get_arch(arch, reduced=True).replace(dtype="float32"), pqp, \
        (cfg, qp)


def _mk(served, prefix=False, **kw):
    pcfg, pqp, _ = served
    return Engine(pcfg, pqp, ServeConfig(**dict(SCFG, prefix_cache=prefix,
                                                **kw)), device="cpu")


def test_engine_matches_reference_engine(served):
    """Four prompts of 9 to 30 tokens through two slots (two chunks for
    the longest): the reference engine's greedy tokens under the margin
    rule, and the port's own generate_reference. Both run the configs'
    own bf16 activations: the reference's hybrid decode keeps an f32
    conv tail where the ring is bf16 and its decode loop rejects f32
    activations."""
    pcfg, pqp, (jcfg, qp) = served
    pcfg, jcfg = (c.replace(dtype="bfloat16") for c in (pcfg, jcfg))
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, pcfg.vocab_size, n)]
               for n in (9, 30, 17, 12)]
    jres = JEngine(jcfg, qp, JServeConfig(**SCFG)).generate(prompts)
    eng = Engine(pcfg, pqp, ServeConfig(**SCFG), device="cpu")
    got = eng.generate(prompts)
    fwd = jax.jit(lambda p, t: JT.forward_seq(p, jcfg, tokens=t)[0])
    compared = total = 0
    for prompt, ref, out in zip(prompts, jres, got):
        assert len(out) == len(ref) == SCFG["max_new_tokens"]
        total += len(ref)
        t = next((i for i, (a, b) in enumerate(zip(ref, out)) if a != b),
                 None)
        if t is not None:
            logits = fwd(qp, np.asarray([prompt + ref[:t]], np.int32))
            top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
            assert top[1] - top[0] < MARGIN_TOL, (t, ref[t], out[t])
        compared += len(ref) if t is None else t
    assert compared >= 0.8 * total
    assert eng.generate_reference(prompts[:2]) == got[:2]


def test_batched_admission_equals_sequential(served):
    pcfg = served[0]
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, pcfg.vocab_size, n)]
               for n in (5, 21, 11)]
    outs = _mk(served, prefill_batch=4).generate(prompts)
    assert outs == [_mk(served).generate([p])[0] for p in prompts]
    assert outs == _mk(served, prefill_batch=1).generate(prompts)


def test_one_chunk_shape_across_prompt_lengths(served, monkeypatch):
    """Prompt lengths 3..21 against prefill_chunk=8: every prefill chunk
    has the grid's shape (one row, 8 columns), at absolute starts that
    are multiples of 8."""
    pcfg = served[0]
    shapes, starts, chunk = set(), set(), PT.prefill_chunk

    def record(params, cfg, cache, *, tokens, start, lengths):
        shapes.add(tuple(tokens.shape))
        starts.add(start % 8)
        return chunk(params, cfg, cache, tokens=tokens, start=start,
                     lengths=lengths)
    monkeypatch.setattr(PT, "prefill_chunk", record)
    eng = _mk(served, max_new_tokens=2, decode_chunk=2, max_slots=1,
              prefill_chunk=8)
    rng = np.random.default_rng(3)
    for n in range(3, 22):
        eng.generate([[int(t) for t in rng.integers(0, pcfg.vocab_size, n)]])
    assert shapes == {(1, 8)} and starts == {0}


def test_page_pins_to_prefill_chunk(served):
    eng = _mk(served, prefix=True, prefix_page=8)       # 8 ignored
    assert eng._page == eng._chunk == 16
    assert eng._caps.prefix_mode == "checkpoints"


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_prefix_cache_on_equals_off(served, temperature):
    """A shared-prefix queue twice: the first cycle checkpoints state at
    page boundaries (cold, then mixed groups), the second restores it.
    Both equal the cache-off engine's tokens, greedy and at a
    temperature (the warm path draws the same noise)."""
    pcfg = served[0]
    prompts = _shared_prompts(pcfg.vocab_size, 3, seed=11)
    kw = dict(temperature=temperature, seed=7)
    off, on = _mk(served, **kw), _mk(served, prefix=True, **kw)
    for _ in range(2):
        assert off.generate(prompts) == on.generate(prompts)
    # every row of the warm cycle restores the 16-token checkpoint
    assert on.stats["prefix_hits"] >= 3
    assert on.stats["prefix_tokens_reused"] >= 3 * 16


def test_eviction_then_rehit(served):
    """A three-page checkpoint pool thrashed by four distinct prompts:
    the tokens stay the cache-off engine's, and pages are evicted."""
    pcfg = served[0]
    page_bytes = PT.cache_page_bytes(pcfg, 16)
    off = _mk(served)
    on = _mk(served, prefix=True, prefix_bytes=3 * page_bytes)
    assert on._prefix.capacity == 3
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(0, pcfg.vocab_size, 20)]
               for _ in range(4)]
    for _ in range(3):
        assert off.generate(prompts) == on.generate(prompts)
    assert on._prefix.evictions > 0
    assert on._prefix.pages_in_use <= 3


def test_mixed_cold_and_warm_group(served):
    """A checkpoint hit in one prefill group with a new request: the cold
    row pulls the group's horizon to 0, the tokens stay the cache-off
    engine's, and the warm request still re-hits alone afterwards."""
    pcfg = served[0]
    rng = np.random.default_rng(14)
    A = [int(t) for t in rng.integers(0, pcfg.vocab_size, 22)]
    B = [int(t) for t in rng.integers(0, pcfg.vocab_size, 9)]
    off, on = _mk(served), _mk(served, prefix=True)
    assert off.generate([A]) == on.generate([A])      # checkpoint A
    assert off.generate([A, B]) == on.generate([A, B])
    assert on.stats["prefix_hits"] == 0               # cold drags s0 to 0
    assert off.generate([A]) == on.generate([A])      # A still re-hits
    assert on.stats["prefix_hits"] == 1
    assert on.stats["prefix_tokens_reused"] == 16
