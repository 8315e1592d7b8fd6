"""Temperature sampling in the port's engine.

``Engine._sample`` draws Gumbel-max, ``argmax(logits / T + g)``, which is
how the reference's ``jax.random.categorical`` samples. JAX's threefry
and torch's Philox differ, so the port is not held token for token
against the JAX engine under a temperature. It is held instead to:

* the distribution: over 40,000 draws on fixed logits the frequencies
  pass a chi-square test against ``softmax(logits / T)``, and a
  two-sample chi-square test against 40,000 draws of
  ``jax.random.categorical`` on the same logits (each at p > 1e-3: a
  correct sampler fails one of them about once in 500 runs, and these
  draws are fixed by their seeds);
* the reference's contract (``tests/test_engine_scheduler.py::
  test_sampling_determinism_and_modes``): the same seed gives the same
  tokens, another seed other tokens, and ``run()`` equals
  ``generate_reference``;
* the reference's draw discipline: batched admission equals
  ``prefill_batch=1``, and the tokens do not depend on ``decode_chunk``,
  under ``eos_id`` as well. A decode chunk whose slots all died at an
  EOS the host could not see runs on without consuming draws.

The model is reduced qwen3-1.7b (qk-norm) in bf16, packed under
``paper_llama_mix``, on the CPU. Random weights almost never emit a given
id, so ``eos_id`` is the token that request 0 samples at its third step
in the run without it: the same seed gives the same prefix, so EOS then
ends that request early.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.configs.base import get_arch
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

P_MIN = 1e-3
TEMP = 0.8
LOGITS = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0, 1.5], np.float32)
ROWS, DRAWS = 4000, 10              # 40,000 samples


@pytest.fixture(scope="module")
def model():
    cfg = get_arch("qwen3-1.7b", reduced=True)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    qp, _ = quantize_params(params, get_policy("paper_llama_mix"))
    return cfg, qp


def _engine(model, **kw):
    cfg, qp = model
    base = dict(max_new_tokens=8, cache_len=64, decode_chunk=8, max_slots=2,
                temperature=TEMP, seed=7)
    base.update(kw)
    return Engine(cfg, qp, ServeConfig(**base), device="cpu")


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size, int(k))]
            for k in rng.integers(2, 9, n)]


def _port_counts(model):
    eng = _engine(model)
    logits = torch.from_numpy(np.tile(LOGITS, (ROWS, 1)))
    toks = torch.cat([eng._sample(logits, d) for d in range(DRAWS)])
    return np.bincount(toks.numpy(), minlength=LOGITS.size)


def test_sample_frequencies_match_softmax(model):
    counts = _port_counts(model)
    z = LOGITS.astype(np.float64) / TEMP
    p = np.exp(z - z.max())
    p /= p.sum()
    assert counts.sum() == ROWS * DRAWS
    assert stats.chisquare(counts, p * counts.sum()).pvalue > P_MIN


def test_sample_frequencies_match_jax_categorical(model):
    counts = _port_counts(model)
    jtoks = jax.random.categorical(jax.random.PRNGKey(0),
                                   jnp.asarray(LOGITS) / TEMP,
                                   shape=(ROWS * DRAWS,))
    jcounts = np.bincount(np.asarray(jtoks), minlength=LOGITS.size)
    table = np.stack([counts, jcounts])
    assert stats.chi2_contingency(table).pvalue > P_MIN


def test_greedy_ignores_the_stream(model):
    eng = _engine(model, temperature=0.0)
    logits = torch.from_numpy(np.tile(LOGITS, (3, 1)))
    assert eng._sample(logits, 5).tolist() == [0, 0, 0]


def test_sampling_determinism_and_modes(model):
    """The reference's contract: greedy repeats, a fixed seed repeats,
    another seed differs, and run() equals generate_reference."""
    cfg, _ = model
    prompts = _prompts(cfg, 2)
    g = _engine(model, temperature=0.0)
    assert g.generate(prompts) == g.generate(prompts)
    t7 = _engine(model)
    a, b = t7.generate(prompts), t7.generate(prompts)
    assert a == b
    assert a != _engine(model, seed=8).generate(prompts)
    assert a == t7.generate_reference(prompts)
    assert a != g.generate(prompts)             # the noise does something


def _eos_of(model, prompts, **kw):
    """The token request 0 samples at its third step without EOS."""
    return _engine(model, **kw).generate(prompts)[0][2]


@pytest.mark.parametrize("with_eos", [False, True])
def test_batched_admission_equals_one_at_a_time(model, with_eos):
    cfg, _ = model
    prompts = _prompts(cfg, 4, seed=1)
    kw = dict(max_slots=4, prefill_batch=4)
    if with_eos:
        kw["eos_id"] = _eos_of(model, prompts, **kw)
    batched = _engine(model, **kw)
    res = batched.generate(prompts)
    assert batched.stats["prefill_groups"] == 1
    single = _engine(model, **{**kw, "prefill_batch": 1})
    assert single.generate(prompts) == res
    assert single.stats["prefill_groups"] == 4
    assert batched.generate_reference(prompts) == res
    if with_eos:
        assert len(res[0]) <= 3 and res[0][-1] == kw["eos_id"]


@pytest.mark.parametrize("with_eos", [False, True])
def test_deep_queue_tokens_do_not_depend_on_decode_chunk(model, with_eos):
    """Five requests through fewer slots, at decode_chunk 1, 3 and 32.
    Without EOS every slot dies at its budget, on a step the host knows,
    so two slots refill at the same steps whatever the chunk. Under EOS a
    slot freed mid-chunk refills at the chunk's end, which moves the
    later requests' draws (in the reference too); one slot keeps the
    draw order fixed, and the chunk of 32 runs past the EOS with no slot
    live, which must consume no draw."""
    cfg, _ = model
    prompts = _prompts(cfg, 5, seed=2)
    kw = dict(max_new_tokens=6, max_slots=1 if with_eos else 2)
    if with_eos:
        kw["eos_id"] = _eos_of(model, prompts, **kw)
    runs, forwards = [], []
    for chunk in (1, 3, 32):
        eng = _engine(model, decode_chunk=chunk, **kw)
        runs.append(eng.generate(prompts))
        forwards.append(eng.stats["forwards"])
    assert runs[0] == runs[1] == runs[2]
    if with_eos:
        assert len(runs[0][0]) <= 3 and runs[0][0][-1] == kw["eos_id"]
        assert forwards[2] > forwards[0]        # dead steps did run
