"""Speculative decoding in the port's engine.

Against the reference (reduced tinyllama in f32, packed with
``paper_llama_mix``, the same weights and prompts on both sides): the
ngram drafter with scan verify gives the JAX engine's greedy tokens and,
where the tokens agree, its ``draft_tokens``/``draft_accepted``/
``spec_rounds``; the self drafter with batched verify gives its tokens.
Tokens are held by test_torch_engine.py's margin rule: a divergence
counts only where the reference's top-2 logit margin is below
``MARGIN_TOL``. The ring and verify pieces (``ring_gather``,
``ring_restore``, ``verify_attention``) are held to the reference's on
equal inputs, exactly.

The reference's contracts (``tests/test_spec_decode.py``) run port
against port: greedy speculative decode gives plain decode's tokens for
both drafters, through ring wrap under a window, an int8 ring, the ring
end of a full-attention ring, mixed speculating and plain slots, EOS
inside an accepted block, ragged budgets and a mid-stream cancel; at a
temperature ``run()`` equals ``generate_spec_reference``. Scan verify is
bit for bit plain decode's logits; batched verify (one masked forward) is
held to the margin rule against plain decode, measured on the port's own
model.

Three tests would fail on a wrong port: the self drafter's draft cache
must not alias the main cache; ``_accept_impl`` at a temperature must
emit tokens distributed as ``softmax(l / T)`` (chi-square at p > 1e-3
over 20,000 numbered draws: a correct sampler fails about once in 1,000
seeds, and these draws are fixed); and ``run()`` must equal the numpy
oracle ``generate_spec_reference`` at a temperature, with and without
EOS.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs.base import get_arch
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.kernels import ops as JO
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs.base import get_arch as p_get_arch
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.kernels import ops as PO
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.serving.drafters import SelfDrafter
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

MARGIN_TOL = 0.1
P_MIN = 1e-3
DRAFTERS = ("ngram", "self")
SCFG = dict(max_new_tokens=8, cache_len=64, decode_chunk=10, max_slots=3,
            prefill_bucket=4, prefill_chunk=8, draft_k=3)
STATS = ("draft_tokens", "draft_accepted", "spec_rounds")


def _prompts(vocab, n, lo=2, hi=12, seed=0, repetitive_first=True):
    rng = np.random.default_rng(seed)
    ps = [[int(t) for t in rng.integers(0, vocab, int(m))]
          for m in rng.integers(lo, hi, n)]
    if repetitive_first:
        ps[0] = [7, 11] * 4          # prompt-lookup's home turf
    return ps


def _first_divergence(ref, got):
    for t, (a, b) in enumerate(zip(ref, got)):
        if a != b:
            return t
    return None


def _assert_margin_match(refs, gots, prompts, margin):
    """Token for token, or a divergence where ``margin(seq)`` (the top-2
    logit gap predicting the token after ``seq``) is below MARGIN_TOL."""
    compared = total = 0
    for prompt, ref, got in zip(prompts, refs, gots):
        assert len(got) == len(ref)
        total += len(ref)
        t = _first_divergence(ref, got)
        if t is not None:
            m = margin(prompt + ref[:t])
            assert m < MARGIN_TOL, (t, ref[t], got[t], m)
        compared += len(ref) if t is None else t
    assert compared >= 0.8 * total


# ---------------------------------------------------------------------------
# against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(dtype="float32")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qp, _ = j_quantize_params(params, j_get_policy("paper_llama_mix"))
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    pcfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32")
    prompts = _prompts(cfg.vocab_size, 5)

    def margin(seq):
        logits, _, _ = JT.forward_seq(qp, cfg,
                                      tokens=np.asarray([seq], np.int32))
        top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
        return float(top[1] - top[0])
    return cfg, qp, pcfg, pqp, prompts, margin


@pytest.fixture(scope="module")
def jax_ngram_scan(bridged):
    cfg, qp, _, _, prompts, _ = bridged
    eng = JEngine(cfg, qp, JServeConfig(**SCFG, drafter="ngram"))
    return eng.generate(prompts), dict(eng.stats)


@pytest.fixture(scope="module")
def jax_self_batched(bridged):
    cfg, qp, _, _, prompts, _ = bridged
    eng = JEngine(cfg, qp, JServeConfig(**SCFG, drafter="self",
                                        draft_verify="batched"))
    return eng.generate(prompts), dict(eng.stats)


def test_ngram_scan_matches_reference_engine(bridged, jax_ngram_scan):
    _, _, pcfg, pqp, prompts, margin = bridged
    jres, jstats = jax_ngram_scan
    eng = Engine(pcfg, pqp, ServeConfig(**SCFG, drafter="ngram"),
                 device="cpu")
    pres = eng.generate(prompts)
    _assert_margin_match(jres, pres, prompts, margin)
    assert eng.stats["spec_rounds"] > 0 and eng.stats["draft_accepted"] > 0
    if pres == jres:                    # the acceptance bookkeeping too
        assert {k: eng.stats[k] for k in STATS} == {k: jstats[k]
                                                    for k in STATS}


def test_self_batched_matches_reference_engine(bridged, jax_self_batched):
    _, _, pcfg, pqp, prompts, margin = bridged
    jres, _ = jax_self_batched
    eng = Engine(pcfg, pqp, ServeConfig(**SCFG, drafter="self",
                                        draft_verify="batched"),
                 device="cpu")
    _assert_margin_match(jres, eng.generate(prompts), prompts, margin)
    assert eng.stats["draft_tokens"] > 0


def _ring_case(seed=0):
    rng = np.random.default_rng(seed)
    L, B, T, KH, D, S = 2, 3, 8, 2, 4, 3
    kv = rng.standard_normal((L, B, T, KH, D)).astype(np.float32)
    pos = rng.integers(-1, 20, (B, T)).astype(np.int32)
    slots = ((rng.integers(0, 20, B)[:, None] + np.arange(S)) % T).astype(
        np.int32)
    keep = np.array([0, 2, 3], np.int32)
    return kv, pos, slots, keep


def test_ring_gather_and_restore_match_reference():
    kv, pos, slots, keep = _ring_case()
    for arr, axis in ((kv, 2), (pos, 1)):
        jsnap = JO.ring_gather(jnp.asarray(arr), jnp.asarray(slots),
                               ring_axis=axis)
        t = torch.from_numpy(arr.copy())
        psnap = PO.ring_gather(t, torch.from_numpy(slots), ring_axis=axis)
        np.testing.assert_array_equal(psnap.numpy(), np.asarray(jsnap))
        psnap_before = psnap.clone()
        # a verify pass overwrites the rows, then rewinds past ``keep``
        scribble = torch.full_like(psnap, 99)
        t.scatter_(axis, PO._ring_index(torch.from_numpy(slots), t, axis),
                   scribble)
        assert torch.equal(psnap, psnap_before)     # the snapshot copied
        jwritten = jnp.asarray(t.numpy())
        jout = JO.ring_restore(jwritten, jsnap, jnp.asarray(slots),
                               jnp.asarray(keep), ring_axis=axis)
        pout = PO.ring_restore(t, psnap, torch.from_numpy(slots),
                               torch.from_numpy(keep), ring_axis=axis)
        assert pout is t
        np.testing.assert_array_equal(t.numpy(), np.asarray(jout))


def test_verify_attention_matches_reference():
    rng = np.random.default_rng(1)
    B, S, H, KH, D, T = 2, 3, 4, 2, 8, 8
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    vc = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    kn = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    vn = rng.standard_normal((B, S, KH, D)).astype(np.float32)
    sp = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    sp[1, 5:] = -1
    positions = np.array([[9, 10, 11], [5, 6, 7]], np.int32)
    valid = np.array([[True, True, True], [True, False, False]])
    for window in (None, 4):
        j = JL.verify_attention(*map(jnp.asarray, (q, kc, vc, sp, kn, vn,
                                                   positions, valid)),
                                window=window)
        args = [torch.from_numpy(a.copy()) for a in (q, kc, vc, sp, kn, vn,
                                                     positions, valid)]
        kc_before = args[1].clone()
        p = PL.verify_attention(*args, window=window)
        assert torch.equal(args[1], kc_before)      # the ring is not written
        rows = valid
        np.testing.assert_allclose(p.numpy()[rows], np.asarray(j)[rows],
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the reference's contracts, port against port
# ---------------------------------------------------------------------------

def _port_model(arch, seed=0, **cfg_kw):
    cfg = p_get_arch(arch, reduced=True).replace(dtype="float32", **cfg_kw)
    params = PT.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    return cfg, params


@pytest.fixture(scope="module")
def causal():
    return _port_model("tinyllama-1.1b")


@pytest.fixture(scope="module")
def windowed():
    return _port_model("h2o-danube-1.8b")               # window = 64


@pytest.fixture(scope="module")
def int8kv():
    return _port_model("llama3.2-1b", kv_cache_quant=True)


def _mk(model, drafter=None, **kw):
    cfg, params = model
    base = dict(SCFG, drafter=drafter)
    base.update(kw)
    return Engine(cfg, params, ServeConfig(**base), device="cpu")


def _port_margin(model):
    cfg, params = model

    def margin(seq):
        logits = PT.forward_seq(params, cfg, tokens=torch.tensor([seq]))
        top = torch.sort(logits[0, -1]).values[-2:]
        return float(top[1] - top[0])
    return margin


def test_greedy_parity_causal(causal):
    prompts = _prompts(causal[0].vocab_size, 5)
    ref = _mk(causal).generate(prompts)
    for drafter in DRAFTERS:
        eng = _mk(causal, drafter=drafter)
        assert eng.generate(prompts) == ref, drafter
        assert eng.stats["spec_rounds"] > 0
        assert eng.stats["draft_tokens"] > 0
        # one flag read before every round, and one that ends each chunk
        s = eng.stats
        assert s["host_syncs"] == (s["prefill_groups"] + 2 * s["chunks"]
                                   + s["spec_rounds"])


def test_batched_verify_meets_the_margin_rule(causal):
    prompts = _prompts(causal[0].vocab_size, 5, seed=1)
    ref = _mk(causal).generate(prompts)
    for drafter in DRAFTERS:
        eng = _mk(causal, drafter=drafter, draft_verify="batched")
        _assert_margin_match(ref, eng.generate(prompts), prompts,
                             _port_margin(causal))


def test_greedy_parity_sliding_window_ring_wrap(windowed):
    """Drafts written (and rolled back) across the ring wrap: prompts
    longer than the 64-slot ring force mid-block wrap, and the rewind must
    restore the overwritten still-in-window entries."""
    cfg, _ = windowed
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 90)],
               [3, 5] * 10]
    ref = _mk(windowed, max_slots=2, prefill_chunk=16).generate(prompts)
    for drafter in DRAFTERS:
        eng = _mk(windowed, drafter=drafter, max_slots=2, prefill_chunk=16)
        assert eng.generate(prompts) == ref, drafter


def test_greedy_parity_int8_kv(int8kv):
    prompts = _prompts(int8kv[0].vocab_size, 4, seed=2)
    ref = _mk(int8kv, max_new_tokens=6).generate(prompts)
    for drafter in DRAFTERS:
        eng = _mk(int8kv, drafter=drafter, max_new_tokens=6, draft_layers=1)
        assert eng.generate(prompts) == ref, drafter


def test_ring_end_flush_boundary_sweep(causal):
    """Full-attention slots within draft_k of the ring end fall back to
    plain steps; every prompt length with prompt + budget == cache_len
    exactly, both drafters, and ragged slots clamped at different steps."""
    cfg, _ = causal
    Tring = 16
    rng = np.random.default_rng(7)
    for p in (3, 8, 11, 13, 14):
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, p)]]
        kw = dict(cache_len=Tring, max_slots=1, max_new_tokens=Tring - p)
        ref_eng = _mk(causal, **kw)
        ref = ref_eng.generate(prompts)
        assert ref == ref_eng.generate_reference(prompts)
        for drafter in DRAFTERS:
            assert _mk(causal, drafter=drafter, **kw).generate(prompts) == \
                ref, (drafter, p)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, p)]
               for p in (3, 9, 13)]
    kw = dict(cache_len=Tring, max_slots=3, max_new_tokens=3)
    ref = _mk(causal, **kw).generate(prompts)
    for drafter in DRAFTERS:
        assert _mk(causal, drafter=drafter, **kw).generate(prompts) == ref


def test_greedy_parity_mixed_spec_and_plain_slots(causal):
    prompts = _prompts(causal[0].vocab_size, 6, seed=5)
    plain = _mk(causal)
    ref_ids = [plain.submit(p) for p in prompts]
    ref = plain.run()
    eng = _mk(causal, drafter="ngram")
    ids = [eng.submit(p, speculate=(i % 2 == 0))
           for i, p in enumerate(prompts)]
    res = eng.run()
    assert [res[i] for i in ids] == [ref[i] for i in ref_ids]


def test_greedy_host_oracle_agrees(causal):
    prompts = _prompts(causal[0].vocab_size, 3, seed=6)
    for drafter in DRAFTERS:
        a = _mk(causal, drafter=drafter)
        b = _mk(causal, drafter=drafter)
        assert a.generate(prompts) == b.generate_spec_reference(prompts)
        assert {k: a.stats[k] for k in STATS} == {k: b.stats[k]
                                                  for k in STATS}


def test_eos_inside_accepted_draft_block(causal):
    """The full-depth self drafter accepts every draft, so an EOS arrives
    inside an accepted block: emission stops at it and the slot frees."""
    cfg, _ = causal
    prompts = _prompts(cfg.vocab_size, 4, seed=7)
    kw = dict(max_new_tokens=12, decode_chunk=13)
    free = _mk(causal, **kw).generate(prompts)
    eos = free[0][2]
    ref = _mk(causal, eos_id=eos, **kw).generate(prompts)
    assert any(len(o) < 12 for o in ref)
    eng = _mk(causal, drafter="self", draft_layers=cfg.n_layers, eos_id=eos,
              **kw)
    outs = eng.generate(prompts)
    assert outs == ref
    assert eng.stats["accept_rate"] > 0.9
    for o in outs:
        if eos in o:
            assert o.index(eos) == len(o) - 1


def test_ragged_budgets_and_instant_finish(causal):
    prompts = _prompts(causal[0].vocab_size, 5, seed=8)
    budgets = [1, 2, 5, 7, 8]
    plain = _mk(causal)
    rids = [plain.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    ref = plain.run()
    eng = _mk(causal, drafter="ngram")
    ids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    res = eng.run()
    assert [res[i] for i in ids] == [ref[i] for i in rids]
    assert all(len(res[i]) == b for i, b in zip(ids, budgets))


def test_midstream_cancel_during_speculation(causal):
    prompts = _prompts(causal[0].vocab_size, 3, seed=9)

    def run(drafter):
        eng = _mk(causal, drafter=drafter, max_new_tokens=10,
                  decode_chunk=11)
        seen = []

        def cb(rid, tok):
            seen.append(tok)
            if len(seen) == 3:
                eng.cancel(rid)
        a = eng.submit(prompts[0], on_token=cb)
        b = eng.submit(prompts[1])
        c = eng.submit(prompts[2])
        res = eng.run()
        return res[a], res[b], res[c]

    ref = run(None)
    for drafter in DRAFTERS:
        got = run(drafter)
        assert got[0] == ref[0][:len(got[0])] and len(got[0]) >= 3
        assert got[1:] == ref[1:]
    eng = _mk(causal, drafter="ngram", max_slots=1)
    x = eng.submit(prompts[0])
    y = eng.submit(prompts[1])
    assert eng.cancel(y)
    res = eng.run()
    assert res[y] == [] and len(res[x]) == 8


@pytest.mark.parametrize("with_eos", [False, True])
def test_temperature_run_equals_spec_reference(causal, with_eos):
    """``run()`` against the numpy oracle at a temperature: the same
    numbered draws (uniforms, then Gumbel noise, per round), the
    acceptance re-implemented on the host."""
    prompts = _prompts(causal[0].vocab_size, 3, seed=10)
    kw = dict(temperature=0.8, seed=11)
    if with_eos:
        kw["eos_id"] = _mk(causal, drafter="ngram", **kw).generate(
            prompts)[0][2]
    for drafter in DRAFTERS:
        a = _mk(causal, drafter=drafter, **kw)
        b = _mk(causal, drafter=drafter, **kw)
        oa = a.generate(prompts)
        assert oa == b.generate_spec_reference(prompts), drafter
        assert oa == a.generate(prompts)              # seed-fixed
        if with_eos and drafter == "ngram":
            assert oa[0][-1] == kw["eos_id"] and len(oa[0]) == 3


def test_temperature_seed_sensitivity(causal):
    prompts = _prompts(causal[0].vocab_size, 2, seed=12)
    a = _mk(causal, drafter="ngram", temperature=0.9, seed=1)
    b = _mk(causal, drafter="ngram", temperature=0.9, seed=2)
    assert a.generate(prompts) != b.generate(prompts)


def test_full_depth_self_drafter_accepts_everything(causal):
    cfg, _ = causal
    eng = _mk(causal, drafter="self", draft_layers=cfg.n_layers)
    eng.generate(_prompts(cfg.vocab_size, 3, seed=13))
    s = eng.stats
    assert s["accept_rate"] == 1.0
    assert s["draft_accepted"] == s["draft_tokens"] > 0
    assert s["tokens"] <= s["spec_rounds"] * (SCFG["draft_k"] + 1) * 3
    assert s["spec_rounds"] < s["tokens"]


def test_batched_verify_mode_deterministic(causal):
    prompts = _prompts(causal[0].vocab_size, 4, seed=14)
    eng = _mk(causal, drafter="ngram", draft_verify="batched")
    o1 = eng.generate(prompts)
    assert o1 == eng.generate(prompts)
    assert all(len(o) == 8 for o in o1)
    assert eng.stats["draft_tokens"] > 0


def test_spec_config_validation(causal):
    cfg, params = causal

    def build(**kw):
        return Engine(cfg, params, ServeConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="decode_chunk"):
        build(drafter="ngram", draft_k=8, decode_chunk=8)
    with pytest.raises(ValueError, match="draft_verify"):
        build(drafter="ngram", draft_verify="nope")
    with pytest.raises(ValueError, match="unknown drafter"):
        build(drafter="oracle")
    with pytest.raises(ValueError, match="draft_layers"):
        build(drafter="self", draft_layers=99)
    with pytest.raises(ValueError, match="draft_hist"):
        build(drafter="ngram", draft_ngram=9, draft_hist=8)
    with pytest.raises(ValueError, match="exceeds the KV ring"):
        build(drafter="ngram", draft_k=8, decode_chunk=16, cache_len=8)
    with pytest.raises(ValueError, match="drafter"):
        _mk(causal).submit([1, 2], speculate=True)


def test_quantized_params_spec_parity(causal):
    """The same packed weights serve the draft prefix and the verify."""
    cfg, params = causal
    qp, _ = quantize_params(params, get_policy("paper_llama_mix"))
    prompts = _prompts(cfg.vocab_size, 3, seed=15)
    ref = _mk((cfg, qp), max_new_tokens=6).generate(prompts)
    for drafter in DRAFTERS:
        eng = _mk((cfg, qp), drafter=drafter, max_new_tokens=6,
                  draft_layers=1)
        assert eng.generate(prompts) == ref, drafter


# ---------------------------------------------------------------------------
# tests that fail on a wrong port
# ---------------------------------------------------------------------------

def test_self_drafter_leaves_the_main_cache_unchanged(causal):
    """The draft cache is a copy: proposing must not change one byte of
    the main ring or ``pos`` (a ``v[:dl]`` view would)."""
    cfg, params = causal
    eng = _mk(causal, drafter="self", draft_layers=1, max_slots=2)
    for p in _prompts(cfg.vocab_size, 2, seed=16):
        eng.submit(p)
    eng._admit_pending()
    before = {k: v.clone() for k, v in eng._cache.items()}
    drafter = SelfDrafter(cfg, eng.scfg)
    drafts, _ = drafter.propose(
        params, cfg, eng._cache, {}, torch.as_tensor(eng._tok),
        torch.as_tensor(eng._pos), torch.ones(2, dtype=torch.bool))
    assert drafts.shape == (2, SCFG["draft_k"])
    for k, v in eng._cache.items():
        assert torch.equal(v, before[k]), k


def test_accept_at_temperature_samples_softmax(causal):
    """Speculative sampling with a point-mass drafter emits exactly the
    target distribution: over 20,000 numbered draws the first emitted
    token follows softmax(l0 / T), and the second, given that d1 was
    accepted, softmax(l1 / T)."""
    temp = 0.8
    eng = _mk(causal, drafter="ngram", temperature=temp, draft_k=2)
    l0 = np.array([1.0, 0.2, -0.5, 0.8, -1.0, 0.0], np.float32)
    l1 = np.array([-0.3, 0.9, 0.1, -1.2, 0.6, 0.3], np.float32)
    l2 = np.zeros(6, np.float32)
    logits = torch.from_numpy(np.stack([l0, l1, l2])[None])
    drafts = torch.tensor([[0, 1]])                 # d1 = 0, d2 = 1
    spec = torch.ones(1, dtype=torch.bool)
    first, second = [], []
    for n in range(20000):
        acc, fin = eng._accept_impl(logits, drafts, spec, 2 * n)
        acc, fin = int(acc), int(fin)
        first.append(0 if acc >= 1 else fin)
        if acc >= 1:
            second.append(1 if acc >= 2 else fin)

    def softmax(z):
        e = np.exp(z.astype(np.float64) / temp - (z / temp).max())
        return e / e.sum()
    for toks, z in ((first, l0), (second, l1)):
        counts = np.bincount(toks, minlength=6)
        assert stats.chisquare(counts,
                               softmax(z) * counts.sum()).pvalue > P_MIN
    assert len(second) > 5000
