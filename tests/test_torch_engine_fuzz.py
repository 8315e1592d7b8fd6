"""The engine's schedule-fuzz contract (``tests/test_engine_fuzz.py``)
over the port, on the CPU.

Two port engines over the same weights, one admitting in batched prefill
groups (``prefill_batch=3``) and one strictly a request at a time
(``prefill_batch=1``), are driven through identical randomized
schedules: waves of ragged submits (prompts long enough for a
multi-chunk prefill, queues deeper than the slots), cancels of queued
requests, per-request speculation toggles, EOS on or off, greedy or
temperature sampling. Every wave must give token-for-token identical
results. The in-flight driver cancels from ``on_token`` callbacks at
random trigger points (the victim queued, between a long prompt's
prefill chunks and its slot binding, or running), greedy, one cancel a
wave. ``generate_reference`` (the host-driven per-token loop) closes the
triangle batched == sequential == reference. The family axis runs the
same schedules through reduced mamba2 (ssm), zamba2 (hybrid, at
temperature 0.8) and olmoe (moe, with an EOS id greedy decode emits);
olmoe's draw seed=805789, which fails the reference's engines (ROADMAP
queue 3), is a fixed case here.

Against the reference: one fixed schedule a mode through the
reference's batched ``Engine`` and the port's, on the reference's weights
moved by ``bridge.from_jax_params`` (f32, so that a rounding tie is
rare): greedy and EOS tokens equal under the top-2 margin rule
(``test_torch_engine.py``); at temperature the two frameworks draw from
different generators (threefry, Philox), so the results are held to the
schedule's shape: the same requests, each as long as its budget, the
cancelled ones empty.

The schedules come from ``hypothesis`` seeds (or the deterministic
``tests/_hypothesis_stub.py`` where hypothesis is missing) and from
numpy generators of those seeds, as in the reference. The TP axes are in
``test_torch_engine_fuzz_tp.py``.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

MAX_NEW = 6
MAX_PROMPT = 22          # > prefill_chunk: long prompts stream in chunks
BASE = dict(max_new_tokens=MAX_NEW, cache_len=64, decode_chunk=4,
            max_slots=3, prefill_bucket=4, prefill_chunk=8)
SPEC = dict(drafter="ngram", draft_k=3)
MARGIN_TOL = 0.1
MOE_FLAKY_SEED = 805789  # fails the reference's olmoe pair (queue 3)


def init_params(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


def engine_pair(cfg, params, **kw):
    """(batched, sequential) port engines of one ServeConfig."""
    base = dict(BASE, **kw)
    return (Engine(cfg, params, ServeConfig(prefill_batch=3, **base),
                   device="cpu"),
            Engine(cfg, params, ServeConfig(prefill_batch=1, **base),
                   device="cpu"))


def probe_eos(cfg, params, **kw):
    """An EOS id that greedy decode emits (its second token on a fixed
    prompt), so EOS schedules cut sequences short mid-stream."""
    eng = Engine(cfg, params, ServeConfig(**dict(BASE, **kw)), device="cpu")
    return eng.generate([[7, 3, 11]])[0][1]


def make_waves(cfg, rng, has_drafter):
    """The reference's randomized schedule, drawn in its order: 1-2
    waves, each of 1-8 ragged requests (prompt, budget, speculate) and
    the indices of those cancelled while queued."""
    waves = []
    for _wave in range(int(rng.integers(1, 3))):
        n = int(rng.integers(1, 9))
        reqs = []
        for _ in range(n):
            prompt = rng.integers(0, cfg.vocab_size,
                                  int(rng.integers(1, MAX_PROMPT))).tolist()
            budget = int(rng.integers(1, MAX_NEW + 1))
            spec = bool(rng.integers(0, 2)) if has_drafter else None
            reqs.append((prompt, budget, spec))
        cancels = [int(i) for i in rng.permutation(n)[:int(rng.integers(0, n))]
                   if rng.integers(0, 2)]
        waves.append((reqs, cancels))
    return waves


def run_wave(eng, reqs, cancels):
    """Submit a wave, cancel its victims while queued, run it: (what each
    cancel returned, each request's tokens in submission order)."""
    ids = [eng.submit(p, max_new_tokens=b, speculate=s) for p, b, s in reqs]
    ok = [eng.cancel(ids[i]) for i in cancels]
    res = eng.run()
    assert set(res) == set(ids)
    return ok, [res[i] for i in ids]


def drive_waves(cfg, batched, seq, rng):
    """Identical randomized submit/cancel schedules into two engines;
    every wave must agree token for token."""
    for reqs, cancels in make_waves(cfg, rng,
                                    batched.scfg.drafter is not None):
        ok_b, got = run_wave(batched, reqs, cancels)
        ok_s, want = run_wave(seq, reqs, cancels)
        assert ok_b == ok_s and all(ok_b)
        assert got == want
        for toks, (_, budget, _), i in zip(got, reqs, range(len(reqs))):
            assert len(toks) <= budget
            if i in cancels:
                assert toks == []


@pytest.fixture(scope="module")
def pairs():
    """(batched, sequential) engine pairs, one a sampling/EOS mode, built
    once and reused by every example. The greedy and EOS pairs carry an
    ngram drafter so schedules can toggle speculation a request."""
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    params = init_params(cfg)
    eos = probe_eos(cfg, params)
    return dict(cfg=cfg,
                greedy=engine_pair(cfg, params, **SPEC),
                eos=engine_pair(cfg, params, eos_id=eos, **SPEC),
                temp=engine_pair(cfg, params, temperature=0.9, seed=11))


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 2**20), mode=st.sampled_from(
    ["greedy", "eos", "temp"]))
def test_fuzz_schedule_parity(pairs, seed, mode):
    batched, seq = pairs[mode]
    drive_waves(pairs["cfg"], batched, seq, np.random.default_rng(seed))


def inflight_schedule(cfg, rng):
    """The reference's in-flight schedule: 3-7 prompts, a speculation
    toggle each and ONE canceller (before any cancel both schedulers are
    in lockstep, so the cancel lands at one logical state; a second
    cancel's order within a chunk could differ): {canceller index:
    (victim index, trigger count)}."""
    n = int(rng.integers(3, 8))
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(1, MAX_PROMPT))).tolist()
               for _ in range(n)]
    spec = [bool(rng.integers(0, 2)) for _ in range(n)]
    plans = {int(rng.integers(0, n)): (int(rng.integers(0, n)),
                                       int(rng.integers(1, MAX_NEW + 1)))}
    return prompts, spec, plans


def run_inflight(eng, prompts, spec, plans):
    counts, ids = {}, []

    def mk_cb(idx):
        def cb(rid, tok):
            c = counts[rid] = counts.get(rid, 0) + 1
            victim, trig = plans.get(idx, (None, None))
            if victim is not None and c == trig:
                eng.cancel(ids[victim])
        return cb
    for i, p in enumerate(prompts):
        ids.append(eng.submit(p, on_token=mk_cb(i), speculate=spec[i]))
    res = eng.run()
    assert set(res) == set(ids)
    assert all(len(res[i]) <= MAX_NEW for i in ids)
    return [res[i] for i in ids]


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 2**20))
def test_fuzz_inflight_cancels_parity(pairs, seed):
    """Callback-driven cancels: greedy tokens do not see the slot layout a
    mid-admission cancel perturbs, so batched and sequential admission
    agree request for request, cancelled prefixes included, and both
    drain cleanly afterwards."""
    batched, seq = pairs["greedy"]
    sched = inflight_schedule(pairs["cfg"], np.random.default_rng(seed))
    assert run_inflight(batched, *sched) == run_inflight(seq, *sched)
    assert batched.generate([[1, 2, 3]]) == seq.generate([[1, 2, 3]])


def test_cancel_between_prefill_chunks_of_long_prompt(pairs):
    """Request A's first-token callback cancels long-prompt request B.
    Sequentially B is still queued; batched, B's 3-chunk prefill has run
    inside A's group but its slot is not bound: both report True, emit
    nothing for B and leave A and C as they were."""
    cfg = pairs["cfg"]
    rng = np.random.default_rng(123)
    long_prompt = rng.integers(0, cfg.vocab_size, 21).tolist()
    short = rng.integers(0, cfg.vocab_size, 3).tolist()

    def run(eng):
        ids, cancelled = {}, {}

        def cb(rid, tok):
            if not cancelled:
                cancelled[0] = eng.cancel(ids["b"])
        ids["a"] = eng.submit(short, on_token=cb)
        ids["b"] = eng.submit(long_prompt)
        ids["c"] = eng.submit(short)
        res = eng.run()
        return {k: res[v] for k, v in ids.items()}, cancelled[0]

    got, ok_b = run(pairs["greedy"][0])
    want, ok_s = run(pairs["greedy"][1])
    assert ok_b and ok_s
    assert got == want and got["b"] == []
    assert len(got["a"]) == MAX_NEW


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**20))
def test_fuzz_parity_with_reference_loop(pairs, seed):
    """The batched engine against the host-driven per-token loop on
    random ragged batches (<= max_slots: the loop has no queue),
    speculation off (``generate_reference`` is the plain decode
    oracle)."""
    cfg = pairs["cfg"]
    batched, _ = pairs["greedy"]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(1, 13))).tolist()
               for _ in range(int(rng.integers(1, 4)))]
    ids = [batched.submit(list(p), speculate=False) for p in prompts]
    res = batched.run()
    assert [res[i] for i in ids] == batched.generate_reference(prompts)


# -- the family axis: the same schedules through ssm, hybrid and moe
# engines, with no drafter (the axis targets admission and cancel
# scheduling; speculation needs a KV ring)

@pytest.fixture(scope="module")
def family_pairs():
    """(cfg, batched, sequential) a family: ssm greedy on the fixed
    recurrent chunk grid, hybrid at temperature (the warm draw
    discipline), moe with an emitted EOS id."""
    def mk(arch, probe=False, **kw):
        cfg = get_arch(arch, reduced=True)
        params = init_params(cfg)
        if probe:
            kw["eos_id"] = probe_eos(cfg, params, **kw)
        return (cfg,) + engine_pair(cfg, params, **kw)
    return {"ssm": mk("mamba2-2.7b"),
            "hybrid": mk("zamba2-1.2b", temperature=0.8, seed=5),
            "moe": mk("olmoe-1b-7b", probe=True)}


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**20),
       family=st.sampled_from(["ssm", "hybrid", "moe"]))
def test_fuzz_schedule_parity_across_families(family_pairs, seed, family):
    cfg, batched, seq = family_pairs[family]
    drive_waves(cfg, batched, seq, np.random.default_rng(seed))


def test_moe_schedule_that_fails_the_reference(family_pairs):
    """olmoe's seed=805789: the reference's batched and sequential
    engines disagree on it; the port's expert products run a row at a
    time, so its engines must agree."""
    cfg, batched, seq = family_pairs["moe"]
    drive_waves(cfg, batched, seq, np.random.default_rng(MOE_FLAKY_SEED))


# -- against the reference engine on bridged weights

REF_SEED = 4             # 2 waves, 15 requests, 3 cancelled, 5 past two chunks


@pytest.fixture(scope="module")
def bridged():
    """Reduced tinyllama in f32 on the reference's weights, the port's
    copy made by the bridge, and each mode's ServeConfig fields."""
    jcfg = j_get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32")
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(dtype="float32")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jp))
    modes = {"greedy": dict(SPEC),
             "eos": dict(SPEC, eos_id=probe_eos(cfg, params)),
             "temp": dict(temperature=0.9, seed=11)}
    return jcfg, jp, cfg, params, modes


def _margin_ok(jcfg, jp, prompt, ref, got):
    """Tokens equal, or the first divergence at a reference top-2 margin
    below ``MARGIN_TOL`` (a rounding tie)."""
    for t, (a, b) in enumerate(zip(ref, got)):
        if a != b:
            logits, _, _ = JT.forward_seq(
                jp, jcfg, tokens=np.asarray([prompt + ref[:t]], np.int32))
            top = np.sort(np.asarray(logits[0, -1], np.float32))
            return top[-1] - top[-2] < MARGIN_TOL
    return len(ref) == len(got)


@pytest.mark.parametrize("mode", ["greedy", "eos", "temp"])
def test_fixed_schedule_against_reference_engine(bridged, mode):
    jcfg, jp, cfg, params, modes = bridged
    kw = dict(BASE, prefill_batch=3, **modes[mode])
    port = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    ref = JEngine(jcfg, jp, JServeConfig(**kw))
    rng = np.random.default_rng(REF_SEED)
    waves = make_waves(cfg, rng, port.scfg.drafter is not None)
    assert sum(len(r) for r, _ in waves) == 15
    for reqs, cancels in waves:
        ok_p, got = run_wave(port, reqs, cancels)
        ok_r, want = run_wave(ref, reqs, cancels)
        assert ok_p == ok_r
        want = [[int(t) for t in w] for w in want]
        for i, ((prompt, budget, _), g, w) in enumerate(
                zip(reqs, got, want)):
            if i in cancels:
                assert g == w == []
            elif mode == "temp":
                assert len(g) == len(w) == budget
            else:
                assert _margin_ok(jcfg, jp, prompt, w, g), (i, w, g)
