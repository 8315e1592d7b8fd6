"""The prefix cache (KV-page mode) in the port's engine.

Against the reference: the port's ``PrefixCache`` copy gives the
reference's results on one scripted sequence of matches, inserts,
evictions and dropped inserts; ``page_gather``/``page_scatter`` give the
reference's on equal inputs (the port drops out-of-range entries on the
host, the reference with ``mode="drop"``); and the engine with the cache
on gives the JAX engine's greedy tokens and its four prefix stats, cold
and warm (reduced tinyllama in f32 packed with ``paper_llama_mix``;
tokens by test_torch_engine.py's margin rule).

The reference's contracts (``tests/test_prefix_cache.py``) run port
against port: greedy output with the cache on equals the cache off,
through full re-hits, partial-page (copy-on-write) hits, mixed warm and
cold groups, eviction under a tiny pool, a windowed prompt longer than
the ring, the fused attention, an int8 ring, speculative decoding on top
and sampling at a temperature; the page clamps to a divisor of the ring
and a saturated pool surfaces its dropped inserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.kernels import ops as JO
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro_torch import bridge
from repro_torch.configs.base import get_arch as p_get_arch
from repro_torch.kernels import ops as PO
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.prefix_cache import PrefixCache

torch.set_num_threads(2)

MARGIN_TOL = 0.1
SCFG = dict(max_new_tokens=5, cache_len=64, decode_chunk=5, max_slots=2,
            prefill_bucket=4, prefill_chunk=16, prefix_page=8)
PREFIX_STATS = ("prefix_hits", "prefix_tokens_reused", "prefix_evictions",
                "prefix_insert_drops")


def _shared_prompts(vocab, n, shared_len=24, uniq=(3, 9), seed=0):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, vocab, shared_len)]
    return [shared + [int(t) for t in rng.integers(
        0, vocab, int(rng.integers(*uniq)))] for _ in range(n)]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _script(pc):
    """One scripted sequence of radix-tree operations; returns everything
    observable after each step."""
    out = []
    a, b = list(range(17)), list(range(100, 117))
    c = list(range(12)) + [50, 51, 52, 53, 54]
    protect: set = set()
    for step in (lambda: pc.insert(a, protect), lambda: pc.insert(b, protect),
                 lambda: pc.match(a), lambda: pc.match(c),
                 lambda: pc.insert(c), lambda: pc.match_len(c + [1]),
                 lambda: pc.insert(list(range(200, 230))),
                 lambda: pc.match(b), lambda: pc.page_chain(a),
                 lambda: pc.insert(a), lambda: pc.match(a[:5])):
        out.append((step(), pc.evictions, pc.insert_drops, pc.pages_in_use))
    pc.clear()
    out.append((pc.match(a), pc.pages_in_use))
    return out


def test_radix_tree_matches_reference_on_a_script():
    assert _script(PrefixCache(page=4, capacity=5)) == _script(
        JPrefixCache(page=4, capacity=5))


def test_page_gather_and_scatter_match_reference():
    rng = np.random.default_rng(0)
    L, B, T, KH, D, page = 2, 3, 8, 2, 4, 4
    ring = rng.standard_normal((L, B, T, KH, D)).astype(np.float32)
    pos = rng.integers(-1, 30, (B, T)).astype(np.int32)
    rows = np.array([2, 0], np.int32)
    cols = np.array([[4, 5, 6, 7], [0, 1, 2, 3]], np.int32)
    for arr, axis in ((ring, 2), (pos, 1)):
        jp = JO.page_gather(jnp.asarray(arr), jnp.asarray(rows),
                            jnp.asarray(cols), ring_axis=axis)
        pp = PO.page_gather(torch.from_numpy(arr), rows, cols,
                            ring_axis=axis)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        # scatter into another ring: row 1's page partial (2 rows taken,
        # the rest marked T = drop), row 0's page dropped entirely
        dst = np.zeros_like(arr)
        srows = np.array([1, 0], np.int32)
        scols = np.array([[2, 3, T, T], [T, T, T, T]], np.int32)
        jd = JO.page_scatter(jnp.asarray(dst), jp, jnp.asarray(srows),
                             jnp.asarray(scols), ring_axis=axis)
        pd = torch.from_numpy(dst.copy())
        PO.page_scatter(pd, pp, srows, scols, ring_axis=axis)
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    with pytest.raises(ValueError, match="out of range"):
        PO.page_gather(torch.from_numpy(ring), rows, cols + T, ring_axis=2)


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
def jax_prefix_runs(bridged):
    """The reference engine's tokens and prefix stats over two cycles of
    one shared-prefix queue (cold + mixed, then warm)."""
    cfg, qp, _, _ = bridged
    prompts = _shared_prompts(cfg.vocab_size, 5, seed=1)
    eng = JEngine(cfg, qp, JServeConfig(**SCFG, prefix_cache=True))
    runs = []
    for _ in range(2):
        runs.append((eng.generate(prompts),
                     {k: eng.stats[k] for k in PREFIX_STATS}))
    return prompts, runs, (eng._page, eng._prefix.capacity)


def test_engine_matches_reference_engine_cold_and_warm(bridged,
                                                       jax_prefix_runs):
    cfg, qp, pcfg, pqp = bridged
    prompts, runs, geometry = jax_prefix_runs
    eng = Engine(pcfg, pqp, ServeConfig(**SCFG, prefix_cache=True),
                 device="cpu")
    assert (eng._page, eng._prefix.capacity) == geometry
    for jres, jstats in runs:
        pres = eng.generate(prompts)
        assert {k: eng.stats[k] for k in PREFIX_STATS} == jstats
        for prompt, ref, got in zip(prompts, jres, pres):
            for t, (a, b) in enumerate(zip(ref, got)):
                if a != b:
                    logits, _, _ = JT.forward_seq(
                        qp, cfg, tokens=np.asarray([prompt + ref[:t]],
                                                   np.int32))
                    top = np.sort(np.asarray(logits[0, -1], np.float32))
                    assert top[-1] - top[-2] < MARGIN_TOL
                    break
    assert runs[1][1]["prefix_hits"] == 5


# ---------------------------------------------------------------------------
# the reference's contracts, port against port
# ---------------------------------------------------------------------------

def _port_model(arch, **cfg_kw):
    cfg = p_get_arch(arch, reduced=True).replace(**cfg_kw)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
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
    return _port_model("llama3.2-1b", kv_cache_quant=True, dtype="float32")


def _mk(model, prefix=False, **kw):
    cfg, params = model
    base = dict(SCFG, prefix_cache=prefix)
    base.update(kw)
    return Engine(cfg, params, ServeConfig(**base), device="cpu")


@pytest.mark.parametrize("fixture", ["causal", "windowed", "int8kv"])
def test_greedy_parity_on_vs_off(fixture, request):
    model = request.getfixturevalue(fixture)
    prompts = _shared_prompts(model[0].vocab_size, 5, seed=1)
    off, on = _mk(model), _mk(model, prefix=True)
    assert off.generate(prompts) == on.generate(prompts)     # cold+mixed
    assert off.generate(prompts) == on.generate(prompts)     # fully warm
    assert on.stats["prefix_hits"] == 5
    assert on.stats["prefix_tokens_reused"] >= 5 * 24


def test_fused_attention_over_scattered_pages(causal):
    """A warm admission under the fused attention attends a ring whose
    prefix rows were scattered from the pool (the chip's masking
    pattern), in multi-chunk suffixes."""
    cfg, params = causal
    model = (cfg.replace(attn_impl="fused"), params)
    prompts = _shared_prompts(cfg.vocab_size, 4, shared_len=40,
                              uniq=(9, 30), seed=2)
    kw = dict(prefill_chunk=8, max_slots=4, prefill_batch=4, cache_len=80)
    off, on = _mk(model, **kw), _mk(model, prefix=True, **kw)
    for _ in range(2):
        assert off.generate(prompts) == on.generate(prompts)
    assert on.stats["prefix_hits"] == 4


@pytest.mark.parametrize("attn_impl", ["naive", "fused"])
def test_warm_first_logits_equal_cold_bit_for_bit(causal, attn_impl):
    """The warm chunk grid starts at a prefill-chunk boundary, so each key
    sits where a cold prefill puts it: the first tokens' logits are the
    cache-off engine's bit for bit, also under the fused attention, whose
    tiled sums follow the key layout. (Starting the grid at the smallest
    match, as the reference does, fails this under "fused".)"""
    cfg, params = causal
    model = (cfg.replace(attn_impl=attn_impl), params)
    rng = np.random.default_rng(18)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, 48)]
    prompts = [shared + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                      int(n))]
               for n in rng.integers(4, 20, 8)]
    kw = dict(max_new_tokens=8, decode_chunk=8, cache_len=128, max_slots=4,
              prefill_batch=4, prefill_chunk=32)

    def first_logits(eng):
        rows = []
        sample = eng._sample_first

        def record(last_logits, G):
            rows.append(last_logits[:G].clone())
            return sample(last_logits, G)
        eng._sample_first = record
        return eng.generate(prompts), torch.cat(rows)
    cold = first_logits(_mk(model, **kw))
    on = _mk(model, prefix=True, **kw)
    for _ in range(2):
        warm = first_logits(on)
        assert warm[0] == cold[0]
        assert torch.equal(warm[1], cold[1])
    assert on.stats["prefix_hits"] == 8


def test_partial_page_cow_hit(causal):
    cfg, _ = causal
    rng = np.random.default_rng(2)
    A = [int(t) for t in rng.integers(0, cfg.vocab_size, 21)]
    B = A[:12] + [int(t) for t in rng.integers(0, cfg.vocab_size, 9)]
    off, on = _mk(causal), _mk(causal, prefix=True)
    assert off.generate([A]) == on.generate([A])
    assert off.generate([B]) == on.generate([B])
    assert on.stats["prefix_tokens_reused"] == 12   # 1 page + 4 rows
    assert off.generate([A]) == on.generate([A])    # A unharmed
    assert on.stats["prefix_tokens_reused"] == 16


def test_mixed_cold_and_warm_group_parity(causal):
    cfg, _ = causal
    rng = np.random.default_rng(8)
    A = [int(t) for t in rng.integers(0, cfg.vocab_size, 22)]
    B = [int(t) for t in rng.integers(0, cfg.vocab_size, 9)]
    C = [int(t) for t in rng.integers(0, cfg.vocab_size, 30)]
    off, on = _mk(causal), _mk(causal, prefix=True)
    assert off.generate([A]) == on.generate([A])
    assert off.generate([A, B]) == on.generate([A, B])
    assert on.stats["prefix_hits"] == 1
    assert off.generate([A, C]) == on.generate([A, C])


def test_eviction_then_rehit_parity(causal):
    cfg, _ = causal
    kw = dict(max_new_tokens=4, decode_chunk=4)
    off = _mk(causal, **kw)
    on = _mk(causal, prefix=True, prefix_bytes=3 * PT.cache_page_bytes(
        cfg, 8), **kw)
    assert on._prefix.capacity == 3
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 17)]
               for _ in range(4)]
    for _ in range(3):
        assert off.generate(prompts) == on.generate(prompts)
    assert on._prefix.evictions > 0
    assert on._prefix.pages_in_use <= 3


def test_window_arch_long_prompt_skips_insertion(windowed):
    cfg, _ = windowed
    rng = np.random.default_rng(4)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, 40)]
    prompts = [shared + [int(t) for t in rng.integers(0, cfg.vocab_size, k)]
               for k in (5, 9, 40)]                         # last: 80 > 64
    off, on = _mk(windowed), _mk(windowed, prefix=True)
    for _ in range(2):
        assert off.generate(prompts) == on.generate(prompts)
    assert on.stats["prefix_hits"] >= 2


def test_spec_decode_rides_prefix_cache(causal):
    prompts = _shared_prompts(causal[0].vocab_size, 4, seed=5)
    kw = dict(max_new_tokens=8, decode_chunk=10)
    ref = _mk(causal, **kw).generate(prompts)
    eng = _mk(causal, prefix=True, drafter="ngram", draft_k=3, **kw)
    assert eng.generate(prompts) == ref                     # cold
    assert eng.generate(prompts) == ref                     # warm
    assert eng.stats["prefix_hits"] > 0


def test_temperature_parity_on_vs_off(causal):
    prompts = _shared_prompts(causal[0].vocab_size, 4, seed=6)
    off = _mk(causal, temperature=0.8, seed=9)
    on = _mk(causal, prefix=True, temperature=0.8, seed=9)
    for _ in range(2):
        assert off.generate(prompts) == on.generate(prompts)
    assert on.stats["prefix_hits"] == 4


def test_page_clamps_to_ring_divisor(causal):
    eng = _mk(causal, prefix=True, prefix_page=48, cache_len=64)
    assert eng._page == 32 and eng.prefix_page == 32
    assert _mk(causal).prefix_page is None


def test_prefix_match_len_probe(causal):
    prompts = _shared_prompts(causal[0].vocab_size, 2, seed=7)
    eng = _mk(causal, prefix=True)
    assert eng.prefix_match_len(prompts[1]) == 0
    eng.generate(prompts[:1])
    stamps = [n.stamp for n in eng._prefix._root.children.values()]
    assert eng.prefix_match_len(prompts[1]) == 24
    assert stamps == [n.stamp for n in eng._prefix._root.children.values()]
    assert _mk(causal).prefix_match_len(prompts[1]) == 0


def test_engine_surfaces_insert_drops_stat(causal):
    cfg, _ = causal
    rng = np.random.default_rng(21)
    P = [int(t) for t in rng.integers(0, cfg.vocab_size, 28)]  # 3 pages
    expect = _mk(causal).generate([P])
    tiny = _mk(causal, prefix=True, prefix_bytes=1)    # floor: 2 pages
    assert tiny.generate([P]) == expect
    assert tiny.stats["prefix_insert_drops"] == 1
    assert tiny.generate([P]) == expect
    assert tiny.stats["prefix_insert_drops"] == 1
    assert tiny.stats["prefix_hits"] == 1
    big = _mk(causal, prefix=True)
    assert big.generate([P]) == expect
    assert big.stats["prefix_insert_drops"] == 0


# -- the radix tree, host side -----------------------------------------------

def test_radix_match_insert_roundtrip():
    pc = PrefixCache(page=4, capacity=8)
    toks = list(range(10))
    assert pc.match(toks) == (0, [])
    assert [p0 for _, p0 in pc.insert(toks)] == [0, 4]
    m, pages = pc.match(toks)
    assert m == 8 and [(p0, t) for _, p0, t in pages] == [(0, 4), (4, 4)]
    assert pc.match(toks[:5])[0] == 4               # capped at len - 1
    m, pages = pc.match([0, 1, 2, 3, 4, 5, 9, 9, 9])
    assert m == 6 and pages[-1][2] == 2             # a partial page
    assert pc.insert(toks) == [] and pc.pages_in_use == 2


def test_radix_refcount_and_lru_eviction():
    pc = PrefixCache(page=2, capacity=3)
    pc.insert([1, 2, 3, 4])
    pc.insert([1, 2, 5, 6])
    root_child = pc._root.children[(1, 2)]
    assert root_child.refcount == 2
    assert len(pc.insert([7, 8])) == 1 and pc.evictions == 1
    assert (3, 4) not in root_child.children and (5, 6) in root_child.children
    assert len(pc.insert([1, 2, 3, 4])) == 1


def test_radix_batched_insert_protect_no_index_recycle():
    pc = PrefixCache(page=8, capacity=3)
    protect: set = set()
    a, b = list(range(17)), list(range(100, 117))
    new_a = pc.insert(a, protect)
    new_b = pc.insert(b, protect)
    assert len(new_a) == 2 and len(new_b) == 1
    assert not ({i for i, _ in new_a} & {i for i, _ in new_b})
    assert pc.evictions == 0 and pc.match(a)[0] == 16
    pc2 = PrefixCache(page=8, capacity=3)
    pc2.insert(a)
    assert len(pc2.insert(b)) == 2 and pc2.evictions == 1


def test_radix_capacity_exhaustion_drops_tail():
    pc = PrefixCache(page=2, capacity=2)
    assert len(pc.insert([1, 2, 3, 4, 5, 6])) == 2
    assert pc.insert_drops == 1
    assert pc.match([1, 2, 3, 4, 5, 6])[0] == 4
    pc2 = PrefixCache(page=2, capacity=2)
    pc2.insert([1, 2, 3, 4, 5, 6, 7, 8])
    assert pc2.match([1, 2, 3, 4])[0] == 3 and pc2.insert_drops == 2
    pc2.insert([1, 2, 3, 4])
    assert pc2.insert_drops == 2
