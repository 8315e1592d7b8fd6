"""Disaggregated prefill/decode serving in the port
(``repro_torch.serving.disagg``) and the engine's KV page hand-off.

The reference's contracts (``tests/test_disagg.py``) run port against
port: routed output through ``DisaggEngine`` (prefill workers, page
migration, decode workers behind the radix router) equals one monolithic
port ``Engine`` with the same ServeConfig token for token, greedy across
causal, windowed and int8-KV rings against the cache-off and cache-on
engines, with speculation on the decode tier, at a temperature (1P+1D),
at 2P+2D and on reduced olmoe; export then import is bit-identical
(int8 codes and f32 scales included) and deduplicates; the page copies
round-trip through a wrapped ring; routing, validation and cancel.

Against the reference, on weights carried across by ``bridge.py``
(reduced tinyllama in f32, packed with ``paper_llama_mix``, an int8 KV
ring): the port's 1P+1D tokens equal the JAX engine's under the top-2
margin rule (test_torch_engine.py), and the pages the port's prefill
worker exports have the reference's keys, shapes and dtypes, the page
axis at dim 1, int8 codes within 1 and scales within 1e-5 relative (the
two frameworks' f32 sums differ in the last bits, which can move a code
across a rounding boundary).
"""
import json

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
from repro_torch.models import transformer as PT
from repro_torch.serving.disagg import DisaggEngine
from repro_torch.serving.engine import Engine, KVPages, ServeConfig
from repro_torch.serving.prefix_cache import PrefixCache

torch.set_num_threads(2)

MARGIN_TOL = 0.1
BASE = dict(max_new_tokens=5, cache_len=64, decode_chunk=5, max_slots=2,
            prefill_bucket=4, prefill_chunk=16, prefix_page=8)


def _scfg(**kw):
    base = dict(BASE)
    base.update(kw)
    return ServeConfig(**base)


def _prompts(vocab, n, shared_len=24, uniq=(3, 9), seed=0):
    """A shared-system-prompt queue plus one sub-page prompt (the router's
    direct-to-decode path, in every parity run)."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, vocab, shared_len)]
    ps = [shared + [int(t) for t in rng.integers(
        0, vocab, int(rng.integers(*uniq)))] for _ in range(n)]
    ps.append([int(t) for t in rng.integers(0, vocab, 4)])     # < one page
    return ps


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


def _engine(model, **kw):
    cfg, params = model
    return Engine(cfg, params, _scfg(**kw), device="cpu")


def _disagg(model, p=1, d=1, **kw):
    cfg, params = model
    return DisaggEngine(cfg, params, _scfg(**kw), prefill_workers=p,
                        decode_workers=d, device="cpu")


# ---------------------------------------------------------------------------
# port against port: the parity matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["causal", "windowed", "int8kv"])
@pytest.mark.parametrize("spec", [False, True])
def test_greedy_parity_matrix(fixture, spec, request):
    """1P+1D routed output equals the monolithic engine's with the prefix
    cache off and on, pages migrate and the decode tier reuses them; a
    repeat run stays warm and equal (radix state survives generate)."""
    model = request.getfixturevalue(fixture)
    kw = dict(drafter="ngram", draft_k=4) if spec else {}
    prompts = _prompts(model[0].vocab_size, 4, seed=1)
    expect = _engine(model, **kw).generate(prompts)
    assert _engine(model, prefix_cache=True, **kw).generate(prompts) == expect
    dis = _disagg(model, **kw)
    assert dis.generate(prompts) == expect
    assert dis.stats["migrated_pages"] > 0
    assert dis.stats["prefix_hits"] > 0
    assert dis.stats["router"]["direct_decode"] == 1
    if spec:
        assert dis.stats["spec_rounds"] > 0
    assert dis.generate(prompts) == expect
    assert dis.stats["router"]["migrated_pages_total"] > 0


def test_temperature_parity_1p1d(causal):
    """One decode worker admits in the monolithic engine's order and takes
    its draws in the same order, so sampled output is the same tokens."""
    prompts = _prompts(causal[0].vocab_size, 4, seed=2)
    expect = _engine(causal, temperature=0.7, seed=3).generate(prompts)
    dis = _disagg(causal, temperature=0.7, seed=3)
    assert dis.generate(prompts) == expect
    assert dis.stats["migrated_pages"] > 0
    assert expect != _engine(causal).generate(prompts)      # it sampled


def test_multiworker_greedy_parity(causal):
    """2P+2D: greedy output stays the monolithic engine's with the
    requests spread over both decode workers."""
    prompts = _prompts(causal[0].vocab_size, 5, seed=4)
    dis = _disagg(causal, p=2, d=2)
    assert dis.generate(prompts) == _engine(causal).generate(prompts)
    rt = dis.stats["router"]
    assert all(n > 0 for n in rt["decode_requests"])
    assert rt["migrated_pages_total"] > 0
    # every worker serves the one weight tree: none copies it
    assert all(e.params is causal[1]
               for e in dis.prefill_engines + dis.decode_engines)


def test_moe_parity_1p1d():
    """Reduced olmoe (capacity follows the chunk): the decode tier's warm
    groups keep whole chunks, so the routed tokens, token drops included,
    are the monolithic engine's."""
    model = _port_model("olmoe-1b-7b")
    prompts = _prompts(model[0].vocab_size, 4, shared_len=40, seed=5)
    expect = _engine(model).generate(prompts)
    dis = _disagg(model)
    assert dis.generate(prompts) == expect
    assert dis.stats["migrated_pages"] > 0 and dis.stats["prefix_hits"] > 0


def test_stats_sum_the_tiers_and_serialize(causal):
    prompts = _prompts(causal[0].vocab_size, 4, seed=6)
    dis = _disagg(causal)
    out = dis.generate(prompts)
    s = dis.stats
    pw, dw = dis.prefill_engines[0].stats, dis.decode_engines[0].stats
    assert s["forwards"] == pw["forwards"] + dw["forwards"]
    assert s["prefill_forwards"] == (pw["prefill_forwards"]
                                     + dw["prefill_forwards"])
    assert s["tokens"] == sum(len(t) for t in out) == 5 * len(prompts)
    assert s["prefill_prefix_hits"] == pw["prefix_hits"]
    json.dumps(s)                       # plain numbers only, router included


# ---------------------------------------------------------------------------
# router placement
# ---------------------------------------------------------------------------

def test_router_prefers_prefix_overlap(causal):
    """After worker 0 caches family-A pages, an A-prefixed request routes
    to worker 0 (overlap) and an unrelated one to worker 1 (a tie at 0
    goes to the shallowest queue)."""
    vocab = causal[0].vocab_size
    rng = np.random.default_rng(5)
    A = [int(t) for t in rng.integers(0, vocab, 24)]
    dis = _disagg(causal, p=2)
    dis.generate([A + [int(t) for t in rng.integers(0, vocab, 5)]])
    assert dis.stats["router"]["prefill_requests"] == [1, 0]
    A2 = A + [int(t) for t in rng.integers(0, vocab, 6)]
    B = [int(t) for t in rng.integers(0, vocab, 30)]
    dis.generate([A2, B])
    rt = dis.stats["router"]
    assert rt["prefill_requests"] == [2, 1]
    assert rt["prefill_overlap_hits"][0] == 1
    assert rt["prefill_overlap_tokens"][0] >= 24 - BASE["prefix_page"]
    assert rt["prefill_hit_rate"][0] == 0.5


def test_router_scoring_no_lru_distortion():
    """prefix_match_len (the router's probe) leaves the LRU stamps alone;
    match() touches them."""
    pc = PrefixCache(page=2, capacity=2)
    pc.insert([1, 2, 3, 4])
    stamps = {id(c): c.stamp for c in pc._root.children.values()}
    assert pc.match_len([1, 2, 3, 4, 9]) == 4
    assert {id(c): c.stamp for c in pc._root.children.values()} == stamps
    m, _ = pc.match([1, 2, 3, 4, 9])
    assert m == 4
    assert {id(c): c.stamp for c in pc._root.children.values()} != stamps


# ---------------------------------------------------------------------------
# export/import on their own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["causal", "int8kv"])
def test_export_import_bit_identical(fixture, request):
    """Pages exported from one engine and imported into another come back
    out bit for bit (int8 codes and f32 scales too), the importer's tree
    then matches the prompt, a re-import deduplicates to 0, and the
    imported pages serve the exporter's tokens."""
    model = request.getfixturevalue(fixture)
    rng = np.random.default_rng(6)
    P = [int(t) for t in rng.integers(0, model[0].vocab_size, 21)]
    src, dst = _engine(model, prefix_cache=True), _engine(
        model, prefix_cache=True)
    src.generate([P])
    kv = src.export_kv_pages(P)
    assert kv.n_pages == 2 and kv.tokens == P[:16]
    keys = {"k", "v", "k_scale", "v_scale"} if model[0].kv_cache_quant \
        else {"k", "v"}
    assert set(kv.payload) == keys
    for k, v in kv.payload.items():
        assert v.device.type == "cpu" and v.dtype == src._pool[k].dtype
        assert v.shape[1] == 2 and v.shape[2] == 8      # (L, n, page, ...)
    if model[0].kv_cache_quant:
        assert kv.payload["k"].dtype == torch.int8
        assert kv.payload["k_scale"].dtype == torch.float32
    assert dst.import_kv_pages(kv) == 2
    assert dst.prefix_match_len(P) == 16
    back = dst.export_kv_pages(P)
    assert back.tokens == kv.tokens
    for k in kv.payload:
        assert torch.equal(back.payload[k].view(torch.uint8),
                           kv.payload[k].view(torch.uint8))
    assert dst.import_kv_pages(kv) == 0                  # dedup
    assert dst.generate([P]) == src.generate([P])
    assert dst.stats["prefix_hits"] == 1


def test_import_drops_the_tail_of_a_saturated_pool(causal):
    """A pool with room for fewer pages than the chain keeps its head and
    counts the dropped tail in ``prefix_insert_drops``."""
    rng = np.random.default_rng(7)
    P = [int(t) for t in rng.integers(0, causal[0].vocab_size, 40)]
    src = _engine(causal, prefix_cache=True)
    src.generate([P])
    kv = src.export_kv_pages(P)
    assert kv.n_pages == 5
    page_bytes = src._state.page_bytes(8)
    dst = _engine(causal, prefix_cache=True, prefix_bytes=3 * page_bytes)
    assert dst._prefix.capacity == 3
    assert dst.import_kv_pages(kv) == 3
    assert dst.stats["prefix_insert_drops"] == 2
    assert dst.prefix_match_len(P) == 24
    head = dst.export_kv_pages(P)
    for k in kv.payload:
        assert torch.equal(head.payload[k], kv.payload[k][:, :3])


def test_import_of_a_chain_longer_than_the_ring_is_empty(windowed):
    """A chain past the ring (a windowed arch's long prompt) imports
    nothing, as a local insert skips such prompts."""
    eng = _engine(windowed, prefix_cache=True)
    T = eng._T
    payload = {k: torch.zeros((v.shape[0], T // 8 + 1) + tuple(v.shape[2:]),
                              dtype=v.dtype)
               for k, v in PT.cache_page_pool(windowed[0], 1, 8,
                                              device="cpu").items()}
    kv = KVPages(page=8, tokens=list(range(T + 8)), payload=payload)
    assert eng.import_kv_pages(kv) == 0
    assert eng.prefix_match_len(list(range(T + 8))) == 0


def test_page_roundtrip_ring_wrap(windowed):
    """Pages whose positions straddle the ring's wrap, gathered out of one
    ring and scattered into another, land bit for bit with their
    positions (cols = position % T on both sides), as the reference's."""
    cfg, _ = windowed
    Tr = PT.attn_cache_len(cfg, 64)
    assert Tr == 64
    page = 8
    g = torch.Generator().manual_seed(7)
    ring = PT.init_cache(cfg, 2, 64, device="cpu")
    for k in ("k", "v"):
        ring[k] = torch.randn(ring[k].shape, generator=g).to(ring[k].dtype)
    positions = np.arange(60, 76)               # pages [60..67], [68..75]
    cols = (positions % Tr).reshape(2, page)
    rows = np.array([1, 1])
    pages = PT.cache_gather_pages(ring, rows, cols)
    ring2 = PT.init_cache(cfg, 2, 64, device="cpu")
    PT.cache_scatter_pages(ring2, pages, np.array([0, 0]), cols,
                           positions.reshape(2, page))
    for k in pages:
        got = ring2[k][:, 0][:, cols.ravel()]
        want = ring[k][:, 1][:, cols.ravel()]
        assert torch.equal(got.view(torch.uint16), want.view(torch.uint16))
    np.testing.assert_array_equal(ring2["pos"][0][cols.ravel()].numpy(),
                                  positions)


def test_import_rejects_mismatched_page(causal):
    rng = np.random.default_rng(8)
    P = [int(t) for t in rng.integers(0, causal[0].vocab_size, 17)]
    src = _engine(causal, prefix_cache=True)
    dst = _engine(causal, prefix_cache=True, prefix_page=4)
    src.generate([P])
    with pytest.raises(ValueError, match="page geometry"):
        dst.import_kv_pages(src.export_kv_pages(P))


def test_export_requires_prefix_cache(causal):
    eng = _engine(causal)
    with pytest.raises(RuntimeError, match="prefix_cache"):
        eng.export_kv_pages([1, 2, 3])
    with pytest.raises(RuntimeError, match="prefix_cache"):
        eng.import_kv_pages(None)
    assert eng.prefix_page is None
    assert eng.prefix_match_len([1, 2, 3]) == 0


def test_export_unknown_prompt_is_empty(causal):
    eng = _engine(causal, prefix_cache=True)
    kv = eng.export_kv_pages([5, 6, 7, 8, 9, 10, 11, 12, 13])
    assert kv.n_pages == 0 and kv.payload == {}


# ---------------------------------------------------------------------------
# validation and cancel
# ---------------------------------------------------------------------------

def test_disagg_validation(causal):
    cfg, params = causal
    with pytest.raises(ValueError, match="worker"):
        DisaggEngine(cfg, params, _scfg(), prefill_workers=0, device="cpu")
    for family in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="KV-ring"):
            DisaggEngine(cfg.replace(family=family), params, _scfg(),
                         device="cpu")
    dis = _disagg(causal)
    with pytest.raises(ValueError, match="empty"):
        dis.submit([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        dis.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError, match="drafter"):
        dis.submit([1, 2], speculate=True)
    with pytest.raises(ValueError, match="cache_len"):
        dis.submit(list(range(64)))
    dis.submit([1, 2, 3])
    with pytest.raises(RuntimeError, match="pending"):
        dis.generate([[1, 2]])


def test_disagg_defaults_to_cuda(causal):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    cfg, params = causal
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggEngine(cfg, params, _scfg())


def test_disagg_cancel_queued(causal):
    dis = _disagg(causal)
    rid = dis.submit([1, 2, 3])
    keep = dis.submit([4, 5, 6, 7])
    assert dis.cancel(rid)
    assert not dis.cancel(999)
    res = dis.run()
    assert res[rid] == []
    assert len(res[keep]) == BASE["max_new_tokens"]


def test_disagg_cancel_mid_wave(causal):
    """A cancel from ``poll`` reaches a request in the current wave before
    its hand-off (it completes with no tokens, ``on_done`` once) and one
    being decoded (it keeps what it streamed)."""
    vocab = causal[0].vocab_size
    rng = np.random.default_rng(9)
    a, b = ([int(t) for t in rng.integers(0, vocab, 20)] for _ in range(2))
    dis = _disagg(causal, max_new_tokens=20, decode_chunk=1)
    done = []
    ra = dis.submit(a, on_done=lambda r: done.append(r.id))
    rb = dis.submit(b, max_new_tokens=20, on_done=lambda r: done.append(r.id))
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


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    """Reduced tinyllama in f32 with an int8 KV ring, packed by the
    reference and carried across; the reference engine's tokens and
    exported pages on one shared-prefix queue (its own suite pins its
    disaggregated tokens to these)."""
    kw = dict(dtype="float32", kv_cache_quant=True)
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(**kw)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qp, _ = j_quantize_params(params, j_get_policy("paper_llama_mix"))
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    pcfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(**kw)
    prompts = _prompts(cfg.vocab_size, 4, seed=10)
    ref = JEngine(cfg, qp, JServeConfig(**BASE, prefix_cache=True))
    tokens = ref.generate(prompts)
    pages = [ref.export_kv_pages(p) for p in prompts]
    return cfg, qp, pcfg, pqp, prompts, tokens, pages


def test_disagg_matches_reference_engine(bridged):
    cfg, qp, pcfg, pqp, prompts, ref_tokens, _ = bridged
    dis = DisaggEngine(pcfg, pqp, _scfg(), device="cpu")
    got = dis.generate(prompts)
    assert dis.stats["migrated_pages"] > 0
    for prompt, ref, out in zip(prompts, ref_tokens, got):
        assert len(out) == len(ref)
        for t, (a, b) in enumerate(zip(ref, out)):
            if a != b:
                logits, _, _ = JT.forward_seq(
                    qp, cfg, tokens=np.asarray([prompt + ref[:t]], np.int32))
                top = np.sort(np.asarray(logits[0, -1], np.float32))
                assert top[-1] - top[-2] < MARGIN_TOL
                break


def test_exported_pages_match_reference_layout(bridged):
    """The port prefill worker's pages against the reference engine's for
    the same prompts: keys, shapes, dtypes, page axis at dim 1; int8
    codes within 1 and f32 scales within 1e-5 relative."""
    _, _, pcfg, pqp, prompts, _, ref_pages = bridged
    dis = DisaggEngine(pcfg, pqp, _scfg(), device="cpu")
    dis.generate(prompts)
    worker = dis.prefill_engines[0]
    for prompt, ref in zip(prompts, ref_pages):
        got = worker.export_kv_pages(prompt)
        assert got.page == ref.page and got.tokens == list(ref.tokens)
        if not got.tokens:              # the sub-page prompt: no page
            assert got.payload == {} and ref.payload == {}
            continue
        assert set(got.payload) == set(ref.payload) == {
            "k", "v", "k_scale", "v_scale"}
        for k, want in ref.payload.items():
            have = got.payload[k]
            assert tuple(have.shape) == want.shape
            assert have.shape[1] == got.n_pages and have.shape[2] == got.page
            assert str(have.dtype).split(".")[-1] == str(want.dtype)
            if k in ("k", "v"):
                diff = np.abs(have.numpy().astype(np.int32)
                              - want.astype(np.int32))
                assert diff.max() <= 1
            else:
                np.testing.assert_allclose(have.numpy(), want, rtol=1e-5,
                                           atol=0)
