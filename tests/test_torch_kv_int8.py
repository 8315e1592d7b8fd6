"""The port's int8 KV cache (``cfg.kv_cache_quant``) against the reference.

``_quantize_kv`` is held to the reference byte for byte (codes and f32
scales, all-zero rows included): both divide the absmax by 127 exactly
and round half to even. The model and the engine run reduced tinyllama in
f32, packed with ``paper_llama_mix``.

Tolerances:
  * prefill + decode logits and the dequantized ring, relative to the max
    magnitude: 2**-7, the packed model's tolerance of test_torch_model.py
    (a bf16 matmul input on a rounding boundary), which an int8 code on a
    half-way boundary can also move by one step.
  * ring codes: at most one step apart, on at most 1% of the entries
    (the boundary flips above); scales 2**-7 relative (a layer's K/V
    follow its inputs, which the flips above move).
  * engine tokens: equal, or a divergence where the reference's own top-2
    margin is below ``MARGIN_TOL`` (test_torch_engine.py's rule).
"""
import jax
import jax.numpy as jnp
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
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

TOL = 2.0 ** -7
MARGIN_TOL = 0.1
SCFG = dict(max_new_tokens=8, max_slots=3, decode_chunk=8, cache_len=48,
            prefill_bucket=4, prefill_chunk=8)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _kv_input(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0, 1] = 0.0                           # an all-zero row: scale 0
    x[1, 0, :3] *= 1e3                      # a row with outliers
    if dtype == "bfloat16":
        return x.astype(jnp.bfloat16)
    return x


@pytest.mark.parametrize("shape", [(4, 4, 64), (2, 3, 5, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(shape, dtype):
    x = _kv_input(shape, dtype)
    jq, js = JT._quantize_kv(jnp.asarray(x))
    xt = bridge.from_jax_params({"x": x})["x"]
    pq, ps = PT._quantize_kv(xt)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert (ps.numpy()[0, 1] == 0).all() and (pq.numpy()[0, 1] == 0).all()


def test_int8_cache_layout_matches_reference():
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(
        kv_cache_quant=True)
    pcfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        kv_cache_quant=True)
    jc = JT.init_cache(cfg, 3, 24)
    pc = PT.init_cache(pcfg, 3, 24, device="cpu")
    assert sorted(jc) == sorted(pc)
    for k in jc:
        assert tuple(pc[k].shape) == tuple(jc[k].shape), k
        assert str(pc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
    assert (PT.cache_page_bytes(pcfg, 8)
            == JT.cache_page_bytes(cfg, 8))
    assert PT.cache_page_keys(pcfg) == ("k", "v", "k_scale", "v_scale")


@pytest.fixture(scope="module")
def model():
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32", kv_cache_quant=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qp, _ = j_quantize_params(params, j_get_policy("paper_llama_mix"))
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    pcfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32", kv_cache_quant=True)
    return cfg, qp, pcfg, pqp


def test_prefill_then_decode_int8_matches_reference(model):
    cfg, qp, pcfg, pqp = model
    cfg = cfg.replace(kernel_impl="pallas")     # the kernel's f32 rounding
    B, C, Tlen = 2, 8, 24
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    lengths = np.array([C, 5], np.int32)
    jcache = JT.init_cache(cfg, B, Tlen, dtype=jnp.float32)
    pcache = PT.init_cache(pcfg, B, Tlen, dtype=torch.float32, device="cpu")
    jh, jcache = JT.prefill_chunk(
        qp, cfg, jcache, tokens=jnp.asarray(toks),
        start=jnp.asarray(0, jnp.int32), lengths=jnp.asarray(lengths),
        interpret=True)
    ph, pcache = PT.prefill_chunk(
        pqp, pcfg, pcache, tokens=torch.from_numpy(toks).long(), start=0,
        lengths=torch.from_numpy(lengths).long())
    assert _rel(ph.numpy(), jh) <= TOL
    last = lengths - 1
    jl = JT.lm_logits(qp, cfg, jh[np.arange(B), last], interpret=True)
    pos = lengths.copy()
    for live in ([True, True], [True, False]):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = JT.decode_step(
            qp, cfg, jcache, tokens=jnp.asarray(nxt),
            position=jnp.asarray(pos), live=jnp.asarray(live),
            interpret=True)
        pl, pcache = PT.decode_step(
            pqp, pcfg, pcache, tokens=torch.from_numpy(nxt).long(),
            position=torch.from_numpy(pos).long(), live=torch.tensor(live))
        rows = np.flatnonzero(live)
        assert _rel(pl.numpy()[rows], np.asarray(jl)[rows]) <= TOL
        pos = pos + np.asarray(live, np.int32)
    np.testing.assert_array_equal(pcache["pos"].numpy(), jcache["pos"])
    for k in ("k", "v"):
        assert pcache[k].dtype == torch.int8
        diff = np.abs(pcache[k].numpy().astype(np.int32)
                      - np.asarray(jcache[k]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, k
        assert _rel(pcache[f"{k}_scale"].numpy(),
                    jcache[f"{k}_scale"]) <= TOL, k
        deq = lambda c: (np.asarray(c[k], np.float32)
                         * np.asarray(c[f"{k}_scale"])[..., None])
        assert _rel(deq({kk: v.numpy() for kk, v in pcache.items()}),
                    deq(jcache)) <= TOL, k


def _prompts(vocab, n, seed=0, lo=2, hi=12):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, vocab, int(m))]
            for m in rng.integers(lo, hi, n)]


def _ref_margin(cfg, qp, seq):
    logits, _, _ = JT.forward_seq(qp, cfg.replace(kv_cache_quant=False),
                                  tokens=np.asarray([seq], np.int32))
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


def assert_tokens_match(jres, pres, prompts, cfg, qp):
    """Token for token, or a divergence at a reference near-tie (the rest
    of that request is then not compared). The margin is taken on the
    float-cache forward: an int8 ring moves logits by far less than the
    margin tolerance."""
    compared = total = 0
    for prompt, ref, got in zip(prompts, jres, pres):
        assert len(got) == len(ref)
        total += len(ref)
        for t, (a, b) in enumerate(zip(ref, got)):
            if a != b:
                margin = _ref_margin(cfg, qp, prompt + ref[:t])
                assert margin < MARGIN_TOL, (t, a, b, margin)
                break
            compared += 1
    assert compared >= 0.8 * total


def test_engine_int8_greedy_matches_reference_engine(model):
    cfg, qp, pcfg, pqp = model
    prompts = _prompts(cfg.vocab_size, 6)
    jres = JEngine(cfg, qp, JServeConfig(**SCFG)).generate(prompts)
    peng = Engine(pcfg, pqp, ServeConfig(**SCFG), device="cpu")
    pres = peng.generate(prompts)
    assert_tokens_match(jres, pres, prompts, cfg, qp)
    assert peng._cache["k"].dtype == torch.int8
    assert peng.generate_reference(prompts[:3]) == pres[:3]


def test_int8_tokens_do_not_depend_on_chunk_bounds(model):
    """The chunk attends its own keys' int8 reconstruction, so where the
    chunk boundaries fall does not change the numbers."""
    _, _, pcfg, pqp = model
    prompts = _prompts(pcfg.vocab_size, 4, seed=1, lo=10, hi=30)
    outs = [Engine(pcfg, pqp, ServeConfig(**{**SCFG, "prefill_chunk": c}),
                   device="cpu").generate(prompts) for c in (4, 8, 32)]
    assert outs[0] == outs[1] == outs[2]


def test_int8_fused_attention_equals_naive(model):
    """The fused route takes the f32 reconstructions as its K/V; it sums
    the softmax in another order than the naive route, so the two are held
    to the margin rule."""
    cfg, qp, pcfg, pqp = model
    prompts = _prompts(pcfg.vocab_size, 4, seed=2, lo=10, hi=30)
    naive = Engine(pcfg, pqp, ServeConfig(**SCFG), device="cpu")
    fused = Engine(pcfg.replace(attn_impl="fused"), pqp, ServeConfig(**SCFG),
                   device="cpu")
    assert_tokens_match(naive.generate(prompts), fused.generate(prompts),
                        prompts, cfg, qp)


def test_int8_ring_wraps_under_a_window():
    """A sliding-window arch wraps its int8 ring (codes and scales)."""
    cfg = p_get_arch("h2o-danube-1.8b", reduced=True).replace(
        kv_cache_quant=True, dtype="float32", sliding_window=16)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompts = _prompts(cfg.vocab_size, 2, seed=3, lo=20, hi=30)
    eng = Engine(cfg, params, ServeConfig(**{**SCFG, "max_new_tokens": 12,
                                             "decode_chunk": 12}),
                 device="cpu")
    got = eng.generate(prompts)
    assert eng._T == 16 and all(len(t) == 12 for t in got)
    assert eng.generate_reference(prompts) == got
