"""The rest of the dense llama family in the port, against the reference:
llama3.2-1b (LM head tied to the embedding), qwen3-1.7b (per-head
RMSNorm on q and k), phi3-mini-3.8b (no GQA, d_head 96 at full width) and
h2o-danube-1.8b (sliding window).

Configs are mirrored field by field; the parameter tree has the
reference's paths and shapes (no ``lm_head`` when tied, ``q_norm`` and
``k_norm`` under qk-norm). The reduced models, moved across with
``bridge.from_jax_params``, are held on ``forward_seq``, ``prefill_chunk``
and two decode steps in f32, unpacked, at 1e-4 relative to the largest
logit (the f32 summation order differs between the frameworks). Packed
under ``paper_llama_mix``, the report equals the reference's and every
payload is bit-exact. The engine's greedy tokens equal the reference
engine's under the top-2 margin rule of ``tests/test_torch_engine.py``:
a divergence is accepted only where the reference's own top-2 logit
margin at that step is below 0.1. h2o-danube's ring (its 64-token window
in the reduced config) wraps in the last test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import _flatten_paths as j_flatten_paths
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.core import policy as PP
from repro_torch.core import qlinear as PL
from repro_torch.core.quantize import QTensor
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

TOL = 1e-4
MARGIN_TOL = 0.1
ARCHS = ("llama3.2-1b", "qwen3-1.7b", "phi3-mini-3.8b", "h2o-danube-1.8b")
POLICY = "paper_llama_mix"


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _same_bytes(a, b: torch.Tensor) -> bool:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
        b = b.view(torch.int16)
    b = b.numpy()
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _cfgs(arch, **kw):
    return (JC.get_arch(arch, reduced=True).replace(**kw),
            PC.get_arch(arch, reduced=True).replace(**kw))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirror(arch, reduced):
    j = dataclasses.asdict(JC.get_arch(arch, reduced=reduced))
    p = dataclasses.asdict(PC.get_arch(arch, reduced=reduced))
    assert p == j
    assert arch in PC.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    jcfg, pcfg = _cfgs(arch)
    jtree = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    ptree = PT.init_params(pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jshapes = {p: tuple(a.shape) for p, a in j_flatten_paths(jtree)}
    pshapes = {p: tuple(t.shape) for p, t in PL._flatten_paths(ptree)}
    assert pshapes == jshapes
    assert ("lm_head" in pshapes) == (not pcfg.tie_embeddings)
    assert ("layers/attn/q_norm" in pshapes) == pcfg.qk_norm
    if pcfg.qk_norm:
        L, Dh = pcfg.n_layers, pcfg.d_head
        assert pshapes["layers/attn/k_norm"] == (L, Dh)
        assert bool((ptree["layers"]["attn"]["q_norm"] == 1).all())


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference f32 params, the same packed under paper_llama_mix,
    its report, and the float params moved to the port)."""
    arch = request.param
    cfg = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qp, report = j_quantize_params(params, j_get_policy(POLICY))
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    return arch, params, qp, report, pparams


def test_quantize_params_matches_reference(model):
    """The report equals the reference's (``q_norm``/``k_norm`` and the
    embedding stay float), every payload bit-exact."""
    arch, _, qp, jrep, pparams = model
    pq, prep = PL.quantize_params(pparams, PP.get_policy(POLICY))
    assert prep == jrep
    cfg = PC.get_arch(arch, reduced=True)
    if cfg.qk_norm:
        assert prep["layers/attn/q_norm"] is None
        assert prep["layers/attn/k_norm"] is None
    assert prep["wte"] is None
    jflat = dict(j_flatten_paths(qp))
    for path, leaf in PL._flatten_paths(pq):
        j = jflat[path]
        if isinstance(leaf, QTensor):
            assert leaf.variant == j.variant and leaf.shape == tuple(j.shape)
            for k in j.data:
                assert _same_bytes(j.data[k], leaf.data[k]), (path, k)
        else:
            assert _same_bytes(j, leaf), path
    L = cfg.n_layers
    head = 0 if cfg.tie_embeddings else 1       # q2_k on wk, wv, lm_head
    assert PL.variant_counts(prep, pq) == {"q2_k": 2 * L + head,
                                           "q3_k": 5 * L}


def test_forward_seq_matches_reference(model):
    arch, params, _, _, pparams = model
    cfg, pcfg = _cfgs(arch, dtype="float32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    jl, _, _ = jax.jit(JT.forward_seq, static_argnames=("cfg",))(
        params, cfg, tokens=jnp.asarray(toks, jnp.int32))
    pl = PT.forward_seq(pparams, pcfg, tokens=torch.from_numpy(toks))
    assert pl.shape == (2, 12, cfg.vocab_size)
    assert _rel(pl.numpy(), jl) <= TOL


def test_prefill_then_decode_matches_reference(model):
    """One prefill chunk over a ragged batch, then two decode steps (the
    second with a dead slot): logits, hidden states and the cache."""
    arch, params, _, _, pparams = model
    cfg, pcfg = _cfgs(arch, dtype="float32")
    prefill = jax.jit(JT.prefill_chunk, static_argnames=("cfg",))
    decode = jax.jit(JT.decode_step, static_argnames=("cfg",))
    B, C, Tlen = 2, 8, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, C))
    lengths = np.array([C, 5], np.int32)
    jcache = JT.init_cache(cfg, B, Tlen, dtype=jnp.float32)
    pcache = PT.init_cache(pcfg, B, Tlen, dtype=torch.float32, device="cpu")
    jh, jcache = prefill(params, cfg, jcache,
                         tokens=jnp.asarray(toks, jnp.int32),
                         start=jnp.asarray(0, jnp.int32),
                         lengths=jnp.asarray(lengths))
    ph, pcache = PT.prefill_chunk(pparams, pcfg, pcache,
                                  tokens=torch.from_numpy(toks), start=0,
                                  lengths=torch.from_numpy(lengths).long())
    assert _rel(ph.numpy(), jh) <= TOL
    last = lengths - 1
    jl = JT.lm_logits(params, cfg, jh[np.arange(B), last])
    pl = PT.lm_logits(pparams, pcfg, ph[torch.arange(B), last])
    assert _rel(pl.numpy(), jl) <= TOL

    pos = lengths.copy()
    for step, live in enumerate(([True, True], [True, False])):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = decode(params, cfg, jcache, tokens=jnp.asarray(nxt),
                            position=jnp.asarray(pos),
                            live=jnp.asarray(live))
        pl, pcache = PT.decode_step(pparams, pcfg, pcache,
                                    tokens=torch.from_numpy(nxt).long(),
                                    position=torch.from_numpy(pos).long(),
                                    live=torch.tensor(live))
        rows = np.flatnonzero(live)
        assert _rel(pl.numpy()[rows], np.asarray(jl)[rows]) <= TOL, step
        pos = pos + np.asarray(live, np.int32)
    np.testing.assert_array_equal(pcache["pos"].numpy(), jcache["pos"])
    for k in ("k", "v"):
        assert _rel(pcache[k].numpy(), jcache[k]) <= TOL, k


def _ref_margin(cfg, qp, seq):
    """The reference's top-2 logit margin predicting the token after
    ``seq`` (a full-sequence forward, same packed weights)."""
    logits, _, _ = JT.forward_seq(qp, cfg, tokens=np.asarray([seq], np.int32))
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


def _assert_tokens_match(cfg, qp, prompts, ref, got, budget):
    compared = 0
    for prompt, r, g in zip(prompts, ref, got):
        assert len(r) == len(g) == budget
        for t, (a, b) in enumerate(zip(r, g)):
            if a != b:
                margin = _ref_margin(cfg, qp, prompt + r[:t])
                assert margin < MARGIN_TOL, (t, a, b, margin)
                break
            compared += 1
    # ties are rare: nearly every token must have been compared
    assert compared >= 0.8 * len(prompts) * budget


def _packed_bf16(arch, seed=0):
    cfg = JC.get_arch(arch, reduced=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    qp, _ = j_quantize_params(params, j_get_policy(POLICY))
    return cfg, qp, bridge.from_jax_params(jax.tree.map(np.asarray, qp))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch):
    """The serve_quantized workload (as test_torch_engine's) on each model
    in bf16 under paper_llama_mix."""
    cfg, qp, pqp = _packed_bf16(arch)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 6)]
               for _ in range(6)]
    scfg = dict(max_new_tokens=10, max_slots=2, decode_chunk=10,
                cache_len=32)
    jres = JEngine(cfg, qp, JServeConfig(**scfg)).generate(prompts)
    eng = Engine(PC.get_arch(arch, reduced=True), pqp, ServeConfig(**scfg),
                 device="cpu")
    got = eng.generate(prompts)
    _assert_tokens_match(cfg, qp, prompts, jres, got, 10)
    assert eng.generate_reference(prompts[:2]) == got[:2]


def test_sliding_window_ring_wraps():
    """h2o-danube's reduced window is 64, so the ring holds 64 slots. A
    60-token prompt in 32-token prefill chunks, then 12 new tokens, runs
    to position 71: the ring wraps and the window drops the oldest keys.
    Decode logits in f32 (unpacked) equal the reference's at 1e-4 at every
    step, and the packed engines give the same greedy tokens on it and
    three more prompts of 50 to 58 tokens (two slots)."""
    arch = "h2o-danube-1.8b"
    cfg, pcfg = _cfgs(arch, dtype="float32")
    assert cfg.sliding_window == 64
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    prompt = [int(t) for t in np.random.default_rng(2).integers(
        0, cfg.vocab_size, 60)]
    n_new = 12
    T = PT.attn_cache_len(pcfg, 256)
    assert T == 64 and len(prompt) + n_new > T

    prefill = jax.jit(JT.prefill_chunk, static_argnames=("cfg",))
    decode = jax.jit(JT.decode_step, static_argnames=("cfg",))
    jcache = JT.init_cache(cfg, 1, 256, dtype=jnp.float32)
    pcache = PT.init_cache(pcfg, 1, 256, dtype=torch.float32, device="cpu")
    assert jcache["k"].shape == tuple(pcache["k"].shape)
    toks = np.asarray([prompt + [0] * 4], np.int32)
    for start in (0, 32):
        jh, jcache = prefill(params, cfg, jcache,
                             tokens=jnp.asarray(toks[:, start:start + 32]),
                             start=jnp.asarray(start, jnp.int32),
                             lengths=jnp.asarray([60]))
        ph, pcache = PT.prefill_chunk(
            pparams, pcfg, pcache,
            tokens=torch.from_numpy(toks[:, start:start + 32]).long(),
            start=start, lengths=torch.tensor([60]))
        assert _rel(ph.numpy(), jh) <= TOL, start
    jl = JT.lm_logits(params, cfg, jh[:, 27])
    pl = PT.lm_logits(pparams, pcfg, ph[:, 27])
    for step in range(n_new):
        assert _rel(pl.numpy(), jl) <= TOL, step
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = np.asarray([60 + step], np.int32)
        jl, jcache = decode(params, cfg, jcache, tokens=jnp.asarray(nxt),
                            position=jnp.asarray(pos))
        pl, pcache = PT.decode_step(pparams, pcfg, pcache,
                                    tokens=torch.from_numpy(nxt).long(),
                                    position=torch.from_numpy(pos).long())
    assert _rel(pl.numpy(), jl) <= TOL
    np.testing.assert_array_equal(pcache["pos"].numpy(), jcache["pos"])
    assert int(pcache["pos"].max()) == 71 and int(pcache["pos"].min()) == 8

    cfg16, qp, pqp = _packed_bf16(arch, seed=1)
    scfg = dict(max_new_tokens=n_new, max_slots=2, decode_chunk=n_new,
                cache_len=256, prefill_chunk=32)
    rng = np.random.default_rng(3)
    prompts = [prompt] + [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                        n)]
                          for n in (58, 54, 50)]
    jres = JEngine(cfg16, qp, JServeConfig(**scfg)).generate(prompts)
    got = Engine(PC.get_arch(arch, reduced=True), pqp, ServeConfig(**scfg),
                 device="cpu").generate(prompts)
    _assert_tokens_match(cfg16, qp, prompts, jres, got, n_new)
