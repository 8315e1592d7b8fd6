"""The paper's other two evaluation models in the port, against the
reference: mobilellama-1.4b (dense llama family, no GQA, d_head 128) and
gpt2-paper (gpt2 family: LayerNorm, learned positions, fused qkv with
biases, GELU MLP).

Configs are mirrored field by field; the Table III layouts (49 Q2_K + 120
Q3_K, 25 Q2_K + 24 Q3_K MatMuls) follow from the mirrored policies; the
reduced models, moved across with ``bridge.from_jax_params``, are held on
``forward_seq``, ``prefill_chunk`` and decode logits at slice 1's
tolerances (``tests/test_torch_model.py``): 1e-4 unquantized in f32, 2**-7
packed (the kernel rounds matmul inputs to bf16, so a last-bit difference
on a rounding boundary moves one bf16 step). For the packed runs the
reference uses its Pallas kernel in interpret mode. The engine's greedy
tokens must equal the reference engine's, with slice 1's margin rule
(``tests/test_torch_engine.py``): a divergence is accepted only where the
reference's own top-2 logit margin at that step is below 0.1.

JAX clamps an out-of-range gather index, and the reference reads ``wpe``
past ``max_position`` for the padding columns of a prefill chunk; the
port clamps there too, shown with ``cache_len == max_position``.
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
from repro_torch.benchmarks.shapes import model_matmuls
from repro_torch.configs import base as PC
from repro_torch.core import policy as PP
from repro_torch.core import qlinear as PL
from repro_torch.core.quantize import QTensor
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

TOL = 1e-4
TOL_PACKED = 2.0 ** -7
MARGIN_TOL = 0.1
NEW_ARCHS = ("mobilellama-1.4b", "gpt2-paper")
PAPER_MIX = {"tinyllama-1.1b": "paper_llama_mix",
             "mobilellama-1.4b": "paper_llama_mix",
             "gpt2-paper": "paper_gpt2_mix"}
TABLE3 = {"tinyllama-1.1b": {"q2_k": 45, "q3_k": 110},
          "mobilellama-1.4b": {"q2_k": 49, "q3_k": 120},
          "gpt2-paper": {"q2_k": 25, "q3_k": 24}}


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


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirror(arch, reduced):
    j = dataclasses.asdict(JC.get_arch(arch, reduced=reduced))
    p = dataclasses.asdict(PC.get_arch(arch, reduced=reduced))
    assert p == j
    assert set(PC.ARCH_IDS) <= set(JC.ARCH_IDS)


@pytest.mark.parametrize("arch", sorted(TABLE3))
def test_table3_layout(arch):
    """Each model's MatMuls under its paper mix: the Table III counts."""
    counts = {}
    jpol = j_get_policy(PAPER_MIX[arch])
    pol = PP.get_policy(PAPER_MIX[arch])
    for path, K, N in model_matmuls(PC.get_arch(arch)):
        v = pol.variant_for(path, K, N)
        assert v == jpol.variant_for(path, K, N)
        counts[v] = counts.get(v, 0) + 1
    assert counts == TABLE3[arch]


@pytest.fixture(scope="module", params=NEW_ARCHS)
def model(request):
    """(arch, reference f32 params, the same packed under its paper mix)."""
    arch = request.param
    cfg = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qp, report = j_quantize_params(params, j_get_policy(PAPER_MIX[arch]))
    return arch, params, qp, report


def test_quantize_params_matches_reference(model):
    arch, params, qp, jrep = model
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    pq, prep = PL.quantize_params(pparams, PP.get_policy(PAPER_MIX[arch]))
    assert prep == jrep
    jflat = dict(j_flatten_paths(qp))
    for path, leaf in PL._flatten_paths(pq):
        j = jflat[path]
        if isinstance(leaf, QTensor):
            assert leaf.variant == j.variant and leaf.shape == tuple(j.shape)
            for k in j.data:
                assert _same_bytes(j.data[k], leaf.data[k]), (path, k)
        else:
            assert _same_bytes(j, leaf), path
    L = PC.get_arch(arch, reduced=True).n_layers
    counts = PL.variant_counts(prep, pq)
    if arch == "gpt2-paper":     # q2_k on c_attn, c_fc, lm_head
        assert counts == {"q2_k": 2 * L + 1, "q3_k": 2 * L}
    else:                        # q2_k on wk, wv, lm_head
        assert counts == {"q2_k": 2 * L + 1, "q3_k": 5 * L}


@pytest.mark.parametrize("packed", [False, True])
def test_forward_seq_matches_reference(model, packed):
    arch, params, qp, _ = model
    cfg = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    pcfg = PC.get_arch(arch, reduced=True).replace(dtype="float32")
    tree = qp if packed else params
    if packed:
        cfg = cfg.replace(kernel_impl="pallas")
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, tree))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    jl, _, _ = jax.jit(JT.forward_seq,
                       static_argnames=("cfg", "interpret"))(
        tree, cfg, tokens=jnp.asarray(toks, jnp.int32), interpret=True)
    pl = PT.forward_seq(pparams, pcfg, tokens=torch.from_numpy(toks))
    assert pl.shape == (2, 12, cfg.vocab_size)
    assert _rel(pl.numpy(), jl) <= (TOL_PACKED if packed else TOL)


@pytest.mark.parametrize("packed", [False, True])
def test_prefill_then_decode_matches_reference(model, packed):
    """One prefill chunk over a ragged batch, then two decode steps (the
    second with a dead slot): logits, hidden states and the cache."""
    arch, params, qp, _ = model
    cfg = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    pcfg = PC.get_arch(arch, reduced=True).replace(dtype="float32")
    tree = qp if packed else params
    if packed:
        cfg = cfg.replace(kernel_impl="pallas")
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, tree))
    tol = TOL_PACKED if packed else TOL
    prefill = jax.jit(JT.prefill_chunk, static_argnames=("cfg", "interpret"))
    decode = jax.jit(JT.decode_step, static_argnames=("cfg", "interpret"))
    logits = jax.jit(JT.lm_logits, static_argnames=("cfg", "interpret"))

    B, C, Tlen = 2, 8, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, C))
    lengths = np.array([C, 5], np.int32)
    jcache = JT.init_cache(cfg, B, Tlen, dtype=jnp.float32)
    pcache = PT.init_cache(pcfg, B, Tlen, dtype=torch.float32, device="cpu")
    jh, jcache = prefill(tree, cfg, jcache,
                         tokens=jnp.asarray(toks, jnp.int32),
                         start=jnp.asarray(0, jnp.int32),
                         lengths=jnp.asarray(lengths), interpret=True)
    ph, pcache = PT.prefill_chunk(pparams, pcfg, pcache,
                                  tokens=torch.from_numpy(toks), start=0,
                                  lengths=torch.from_numpy(lengths).long())
    assert _rel(ph.numpy(), jh) <= tol
    last = lengths - 1
    jl = logits(tree, cfg, jh[np.arange(B), last], interpret=True)
    pl = PT.lm_logits(pparams, pcfg, ph[torch.arange(B), last])
    assert _rel(pl.numpy(), jl) <= tol

    pos = lengths.copy()
    for step, live in enumerate(([True, True], [True, False])):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = decode(tree, cfg, jcache, tokens=jnp.asarray(nxt),
                            position=jnp.asarray(pos),
                            live=jnp.asarray(live), interpret=True)
        pl, pcache = PT.decode_step(pparams, pcfg, pcache,
                                    tokens=torch.from_numpy(nxt).long(),
                                    position=torch.from_numpy(pos).long(),
                                    live=torch.tensor(live))
        rows = np.flatnonzero(live)
        assert _rel(pl.numpy()[rows], np.asarray(jl)[rows]) <= tol, step
        pos = pos + np.asarray(live, np.int32)
    np.testing.assert_array_equal(pcache["pos"].numpy(), jcache["pos"])
    for k in ("k", "v"):
        assert _rel(pcache[k].numpy(), jcache[k]) <= tol, k


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


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_matches_reference_engine(arch):
    """The serve_quantized workload (as test_torch_engine's) on each model
    in bf16 under its paper mix."""
    cfg = JC.get_arch(arch, reduced=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    qp, _ = j_quantize_params(params, j_get_policy(PAPER_MIX[arch]))
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
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


def test_gpt2_positions_clamp_at_max_position():
    """cache_len == max_position (256 in the reduced config): a 250-token
    prompt in 48-token prefill chunks pads to 288 columns, so the last
    chunk's padding columns sit at positions 256..287, past ``wpe``. The
    reference clamps the gather there (JAX), and so does the port: the
    same greedy tokens, and the chunk's hidden states agree."""
    arch = "gpt2-paper"
    cfg = JC.get_arch(arch, reduced=True)
    T = cfg.max_position
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    qp, _ = j_quantize_params(params, j_get_policy(PAPER_MIX[arch]))
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    prompt = [int(t) for t in np.random.default_rng(2).integers(
        0, cfg.vocab_size, 250)]
    scfg = dict(max_new_tokens=6, max_slots=1, decode_chunk=6, cache_len=T,
                prefill_chunk=48, prefill_batch=1)
    jres = JEngine(cfg, qp, JServeConfig(**scfg)).generate([prompt])
    eng = Engine(PC.get_arch(arch, reduced=True), pqp, ServeConfig(**scfg),
                 device="cpu")
    assert eng._group_shape([250])[:2] == (288, 48)
    got = eng.generate([prompt])
    _assert_tokens_match(cfg, qp, [prompt], jres, got, 6)

    # the last chunk alone, in f32, unquantized: positions 240..287
    cfg32 = cfg.replace(dtype="float32")
    pcfg32 = PC.get_arch(arch, reduced=True).replace(dtype="float32")
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    toks = np.asarray([prompt[240:] + [0] * 38], np.int64)
    jh, _ = JT.prefill_chunk(
        params, cfg32, JT.init_cache(cfg32, 1, T, dtype=jnp.float32),
        tokens=jnp.asarray(toks, jnp.int32),
        start=jnp.asarray(240, jnp.int32), lengths=jnp.asarray([250]))
    ph, _ = PT.prefill_chunk(
        pparams, pcfg32, PT.init_cache(pcfg32, 1, T, dtype=torch.float32,
                                       device="cpu"),
        tokens=torch.from_numpy(toks), start=240,
        lengths=torch.tensor([250]))
    assert ph.shape == (1, 48, cfg.d_model)
    assert _rel(ph.numpy(), jh) <= TOL
