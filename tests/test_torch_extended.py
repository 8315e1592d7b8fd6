"""Slice 2 of the port: reduced tinyllama under ``extended_mix`` with the
fused prefill attention, against the reference.

``extended_mix`` packs ``attn/wv`` and ``mlp/w_down`` as Q4_K, the LM head
as Q6_K and every other projection as Q3_K. The reference packs the
weights once (module fixture); ``bridge.from_jax_params`` carries them
into the port byte for byte. The reference's functions run under
``jax.jit`` here, as its engine runs them (eager, its Pallas kernels in
interpret mode are traced anew at every call). Prompts of 20 to 40 tokens
stream through 16-token prefill chunks against a 64-slot ring, so later
chunks attend a partly filled ring.

Model (prefill chunks with ``attn_impl="fused"``, then decode steps),
tolerances relative to the max magnitude of the compared tensor:
  * f32 model: 2**-7, one bf16 ulp at the max. Every matmul rounds its
    input to bf16 on both sides (the reference through its Pallas kernel
    in interpret mode), so an activation that differs in its last f32 bit
    and sits on a bf16 rounding boundary rounds one bf16 step the other
    way, and that step propagates (the kernels alone agree to 1e-5 and
    5e-6: test_torch_kernels, test_torch_attn).
  * bf16 model: 2**-6, two bf16 ulps at the max. Activations, the K/V
    ring and every residual add round to bf16 at each step on both sides,
    at places the two frameworks choose differently (fused elementwise
    chains in XLA, one op at a time in PyTorch); over two layers and
    three chunks the flips add up to just over one bf16 ulp (8.6e-3 at
    most on this workload).

Engine: the reference engine has no interpret mode, so it cannot take the
fused route on the CPU. The port's engine is held to the reference engine
token for token on the naive route, and its fused route to its naive
route; greedy ties follow the margin rule of ``test_torch_engine.py``.
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
from repro_torch.core import policy as PP
from repro_torch.core import qlinear as PQL
from repro_torch.core.quantize import QTensor
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Engine, ServeConfig

torch.set_num_threads(2)

TOL_F32 = 2.0 ** -7
TOL_BF16 = 2.0 ** -6
MARGIN_TOL = 0.1
SCFG = dict(max_new_tokens=8, max_slots=2, decode_chunk=8, cache_len=64,
            prefill_chunk=16)


@pytest.fixture(scope="module")
def packed():
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    params = jax.jit(JT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    report = {}

    def pack(p):        # the report is filled while jit traces
        q, rep = j_quantize_params(p, j_get_policy("extended_mix"))
        report.update(rep)
        return q
    qp = jax.jit(pack)(params)
    rng = np.random.default_rng(14)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(20, 41, 5)]
    npp = jax.tree.map(np.asarray, params)
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    return cfg, npp, qp, report, pqp, prompts


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def test_port_packs_extended_mix_like_the_reference(packed):
    """The port's own quantize_params gives the reference's report and
    payloads (q3_k, q4_k and q6_k), and the launch layout of the path."""
    _, npp, qp, report, pqp, _ = packed
    mine, prep = PQL.quantize_params(bridge.from_jax_params(npp),
                                     PP.get_policy("extended_mix"))
    assert prep == report
    assert PQL.variant_counts(prep, mine) == {"q3_k": 10, "q4_k": 4,
                                              "q6_k": 1}
    for (path, a), (_, b) in zip(PQL._flatten_paths(mine),
                                 PQL._flatten_paths(pqp)):
        if isinstance(a, QTensor):
            assert a.variant == b.variant, path
            for k in a.data:
                assert torch.equal(a.data[k], b.data[k]), (path, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_prefill_then_decode_matches_reference(packed, dtype):
    cfg0, _, qp, _, pqp, prompts = packed
    jcfg = cfg0.replace(dtype=dtype, attn_impl="fused", kernel_impl="pallas")
    pcfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype=dtype, attn_impl="fused")
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)

    B, C, Tlen = 2, 16, 64
    lens = np.array([len(prompts[0]), len(prompts[1])], np.int32)
    P = -(-int(lens.max()) // C) * C
    toks = np.zeros((B, P), np.int32)
    for b in range(B):
        toks[b, :lens[b]] = prompts[b]
    prefill = jax.jit(JT.prefill_chunk, static_argnames=("cfg", "interpret"))
    decode = jax.jit(JT.decode_step, static_argnames=("cfg", "interpret"))
    jcache = JT.init_cache(jcfg, B, Tlen, dtype=jdt)
    pcache = PT.init_cache(pcfg, B, Tlen, dtype=tdt, device="cpu")
    last = lens - 1
    first = np.zeros(B, np.int32)       # each row's first generated token
    for start in range(0, P, C):
        jh, jcache = prefill(
            qp, cfg=jcfg, cache=jcache,
            tokens=jnp.asarray(toks[:, start:start + C]),
            start=jnp.asarray(start, jnp.int32), lengths=jnp.asarray(lens),
            interpret=True)
        ph, pcache = PT.prefill_chunk(
            pqp, pcfg, pcache,
            tokens=torch.from_numpy(toks[:, start:start + C]).long(),
            start=start, lengths=torch.from_numpy(lens).long())
        rows = np.flatnonzero((last >= start) & (last < start + C))
        if len(rows):
            jl = JT.lm_logits(qp, jcfg, jh[rows, last[rows] - start],
                              interpret=True)
            pl = PT.lm_logits(pqp, pcfg, ph[rows, last[rows] - start])
            assert _rel(_np(pl), jl) <= tol, start
            first[rows] = np.asarray(jnp.argmax(jl, -1))
    pos, nxt = lens.copy(), first
    for step in range(2):
        jl, jcache = decode(
            qp, cfg=jcfg, cache=jcache, tokens=jnp.asarray(nxt),
            position=jnp.asarray(pos), interpret=True)
        pl, pcache = PT.decode_step(
            pqp, pcfg, pcache, tokens=torch.from_numpy(nxt).long(),
            position=torch.from_numpy(pos).long())
        assert _rel(_np(pl), jl) <= tol, step
        pos, nxt = pos + 1, np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    np.testing.assert_array_equal(pcache["pos"].numpy(), jcache["pos"])
    for k in ("k", "v"):
        assert _rel(_np(pcache[k]), jnp.asarray(jcache[k], jnp.float32)) \
            <= tol, k


def _port_engine(pqp, attn_impl="auto", **kw):
    cfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        attn_impl=attn_impl)
    return Engine(cfg, pqp, ServeConfig(**{**SCFG, **kw}), device="cpu")


def _ref_margin(cfg, qp, seq):
    """The reference model's top-2 logit margin predicting the token after
    ``seq`` (a full-sequence forward, same packed weights)."""
    logits, _, _ = JT.forward_seq(qp, cfg, tokens=np.asarray([seq], np.int32))
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


def _assert_same_or_tie(cfg, qp, prompts, ref, got):
    """Token for token, except past a step where the reference's own top-2
    margin is below MARGIN_TOL (a near-tie either side may break)."""
    compared = 0
    for prompt, a_toks, b_toks in zip(prompts, ref, got):
        assert len(a_toks) == len(b_toks) == SCFG["max_new_tokens"]
        for t, (a, b) in enumerate(zip(a_toks, b_toks)):
            if a != b:
                margin = _ref_margin(cfg, qp, prompt + a_toks[:t])
                assert margin < MARGIN_TOL, (t, a, b, margin)
                break
            compared += 1
    assert compared >= 0.8 * len(prompts) * SCFG["max_new_tokens"]


def test_engine_matches_reference_engine_naive(packed):
    cfg, _, qp, _, pqp, prompts = packed
    jeng = JEngine(cfg, qp, JServeConfig(**SCFG))
    ids = [jeng.submit(p) for p in prompts]
    jres = jeng.run()
    got = _port_engine(pqp).generate(prompts)
    _assert_same_or_tie(cfg, qp, prompts, [jres[i] for i in ids], got)


def test_engine_fused_route(packed):
    """The fused route gives the naive route's tokens, batched admission
    equals sequential admission, and generate equals generate_reference."""
    cfg, _, qp, _, pqp, prompts = packed
    naive = _port_engine(pqp).generate(prompts)
    batched = _port_engine(pqp, "fused", max_slots=4,
                           prefill_batch=4).generate(prompts)
    _assert_same_or_tie(cfg, qp, prompts, naive, batched)
    seq = _port_engine(pqp, "fused", max_slots=4,
                       prefill_batch=1).generate(prompts)
    assert seq == batched
    eng = _port_engine(pqp, "fused", decode_chunk=3)
    assert eng.generate(prompts[:2]) == eng.generate_reference(prompts[:2])
