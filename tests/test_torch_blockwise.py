"""The port's blockwise attention against the reference.

``layers.blockwise_attention`` is the reference's exact online softmax
over KV chunks, with the causal (and window) KV-chunk range, in plain
torch: the reference has no kernel for it. It is held in f32 against
``repro.models.layers.blockwise_attention`` and against the port's
``naive_attention`` at S = 64 with chunks of 16, GQA (4 heads on 2 KV
heads), a window and a softcap, causal and not. The tolerance is 1e-5
relative to the largest output: the same f32 arithmetic, summed in
another order (the naive path materializes the whole softmax).
``forward_seq`` under ``attn_impl="blockwise"`` is held against the
reference's at 1e-4, as the other forward tests of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.models import layers as L
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

TOL = 1e-5
TOL_MODEL = 1e-4
B, S, H, KH, D = 2, 64, 4, 2, 32
CHUNK = 16
CASES = [dict(causal=True), dict(causal=True, window=24),
         dict(causal=True, softcap=5.0),
         dict(causal=True, window=20, softcap=5.0),
         dict(causal=False), dict(causal=False, window=24, softcap=5.0)]


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _qkv(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D), np.float32) * 2
    k = rng.standard_normal((B, S, KH, D), np.float32) * 2
    v = rng.standard_normal((B, S, KH, D), np.float32)
    return q, k, v


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_blockwise_matches_reference_and_naive(case):
    q, k, v = _qkv(0)
    got = L.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), q_chunk=CHUNK,
        kv_chunk=CHUNK, **case)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    ref = JL.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), q_chunk=CHUNK, kv_chunk=CHUNK,
        **case)
    assert _rel(got.numpy(), ref) <= TOL
    naive = L.naive_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              **case)
    assert _rel(got.numpy(), naive.numpy()) <= TOL


def test_blockwise_rejects_ragged_chunks():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1))
    with pytest.raises(ValueError, match="q_chunk"):
        L.blockwise_attention(q, k, v, q_chunk=24, kv_chunk=CHUNK)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "h2o-danube-1.8b"])
def test_forward_seq_blockwise_matches_reference(arch):
    """Reduced llama3.2-1b (tied head) and h2o-danube-1.8b (window 64 over
    96 tokens) in f32, unpacked, 32-token chunks, against the reference's
    blockwise forward; and against the port's own naive forward."""
    kw = dict(dtype="float32", attn_impl="blockwise", attn_q_chunk=32,
              attn_kv_chunk=32)
    cfg = JC.get_arch(arch, reduced=True).replace(**kw)
    pcfg = PC.get_arch(arch, reduced=True).replace(**kw)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 96))
    jl, _, _ = jax.jit(JT.forward_seq, static_argnames=("cfg",))(
        params, cfg, tokens=jnp.asarray(toks, jnp.int32))
    pl = PT.forward_seq(pparams, pcfg, tokens=torch.from_numpy(toks))
    assert _rel(pl.numpy(), jl) <= TOL_MODEL
    naive = PT.forward_seq(pparams, pcfg.replace(attn_impl="naive"),
                           tokens=torch.from_numpy(toks))
    assert _rel(pl.numpy(), naive.numpy()) <= TOL_MODEL

