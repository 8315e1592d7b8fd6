"""The port's dense transformer against the reference, on bridged params.

Reduced tinyllama, run in f32 (model and cache) so the comparison is
tight: one prefill chunk over a ragged batch, then decode steps (one with
a dead slot), compared on logits and on the cache contents. Unquantized,
and packed with ``paper_llama_mix``; for the packed run the reference uses
its Pallas kernel in interpret mode (``kernel_impl="pallas"``), because at
f32 its XLA path rounds each product to bf16 before the output cast and
the kernel does not.

Tolerances, relative to the max magnitude of the compared tensor:
  * unquantized: 1e-4. Both sides compute in f32; they differ in summation
    order (matmuls, softmax, norms) and in the last ulp of pow/cos/sin.
  * packed: 2**-7, one bf16 ulp at the max. The kernel rounds every matmul
    input to bf16 (8 significant bits), so an activation that differs in
    its last f32 bit and sits on a bf16 rounding boundary rounds one bf16
    step the other way, and that step propagates through the layers (the
    kernel alone, on equal inputs, agrees to 1e-5: test_torch_kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.core.quantize import QTensor as JQTensor
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.base import get_arch as p_get_arch
from repro_torch.core.quantize import QTensor
from repro_torch.models import layers as PLY
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

TOL = 1e-4
TOL_PACKED = 2.0 ** -7


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _np_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_roundtrip_bit_exact(dtype):
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(1), dtype=dtype)
    qp, _ = j_quantize_params(params, j_get_policy("paper_llama_mix"))
    for tree in (params, qp):
        npt = jax.tree.map(np.asarray, tree)
        pt = bridge.from_jax_params(npt)
        jl = jax.tree.leaves(npt, is_leaf=lambda x: isinstance(x, JQTensor))
        flat = []

        def walk(n):
            if isinstance(n, dict):
                for k in sorted(n):
                    walk(n[k])
            else:
                flat.append(n)
        walk(pt)
        assert len(flat) == len(jl)
        for j, p in zip(jl, flat):
            if isinstance(j, JQTensor):
                assert isinstance(p, QTensor) and p.variant == j.variant
                assert tuple(p.shape) == tuple(j.shape)
                for k in j.data:
                    np.testing.assert_array_equal(_to_numpy(p.data[k]),
                                                  _np_bits(j.data[k]))
            else:
                np.testing.assert_array_equal(_to_numpy(p), _np_bits(j))


@pytest.mark.parametrize("policy", [None, "paper_llama_mix"])
def test_prefill_then_decode_matches_reference(policy):
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(dtype="float32")
    pcfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    if policy is not None:
        params, _ = j_quantize_params(params, j_get_policy(policy))
        cfg = cfg.replace(kernel_impl="pallas")
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    tol = TOL if policy is None else TOL_PACKED

    B, C, Tlen = 2, 8, 32
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    lengths = np.array([C, 5], np.int32)
    jcache = JT.init_cache(cfg, B, Tlen, dtype=jnp.float32)
    pcache = PT.init_cache(pcfg, B, Tlen, dtype=torch.float32, device="cpu")

    jh, jcache = JT.prefill_chunk(
        params, cfg, jcache, tokens=jnp.asarray(toks),
        start=jnp.asarray(0, jnp.int32), lengths=jnp.asarray(lengths),
        interpret=True)
    ph, pcache = PT.prefill_chunk(
        pparams, pcfg, pcache, tokens=torch.from_numpy(toks).long(),
        start=0, lengths=torch.from_numpy(lengths).long())
    assert _rel(ph.numpy(), jh) <= tol
    last = lengths - 1
    jl = JT.lm_logits(params, cfg, jh[np.arange(B), last], interpret=True)
    pl = PT.lm_logits(pparams, pcfg, ph[torch.arange(B), last])
    assert _rel(pl.numpy(), jl) <= tol

    pos = lengths.copy()
    for step, live in enumerate(([True, True], [True, False])):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = JT.decode_step(
            params, cfg, jcache, tokens=jnp.asarray(nxt),
            position=jnp.asarray(pos), live=jnp.asarray(live),
            interpret=True)
        pl, pcache = PT.decode_step(
            pparams, pcfg, pcache, tokens=torch.from_numpy(nxt).long(),
            position=torch.from_numpy(pos).long(),
            live=torch.tensor(live))
        assert pl.shape == (B, cfg.vocab_size) and pl.dtype == torch.float32
        # a dead slot's logits are garbage by contract: compare live rows
        rows = np.flatnonzero(live)
        assert _rel(pl.numpy()[rows], np.asarray(jl)[rows]) <= tol, step
        pos = pos + np.asarray(live, np.int32)

    np.testing.assert_array_equal(pcache["pos"].numpy(), jcache["pos"])
    for k in ("k", "v"):
        assert _rel(pcache[k].numpy(), jcache[k]) <= tol, k


def test_cache_set_slots_drops_out_of_range_rows():
    cfg = p_get_arch("tinyllama-1.1b", reduced=True)
    cache = PT.init_cache(cfg, 3, 16, device="cpu")
    group = PT.init_cache(cfg, 2, 16, device="cpu")
    group["k"].fill_(1.0)
    group["pos"].fill_(7)
    PT.cache_set_slots(cache, group, np.array([2, 3]))   # 3 >= B: dropped
    assert cache["k"][:, 2].eq(1).all() and cache["k"][:, :2].eq(0).all()
    assert cache["pos"][2].eq(7).all() and cache["pos"][:2].eq(-1).all()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    cfg = p_get_arch("tinyllama-1.1b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_cache(cfg, 1, 8)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert params["layers"]["attn"]["wq"].shape == (2, 256, 256)
    assert params["lm_head"].shape == (256, 512)


@pytest.mark.parametrize("attn_impl,expect", [("fused", "fused"),
                                              ("auto", "naive"),
                                              ("naive", "naive")])
def test_prefill_chunk_takes_the_configured_attention(monkeypatch, attn_impl,
                                                      expect):
    """cfg.attn_impl == "fused" sends every layer's prefill attention to
    the fused route, as the reference's prefill_chunk does
    (src/repro/models/transformer.py:737); any other value keeps the
    naive route. The fused route reaches the fused attention's dispatch
    once a layer."""
    cfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32", attn_impl=attn_impl)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    seen, fused_calls = [], []
    route = PLY.prefill_attention
    fused = getattr(PLY, "prefill_attn_fused", None)
    monkeypatch.setattr(PLY, "prefill_attention", lambda *a, **kw: (
        seen.append(kw.get("impl", "naive")), route(*a, **kw))[1])
    monkeypatch.setattr(PLY, "prefill_attn_fused", lambda *a, **kw: (
        fused_calls.append(1), fused(*a, **kw))[1], raising=False)
    cache = PT.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    h, _ = PT.prefill_chunk(params, cfg, cache,
                            tokens=torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]]),
                            start=0, lengths=torch.tensor([4, 3]))
    assert seen == [expect] * cfg.n_layers
    assert len(fused_calls) == (cfg.n_layers if expect == "fused" else 0)
    assert bool(torch.isfinite(h).all())
