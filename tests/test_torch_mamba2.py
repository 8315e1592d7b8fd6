"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the
reference's ``repro.models.mamba2``, on the CPU.

Inputs are made from numpy seeds and run through both packages in f32.
``_causal_conv`` (with and without a carried tail, with ``state_take``
including a row of 0 valid columns) is held at 1e-6 relative to the
largest output (the same products summed in the same tap order; XLA may
fuse a multiply-add), its new tail exactly. ``_ssd_chunk_scan`` is held
against the reference's and against ``naive_recurrence`` (the port's and
the reference's) at 1e-4 absolute, the reference's own
``test_models.py`` tolerance, with S a multiple of the chunk and not.
``mamba2_forward`` (with ``valid`` and carried states) and
``mamba2_decode`` run one layer of the reduced mamba2-2.7b, its weights
moved across with ``bridge``, at 1e-5 relative to the largest output:
the two frameworks sum the f32 products in other orders. The port runs
the scan's products a batch row at a time, so a row's output is the
same bits in a batch of three as alone (checked exactly), and a decay
that overflows above the diagonal still gives finite outputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.models import mamba2 as PM

torch.set_num_threads(2)

# the reference's functions under jax.jit: one compile each, where eager
# JAX compiles every op
j_scan = jax.jit(JM._ssd_chunk_scan, static_argnums=6)
j_naive = jax.jit(JM.naive_recurrence)
j_conv = jax.jit(JM._causal_conv)
j_forward = jax.jit(JM.mamba2_forward, static_argnums=2)
j_decode = jax.jit(JM.mamba2_decode, static_argnums=2)

ARCH = "mamba2-2.7b"
TOL_CONV = 1e-6
TOL_SCAN = 1e-4         # the reference's test_models.py tolerance
TOL_BLOCK = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_inputs(B=3, S=48, H=4, P=8, N=16, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("S", [48, 40])
def test_ssd_chunk_scan_matches_reference_and_recurrence(S):
    x, dt, A, Bm, Cm, s0 = _scan_inputs()
    x, dt, Bm, Cm = x[:, :S], dt[:, :S], Bm[:, :S], Cm[:, :S]
    args = (x, dt, A, Bm, Cm, s0)
    py, ps = PM._ssd_chunk_scan(*map(_t, args), 16)
    jy, js = j_scan(*map(jnp.asarray, args), 16)
    ny, ns = PM.naive_recurrence(*map(_t, args))
    jny, jns = j_naive(*map(jnp.asarray, args))
    assert py.shape == (3, S, 4, 8) and ps.shape == (3, 4, 8, 16)
    for got, want in ((py, jy), (ps, js), (py, ny), (ps, ns), (ny, jny),
                      (ns, jns)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=TOL_SCAN)


def test_ssd_rows_do_not_depend_on_the_batch():
    x, dt, A, Bm, Cm, s0 = _scan_inputs(S=40)
    y, st = PM._ssd_chunk_scan(*map(_t, (x, dt, A, Bm, Cm, s0)), 16)
    for b in range(3):
        one = [a[b:b + 1] for a in (x, dt)] + [A] + [
            a[b:b + 1] for a in (Bm, Cm, s0)]
        y1, st1 = PM._ssd_chunk_scan(*map(_t, one), 16)
        assert torch.equal(y1[0], y[b]) and torch.equal(st1[0], st[b])


def test_ssd_overflowing_decay_stays_finite():
    """A strongly decaying head: exp(acs_i - acs_j) above the diagonal is
    +inf, masked before any product, as the reference's where()."""
    x, dt, A, Bm, Cm, s0 = _scan_inputs(S=32)
    A = np.full_like(A, -200.0)
    dt = np.full_like(dt, 2.0)
    y, st = PM._ssd_chunk_scan(*map(_t, (x, dt, A, Bm, Cm, s0)), 16)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    jy, _ = j_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm, s0)), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL_SCAN)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("take", [None, (5, 0, 9)])
def test_causal_conv_matches_reference(carry, take):
    rng = np.random.default_rng(4)
    B, S, C, W = 3, 9, 24, 4
    xBC = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    state = (rng.standard_normal((B, W - 1, C)).astype(np.float32)
             if carry else None)
    st = None if take is None else np.asarray(take, np.int32)
    py, pst = PM._causal_conv(_t(xBC), _t(w), _t(bias),
                              None if state is None else _t(state),
                              None if st is None else _t(st))
    jy, jst = j_conv(jnp.asarray(xBC), jnp.asarray(w),
                              jnp.asarray(bias),
                              None if state is None else jnp.asarray(state),
                              None if st is None else jnp.asarray(st))
    assert _rel(py, jy) <= TOL_CONV
    np.testing.assert_array_equal(pst.numpy(), np.asarray(jst))
    if take is not None and carry:
        # a row of 0 valid columns keeps its tail
        np.testing.assert_array_equal(pst[1].numpy(), state[1])


@pytest.fixture(scope="module")
def layer():
    """(reference cfg, port cfg, reference layer-0 ssm params, the same
    in the port), the reduced mamba2-2.7b in f32."""
    jcfg = JC.get_arch(ARCH, reduced=True).replace(dtype="float32")
    pcfg = PC.get_arch(ARCH, reduced=True).replace(dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    params = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: a[0], params["layers"]["ssm"])
    # a nonzero A_log, D and dt_bias, so every term is exercised
    rng = np.random.default_rng(5)
    H = lp["A_log"].shape[0]
    lp = dict(lp, **{k: jnp.asarray(rng.standard_normal(H) * 0.5,
                                    jnp.float32)
                     for k in ("A_log", "D", "dt_bias")})
    return jcfg, pcfg, lp, bridge.from_jax_params(
        jax.tree.map(np.asarray, lp))


def test_ssm_dims_match_reference():
    for arch in ("mamba2-2.7b", "zamba2-1.2b"):
        for reduced in (False, True):
            assert PM.ssm_dims(PC.get_arch(arch, reduced=reduced)) == \
                JM.ssm_dims(JC.get_arch(arch, reduced=reduced))


def test_mamba2_forward_with_valid_matches_reference(layer):
    jcfg, pcfg, jlp, plp = layer
    rng = np.random.default_rng(6)
    B, S = 3, 20
    dd = PM.ssm_dims(pcfg)
    h = rng.standard_normal((B, S, pcfg.d_model)).astype(np.float32)
    cs = rng.standard_normal((B, pcfg.ssm_conv_width - 1,
                              dd["conv_ch"])).astype(np.float32)
    ss = (rng.standard_normal((B, dd["n_heads"], dd["head_dim"],
                               dd["state"])) * 0.1).astype(np.float32)
    valid = np.arange(S)[None] < np.array([20, 7, 0])[:, None]
    py, (pc, ps) = PM.mamba2_forward(_t(h), plp, pcfg, conv_state=_t(cs),
                                     ssm_state=_t(ss), valid=_t(valid))
    jy, (jc, js) = j_forward(jnp.asarray(h), jlp, jcfg,
                             conv_state=jnp.asarray(cs),
                             ssm_state=jnp.asarray(ss),
                             valid=jnp.asarray(valid))
    # outputs at invalid columns are garbage by contract
    for b, n in enumerate((20, 7, 0)):
        if n:
            assert _rel(py[b, :n], jy[b, :n]) <= TOL_BLOCK
    assert _rel(pc, jc) <= TOL_BLOCK and _rel(ps, js) <= TOL_BLOCK
    # the length-0 row keeps both states exactly
    np.testing.assert_array_equal(pc[2].numpy(), cs[2])
    np.testing.assert_array_equal(ps[2].numpy(), ss[2])
    # no carried state and no mask: the training/forward_seq call
    py, (pc, ps) = PM.mamba2_forward(_t(h), plp, pcfg)
    jy, (jc, js) = j_forward(jnp.asarray(h), jlp, jcfg)
    assert max(_rel(py, jy), _rel(pc, jc), _rel(ps, js)) <= TOL_BLOCK


def test_mamba2_decode_matches_reference(layer):
    jcfg, pcfg, jlp, plp = layer
    rng = np.random.default_rng(7)
    B = 2
    dd = PM.ssm_dims(pcfg)
    cs = rng.standard_normal((B, pcfg.ssm_conv_width - 1,
                              dd["conv_ch"])).astype(np.float32)
    ss = (rng.standard_normal((B, dd["n_heads"], dd["head_dim"],
                               dd["state"])) * 0.1).astype(np.float32)
    pst, jst = (_t(cs), _t(ss)), (jnp.asarray(cs), jnp.asarray(ss))
    for step in range(3):
        h = rng.standard_normal((B, pcfg.d_model)).astype(np.float32)
        py, pst = PM.mamba2_decode(_t(h), plp, pcfg, *pst)
        jy, jst = j_decode(jnp.asarray(h), jlp, jcfg, *jst)
        assert _rel(py, jy) <= TOL_BLOCK, step
        assert _rel(pst[0], jst[0]) <= TOL_BLOCK
        assert _rel(pst[1], jst[1]) <= TOL_BLOCK


def test_chunked_forward_equals_decode_steps(layer):
    """Prefill in one masked chunk, then decode: the states after the
    chunk equal stepping the recurrence token by token (the SSD duality
    the engine's prefill relies on)."""
    _, pcfg, _, plp = layer
    rng = np.random.default_rng(8)
    S = 12
    h = _t(rng.standard_normal((1, S, pcfg.d_model)).astype(np.float32))
    _, (pc, ps) = PM.mamba2_forward(h, plp, pcfg)
    dd = PM.ssm_dims(pcfg)
    cs = torch.zeros((1, pcfg.ssm_conv_width - 1, dd["conv_ch"]))
    ss = torch.zeros((1, dd["n_heads"], dd["head_dim"], dd["state"]))
    for t in range(S):
        _, (cs, ss) = PM.mamba2_decode(h[:, t], plp, pcfg, cs, ss)
    assert _rel(cs, pc) <= TOL_BLOCK and _rel(ss, ps) <= TOL_BLOCK
