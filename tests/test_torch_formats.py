"""The port's packing against the reference, bit for bit.

All eight weight variants' quantize/dequantize (golden super-blocks
included; q3_k_o also with activation stats, q4_0/q8_0 also at a K that
is a multiple of 32 and not of 256), the slab layout, the stacked
``quantize_params`` tree of reduced tinyllama under ``paper_llama_mix``
and its per-path report
(``extended_mix``'s is in ``test_torch_extended.py``), and the mirrored
configs, format registry and policies. Inputs come from a seeded numpy
generator and go through both packages; payloads are compared as raw
bytes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core import formats as JF
from repro.core import policy as JP
from repro.core import qlinear as JL
from repro.core import quantize as JQ
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.core import formats as PF
from repro_torch.core import policy as PP
from repro_torch.core import qlinear as PL
from repro_torch.core import quantize as PQ

torch.set_num_threads(2)


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _assert_qtensor_bytes(jt, pt):
    assert pt.variant == jt.variant and tuple(pt.shape) == tuple(jt.shape)
    assert sorted(pt.data) == sorted(jt.data)
    for k in jt.data:
        assert _same_bytes(np.asarray(jt.data[k]), pt.data[k].numpy()), k


PORTED = ["q2_k", "q3_k", "q3_k_o", "q4_0", "q4_k", "q5_k", "q6_k", "q8_0"]


@pytest.mark.parametrize("variant", PORTED)
@pytest.mark.parametrize("shape", [(256, 96), (512, 320), (2, 256, 64)])
def test_quantize_dequantize_bitexact(variant, shape):
    rng = np.random.default_rng([len(variant), variant == "q2_k", *shape])
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0, 0] = 0.0                      # a zero weight in a block
    pt = PQ.quantize(variant, torch.from_numpy(w))
    if len(shape) == 2:
        jt = JQ.quantize(variant, jnp.asarray(w))
    else:                                   # stacked: the reference vmaps
        jt = jax.vmap(JQ._QUANTIZE[variant])(jnp.asarray(w))
    _assert_qtensor_bytes(jt, pt)
    dj = np.asarray(JQ.dequantize(jt) if len(shape) == 2 else
                    jax.vmap(lambda t: JQ.dequantize(t))(jt))
    assert _same_bytes(dj, PQ.dequantize(pt).numpy())


@pytest.mark.parametrize("variant", ["q4_k", "q5_k", "q6_k"])
def test_tiny_scales_bitexact(variant):
    """Weights at 1e-5: the fp16 super-scales d/dmin go subnormal, where
    the cast order (codes from the f32 scale, fp16 cast last) decides
    every byte."""
    rng = np.random.default_rng(["q4_k", "q5_k", "q6_k"].index(variant))
    w = (rng.standard_normal((512, 48)) * 1e-5).astype(np.float32)
    pt = PQ.quantize(variant, torch.from_numpy(w))
    jt = JQ.quantize(variant, jnp.asarray(w))
    _assert_qtensor_bytes(jt, pt)
    assert _same_bytes(np.asarray(JQ.dequantize(jt)),
                       PQ.dequantize(pt).numpy())


@pytest.mark.parametrize("bits,sb", [(1, 256), (2, 256), (4, 256), (2, 64)])
def test_slab_pack_unpack_exact(bits, sb):
    rng = np.random.default_rng(bits * 1000 + sb)
    q = rng.integers(0, 1 << bits, size=(512, 24)).astype(np.uint8)
    packed = PF.slab_pack(torch.from_numpy(q), bits, sb)
    assert _same_bytes(np.asarray(JF.slab_pack(jnp.asarray(q), bits, sb)),
                       packed.numpy())
    assert np.array_equal(PF.slab_unpack(packed, bits, sb).numpy(), q)


def test_golden_q2_k_superblock():
    # the reference's hand-computed super-block (test_formats_golden.py):
    # block b has scale code b and min code 15-b, d=0.5, dmin=0.25, and
    # the in-block pattern [0,1,2,3]*4 pins the grid ends
    d, dmin = 0.5, 0.25
    sc_q = np.arange(16)
    m_q = 15 - np.arange(16)
    q = np.where(sc_q[:, None] > 0, np.tile(np.arange(4), 4)[None, :], 0)
    w1 = ((d * sc_q)[:, None] * q - (dmin * m_q)[:, None]).reshape(256)
    w = w1[:, None] * (2.0 ** np.arange(2))[None, :]
    t = PQ.quantize("q2_k", torch.tensor(w, dtype=torch.float32))
    assert t.variant == "q2_k" and t.shape == (256, 2)
    np.testing.assert_array_equal(
        t.data["scales"].numpy(),
        np.repeat((sc_q | (m_q << 4)).astype(np.uint8)[:, None], 2, axis=1))
    np.testing.assert_array_equal(t.data["d"].float().numpy(), [[d, 2 * d]])
    np.testing.assert_array_equal(t.data["dmin"].float().numpy(),
                                  [[dmin, 2 * dmin]])
    qkn = np.repeat(q.reshape(256)[:, None], 2, axis=1).astype(np.uint8)
    ref = JF.slab_pack(jnp.asarray(qkn), 2, 256)
    np.testing.assert_array_equal(t.data["qs"].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(PQ.dequantize(t).numpy(), w)   # exact


def test_golden_q3_k_superblock():
    # block b: 6-bit scale code 2b+1 (31 pins d=0.25); q in [-4, 3] with
    # -4 present so amax/4 recovers the block scale exactly
    d = 0.25
    sc_q = 2 * np.arange(16) + 1
    qpat = np.tile(np.arange(-4, 4), 2)
    w1 = ((d * sc_q)[:, None] * qpat[None, :]).reshape(256)
    w = w1[:, None] * (2.0 ** np.arange(2))[None, :]
    t = PQ.quantize("q3_k", torch.tensor(w, dtype=torch.float32))
    np.testing.assert_array_equal(
        t.data["scales"].numpy(),
        np.repeat((sc_q + 32).astype(np.uint8)[:, None], 2, axis=1))
    np.testing.assert_array_equal(t.data["d"].float().numpy(), [[d, 2 * d]])
    stored = np.repeat(np.tile(qpat + 4, 16).astype(np.uint8)[:, None], 2,
                       axis=1)
    np.testing.assert_array_equal(
        t.data["qs"].numpy(),
        np.asarray(JF.slab_pack(jnp.asarray(stored & 3), 2, 256)))
    np.testing.assert_array_equal(
        t.data["hmask"].numpy(),
        np.asarray(JF.slab_pack(jnp.asarray(stored >> 2), 1, 256)))
    np.testing.assert_array_equal(PQ.dequantize(t).numpy(), w)


def test_golden_q4_k_superblock():
    # the reference's hand-computed super-block (test_formats_golden.py):
    # 8 blocks of 32, 6-bit scale code 63-8b (63 pins d = 0.25), 6-bit min
    # code 8b+7 (63 pins dmin = 0.125); the in-block pattern [0..15]*2
    # pins bmax/bmin to the exact affine grid ends
    d, dmin = 0.25, 0.125
    sc_q = 63 - 8 * np.arange(8)
    m_q = 8 * np.arange(8) + 7
    qpat = np.tile(np.arange(16), 2)
    w1 = (d * sc_q)[:, None] * qpat[None, :] - (dmin * m_q)[:, None]
    w = w1.reshape(256)[:, None] * (2.0 ** np.arange(2))[None, :]
    t = PQ.quantize("q4_k", torch.tensor(w, dtype=torch.float32))
    assert t.variant == "q4_k" and t.shape == (256, 2)
    np.testing.assert_array_equal(
        t.data["scales"].numpy(),
        np.repeat(sc_q.astype(np.uint8)[:, None], 2, axis=1))
    np.testing.assert_array_equal(
        t.data["mins"].numpy(),
        np.repeat(m_q.astype(np.uint8)[:, None], 2, axis=1))
    np.testing.assert_array_equal(t.data["d"].float().numpy(), [[d, 2 * d]])
    np.testing.assert_array_equal(t.data["dmin"].float().numpy(),
                                  [[dmin, 2 * dmin]])
    stored = np.repeat(np.tile(qpat, 8).astype(np.uint8)[:, None], 2, axis=1)
    np.testing.assert_array_equal(
        t.data["qs"].numpy(),
        np.asarray(JF.slab_pack(jnp.asarray(stored), 4, 256)))
    np.testing.assert_array_equal(PQ.dequantize(t).numpy(), w)   # exact


def test_golden_q6_k_superblock():
    # block b: int8 scale code 127-8b (127 pins d = 0.125); q in [-32, 31]
    # with -32 present so amax/32 recovers the block scale exactly
    d = 0.125
    sc_q = 127 - 8 * np.arange(16)
    qpat = np.array([-32, -16, -8, -4, -2, -1, 0, 1,
                     2, 4, 8, 16, 24, 30, 31, -31])
    w1 = ((d * sc_q)[:, None] * qpat[None, :]).reshape(256)
    w = w1[:, None] * (2.0 ** np.arange(2))[None, :]
    t = PQ.quantize("q6_k", torch.tensor(w, dtype=torch.float32))
    assert t.data["scales"].dtype == torch.int8
    np.testing.assert_array_equal(
        t.data["scales"].numpy(),
        np.repeat(sc_q.astype(np.int8)[:, None], 2, axis=1))
    np.testing.assert_array_equal(t.data["d"].float().numpy(), [[d, 2 * d]])
    stored = np.repeat(np.tile(qpat + 32, 16).astype(np.uint8)[:, None], 2,
                       axis=1)
    np.testing.assert_array_equal(
        t.data["ql"].numpy(),
        np.asarray(JF.slab_pack(jnp.asarray(stored & 15), 4, 256)))
    np.testing.assert_array_equal(
        t.data["qh"].numpy(),
        np.asarray(JF.slab_pack(jnp.asarray(stored >> 4), 2, 256)))
    np.testing.assert_array_equal(PQ.dequantize(t).numpy(), w)


def test_quantize_params_tree_matches_reference():
    """Reduced tinyllama under paper_llama_mix: the same report, and every
    stacked QTensor byte-identical with its leading layer axis."""
    cfg = JC.get_arch("tinyllama-1.1b", reduced=True)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    jq, jrep = JL.quantize_params(params, JP.get_policy("paper_llama_mix"))
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    pq, prep = PL.quantize_params(pparams, PP.get_policy("paper_llama_mix"))
    assert prep == jrep
    assert prep["wte"] is None              # the *embed* rule matches nothing
    assert prep["layers/attn/wk"] == "q2_k" and prep["lm_head"] == "q2_k"
    assert prep["layers/mlp/w_down"] == "q3_k"
    jflat = dict(JL._flatten_paths(jq))
    for path, leaf in PL._flatten_paths(pq):
        if isinstance(leaf, PQ.QTensor):
            _assert_qtensor_bytes(jflat[path], leaf)
        else:
            assert _same_bytes(np.asarray(jflat[path]), leaf.numpy()), path
    wq = pq["layers"]["attn"]["wq"]
    assert wq.variant == "q3_k" and wq.shape == (256, 256)
    assert tuple(wq.data["qs"].shape) == (2, 64, 256)
    assert PL.variant_counts(prep, pq) == {"q2_k": 2 * 2 + 1, "q3_k": 5 * 2}


@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirror(reduced):
    j = dataclasses.asdict(JC.get_arch("tinyllama-1.1b", reduced=reduced))
    p = dataclasses.asdict(PC.get_arch("tinyllama-1.1b", reduced=reduced))
    assert p == j


def test_format_registry_and_policy_mirror():
    assert sorted(PF.FORMATS) == sorted(JF.FORMATS)
    for name, fmt in JF.FORMATS.items():
        assert dataclasses.asdict(PF.FORMATS[name]) == dataclasses.asdict(fmt)
    assert PF.WEIGHT_VARIANTS == JF.WEIGHT_VARIANTS
    assert sorted(PP.POLICIES) == sorted(JP.POLICIES)
    for name, pol in JP.POLICIES.items():
        assert dataclasses.asdict(PP.POLICIES[name]) == dataclasses.asdict(pol)
    paths = ["layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
             "layers/mlp/w_down", "lm_head", "embed", "layers/ln1/w"]
    for name in JP.POLICIES:
        for path in paths:
            for K, N in [(64, 64), (256, 16), (288, 64), (2048, 5632)]:
                assert (PP.POLICIES[name].variant_for(path, K, N)
                        == JP.POLICIES[name].variant_for(path, K, N))
    for K in (256, 288, 64):
        assert PF.pick_fallback("q3_k", K) == JF.pick_fallback("q3_k", K)
    for mod in (PF, JF):
        with pytest.raises(ValueError):
            mod.pick_fallback("q3_k", 100)


def test_unknown_variant_raises():
    w = torch.zeros(256, 32)
    with pytest.raises(KeyError):
        PQ.quantize("q9_z", w)
    with pytest.raises(KeyError):
        JQ.quantize("q9_z", jnp.asarray(w.numpy()))


@pytest.mark.parametrize("variant", ["q4_0", "q8_0"])
def test_32_row_formats_ragged_k_bitexact(variant):
    """K = 288: a multiple of 32 and not of 256, where q8_0 is the
    fallback of every k-quant (formats.pick_fallback)."""
    rng = np.random.default_rng(["q4_0", "q8_0"].index(variant) + 40)
    w = (rng.standard_normal((288, 64)) * 0.05).astype(np.float32)
    w[3, :] = 0.0                           # all-zero rows in one block
    pt = PQ.quantize(variant, torch.from_numpy(w))
    jt = JQ.quantize(variant, jnp.asarray(w))
    _assert_qtensor_bytes(jt, pt)
    assert _same_bytes(np.asarray(JQ.dequantize(jt)),
                       PQ.dequantize(pt).numpy())
    assert PQ.quantize("q3_k", torch.from_numpy(w)).variant == "q8_0"


def test_q3_k_o_activation_stats_bitexact():
    """Scores |w| * act_absmax pick the sidecar rows; stacked layers share
    one stats vector, as the reference's vmap with a closed-over vector
    gives. Random f32 scores do not tie, so top_k order agrees."""
    rng = np.random.default_rng(15)
    w = rng.standard_normal((2, 512, 48)).astype(np.float32)
    a = (rng.random(512) + 0.5).astype(np.float32)
    a[77] = 1e4                             # a hot activation row
    pt = PQ.quantize_q3_k_o(torch.from_numpy(w), act_absmax=a)
    jt = jax.vmap(lambda x: JQ.quantize_q3_k_o(x, act_absmax=a))(
        jnp.asarray(w))
    _assert_qtensor_bytes(jt, pt)
    oidx = pt.data["oidx"].numpy().reshape(2, 2, 8, 48)
    assert (oidx[:, 0] == 77).any(axis=1).all()     # in every column


def _col_dup(w1):
    return w1[:, None] * (2.0 ** np.arange(2))[None, :]


def test_golden_q3_k_o_superblock_with_outlier_sidecar():
    # the reference's golden block (test_formats_golden.py): the q3_k
    # pattern plus 8 outlier rows per super-block at in-block offset 5
    # with distinct descending magnitudes, so the top-k order is fixed
    d = 0.25
    sc_q = 2 * np.arange(16) + 1
    qpat = np.tile(np.arange(-4, 4), 2)
    base1 = ((d * sc_q)[:, None] * qpat[None, :]).reshape(256)
    orows = 16 * np.arange(8) + 5
    ovals1 = 100.0 * (8 - np.arange(8))
    wfull1 = base1.copy()
    wfull1[orows] = ovals1
    w = _col_dup(wfull1)
    t = PQ.quantize("q3_k_o", torch.tensor(w, dtype=torch.float32))
    assert t.variant == "q3_k_o" and t.shape == (256, 2)
    np.testing.assert_array_equal(
        t.data["oidx"].numpy(),
        np.repeat(orows.astype(np.uint8)[:, None], 2, axis=1))
    np.testing.assert_array_equal(t.data["ovals"].float().numpy(),
                                  _col_dup(ovals1))
    np.testing.assert_array_equal(
        t.data["scales"].numpy(),
        np.repeat((sc_q + 32).astype(np.uint8)[:, None], 2, axis=1))
    np.testing.assert_array_equal(t.data["d"].float().numpy(), [[d, 2 * d]])
    stored1 = (np.tile(qpat, 16) + 4).astype(np.uint8)
    stored1[orows] = 4
    stored = np.repeat(stored1[:, None], 2, axis=1)
    np.testing.assert_array_equal(
        t.data["qs"].numpy(),
        np.asarray(JF.slab_pack(jnp.asarray(stored & 3), 2, 256)))
    np.testing.assert_array_equal(
        t.data["hmask"].numpy(),
        np.asarray(JF.slab_pack(jnp.asarray(stored >> 2), 1, 256)))
    np.testing.assert_array_equal(PQ.dequantize(t).numpy(), w)   # exact
    _assert_qtensor_bytes(JQ.quantize("q3_k_o", jnp.asarray(w, jnp.float32)),
                          t)


def test_golden_q4_0_blocks():
    # block 0 has a negative extreme (d = +0.5), block 1 a positive one
    # (d = -0.25): llama.cpp's sign convention d = mval / -8
    qpat = np.tile(np.arange(16), 2)
    d_blocks = np.array([0.5, -0.25])
    w1 = (d_blocks[:, None] * (qpat[None, :] - 8.0)).reshape(64)
    w = _col_dup(w1)
    t = PQ.quantize("q4_0", torch.tensor(w, dtype=torch.float32))
    assert t.variant == "q4_0" and t.shape == (64, 2)
    np.testing.assert_array_equal(t.data["d"].float().numpy(),
                                  np.stack([d_blocks, 2 * d_blocks], axis=1))
    qkn = np.repeat(qpat[None].repeat(2, 0).reshape(64)[:, None].astype(
        np.uint8), 2, axis=1)
    np.testing.assert_array_equal(
        t.data["qs"].numpy(),
        np.asarray(JF.slab_pack(jnp.asarray(qkn), 4, 32)))
    np.testing.assert_array_equal(PQ.dequantize(t).numpy(), w)   # exact


def test_golden_q8_0_block():
    # one 32-block: d = 0.5 pinned by |q| = 127; codes stored verbatim
    qpat = np.concatenate([[127, -127, 0, 1, -1], np.arange(-13, 14)])
    w = _col_dup(0.5 * qpat)
    t = PQ.quantize("q8_0", torch.tensor(w, dtype=torch.float32))
    assert t.variant == "q8_0"
    np.testing.assert_array_equal(
        t.data["qs"].numpy(),
        np.repeat(qpat.astype(np.int8)[:, None], 2, axis=1))
    np.testing.assert_array_equal(t.data["d"].float().numpy(), [[0.5, 1.0]])
    np.testing.assert_array_equal(PQ.dequantize(t).numpy(), w)
