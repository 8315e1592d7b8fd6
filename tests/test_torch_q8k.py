"""The port's Q8_K activation path against the reference, on the CPU.

Q8_K is the input format of the paper's integer datapath: per 256-value
super-block an f32 scale ``d = absmax / 127``, int8 ``qs`` and the int16
16-value block sums ``bsums``. On the CPU the port's ``ops.q8k_quantize``
runs the kernel's plain version (``kernels/q8k_quant.py``); the CUDA
kernel itself is checked byte for byte on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.

What is held, with its tolerance:
  * ``quantize_q8_k`` / ``dequantize_q8_k`` and ``ops.q8k_quantize``
    against the reference's jnp versions (``impl="xla"``): bit-exact. Both
    divide ``amax / 127`` and multiply by the safe reciprocal in f32, and
    round half to even.
  * ``ops.q8k_quantize`` against the reference's Pallas kernel in
    interpret mode: the reference's own tolerance for its kernel
    (``tests/test_kernels.py::test_property_q8k_batched_masked``): ``d`` to
    1e-6 relative, ``qs`` within 1, ``bsums`` the sums of the kernel's own
    ``qs``, masked rows all zero.
  * ``matmul_q8k_ref`` against the reference's: 1e-5 relative to the
    output's max (the reference's ``test_isa.py`` tolerance); the integer
    dots and the block-scale sums are exact on both sides, and only the
    f32 rescaling and super-block sum may round in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import quantize as JQ
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import quantize as PQ
from repro_torch.core.formats import WEIGHT_VARIANTS
from repro_torch.kernels import ops as PO
from repro_torch.kernels import q8k_quant as PK
from repro_torch.kernels import ref as PR

torch.set_num_threads(2)

TOL_INT = 1e-5


def _same_bytes(a, b: torch.Tensor) -> bool:
    a = np.asarray(a)
    b = b.numpy()
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _inputs(case: str) -> np.ndarray:
    rng = np.random.default_rng(list(case.encode()))
    if case == "normal":
        return rng.standard_normal((5, 768)).astype(np.float32)
    if case == "zero_blocks":
        x = rng.standard_normal((4, 1024)).astype(np.float32)
        x[0] = 0.0                          # a whole zero row
        x[1, 256:512] = 0.0                 # one zero super-block
        x[2, 3] = -0.0
        return x
    if case == "magnitudes":
        # super-blocks scaled from 1e-30 to 1e30: subnormal d, huge d
        x = rng.standard_normal((3, 7, 256)).astype(np.float32)
        x *= np.float32(10.0) ** np.arange(-30, 31, 10,
                                           dtype=np.float32)[:, None]
        return x.reshape(3, 7 * 256)
    if case == "leading_dims":
        return rng.standard_normal((2, 3, 512)).astype(np.float32) * 4
    if case == "ties":
        # amax 127 gives d = 1, so every half-integer value is an exact
        # rounding tie: half to even on both sides
        x = (rng.integers(-254, 255, (2, 256)) / 2).astype(np.float32)
        x[:, 0] = 127.0
        return x
    raise KeyError(case)


CASES = ["normal", "zero_blocks", "magnitudes", "leading_dims", "ties"]


@pytest.mark.parametrize("case", CASES)
def test_quantize_q8_k_bitexact(case):
    x = _inputs(case)
    j = JQ.quantize_q8_k(jnp.asarray(x))
    p = PQ.quantize_q8_k(torch.from_numpy(x))
    assert sorted(p) == sorted(j)
    for k in j:
        assert _same_bytes(j[k], p[k]), k
    assert p["qs"].shape == x.shape and p["d"].dtype == torch.float32
    jd = np.asarray(JQ.dequantize_q8_k(j))
    assert _same_bytes(jd, PQ.dequantize_q8_k(p))
    if case == "zero_blocks":
        assert not p["qs"][0].any() and not p["d"][0].any()
        assert float(p["d"][1, 1]) == 0.0


def test_quantize_q8_k_takes_bf16_and_rejects_ragged_k():
    x = np.random.default_rng(7).standard_normal((3, 512)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    p = PQ.quantize_q8_k(xb)
    j = JQ.quantize_q8_k(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    for k in j:
        assert _same_bytes(j[k], p[k]), k
    with pytest.raises(ValueError, match="K % 256"):
        PQ.quantize_q8_k(torch.zeros(2, 300))


def test_q8k_bsums_consistent():
    """Port of tests/test_formats.py::test_q8k_bsums_consistent."""
    x = np.random.default_rng(3).standard_normal((4, 512)).astype(np.float32)
    qx = PQ.quantize_q8_k(torch.from_numpy(x))
    qs = qx["qs"].to(torch.int32)
    assert torch.equal(qs.reshape(4, -1, 16).sum(-1),
                       qx["bsums"].to(torch.int32))


def test_q8k_roundtrip():
    """Port of tests/test_formats.py::test_q8k_roundtrip."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 512)).astype(np.float32))
    xd = PQ.dequantize_q8_k(PQ.quantize_q8_k(x))
    assert float((xd - x).abs().max() / x.abs().max()) < 0.02


@settings(max_examples=8, deadline=None, derandomize=True, database=None)
@given(m=st.integers(1, 20), nsb=st.integers(1, 3),
       masked=st.integers(0, 1), seed=st.integers(0, 2**16))
def test_ops_q8k_matches_reference_batched_masked(m, nsb, masked, seed):
    """The space of tests/test_kernels.py::test_property_q8k_batched_masked:
    the port against the reference's jnp path bit for bit, against its
    Pallas kernel (interpret mode) at that test's tolerance, masked rows
    exactly zero."""
    K = 256 * nsb
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, K)).astype(np.float32)
    valid = rng.integers(0, 2, m).astype(bool) if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    pv = None if valid is None else torch.from_numpy(valid)
    pq = PO.q8k_quantize(torch.from_numpy(x), valid=pv, impl="torch")
    qj = JO.q8k_quantize(jnp.asarray(x), valid=jv, impl="xla")
    for k in qj:
        assert _same_bytes(qj[k], pq[k]), k
    qk = JO.q8k_quantize(jnp.asarray(x), valid=jv, impl="pallas",
                         interpret=True)
    np.testing.assert_allclose(pq["d"].numpy(), np.asarray(qk["d"]),
                               rtol=1e-6)
    assert np.abs(pq["qs"].numpy().astype(np.int32)
                  - np.asarray(qk["qs"], np.int32)).max() <= 1
    assert torch.equal(pq["qs"].to(torch.int32).reshape(m, -1, 16).sum(-1),
                       pq["bsums"].to(torch.int32))
    if valid is not None:
        dead = torch.from_numpy(~valid)
        for k in ("qs", "d", "bsums"):
            assert not pq[k][dead].any(), k


def test_ops_q8k_leading_dims_and_impls():
    """Leading dims flatten into rows and the mask follows them; "auto"
    takes the plain version on a CPU tensor; the kernel's wrapper refuses
    a CPU tensor instead of computing on it."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 3, 512)).astype(np.float32))
    valid = torch.tensor([[True, False, True], [False, True, True]])
    q = PO.q8k_quantize(x, valid=valid)
    flat = PK.q8k_quantize_plain(x.reshape(6, 512), valid.reshape(6))
    assert q["qs"].shape == (2, 3, 512) and q["d"].shape == (2, 3, 2)
    assert q["bsums"].shape == (2, 3, 32)
    for k in flat:
        assert torch.equal(q[k].reshape(flat[k].shape), flat[k]), k
    assert not q["qs"][0, 1].any() and not q["d"][1, 0].any()
    with pytest.raises(ValueError, match="CUDA tensor"):
        PO.q8k_quantize(x, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        PO.q8k_quantize(x, impl="pallas")
    PK.reset_launches()
    assert PK.launches == {"q8k_quantize": 0}


def _packed(variant, K, N, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    pt = PQ.quantize(variant, torch.from_numpy(w))
    jt = JQ.QTensor(variant, (K, N),
                    {k: jnp.asarray(v.numpy()) for k, v in pt.data.items()})
    return pt, jt


@pytest.mark.parametrize("variant", ["q2_k", "q3_k"])
@pytest.mark.parametrize("M,K,N", [(1, 256, 64), (5, 768, 200),
                                   (16, 512, 96)])
def test_matmul_q8k_ref_matches_reference(variant, M, K, N):
    pt, jt = _packed(variant, K, N, M + K)
    x = np.random.default_rng(K).standard_normal((M, K)).astype(np.float32)
    jo = np.asarray(JR.matmul_q8k_ref(JQ.quantize_q8_k(jnp.asarray(x)), jt))
    po = PR.matmul_q8k_ref(PO.q8k_quantize(torch.from_numpy(x)), pt)
    assert po.shape == (M, N) and po.dtype == torch.float32
    err = np.abs(po.numpy() - jo).max() / np.abs(jo).max()
    assert err <= TOL_INT


@pytest.mark.parametrize("variant", ["q2_k", "q3_k"])
def test_integer_datapath_matches_dequant(variant):
    """Port of tests/test_kernels.py::test_integer_datapath_matches_dequant:
    the integer dots with two-level rescaling equal the dequantized f32
    product of the same Q8_K activations."""
    pt, _ = _packed(variant, 512, 64, 3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16, 512)).astype(np.float32))
    qx = PQ.quantize_q8_k(x)
    oi = PR.matmul_q8k_ref(qx, pt)
    od = PR.matmul_ref(PQ.dequantize_q8_k(qx), pt)
    assert float((oi - od).abs().max() / od.abs().max()) <= TOL_INT
    assert torch.equal(PR.dequant_ref(pt), PQ.dequantize(pt))


@pytest.mark.parametrize("variant",
                         [v for v in WEIGHT_VARIANTS
                          if v not in ("q2_k", "q3_k")])
def test_matmul_q8k_ref_models_only_the_paper_variants(variant):
    K = 256
    pt = PQ.quantize(variant, torch.zeros(K, 32))
    qx = PQ.quantize_q8_k(torch.ones(2, K))
    with pytest.raises(NotImplementedError, match="q2_k, q3_k"):
        PR.matmul_q8k_ref(qx, pt)
    jt = JQ.quantize(variant, jnp.zeros((K, 32)))
    with pytest.raises(NotImplementedError):
        JR.matmul_q8k_ref(JQ.quantize_q8_k(jnp.ones((2, K))), jt)
