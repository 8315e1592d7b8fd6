"""The port's fused BFP matmul against the reference kernel.

On the CPU the port's ``bfp_matmul`` runs the kernel's plain PyTorch
version. It is held against the reference Pallas kernel in interpret mode
(``ops.bfp_matmul(impl="pallas", interpret=True)``) and against the f32
oracle ``ref.matmul_ref``, on the same reference-packed payloads.

Tolerances, relative to the output's max magnitude:
  * vs the Pallas kernel, f32 output: 1e-5. Both round x and w to bf16 and
    accumulate in f32; only the summation order differs.
  * vs the Pallas kernel, bf16 output: 2**-7, one bf16 ulp at the output's
    max (8 significant bits): a sum on a rounding boundary may round
    either way.
  * vs matmul_ref (no bf16 rounding at all): 2e-2, the bf16 rounding of
    both operands (2**-9 relative each) summed over K.
The CUDA kernel itself is checked on the card by ``test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as JQ
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import quantize as PQ
from repro_torch.kernels import bfp_matmul as PB
from repro_torch.kernels import ops as PO
from repro_torch.kernels import ref as PR

torch.set_num_threads(2)

TOL_F32 = 1e-5
TOL_BF16 = 2.0 ** -7
TOL_REF = 2e-2

# (M, K, N): every M of {1, 3, 8, 33}, every K of {256, 512, 768}, ragged N;
# every variant (K = 288 for the 32-row formats below)
SHAPES = [(1, 256, 96), (3, 512, 320), (8, 768, 96), (33, 256, 320),
          (3, 768, 320)]


def _packed(variant, K, N, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    pt = PQ.quantize(variant, torch.from_numpy(w))
    jt = JQ.QTensor(variant, (K, N),
                    {k: jnp.asarray(v.numpy()) for k, v in pt.data.items()})
    return pt, jt


def _rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("variant", PB.VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_ref(variant, dtype):
    for i, (M, K, N) in enumerate(SHAPES):
        pt, jt = _packed(variant, K, N, seed=100 + i)
        x = np.random.default_rng(i).standard_normal((M, K)).astype(
            np.float32)
        xj = jnp.asarray(x, dtype=dtype)
        xp = torch.from_numpy(x).to(getattr(torch, dtype))
        yp = PO.bfp_matmul(xp, pt)
        assert yp.shape == (M, N) and yp.dtype == xp.dtype
        yj = JO.bfp_matmul(xj, jt, impl="pallas", interpret=True)
        tol = TOL_F32 if dtype == "float32" else TOL_BF16
        err = _rel_err(yp.float().numpy(), jnp.asarray(yj, jnp.float32))
        assert err <= tol, (M, K, N, err)
        ref = JR.matmul_ref(jnp.asarray(x), jt)
        assert _rel_err(yp.float().numpy(), ref) <= TOL_REF
        # the port's own oracle is the reference's
        assert _rel_err(PR.matmul_ref(torch.from_numpy(x), pt).numpy(),
                        ref) <= 1e-6


@pytest.mark.parametrize("variant", PB.VARIANTS)
def test_rows_independent_of_m(variant):
    """Row m of a product does not depend on how many rows share the call:
    batched admission equals sequential admission only because of this."""
    pt, _ = _packed(variant, 512, 320, seed=7)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (33, 512)).astype(np.float32)).to(torch.bfloat16)
    full = PO.bfp_matmul(x, pt)
    for m in (0, 5, 32):
        assert torch.equal(PO.bfp_matmul(x[m:m + 1], pt)[0], full[m])
    assert torch.equal(PO.bfp_matmul(x[:8], pt), full[:8])


@pytest.mark.parametrize("variant", ["q4_0", "q8_0"])
def test_plain_32_row_formats_ragged_k(variant):
    """Q4_0 and Q8_0 take a K that is a multiple of 32 and not of 256."""
    for i, (M, K, N) in enumerate([(3, 288, 96), (33, 288, 320)]):
        pt, jt = _packed(variant, K, N, seed=200 + i)
        x = np.random.default_rng(50 + i).standard_normal((M, K)).astype(
            np.float32)
        yp = PO.bfp_matmul(torch.from_numpy(x), pt)
        yj = JO.bfp_matmul(jnp.asarray(x), jt, impl="pallas", interpret=True)
        assert _rel_err(yp.numpy(), yj) <= TOL_F32, (M, K, N)
        assert _rel_err(yp.numpy(), JR.matmul_ref(jnp.asarray(x), jt)) \
            <= TOL_REF


def test_leading_dims_and_impls():
    pt, _ = _packed("q3_k", 256, 96, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 5, 256)).astype(np.float32))
    y = PO.bfp_matmul(x, pt)
    assert y.shape == (2, 5, 96)
    assert torch.equal(y[1], PO.bfp_matmul(x[1], pt, impl="torch"))
    assert _rel_err(PO.bfp_matmul(x, pt, impl="ref").numpy(),
                    y.numpy()) <= TOL_REF
    with pytest.raises(ValueError, match="unknown impl"):
        PO.bfp_matmul(x, pt, impl="pallas")


def test_cuda_impl_rejects_cpu_tensors():
    """A CPU tensor never reaches the kernel: asking for it raises, and
    "auto" takes the plain version without counting a launch."""
    pt, _ = _packed("q2_k", 256, 96, seed=5)
    x = torch.zeros(4, 256)
    PB.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        PO.bfp_matmul(x, pt, impl="cuda")
    PO.bfp_matmul(x, pt)
    assert PB.launches == {v: 0 for v in PB.VARIANTS}
