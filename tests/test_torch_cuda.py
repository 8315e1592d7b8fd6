"""The port's CUDA kernel on the card, against its plain version.

These tests need a CUDA GPU (marker ``cuda``) and skip elsewhere: a CUDA
kernel has no CPU mode. The file imports no JAX, so it also runs where
only the port is installed:

  PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance, relative to the output's max magnitude, f32 output: 1e-5. The
kernel and the plain version round x and w to bf16 alike and accumulate
in f32; only the summation order differs.
"""
import pytest
import torch

from repro_torch.core import quantize as PQ
from repro_torch.kernels import bfp_matmul as PB
from repro_torch.kernels import ops as PO

torch.set_num_threads(2)

TOL_F32 = 1e-5
# (M, K, N): every row tile of the kernel (4, 8 and 16 rows) and ragged
# column blocks (N a multiple of 16, not of 128)
SHAPES = [(1, 256, 96), (3, 512, 320), (8, 768, 96), (33, 256, 320),
          (64, 512, 208), (5, 256, 16)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda")


def _rel_err(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["q2_k", "q3_k"])
def test_kernel_matches_plain(cuda_device, variant):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    PB.reset_launches()
    for M, K, N in SHAPES:
        w = torch.randn(K, N, generator=g, device=cuda_device) / K ** 0.5
        t = PQ.quantize(variant, w)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(M, K, generator=g, device=cuda_device).to(dtype)
            y = PO.bfp_matmul(x, t, impl="cuda", out_dtype=torch.float32)
            ref = PO.bfp_matmul(x, t, impl="torch", out_dtype=torch.float32)
            torch.cuda.synchronize()
            assert _rel_err(y, ref) <= TOL_F32, (M, K, N, dtype)
            yb = PO.bfp_matmul(x, t)            # auto: the kernel
            assert yb.dtype == dtype and yb.shape == (M, N)
    assert PB.launches[variant] == 4 * len(SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["q2_k", "q3_k"])
def test_kernel_rows_independent_of_m(cuda_device, variant):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(33, 512, generator=g, device=cuda_device).bfloat16()
    t = PQ.quantize(variant, torch.randn(512, 320, generator=g,
                                         device=cuda_device))
    full = PO.bfp_matmul(x, t, impl="cuda")
    for m in (0, 8, 32):
        assert torch.equal(PO.bfp_matmul(x[m:m + 1], t, impl="cuda")[0],
                           full[m])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    t = PQ.quantize("q3_k", torch.randn(256, 64, device=cuda_device))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        PO.bfp_matmul(torch.zeros(2, 256, device=cuda_device,
                                  dtype=torch.float16), t, impl="cuda")
    with pytest.raises(ValueError, match="K="):
        PO.bfp_matmul(torch.zeros(2, 512, device=cuda_device), t,
                      impl="cuda")
    with pytest.raises(ValueError, match="must be contiguous"):
        PB.bfp_matmul_cuda(torch.zeros(256, 2, device=cuda_device).T, t)
    t8 = PQ.quantize("q2_k", torch.randn(256, 200, device=cuda_device))
    with pytest.raises(ValueError, match="N % 16"):
        PO.bfp_matmul(torch.zeros(2, 256, device=cuda_device), t8,
                      impl="cuda")
