"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA GPU (marker ``cuda``) and skip elsewhere: a CUDA
kernel has no CPU mode. The tests of ``k_splits``, the wrapper's pure
function of the weight's shape, carry no marker and run everywhere. The
file imports no JAX, so it also runs where only the port is installed:

  PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, relative to the output's max magnitude:
  * matmul, f32 output: 1e-5. The kernel and the plain version round x and
    w to bf16 alike and accumulate in f32; only the summation order
    differs (the tensor cores' k16 steps, and the K split's partials
    summed in ascending order, against one f32 product a row).
  * matmul, f32 output, against the exact (f64) product of the same bf16
    operands on a 32-tile K chain in one split: 1e-6. Each tile's k16
    steps sum in the tensor cores' accumulator, whose additions do not
    round to nearest, and the tile sums in f32 adds that do; a chain of
    every k16 step read 7.7e-6.
  * attention, f32 output: 5e-6 on visible rows, the reference's own
    tolerance for its kernel against the naive path (f32 accumulation
    order, the kernel's visible key tiles against the plain version's
    256-key tiles, and 3xTF32's residual of about 2**-21). bf16 output:
    2**-7, one bf16 ulp at the max.
  * Q8_K quantization: byte for byte, against the plain version on the
    card and on the CPU (every step is correctly rounded on both).
  * the MoE layer (``models/moe.py``, plain torch ops, no kernel of its
    own) on the card against the same call on the CPU, bf16 output:
    2**-6, two bf16 ulps at the max (cuBLAS and the CPU sum the bf16
    expert products in another order, and the output rounds again).
  * one train step (``training/steps.py``, plain torch ops, no kernel) on
    the card against the same step on the CPU, from one state: in f32
    compute, loss 1e-5 and grad norm 1e-4 relative (f32 sums in another
    order), the parameters' update within 1e-3 of its norm, and no
    element more than 2 x lr apart (Adam's first step moves an element
    by lr x g / (|g| + eps): one whose gradient is near 0 can step the
    other way); in bf16 compute, loss and grad norm 2e-2, and the update
    within twice the CPU's own bf16 update against its f32 one.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import quantize as PQ
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.kernels import bfp_matmul as PB
from repro_torch.kernels import ops as PO
from repro_torch.kernels import prefill_attn as PA
from repro_torch.kernels import q8k_quant as PK
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

TOL_F32 = 1e-5
TOL_ATTN = 5e-6
TOL_BF16 = 2.0 ** -7
TOL_EXACT = 1e-6
# (M, K, N): token tiles of one and eight 8-token groups, K split and not
# (k_splits), and ragged column blocks (N a multiple of 16, not of 128)
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
@pytest.mark.parametrize("variant", PB.VARIANTS)
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


# M of every token tile the kernel takes (1, 2, 4 and 8 groups of 8), and
# rows at every place of an 8-token group and of a 64-token tile
ROW_MS = (1, 4, 7, 8, 9, 24, 64, 128, 512)
ROWS = (0, 1, 3, 6, 7, 8, 9, 15, 23, 33, 63, 64, 100, 127, 128, 300, 511)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", PB.VARIANTS)
def test_kernel_rows_independent_of_m(cuda_device, variant):
    """Bit for bit, f32 output: a row of an M-row product equals the M=1
    product of that row, for M from 1 to 512. K is split in two at
    (512, 320), where the splits always go through the workspace, and in
    four at w_up's (2048, 5632), where one block runs a tile's splits in
    turn at M=512 and the workspace takes them at small M."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for (K, N), splits in (((512, 320), 2), ((2048, 5632), 4)):
        assert PB.k_splits(K, N) == splits
        x = torch.randn(512, K, generator=g, device=cuda_device).bfloat16()
        t = PQ.quantize(variant, torch.randn(K, N, generator=g,
                                             device=cuda_device))
        one = {m: PO.bfp_matmul(x[m:m + 1], t, impl="cuda",
                                out_dtype=torch.float32)[0] for m in ROWS}
        for M in ROW_MS:
            full = PO.bfp_matmul(x[:M], t, impl="cuda",
                                 out_dtype=torch.float32)
            for m in ROWS:
                if m < M:
                    assert torch.equal(full[m], one[m]), (K, N, M, m)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", PB.VARIANTS)
@pytest.mark.parametrize("K,N", [(2048, 256), (5632, 2048)])
def test_kernel_split_k_shapes(cuda_device, variant, K, N):
    """wk/wv's and w_down's shapes, where K is split (S = 8 and 11): the
    f32 partials summed in ascending order (through the workspace, or in
    one block at w_down's M=512) match the plain version, and rows of the
    largest M equal the M=1 product bit for bit."""
    assert PB.k_splits(K, N) > 1
    g = torch.Generator(device=cuda_device).manual_seed(K + N)
    t = PQ.quantize(variant, torch.randn(K, N, generator=g,
                                         device=cuda_device) / K ** 0.5)
    for M in (4, 9, 20, 128, 512):
        x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
        y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
        ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
        yb = PB.bfp_matmul_cuda(x, t)
        rb = PB.bfp_matmul_plain(x, t)
        torch.cuda.synchronize()
        assert _rel_err(y, ref) <= TOL_F32, M
        assert _rel_err(yb, rb) <= TOL_BF16, M
    for m in (0, 77, 127, 511):
        assert torch.equal(PB.bfp_matmul_cuda(x[m:m + 1], t)[0], yb[m]), m


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 512])
def test_long_k_chain_within_rounding_of_the_exact_product(cuda_device, M):
    """K = 8192 in one split (132 column tiles fill the card): the f32
    output within ``TOL_EXACT`` of the f64 product of the same bf16 x and
    bf16 dequantized weight, at decode M and at M = 512 (one block a
    tile's splits)."""
    K, N = 8192, 16896
    assert PB.k_splits(K, N) == 1
    g = torch.Generator(device=cuda_device).manual_seed(3)
    t = PQ.quantize("q3_k", torch.randn(K, N, generator=g,
                                        device=cuda_device) / K ** 0.5)
    x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
    y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
    w = PQ.dequantize(t, dtype=torch.float32).bfloat16().double()
    assert _rel_err(y.double(), x.double() @ w) <= TOL_EXACT


def test_k_splits_takes_no_m():
    """The split along K is a function of the weight's shape alone: a
    row's value cannot depend on how many rows share the call."""
    assert list(inspect.signature(PB.k_splits).parameters) == ["K", "N"]
    assert PB.k_splits(2048, 256) == 8       # 2 column tiles of 128
    assert PB.k_splits(2048, 32000) == 1     # 500 column tiles


@pytest.mark.cuda
@pytest.mark.parametrize("variant", PB.VARIANTS)
def test_smem_budget_equals_the_cards_reading(cuda_device, variant):
    """The shared memory computed from the source (``smem_bytes``) is the
    compiled kernel's, by ``cuFuncGetAttribute``: no static shared memory,
    and the dynamic figure the launch allows; registers are read, not
    gated."""
    for row in PB.budget(card=True):
        if row["variant"] != variant:
            continue
        card = row["card"]
        assert card["static_smem"] == row["static"], row
        assert card["max_dynamic_smem"] == row["dynamic"], row
        assert 0 < card["regs"] <= 255 and card["max_threads"] >= 256


@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 5632),
                                 (5632, 2048), (2048, 32000), (768, 2304),
                                 (768, 768), (768, 3072), (3072, 768),
                                 (768, 50257), (2080, 256), (288, 96),
                                 (256, 1)])
def test_k_splits_divides_the_tiles_and_fills_the_card(K, N):
    """S divides the 256-row tiles along K, and it is the least such
    divisor for which column tiles times S reach the SM count, or every
    tile when none does."""
    s = PB.k_splits(K, N)
    tiles, cols = -(-K // 256), -(-N // PB.BLOCK_N)
    assert 1 <= s <= tiles and tiles % s == 0
    assert cols * s >= PB.SMS or s == tiles
    assert all(cols * d < PB.SMS for d in range(1, s) if tiles % d == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["q4_0", "q8_0"])
@pytest.mark.parametrize("M,K,N", [(1, 288, 96), (33, 288, 320),
                                   (4, 2080, 256), (128, 2080, 256)])
def test_kernel_32_row_formats_take_k_multiple_of_32(cuda_device, variant,
                                                      M, K, N):
    """Q4_0 and Q8_0 have 32-row super-blocks: a K that is a multiple of 32
    and not of 256 leaves a partial last tile."""
    g = torch.Generator(device=cuda_device).manual_seed(K + M)
    t = PQ.quantize(variant, torch.randn(K, N, generator=g,
                                         device=cuda_device) / K ** 0.5)
    assert t.variant == variant
    x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
    y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
    ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _rel_err(y, ref) <= TOL_F32
    assert torch.equal(PB.bfp_matmul_cuda(x[:1], t)[0],
                       PB.bfp_matmul_cuda(x, t)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [v for v in PB.VARIANTS if v != "q3_k_o"])
def test_packing_on_the_card_equals_the_cpu(cuda_device, variant):
    """Every payload byte agrees at a real projection shape: the scale
    divisions are true divisions on the card too (a division by a Python
    scalar there is a multiply by its reciprocal, one ulp off for some
    values)."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    w = torch.randn(2048, 5632, generator=g, device=cuda_device)
    gpu, cpu = PQ.quantize(variant, w), PQ.quantize(variant, w.cpu())
    for k, v in cpu.data.items():
        assert torch.equal(v.view(torch.uint8),
                           gpu.data[k].cpu().view(torch.uint8)), k


@pytest.mark.cuda
def test_q3_k_o_packing_on_the_card_equals_the_cpu(cuda_device):
    """torch.topk on CUDA picks the same sidecar rows as on the CPU: every
    payload byte agrees, stacked layers and activation stats included. The
    scores are tie-free (distinct |w| in each column, activation stats of
    powers of two): on tied scores the two devices order the tied rows
    differently."""
    rng = np.random.default_rng(9)
    K, N = 512, 160
    mag = 1 + np.stack([np.stack([rng.permutation(K) for _ in range(N)], 1)
                        for _ in range(2)]) / K
    w = torch.from_numpy((mag * rng.choice([-1, 1], mag.shape)).astype(
        np.float32))
    a = torch.from_numpy((2.0 ** rng.integers(0, 3, K)).astype(np.float32))
    for act in (None, a):
        cpu = PQ.quantize_q3_k_o(w, act_absmax=act)
        gpu = PQ.quantize_q3_k_o(
            w.to(cuda_device),
            act_absmax=None if act is None else act.to(cuda_device))
        for k, v in cpu.data.items():
            assert torch.equal(v.view(torch.uint8),
                               gpu.data[k].cpu().view(torch.uint8)), k


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
    # N = 200 is laid out lane-padded on the card; a payload put back
    # contiguous has rows that do not start on 16-byte boundaries
    t8 = PQ.quantize("q2_k", torch.randn(256, 200, device=cuda_device))
    t8.data["qs"] = t8.data["qs"].contiguous()
    with pytest.raises(ValueError, match="16-byte boundaries"):
        PO.bfp_matmul(torch.zeros(2, 256, device=cuda_device), t8,
                      impl="cuda")
    t0 = PQ.quantize("q4_0", torch.randn(288, 64, device=cuda_device))
    with pytest.raises(ValueError, match="32-row super-block"):
        PO.bfp_matmul(torch.zeros(2, 272, device=cuda_device), t0,
                      impl="cuda")


def _attn_inputs(dev, B, C, T, H, KH, D, dtype, seed):
    """Ring-style positions: a ring of T - C slots with empty (-1) and
    scattered entries, then the chunk's own C keys."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dtype) for s in ((B, C, H, D), (B, T, KH, D),
                                         (B, T, KH, D)))
    start = T - C
    ring = rng.integers(-1, start, (B, T - C))
    chunk = np.broadcast_to(start + np.arange(C), (B, C))
    kp = torch.from_numpy(np.concatenate([ring, chunk], 1).astype(np.int32))
    qp = torch.from_numpy(np.ascontiguousarray(chunk).astype(np.int32))
    return q, k, v, qp.to(dev), kp.to(dev)


def _visible(qp, kp, window):
    vis = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
    if window:
        vis &= kp[:, None, :] > qp[:, :, None] - window
    return vis.any(-1)


# (q dtype, k/v dtype): the bf16 tensor-core route, the 3xTF32 route, and
# a mix, which takes the 3xTF32 route
ATTN_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16)]


def _attn_check(q, k, v, qp, kp, window=None, softcap=None):
    y = PA.prefill_attn_fused(q, k, v, qp, kp, window=window,
                              softcap=softcap)
    ref = PA.prefill_attn_plain(q, k, v, qp, kp, window=window,
                                softcap=softcap)
    torch.cuda.synchronize()
    assert y.dtype == q.dtype and y.shape == q.shape
    vis = _visible(qp, kp, window)
    tol = TOL_ATTN if q.dtype == torch.float32 else TOL_BF16
    assert bool(torch.isfinite(y[vis]).all())
    assert _rel_err(y[vis], ref[vis]) <= tol, (q.dtype, k.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 36, 64, 80, 96, 128, 256])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, None),
                                            (None, 30.0)])
def test_attention_kernel_matches_plain(cuda_device, D, window, softcap):
    """Every head dim of the configs (64, 80, 96, 128), the narrowest and
    widest instance, and D = 36, which no 16-byte chunk divides (copied
    element by element)."""
    PA.reset_launches()
    for qdt, kvdt in ATTN_DTYPES:
        q, k, v, qp, kp = _attn_inputs(cuda_device, 2, 40, 140, 8, 2, D,
                                       torch.float32, seed=D)
        _attn_check(q.to(qdt), k.to(kvdt), v.to(kvdt), qp, kp, window,
                    softcap)
    assert PA.launches["prefill_attn"] == len(ATTN_DTYPES)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", ATTN_DTYPES)
def test_attention_kernel_sparse_ring_and_window(cuda_device, qdt, kvdt):
    """A serving-like ring that is mostly empty: runs of visible slots
    between long runs of -1, past T's last full tile; and a window that
    makes a key tile visible to some rows of a block and not to others
    (G = 8 folds 8 chunk positions into a 64-row block)."""
    rng = np.random.default_rng(11)
    B, C, H, KH, D, ring = 2, 96, 16, 2, 64, 700
    T = ring + C
    start = 500
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda_device) for s in ((B, C, H, D), (B, T, KH, D),
                                          (B, T, KH, D)))
    slots = np.full((B, ring), -1)
    for b in range(B):                 # a few runs of the past positions
        for lo in (0, 130, 333, 640):
            n = int(rng.integers(5, 40))
            slots[b, lo:lo + n] = rng.integers(0, start, n)
    qp = np.broadcast_to(start + np.arange(C), (B, C))
    kp = np.concatenate([slots, qp], 1).astype(np.int32)
    qp = torch.from_numpy(np.ascontiguousarray(qp, np.int32)).to(cuda_device)
    kp = torch.from_numpy(kp).to(cuda_device)
    q, k, v = q.to(qdt), k.to(kvdt), v.to(kvdt)
    for window in (None, 60, 200):
        _attn_check(q, k, v, qp, kp, window)


@pytest.mark.cuda
def test_attention_kernel_batch_rows_independent(cuda_device):
    q, k, v, qp, kp = _attn_inputs(cuda_device, 4, 33, 97, 4, 1, 64,
                                   torch.bfloat16, seed=3)
    full = PA.prefill_attn_cuda(q, k, v, qp, kp)
    one = PA.prefill_attn_cuda(q[:1], k[:1], v[:1], qp[:1], kp[:1])
    assert torch.equal(full[:1], one)


@pytest.mark.cuda
def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    D = PA.MAX_HEAD_DIM + 8
    q, k, v, qp, kp = _attn_inputs(cuda_device, 1, 8, 16, 4, 2, D,
                                   torch.float32, seed=4)
    with pytest.raises(ValueError, match="head dims"):
        PA.prefill_attn_cuda(q, k, v, qp, kp)
    q, k, v = q[..., :32], k[..., :32], v[..., :32]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    assert PA.prefill_attn_cuda(q, k, v, qp, kp).shape == q.shape
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        PA.prefill_attn_cuda(q.half(), k, v, qp, kp)
    with pytest.raises(ValueError, match="CUDA tensor"):
        PA.prefill_attn_cuda(q.cpu(), k.cpu(), v.cpu(), qp.cpu(), kp.cpu())


# -- any N in the dequant-matmul --------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("variant", PB.VARIANTS)
def test_kernel_takes_any_n(cuda_device, variant):
    """N = 8 (mod 16), odd N and N = 1: a QTensor made on the card lays its
    payloads out lane-padded once, and the kernel reads them through the
    row stride; the output is (M, N), rows independent of M."""
    g = torch.Generator(device=cuda_device).manual_seed(31)
    for K, N in ((256, 200), (512, 77), (256, 1), (768, 136)):
        t = PQ.quantize(variant, torch.randn(K, N, generator=g,
                                             device=cuda_device) / K ** 0.5)
        for v in t.data.values():
            assert v.shape[-1] == N and v.stride(0) == PQ.lane_stride(N)
        x = torch.randn(33, K, generator=g, device=cuda_device).bfloat16()
        y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
        ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert y.shape == (33, N)
        assert _rel_err(y, ref) <= TOL_F32, (K, N)
        assert torch.equal(PB.bfp_matmul_cuda(x[:1], t)[0],
                           PB.bfp_matmul_cuda(x, t)[0])


@pytest.mark.cuda
def test_kernel_gpt2_head_without_a_copy(cuda_device):
    """gpt2-paper's LM head, (768, 50257) in q2_k, at decode M: matches the
    plain version, and a call allocates only its output (the padded
    layout is made once, with the QTensor, never per call)."""
    g = torch.Generator(device=cuda_device).manual_seed(32)
    K, N = 768, 50257
    t = PQ.quantize("q2_k", torch.randn(K, N, generator=g,
                                        device=cuda_device) / K ** 0.5)
    x = torch.randn(4, K, generator=g, device=cuda_device).bfloat16()
    y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
    ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
    assert _rel_err(y, ref) <= TOL_F32
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before <= y.numel() * 4 + 512


# -- Q8_K activation quantization ------------------------------------------

def _bytes_equal(a, b):
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_q8k_kernel_equals_plain_byte_for_byte(cuda_device, dtype):
    """The integer path's shapes (M of 1 to 512, the paper models' K), with
    zero super-blocks and with a row mask that masks rows, against the
    plain version on the card and on the CPU."""
    g = torch.Generator(device=cuda_device).manual_seed(41)
    PK.reset_launches()
    calls = 0
    for M in (1, 4, 33, 512):
        for K in (768, 2048, 3072, 5632):
            x = (torch.randn(M, K, generator=g, device=cuda_device)
                 * 3).to(dtype)
            x[0, :256] = 0                      # a zero super-block
            x[-1, -512:] = 0
            mask = torch.rand(M, generator=g, device=cuda_device) < 0.7
            mask[0] = False
            for valid in (None, mask):
                got = PK.q8k_quantize_cuda(x, valid)
                calls += 1
                want = PK.q8k_quantize_plain(x, valid)
                cpu = PK.q8k_quantize_plain(
                    x.cpu(), None if valid is None else valid.cpu())
                for k in ("qs", "d", "bsums"):
                    assert got[k].dtype == want[k].dtype
                    assert _bytes_equal(got[k], want[k]), (M, K, k)
                    assert _bytes_equal(got[k].cpu(), cpu[k]), (M, K, k)
                if valid is not None:
                    for k in ("qs", "d", "bsums"):
                        assert not got[k][~valid].any(), k
    assert PK.launches["q8k_quantize"] == calls


@pytest.mark.cuda
def test_q8k_ops_and_isa_launch_the_kernel(cuda_device):
    """ops.q8k_quantize on a CUDA tensor launches the kernel (leading dims
    flattened), and the ISA simulator launches it once per SCHEDULE."""
    from repro_torch.core import isa
    from repro_torch.kernels import ref as PR
    g = torch.Generator(device=cuda_device).manual_seed(42)
    x = torch.randn(2, 3, 512, generator=g, device=cuda_device)
    PK.reset_launches()
    q = PO.q8k_quantize(x)
    assert PK.launches["q8k_quantize"] == 1 and q["qs"].shape == (2, 3, 512)
    w = PQ.quantize("q3_k", torch.randn(512, 600, generator=g,
                                        device=cuda_device) * 0.2)
    x2 = torch.randn(4, 512, generator=g, device=cuda_device)
    PK.reset_launches()
    out, stats = isa.run_matmul(x2, w)
    assert PK.launches["q8k_quantize"] == stats.schedules == 3
    expect = PR.matmul_q8k_ref(PO.q8k_quantize(x2), w)
    assert _rel_err(out, expect) <= TOL_F32


@pytest.mark.cuda
def test_q8k_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(2, 512, device=cuda_device)
    with pytest.raises(ValueError, match="K % 256"):
        PK.q8k_quantize_cuda(x[:, :300].contiguous())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        PK.q8k_quantize_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        PK.q8k_quantize_cuda(torch.zeros(512, 2, device=cuda_device).T)
    with pytest.raises(ValueError, match="valid"):
        PK.q8k_quantize_cuda(x, torch.ones(3, dtype=torch.bool,
                                           device=cuda_device))


# -- int8 KV cache and the ring/page copies (no kernel: torch ops) ---------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_on_the_card_equals_the_cpu(cuda_device, dtype):
    """The int8 KV cache's codes and scales, byte for byte: the scale
    divides by a tensor on the card, which rounds as the CPU does (a
    Python-scalar divisor is a reciprocal multiply there)."""
    from repro_torch.models import transformer as PT
    g = torch.Generator().manual_seed(43)
    for shape in ((4, 4, 64), (7, 5, 128)):
        x = (torch.randn(shape, generator=g) * 3).to(dtype)
        x[0, 1] = 0                                 # an all-zero row
        x[1, 0, :3] *= 1e3
        q_cpu, s_cpu = PT._quantize_kv(x)
        q_gpu, s_gpu = PT._quantize_kv(x.to(cuda_device))
        assert _bytes_equal(q_gpu.cpu(), q_cpu), shape
        assert _bytes_equal(s_gpu.cpu(), s_cpu), shape


@pytest.mark.cuda
def test_ring_and_page_copies_on_the_card_equal_the_cpu(cuda_device):
    """ring_gather/ring_restore (speculative rewind) and page_gather/
    page_scatter (prefix cache, entries >= T dropped on the host) on the
    card against the same calls on the CPU."""
    g = torch.Generator().manual_seed(44)
    L, B, T, KH, D, S, page = 2, 3, 16, 2, 8, 4, 4
    kv = torch.randn(L, B, T, KH, D, generator=g)
    pos = torch.randint(-1, 40, (B, T), generator=g, dtype=torch.int32)
    slots = (torch.tensor([[3], [14], [7]]) + torch.arange(S)) % T
    keep = torch.tensor([0, 2, 4])
    rows = np.array([2, 0, 1])
    cols = np.array([[4, 5, 6, 7], [12, 13, 14, 15], [0, 1, T, T]])
    for arr, axis in ((kv, 2), (pos, 1)):
        out = {}
        for dev in ("cpu", cuda_device):
            a = arr.to(dev).clone()
            snap = PO.ring_gather(a, slots.to(dev), ring_axis=axis)
            a.fill_(0)
            PO.ring_restore(a, snap, slots.to(dev), keep.to(dev),
                            ring_axis=axis)
            pages = PO.page_gather(arr.to(dev), rows, np.where(
                cols < T, cols, 0), ring_axis=axis)
            PO.page_scatter(a, pages, rows[::-1].copy(), cols,
                            ring_axis=axis)
            out[str(dev)] = (snap.cpu(), pages.cpu(), a.cpu())
        for x, y in zip(out["cpu"], out[str(cuda_device)]):
            assert _bytes_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 1.0])
def test_moe_block_on_the_card_equals_the_cpu(cuda_device, cf):
    """Reduced olmoe's layer 0, packed under default_serve_mix (the E*K
    expert stacks dequantized at use), on a (3, 64, d) bf16 input: the
    card's output equals the CPU's at 2**-6 and the routing (expert,
    slot, keep) exactly; each batch row alone gives its row bit for bit."""
    cfg = get_arch("olmoe-1b-7b", reduced=True).replace(capacity_factor=cf)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    qp, _ = quantize_params(params, get_policy("default_serve_mix"))
    lp = PT._layer(qp["layers"], 0)["moe"]
    lg = {k: v.to(cuda_device) for k, v in lp.items()}
    x = torch.randn(3, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    y_cpu, aux_cpu = PM.moe_block(x, lp, cfg)
    y, aux = PM.moe_block(x.to(cuda_device), lg, cfg)
    assert _rel_err(y.cpu(), y_cpu) <= 2.0 ** -6
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5 * abs(float(aux_cpu))
    k, E = cfg.n_experts_active, cfg.n_experts
    C = PM._capacity(64, k, E, cf)
    _, ti_card, _ = PM.route(x.to(cuda_device), lg["router"], k)
    _, ti_cpu, _ = PM.route(x, lp["router"], k)
    for a, b in zip(PM.dispatch(ti_card, E, C), PM.dispatch(ti_cpu, E, C)):
        assert torch.equal(a.cpu(), b)
    for b in range(3):
        yb, _ = PM.moe_block(x[b:b + 1].to(cuda_device), lg, cfg)
        assert torch.equal(yb[0], y[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("kv8", [False, True])
def test_kv_page_export_import_on_the_card(cuda_device, kv8):
    """The disaggregation hand-off on the card: a prompt's pages exported
    from one engine, imported into another and exported again are the
    same bytes (int8 codes and f32 scales too), and the importer serves
    the exporter's tokens from them."""
    from repro_torch.serving.engine import Engine, ServeConfig
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(
        kv_cache_quant=kv8)
    params = PT.init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                            device=cuda_device)
    scfg = ServeConfig(max_new_tokens=5, cache_len=64, decode_chunk=5,
                       max_slots=2, prefill_bucket=4, prefill_chunk=16,
                       prefix_page=8, prefix_cache=True)
    src = Engine(cfg, params, scfg, device=cuda_device)
    dst = Engine(cfg, params, scfg, device=cuda_device)
    P = [int(t) for t in np.random.default_rng(6).integers(
        0, cfg.vocab_size, 21)]
    want = src.generate([P])
    kv = src.export_kv_pages(P)
    assert kv.n_pages == 2 and len(kv.payload) == (4 if kv8 else 2)
    assert all(v.device.type == "cpu" for v in kv.payload.values())
    assert dst.import_kv_pages(kv) == 2
    back = dst.export_kv_pages(P)
    for k, v in kv.payload.items():
        assert _bytes_equal(back.payload[k], v), k
    assert dst.generate([P]) == want and dst.stats["prefix_hits"] == 1


def _train_step(cfg, state, batch, dev):
    from repro_torch.optim.adamw import AdamWConfig, tree_map
    from repro_torch.training import steps as PS
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step = PS.make_train_step(cfg, opt, microbatches=2)
    new, m = step(tree_map(lambda x: x.to(dev), state),
                  {k: v.to(dev) for k, v in batch.items()})
    return tree_map(lambda x: x.cpu(), new["params"]), {
        k: float(v) for k, v in m.items()}, float(m["lr"])


def _update_err(new, ref, p0):
    """max over leaves of |new - ref| / |ref - p0| (norms)."""
    from repro_torch.optim.adamw import tree_leaves
    return max(float((a.double() - b.double()).norm()
                     / (b.double() - c.double()).norm().clamp_min(1e-30))
               for a, b, c in zip(tree_leaves(new), tree_leaves(ref),
                                  tree_leaves(p0)))


@pytest.mark.cuda
def test_train_step_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.training import steps as PS
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    state = PS.init_train_state(cfg, AdamWConfig(),
                                torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
        for k in ("tokens", "labels")}
    got = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        got[dtype] = (_train_step(c, state, batch, cuda_device),
                      _train_step(c, state, batch, "cpu"))
    p0 = state["params"]
    (card, mc, lr), (cpu, mp, _) = got["float32"]
    assert abs(mc["loss"] - mp["loss"]) <= 1e-5 * mp["loss"]
    assert abs(mc["grad_norm"] - mp["grad_norm"]) <= 1e-4 * mp["grad_norm"]
    assert _update_err(card, cpu, p0) <= 1e-3
    for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
        assert float((a - b).abs().max()) <= 2 * lr
    cpu32 = cpu
    (card, mc, lr), (cpu, mp, _) = got["bfloat16"]
    for k in ("loss", "grad_norm"):
        assert abs(mc[k] - mp[k]) <= 2e-2 * mp[k], k
    noise = _update_err(cpu, cpu32, p0)
    assert _update_err(card, cpu, p0) <= 2 * noise, noise



@pytest.mark.cuda
@pytest.mark.parametrize("variant", PB.VARIANTS)
def test_kernel_on_tensor_parallel_shards(cuda_device, variant):
    """The kernel on a rank's shards of a packed weight, against its plain
    version: a lane slice (a strided view: "sliced"), a K-row slice with
    f32 output ("sliced_row"), and the zero-embedded full width
    ("padded"), whose rank columns equal the whole weight's bit for bit
    and whose other columns are zero."""
    from repro_torch.distributed import sharding as SH
    g = torch.Generator(device=cuda_device).manual_seed(7)
    M, K, N = 4, 1024, 512
    t = PQ.quantize(variant, torch.randn(K, N, generator=g,
                                         device=cuda_device) / K ** 0.5)
    x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
    whole = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
    for tp in (2, 4):
        n, k = N // tp, K // tp
        for r in range(tp):
            lane = SH.lane_shard_qtensor(t, r, tp)
            rows = SH.row_shard_qtensor(t, r, tp)
            xr = x[:, r * k:(r + 1) * k].contiguous()
            for xx, w in ((x, lane), (xr, rows)):
                y = PB.bfp_matmul_cuda(xx, w, out_dtype=torch.float32)
                ref = PB.bfp_matmul_plain(xx, w, out_dtype=torch.float32)
                assert _rel_err(y, ref) <= TOL_F32, (tp, r, w.shape)
            with SH.serve_tp(SH.ServeTPPlan(size=tp), r, group=True):
                emb = PO.tp_embed_lanes(lane)
            y = PB.bfp_matmul_cuda(x, emb, out_dtype=torch.float32)
            assert torch.equal(y[:, r * n:(r + 1) * n],
                               whole[:, r * n:(r + 1) * n])
            assert bool((y[:, :r * n] == 0).all()
                        and (y[:, (r + 1) * n:] == 0).all())


@pytest.mark.cuda
def test_tp_engine_ranks_share_the_card(cuda_device):
    """tp=2 with both ranks on one card (gloo, CUDA operands staged through
    host memory) serves the tp=1 engine's greedy tokens ("padded")."""
    from repro_torch.serving.engine import Engine, ServeConfig
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    params = PT.init_params(cfg, torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device)
    qp, _ = quantize_params(params, get_policy("paper_llama_mix"))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 17, 30)]
    scfg = dict(max_new_tokens=6, max_slots=3, cache_len=64,
                prefill_chunk=16)
    want = Engine(cfg, qp, ServeConfig(**scfg),
                  device=cuda_device).generate(prompts)
    with Engine(cfg, qp, ServeConfig(tp=2, **scfg),
                device=["cuda:0"] * 2) as eng:
        assert eng.tp_backend == "gloo"
        assert eng.generate(prompts) == want
