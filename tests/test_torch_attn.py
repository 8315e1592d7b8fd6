"""The port's fused prefill attention against the reference kernel.

On the CPU the port's ``prefill_attn_fused`` runs the kernel's plain
PyTorch version. It is held against the reference Pallas kernel in
interpret mode (``repro.kernels.prefill_attn.prefill_attn_fused(...,
interpret=True)``) and against the reference's materializing
``layers.naive_attention``, on the same numpy inputs, under the
chunked-prefill position-mask semantics (absolute query positions against
per-slot key positions, -1 for an empty slot).

Tolerance: 5e-6 relative to the max magnitude, on visible rows only (rows
with at least one visible key; the others are garbage on every path by
convention). That is the reference's own tolerance for its kernel against
the naive path: f32 accumulation order only. The CUDA kernel itself is
checked on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.prefill_attn import prefill_attn_fused as j_fused
from repro.models import layers as JL
from repro_torch.kernels import prefill_attn as PA
from repro_torch.models import layers as PL

torch.set_num_threads(2)

TOL = 5e-6


def _mk(seed, B, C, T, H, KH, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, C, H, D), (B, T, KH, D), (B, T, KH, D)))


def _visible(qp, kp, window):
    vis = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
    if window:
        vis &= kp[:, None, :] > qp[:, :, None] - window
    return np.asarray(vis.any(-1))


def _assert_close(got, ref, vis):
    a = np.asarray(ref, np.float32)[vis]
    b = np.asarray(got, np.float32)[vis]
    np.testing.assert_allclose(b, a, rtol=TOL,
                               atol=TOL * (np.abs(a).max() + 1e-9))


def _compare(q, k, v, qp, kp, window=None, softcap=None,
             dtype=torch.float32):
    """Port (plain, through the dispatch) vs the reference kernel in
    interpret mode and vs the reference's naive path."""
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = PA.prefill_attn_fused(tq, tk, tv, torch.from_numpy(qp),
                                torch.from_numpy(kp), window=window,
                                softcap=softcap)
    assert got.shape == tq.shape and got.dtype == dtype
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    ref = j_fused(jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp),
                  window=window, softcap=softcap, interpret=True)
    naive = JL.naive_attention(jq, jk, jv, causal=True, window=window,
                               softcap=softcap, q_positions=jnp.asarray(qp),
                               kv_positions=jnp.asarray(kp))
    vis = _visible(qp, kp, window)
    _assert_close(got.float().numpy(), jnp.asarray(ref, jnp.float32), vis)
    _assert_close(got.float().numpy(), jnp.asarray(naive, jnp.float32), vis)


@pytest.mark.parametrize("H,KH", [(4, 4), (8, 2), (6, 1)])
def test_plain_matches_reference_gqa(H, KH):
    """Plain self-attention positions, MHA / GQA / MQA head layouts."""
    B, C, T, D = 2, 16, 16, 32
    q, k, v = _mk(H * 10 + KH, B, C, T, H, KH, D)
    pos = np.broadcast_to(np.arange(C)[None], (B, C)).astype(np.int32)
    _compare(q, k, v, pos, pos.copy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_reference_ring_semantics(dtype):
    """Queries attend a decode ring (scattered absolute positions, -1
    empty slots) plus keys past the reference's 256-key tile: positions
    are neither sorted nor contiguous along the key axis. bf16 inputs
    round identically on both sides (both cast to f32 before the dot)."""
    B, C, T, H, KH, D = 2, 24, 300, 8, 2, 64
    q, k, v = _mk(1, B, C, T, H, KH, D)
    rng = np.random.default_rng(2)
    kp = rng.integers(-1, 290, (B, T)).astype(np.int32)
    qp = np.sort(rng.integers(0, 300, (B, C)), axis=1).astype(np.int32)
    _compare(q, k, v, qp, kp, dtype=dtype)


@pytest.mark.parametrize("D,H,KH", [(80, 8, 2), (96, 4, 4)])
def test_plain_matches_reference_head_dims(D, H, KH):
    """Head dims that are no power of two: h2o-danube's 80 (GQA) and
    phi3-mini's 96 (no GQA), over a ring with empty slots and a chunk."""
    B, C, T = 2, 12, 40
    q, k, v = _mk(D, B, C, T, H, KH, D)
    rng = np.random.default_rng(D + 1)
    kp = np.concatenate([rng.integers(-1, 28, (B, T - C)),
                         np.broadcast_to(28 + np.arange(C), (B, C))], 1)
    qp = np.ascontiguousarray(kp[:, T - C:])
    _compare(q, k, v, qp.astype(np.int32), kp.astype(np.int32))


@pytest.mark.parametrize("window,softcap", [(5, None), (None, 8.0),
                                            (7, 4.0)])
def test_plain_matches_reference_window_softcap(window, softcap):
    B, C, T, H, KH, D = 1, 12, 12, 4, 2, 16
    q, k, v = _mk(3, B, C, T, H, KH, D)
    pos = np.broadcast_to(np.arange(C)[None], (B, C)).astype(np.int32)
    _compare(q, k, v, pos, pos.copy(), window=window, softcap=softcap)


def test_fused_through_prefill_attention_entry():
    """impl="fused" on the port's layers.prefill_attention: the same ring
    plus new-chunk concatenation as impl="naive", and the reference's
    fused entry, on the valid (non-right-padded) rows."""
    B, C, T, H, KH, D = 2, 6, 16, 4, 2, 16
    rng = np.random.default_rng(4)
    q, kc, vc, kn, vn = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, C, H, D), (B, T, KH, D), (B, T, KH, D), (B, C, KH, D),
        (B, C, KH, D)))
    slot_pos = np.broadcast_to(np.where(np.arange(T) < 10, np.arange(T), -1),
                               (B, T)).astype(np.int32)
    positions = (10 + np.broadcast_to(np.arange(C), (B, C))).astype(np.int32)
    valid = np.broadcast_to(np.arange(C) < 5, (B, C))
    args = (q, kc, vc, slot_pos, kn, vn, positions, valid)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    naive = PL.prefill_attention(*targs)
    fused = PL.prefill_attention(*targs, impl="fused")
    ref = JL.prefill_attention(*map(jnp.asarray, args), impl="fused",
                               interpret=True)
    _assert_close(fused.numpy(), naive.numpy(), valid)
    _assert_close(fused.numpy(), np.asarray(ref), valid)
    with pytest.raises(ValueError, match="unknown prefill attention impl"):
        PL.prefill_attention(*targs, impl="blockwise")


def test_batch_rows_independent():
    """Row b of a batched call equals the call on that row alone."""
    q, k, v = _mk(5, 3, 10, 20, 4, 2, 64)
    qp = np.broadcast_to(10 + np.arange(10), (3, 10)).astype(np.int32)
    kp = np.broadcast_to(np.arange(20), (3, 20)).astype(np.int32)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, qp, kp)]
    full = PA.prefill_attn_plain(*t)
    one = PA.prefill_attn_plain(*(a[1:2] for a in t))
    assert torch.equal(full[1:2], one)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel: asking for it raises, and
    "auto" takes the plain version without counting a launch."""
    q, k, v = (torch.from_numpy(a) for a in _mk(6, 1, 4, 4, 2, 1, 64))
    pos = torch.arange(4, dtype=torch.int32)[None]
    PA.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        PA.prefill_attn_fused(q, k, v, pos, pos, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        PA.prefill_attn_fused(q, k, v, pos, pos, impl="pallas")
    out = PA.prefill_attn_fused(q, k, v, pos, pos)
    assert torch.equal(out, PA.prefill_attn_plain(q, k, v, pos, pos))
    assert PA.launches == {"prefill_attn": 0}
