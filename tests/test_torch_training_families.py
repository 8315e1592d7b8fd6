"""The port's training path on the MoE, ssm and hybrid configs (reduced)
against the reference's: loss, MoE aux loss and gradients, f32 and bf16,
with the tolerances of ``test_torch_training`` (which holds the dense
configs; the two files run on separate workers under ``--dist
loadfile``). MoE in f32 keeps the bf16 tolerance of its gradients: its
expert products are bf16 in every dtype, in both packages.

The SSD scan's mask: above the diagonal of a chunk the decay's exponent
is positive and may overflow to +inf; masking after the exp gave the
forward its zeros but a NaN gradient (0 x inf in exp's backward). It is
masked before the exp now: the forward is the same bit for bit, and the
gradient finite.
"""
import numpy as np
import pytest
import torch

from test_torch_training import (TOL_LOSS_BF16, _batch,
                                 _leaf_errs, check_loss_and_grads,
                                 ref_value_and_grad)
from repro_torch.configs import base as PC
from repro_torch.models import mamba2 as M2
from repro_torch.training import steps as PS

torch.set_num_threads(2)

TOL_AUX_F32 = 1e-4      # the router's f32 logits, downstream of bf16
                        # expert products in the layer before


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


def test_moe_loss_aux_and_grads_match_reference():
    arch = "olmoe-1b-7b"
    batch = _batch(PC.get_arch(arch, reduced=True))
    got = {}
    for dtype in ("float32", "bfloat16"):
        jl, jaux, jg, pc, pp = ref_value_and_grad(arch, dtype, batch)
        loss, metrics, grads = PS.value_and_grad(
            PS.make_loss_fn(pc), pp, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        got[dtype] = (jl, jaux, jg, float(loss), float(metrics["aux"]),
                      grads)
    jl, jaux, jg, pl, paux, pg = got["float32"]
    assert jaux > 0 and np.isfinite(paux)
    assert abs(paux - jaux) <= TOL_AUX_F32 * jaux
    assert abs(pl - jl) <= TOL_AUX_F32 * jl
    bl, baux, bg, ql, qaux, qg = got["bfloat16"]
    assert abs(qaux - baux) <= TOL_LOSS_BF16 * baux
    assert abs(ql - bl) <= TOL_LOSS_BF16 * bl
    noise = max(_leaf_errs(bg, jg).values())
    for grads, want in ((pg, jg), (qg, bg)):
        errs = _leaf_errs(grads, want)
        assert max(errs.values()) <= 2 * noise, (noise, errs)


def test_ssd_scan_gradient_finite_where_the_decay_overflows():
    g = torch.Generator().manual_seed(0)
    B, S, H, P, N = 2, 24, 3, 4, 5
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.full((B, S, H), 8.0)        # 16 steps of 8: exp(120) = inf
    A = torch.tensor([-1.0, -0.5, -2.0], requires_grad=True)
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N,
                                                           generator=g)
    state0 = torch.zeros(B, H, P, N)
    y, st = M2._ssd_chunk_scan(x, dt, A, Bm, Cm, state0, 16)
    with torch.no_grad():
        yn, sn = M2.naive_recurrence(x, dt, A.detach(), Bm, Cm, state0)
    assert torch.allclose(y, yn, rtol=1e-4, atol=1e-5)
    (ga,) = torch.autograd.grad((y.sum() + st.sum()), A)
    assert torch.isfinite(ga).all()
