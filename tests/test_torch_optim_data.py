"""The port's AdamW and data pipeline against the reference's.

``cosine_lr`` and ``apply_updates`` run the same f32 arithmetic as the
reference, step for step; only the global norm's sum runs in another
order (XLA's reduction against torch's), and XLA's and torch's ``cos``
and ``sqrt`` may round an ulp apart. Tolerances:
  * the learning rate: 2 f32 ulps (2**-22 relative);
  * new parameters and f32 moments: 1e-6 relative to each leaf's largest
    value (a few ulps of each step of the update, scaled by a clip
    factor that carries the norm's last-bit difference);
  * bf16 moments: one bf16 ulp (2**-8 relative to the leaf's largest
    value), since an f32 value an ulp off can round to the next bf16;
  * grad norm: 1e-6 relative (the sum's order).
Batches are compared byte for byte: both packages run the same numpy.
The reference's own optimizer tests (``tests/test_training.py``) are
ported as they are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as JD
from repro.optim import adamw as JA
from repro_torch.data import pipeline as PD
from repro_torch.optim import adamw as PA

torch.set_num_threads(2)

TOL_LR = 2.0 ** -22
TOL_F32 = 1e-6
TOL_BF16 = 2.0 ** -8


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("warmup,total,min_ratio", [(10, 100, 0.1),
                                                    (0, 37, 0.0),
                                                    (5, 5, 0.5)])
def test_cosine_lr_matches_reference(warmup, total, min_ratio):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
              min_lr_ratio=min_ratio)
    jcfg, pcfg = JA.AdamWConfig(**kw), PA.AdamWConfig(**kw)
    steps = np.arange(0, total + 5, dtype=np.int32)
    want = np.asarray(JA.cosine_lr(jcfg, jnp.asarray(steps)))
    got = PA.cosine_lr(pcfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_LR, atol=0)
    for s in (0, warmup, total):      # a Python int, as the loop may pass
        assert abs(float(PA.cosine_lr(pcfg, s))
                   - float(JA.cosine_lr(jcfg, jnp.asarray(s)))) \
            <= TOL_LR * kw["lr"]


def _tree(rng, scale):
    """2-D and 1-D leaves, nested as a model's are."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"layers": {"w": a(3, 8, 16), "ln": {"w": a(3, 16)}},
            "lm_head": a(16, 24), "bias": a(24)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_apply_updates_matches_reference(moment_dtype, grad_scale):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0, moment_dtype=moment_dtype)
    jcfg, pcfg = JA.AdamWConfig(**kw), PA.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    pp = PA.tree_map(torch.from_numpy, params)
    js, ps = JA.init_state(jcfg, jp), PA.init_state(pcfg, pp)
    clipped = []
    for _ in range(3):
        grads = _tree(rng, grad_scale)
        jp, js, jm = JA.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray,
                                                             grads), js)
        pp, ps, pm = PA.apply_updates(pcfg, pp, PA.tree_map(
            torch.from_numpy, grads), ps)
        assert _rel(pm["grad_norm"], jm["grad_norm"]) <= TOL_F32
        assert _rel(pm["lr"], jm["lr"]) <= TOL_LR
        clipped.append(float(jm["grad_norm"]) > kw["grad_clip"])
    assert all(clipped) == (grad_scale > 1)    # the case this id names
    assert int(ps["step"]) == int(js["step"]) == 3
    tol_m = TOL_F32 if moment_dtype == "float32" else TOL_BF16
    jl, pl = jax.tree.leaves(jp), PA.tree_leaves(pp)
    for j, p in zip(jl, pl):
        assert p.dtype == torch.float32
        assert _rel(_np(p), j) <= TOL_F32
    for key in ("m", "v"):
        for j, p in zip(jax.tree.leaves(js[key]), PA.tree_leaves(ps[key])):
            assert str(p.dtype) == f"torch.{moment_dtype}"
            assert _rel(_np(p), np.asarray(j, np.float32)) <= tol_m


def test_apply_updates_leaves_its_inputs_and_decays_only_matrices():
    cfg = PA.AdamWConfig(lr=0.0, weight_decay=0.5)
    params = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    state = PA.init_state(cfg, params)
    grads = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    lr = torch.tensor(0.1)
    new, new_state, _ = PA.apply_updates(cfg, params, grads, state, lr=lr)
    assert torch.equal(params["w"], torch.ones(2, 2))     # not in place
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert torch.allclose(new["w"], torch.full((2, 2), 0.95))
    assert torch.equal(new["b"], torch.ones(2))           # no decay on 1-D


# the reference's tests/test_training.py optimizer tests, ported

def test_adamw_reduces_quadratic():
    opt = PA.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                         weight_decay=0.0)
    params = {"w": torch.ones((4, 4)) * 3.0}
    state = PA.init_state(opt, params)
    for _ in range(50):
        grads = {"w": 2 * params["w"]}
        params, state, _ = PA.apply_updates(opt, params, grads, state)
    assert float(params["w"].abs().max()) < 1.0


def test_cosine_schedule():
    opt = PA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1)
    assert float(PA.cosine_lr(opt, torch.tensor(0))) == 0.0
    assert abs(float(PA.cosine_lr(opt, torch.tensor(10))) - 1.0) < 1e-6
    assert abs(float(PA.cosine_lr(opt, torch.tensor(100))) - 0.1) < 1e-6


def test_grad_clipping():
    opt = PA.AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros((2, 2))}
    state = PA.init_state(opt, params)
    _, _, m = PA.apply_updates(opt, params, {"w": torch.ones((2, 2)) * 100},
                               state)
    assert float(m["grad_norm"]) > 100


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def _same_batches(jd, pd, steps):
    for step in steps:
        want, got = jd.batch(step), pd.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("V,S,B,seed", [(512, 32, 4, 0), (32000, 64, 3, 7)])
def test_synthetic_batches_byte_identical(V, S, B, seed):
    kw = dict(vocab_size=V, seq_len=S, global_batch=B, seed=seed)
    _same_batches(JD.DataPipeline(JD.DataConfig(**kw)),
                  PD.DataPipeline(PD.DataConfig(**kw)), (0, 1, 5, 123456))


def test_file_batches_byte_identical(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 65535, 5000).astype(
        np.uint16).tofile(path)
    kw = dict(vocab_size=65536, seq_len=48, global_batch=5, seed=2,
              path=str(path))
    _same_batches(JD.DataPipeline(JD.DataConfig(**kw)),
                  PD.DataPipeline(PD.DataConfig(**kw)), (0, 3, 99))


def test_rows_sliced_by_rank_where_distributed(monkeypatch):
    kw = dict(vocab_size=512, seq_len=16, global_batch=8, seed=1)
    whole = JD.DataPipeline(JD.DataConfig(**kw)).batch(4)
    pd = PD.DataPipeline(PD.DataConfig(**kw))
    assert pd.batch(4)["tokens"].shape[0] == 8    # one process: every row
    for rank in range(4):
        monkeypatch.setattr(PD, "processes", lambda r=rank: (r, 4))
        got = pd.batch(4)
        for k in ("tokens", "labels"):
            assert np.array_equal(got[k], whole[k][2 * rank:2 * rank + 2])
