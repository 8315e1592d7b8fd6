"""The port's training path against the reference's: the loss, its
gradients and the train step, on the dense configs (reduced).

Inputs are seeded numpy; parameters are the reference's, moved over with
``repro_torch.bridge``. The reference's functions run under ``jax.jit``,
one compile per (config, dtype). Errors are relative: a loss against the
reference's loss, and a gradient leaf by the norm of its difference over
the norm of the reference's leaf.

Tolerances:
  * f32 compute: loss 1e-6, each gradient leaf 1e-4 (f32 products summed
    in another order; measured under 1e-5);
  * bf16 compute: loss 2e-3; each gradient leaf within twice the
    reference's own bf16 error, taken as its bf16 gradient against its
    f32 one on the same input (a bf16 gradient passes through dozens of
    roundings, and XLA fuses elementwise steps in f32 where torch rounds
    each one; that error is 1.4-2% on these configs, the port's 1-1.5%);
  * three train steps in f32: loss and grad norm 1e-5 a step; parameters
    moved by an update within 1e-3 of its norm, leaf by leaf (the norm of
    the difference over the norm of the reference's update), and never
    by more than 2 x the summed learning rates apart, the reference's own
    bound in ``test_microbatch_equivalence``: Adam divides each element
    by its own gradient's size, so an element whose gradient is near 0
    can step the other way;
  * three train steps in bf16: loss and grad norm 2e-3, updates within
    twice the reference's own bf16 update against its f32 one;
  * ``chunked_xent``: 1e-5 against ``softmax_xent`` and the reference
    (f32 sums in other orders), gradients 1e-5 absolute (the reference's
    own bound in ``test_chunked_xent_equals_dense`` is 1e-5 for the
    gradients).
The ssm, hybrid and MoE configs are in ``test_torch_training_families``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.optim import adamw as JA
from repro.training import steps as JS
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.launch import train as LT
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from repro_torch.training import steps as PS
from repro_torch.training.loop import run_training

torch.set_num_threads(2)

TOL_LOSS_F32 = 1e-6
TOL_GRAD_F32 = 1e-4
TOL_LOSS_BF16 = 2e-3
TOL_STEP_F32 = 1e-5
TOL_UPDATE_F32 = 1e-3
TOL_XENT = 1e-5
DENSE = ("tinyllama-1.1b", "llama3.2-1b", "gpt2-paper")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().to(torch.float32).numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _norm_rel(a, b) -> float:
    return float(np.linalg.norm((np.asarray(a, np.float64)
                                 - np.asarray(b, np.float64)).ravel())
                 / max(np.linalg.norm(np.asarray(b, np.float64).ravel()),
                       1e-30))


def _leaf_errs(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    return {k: _norm_rel(got[k], want[k]) for k in want}


def _batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def ref_value_and_grad(arch, dtype, batch, **over):
    """(reference loss, aux, grads as numpy, the port's matching config,
    the parameters bridged into the port)."""
    jc = JC.get_arch(arch, reduced=True).replace(dtype=dtype, **over)
    jp = JS.T.init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    f = jax.jit(jax.value_and_grad(JS.make_loss_fn(jc), has_aux=True))
    (loss, metrics), grads = f(jp, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    pc = PC.get_arch(arch, reduced=True).replace(dtype=dtype, **over)
    pp = bridge.from_jax_params(jax.tree.map(np.asarray, jp))
    return (float(loss), float(metrics["aux"]),
            jax.tree.map(np.asarray, grads), pc, pp)


def check_loss_and_grads(arch, **over):
    """f32 and bf16 loss and gradients against the reference's."""
    batch = _batch(JC.get_arch(arch, reduced=True))
    ref = {}
    for dtype in ("float32", "bfloat16"):
        jl, jaux, jg, pc, pp = ref_value_and_grad(arch, dtype, batch, **over)
        loss, metrics, grads = PS.value_and_grad(PS.make_loss_fn(pc), pp,
                                                 _torch_batch(batch))
        ref[dtype] = (jl, jaux, jg, float(loss), float(metrics["aux"]),
                      grads)
    jl, jaux, jg, pl, paux, pg = ref["float32"]
    assert abs(pl - jl) <= TOL_LOSS_F32 * abs(jl)
    errs = _leaf_errs(pg, jg)
    assert max(errs.values()) <= TOL_GRAD_F32, errs
    bl, baux, bg, ql, qaux, qg = ref["bfloat16"]
    assert abs(ql - bl) <= TOL_LOSS_BF16 * abs(bl)
    noise = max(_leaf_errs(bg, jg).values())
    errs = _leaf_errs(qg, bg)
    assert max(errs.values()) <= 2 * noise, (noise, errs)
    return ref


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llama3.2-1b"])
def test_chunked_loss_and_grads_match_reference(arch):
    """A vocabulary of 8192 takes make_loss_fn's chunked branch; 64 tokens
    in chunks of 48 leave a ragged last chunk; llama3.2-1b's head is
    tied."""
    check_loss_and_grads(arch, vocab_size=8192, loss_chunk=48)


def test_remat_changes_no_bits():
    cfg = PC.get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32")
    st = PS.init_train_state(cfg, PA.AdamWConfig(),
                             torch.Generator().manual_seed(0), device="cpu")
    batch = _torch_batch(_batch(cfg))
    outs = [PS.value_and_grad(PS.make_loss_fn(cfg.replace(remat=r)),
                              st["params"], batch) for r in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(PA.tree_leaves(outs[0][2]), PA.tree_leaves(outs[1][2])):
        assert torch.equal(a, b)


def test_forward_seq_hidden_and_aux_keep_its_return():
    cfg = PC.get_arch("tinyllama-1.1b", reduced=True)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    with torch.no_grad():
        logits = PT.forward_seq(params, cfg, tokens=toks)
        h, aux = PT.forward_seq(params, cfg, tokens=toks, return_hidden=True,
                                with_aux=True)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert h.shape == (2, 32, cfg.d_model) and float(aux) == 0.0
    assert torch.equal(PT._logits(params, cfg, h), logits)


# ---------------------------------------------------------------------------
# chunked cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("chunk", [16, 20, 4096])
def test_chunked_xent_matches_dense_and_reference(tied, chunk):
    """B*S = 48 tokens: chunks of 16 divide it, 20 leave a ragged last
    chunk, 4096 is one chunk of all of them."""
    rng = np.random.default_rng(0)
    B, S, d, V = 2, 24, 32, 1000
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((V, d) if tied else (d, V)) * 0.05).astype(
        np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    kw = dict(tie_wte=w, chunk=chunk) if tied else dict(chunk=chunk)

    def jloss(hh):
        return JS.chunked_xent(hh, None if tied else w, labels, **kw)
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(h))

    ht = torch.from_numpy(h).requires_grad_()
    wt, lt = torch.from_numpy(w), torch.from_numpy(labels)
    pkw = dict(tie_wte=wt, chunk=chunk) if tied else dict(chunk=chunk)
    pl = PS.chunked_xent(ht, None if tied else wt, lt, **pkw)
    (pg,) = torch.autograd.grad(pl, ht)
    pl = pl.detach()

    hd = torch.from_numpy(h).requires_grad_()
    logits = hd @ (wt.t() if tied else wt)
    dl = PS.softmax_xent(logits, lt)
    (dg,) = torch.autograd.grad(dl, hd)
    dl = dl.detach()

    assert abs(float(pl) - float(jl)) <= TOL_XENT * abs(float(jl))
    assert abs(float(pl) - float(dl)) <= TOL_XENT * abs(float(dl))
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=TOL_XENT)
    np.testing.assert_allclose(pg.numpy(), dg.numpy(), atol=TOL_XENT)


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for z in (0.0, 1e-4):
        want = float(JS.softmax_xent(jnp.asarray(logits),
                                     jnp.asarray(labels), z_loss=z))
        got = float(PS.softmax_xent(torch.from_numpy(logits),
                                    torch.from_numpy(labels), z_loss=z))
        assert abs(got - want) <= TOL_XENT * abs(want)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _three_steps(arch, dtype, microbatches):
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jc = JC.get_arch(arch, reduced=True).replace(dtype=dtype)
    pc = PC.get_arch(arch, reduced=True).replace(dtype=dtype)
    jo, po = JA.AdamWConfig(**kw), PA.AdamWConfig(**kw)
    js = JS.init_train_state(jc, jo, jax.random.PRNGKey(0))
    ps = bridge.from_jax_params(jax.tree.map(np.asarray, js))
    p0 = _flat(js["params"])
    jstep = jax.jit(JS.make_train_step(jc, jo, microbatches=microbatches))
    pstep = PS.make_train_step(pc, po, microbatches=microbatches)
    rng = np.random.default_rng(5)
    metrics, lrs = [], []
    for _ in range(3):
        batch = {k: rng.integers(0, jc.vocab_size, (4, 32)).astype(np.int32)
                 for k in ("tokens", "labels")}
        js, jm = jstep(js, batch)
        ps, pm = pstep(ps, _torch_batch(batch))
        metrics.append({k: (float(pm[k]), float(jm[k]))
                        for k in ("loss", "grad_norm", "lr")})
        lrs.append(float(jm["lr"]))
    assert int(ps["step"]) == int(js["step"]) == 3
    assert int(ps["opt"]["step"]) == 3

    def moved(params):
        f = _flat(params)
        return {k: f[k] - p0[k] for k in f}
    return metrics, moved(ps["params"]), moved(js["params"]), \
        _flat(ps["params"]), _flat(js["params"]), sum(lrs)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_reference(microbatches):
    arch = "tinyllama-1.1b"
    m32, pu, ju, pp, jp, lr_sum = _three_steps(arch, "float32",
                                               microbatches)
    for step in m32:
        for k, (got, want) in step.items():
            assert abs(got - want) <= TOL_STEP_F32 * abs(want), (k, step)
    for k in ju:
        assert _norm_rel(pu[k], ju[k]) <= TOL_UPDATE_F32, k
        assert np.abs(pp[k] - jp[k]).max() <= 2 * lr_sum, k
    m16, qu, bu, _, _, _ = _three_steps(arch, "bfloat16", microbatches)
    for step in m16:
        for k, (got, want) in step.items():
            assert abs(got - want) <= TOL_LOSS_BF16 * abs(want), (k, step)
    noise = max(_norm_rel(bu[k], ju[k]) for k in ju)
    for k in ju:
        assert _norm_rel(qu[k], bu[k]) <= 2 * noise, (k, noise)


# the reference's tests/test_training.py training tests, ported

def test_microbatch_equivalence():
    """grad accumulation over microbatches == one big batch (same loss
    trajectory within fp tolerance)."""
    cfg = PC.get_arch("llama3.2-1b", reduced=True)
    opt = PA.AdamWConfig(warmup_steps=0, total_steps=10, lr=1e-3)
    state = PS.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                device="cpu")
    step1 = PS.make_train_step(cfg, opt, microbatches=1)
    step2 = PS.make_train_step(cfg, opt, microbatches=2)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    s1, m1 = step1(state, batch)
    s2, m2 = step2(state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-3
    # updated params near-identical (Adam's rescaling amplifies fp noise
    # for near-zero grads, so the bound is loose relative to lr=1e-3)
    diffs = [float((a - b).abs().max()) for a, b in zip(
        PA.tree_leaves(s1["params"]), PA.tree_leaves(s2["params"]))]
    assert max(diffs) < 2e-3


def test_training_loss_decreases():
    cfg = PC.get_arch("llama3.2-1b", reduced=True)
    opt = PA.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    res = run_training(cfg, steps=60, global_batch=8, seq_len=64, opt=opt,
                       log_fn=lambda *_: None, device="cpu")
    first = np.mean(res["losses"][:5])
    last = np.mean(res["losses"][-5:])
    assert last < first - 0.2, (first, last)
    assert set(res["timing"]) == {"p50", "p99", "mean", "stragglers"}


# ---------------------------------------------------------------------------
# the fused attention, the launcher, the device default
# ---------------------------------------------------------------------------

def test_fused_attention_refuses_a_gradient():
    cfg = PC.get_arch("tinyllama-1.1b", reduced=True).replace(
        attn_impl="fused")
    st = PS.init_train_state(cfg, PA.AdamWConfig(),
                             torch.Generator().manual_seed(0), device="cpu")
    batch = _torch_batch(_batch(cfg))
    with pytest.raises(NotImplementedError, match="naive.*blockwise"):
        PS.make_train_step(cfg, PA.AdamWConfig())(st, batch)
    with torch.no_grad():          # serving's forward keeps the kernel
        out = PT.forward_seq(st["params"], cfg, tokens=batch["tokens"])
    assert torch.isfinite(out).all()


def test_train_launcher_on_the_cpu(capsys, tmp_path):
    LT.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
             "--steps", "4", "--batch", "4", "--seq", "16",
             "--microbatches", "2", "--ckpt-dir", str(tmp_path),
             "--ckpt-every", "2", "--layers", "1"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out
    last = out.strip().splitlines()[-1]
    assert last.startswith("done: final loss ") and "stragglers 0" in last
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]


def test_training_entry_points_raise_where_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    cfg = PC.get_arch("tinyllama-1.1b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(cfg, steps=1, global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.init_train_state(cfg, PA.AdamWConfig(), torch.Generator())
