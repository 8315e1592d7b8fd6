"""The embedding-input families in the port, qwen2-vl-72b (vlm: M-RoPE)
and musicgen-large (audio: sinusoidal positions, LayerNorm/GELU), against
the reference, on their reduced configs.

Parameters are the reference's ``init_params`` moved over with
``bridge.from_jax_params``; embeddings and positions are seeded numpy and
go to both packages. Every M-RoPE input has three distinct streams: a
2 x 2 x 4 (t, h, w) grid of vision patches, then text, whose three
streams continue together from the grid's largest position + 1, as
Qwen2-VL numbers them (equal streams would reduce M-RoPE to RoPE). The
reference's functions run under ``jax.jit``; where they reach the Pallas
kernels (packed weights, ``attn_impl="fused"``) in interpret mode, as its
own tests run them, while the port runs the kernels' plain versions.

Tolerances, relative to the compared tensor's largest magnitude:
  * rotary tables and the sinusoidal embedding: 1e-6 absolute (f32 cos
    and sin of the same angles);
  * float-weight forwards and decode steps: 1e-5 with f32 embeddings (the
    residual stream stays f32, as in the reference, which does not cast
    the embeddings to the bf16 ``cfg.dtype``: only the matmul inputs
    round to bf16), 2**-6 with bf16 embeddings (a bf16 stream, whose
    norms and residual adds XLA fuses in f32 where torch rounds each
    step: two bf16 steps at the max, ``test_torch_extended``'s bf16
    bound);
  * packed weights (``default_serve_mix``, the kernels' plain versions
    against the Pallas kernels): 2**-7, one bf16 step at the max;
  * KV caches written in bf16: 2**-7; M-RoPE positions are exact;
  * training (f32 compute): loss 1e-6, gradients 1e-4 a leaf, and a
    two-microbatch step's loss and grad norm 1e-5 and its update within
    1e-3 of its norm (``test_torch_training``'s f32 tolerances);
  * calibration stats 1e-5; quality metrics 1e-3; the search as in
    ``test_torch_policy_auto`` (equal final assignments, or a tie under
    the reference's scores within 1e-3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core import calibrate as JCAL
from repro.core import policy as JP
from repro.core import qlinear as JL
from repro.core import quality as JQY
from repro.core import quantize as JQ
from repro.launch import policy_search as JSRCH
from repro.models import layers as JLY
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.training import steps as JS
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.core import calibrate as PCAL
from repro_torch.core import policy as PP
from repro_torch.core import qlinear as PL
from repro_torch.core import quality as PQY
from repro_torch.launch import policy_search as PSRCH
from repro_torch.launch import serve as PSERVE
from repro_torch.models import layers as PLY
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.training import steps as PS

torch.set_num_threads(2)

ARCHS = ("qwen2-vl-72b", "musicgen-large")
TOL_TABLE = 1e-6
TOL_F32 = 1e-5
TOL_BF16 = 2.0 ** -7
TOL_BF16_STREAM = 2.0 ** -6
TOL_LOSS = 1e-6
TOL_GRAD = 1e-4
TOL_STEP = 1e-5
TOL_UPDATE = 1e-3
TOL_STATS = 1e-5
TOL_QUALITY = 1e-3
SCORE_TOL = 1e-3
B, S = 2, 24


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def mrope_positions(batch, seq, grid=(2, 2, 4)):
    """(3, batch, seq) int32: a (t, h, w) patch grid, then text on three
    equal streams from the grid's largest position + 1."""
    t, h, w = np.meshgrid(*[np.arange(n) for n in grid], indexing="ij")
    vis = np.stack([t.ravel(), h.ravel(), w.ravel()])
    text = vis.max() + 1 + np.arange(seq - vis.shape[1])
    pos = np.concatenate([vis, np.stack([text] * 3)], axis=1)
    return np.broadcast_to(pos[:, None], (3, batch, seq)).astype(np.int32)


def _positions(cfg, batch=B, seq=S):
    return mrope_positions(batch, seq) if cfg.pos_emb == "mrope" else None


def _opt(x, f):
    return None if x is None else f(x)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference config, port config, reference f32 params as
    numpy, the same in the port, both packed under default_serve_mix)."""
    out = {}
    for arch in ARCHS:
        jc = JC.get_arch(arch, reduced=True)
        pc = PC.get_arch(arch, reduced=True)
        npp = jax.tree.map(np.asarray, jax.jit(
            JT.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0)))
        jq = jax.tree.map(np.asarray, jax.jit(lambda p: JL.quantize_params(
            p, JP.get_policy("default_serve_mix"))[0])(npp))
        out[arch] = (jc, pc, npp, bridge.from_jax_params(npp), jq,
                     bridge.from_jax_params(jq))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirror(arch, reduced):
    assert dataclasses.asdict(PC.get_arch(arch, reduced=reduced)) == \
        dataclasses.asdict(JC.get_arch(arch, reduced=reduced))
    assert arch in PC.ARCH_IDS
    assert PC.ARCH_IDS == JC.ARCH_IDS


def test_rope_tables_and_sincos_match_reference():
    """M-RoPE with three distinct streams, its sections each rotated by
    its own stream (so it differs from RoPE on stream 0), equal streams
    giving RoPE, and the sinusoidal embedding."""
    pos = mrope_positions(2, 40)
    for d_head, sections in ((64, (8, 12, 12)), (128, (16, 24, 24))):
        jc, js = JLY.rope_cos_sin(jnp.asarray(pos), d_head, 1e6, sections)
        pc, ps = PLY.rope_cos_sin(torch.from_numpy(pos), d_head, 1e6,
                                  sections)
        assert np.abs(pc.numpy() - np.asarray(jc)).max() <= TOL_TABLE
        assert np.abs(ps.numpy() - np.asarray(js)).max() <= TOL_TABLE
        rc, _ = PLY.rope_cos_sin(torch.from_numpy(pos[0]), d_head, 1e6)
        t, h = sections[0], sections[0] + sections[1]
        assert torch.equal(pc[..., :t], rc[..., :t])
        assert not torch.equal(pc[..., t:h], rc[..., t:h])
        same = torch.from_numpy(np.stack([pos[0]] * 3))
        assert torch.equal(PLY.rope_cos_sin(same, d_head, 1e6, sections)[0],
                           rc)
    with pytest.raises(ValueError, match="mrope_sections"):
        PLY.rope_cos_sin(torch.from_numpy(pos), 64, 1e6)
    p2 = np.arange(2048, dtype=np.int32).reshape(2, 1024)
    got = PLY.sincos_pos_emb(torch.from_numpy(p2), 256).numpy()
    ref = np.asarray(JLY.sincos_pos_emb(jnp.asarray(p2), 256))
    # angles up to 2047 rad, whose f32 ulp is 2**-13: the product of a
    # position and a frequency may round one ulp apart
    assert np.abs(got - ref).max() <= 2 * 2.0 ** -13
    assert np.abs(got[0, :16] - ref[0, :16]).max() <= TOL_TABLE


def test_init_params_has_no_token_embedding(models):
    for arch in ARCHS:
        jc, pc, npp, _, _, _ = models[arch]
        pp = PT.init_params(pc, torch.Generator().manual_seed(0),
                            device="cpu")
        got = dict(PL._flatten_paths(pp))
        want = dict(JL._flatten_paths(npp))
        assert "wte" not in got
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}


def _ref_forward(jc, params, embeds, positions, attn_impl, packed):
    cfg = dataclasses.replace(jc, attn_impl=attn_impl,
                              kernel_impl="pallas" if packed else "auto")
    fwd = jax.jit(lambda p, e, q: JT.forward_seq(
        p, cfg, embeds=e, positions=q, interpret=True)[0])
    return np.asarray(fwd(params, jnp.asarray(embeds),
                          _opt(positions, jnp.asarray)), np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("attn_impl", ["naive", "fused"])
def test_forward_seq_matches_reference(models, arch, attn_impl):
    """f32 and bf16 embeddings on the float weights; "fused" also on the
    packed ones (every kernel of the slice's path: the matmul and the
    prefill attention, q_pos = kv_pos = 0..S-1 whatever the M-RoPE
    positions, as in the reference)."""
    jc, pc, npp, pp, jq, pq = models[arch]
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    pos = _positions(jc)
    cfg = pc.replace(attn_impl=attn_impl)
    for dtype, tol in ((torch.float32, TOL_F32),
                       (torch.bfloat16, TOL_BF16_STREAM)):
        e = torch.from_numpy(emb).to(dtype)
        ref = _ref_forward(jc, npp, _np(e).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else np.float32), pos,
            attn_impl, False)
        got = PT.forward_seq(pp, cfg, embeds=e,
                             positions=_opt(pos, torch.from_numpy))
        assert got.dtype == torch.float32 and got.shape == (B, S, jc.vocab_size)
        assert _rel(_np(got), ref) <= tol, (dtype, _rel(_np(got), ref))
    if attn_impl == "fused":
        ref = _ref_forward(jc, jq, emb, pos, "fused", True)
        got = PT.forward_seq(pq, cfg, embeds=torch.from_numpy(emb),
                             positions=_opt(pos, torch.from_numpy))
        assert _rel(_np(got), ref) <= TOL_BF16


def test_forward_seq_residual_keeps_the_embeddings_dtype(models):
    """The reference's ``_embed`` does not cast the embeddings: f32 ones
    into the bf16 config give an f32 hidden stream, bf16 ones a bf16
    stream, and the two differ."""
    jc, pc, _, pp, _, _ = models["musicgen-large"]
    e = torch.randn(B, S, pc.d_model, generator=torch.Generator().manual_seed(1))
    h32 = PT.forward_seq(pp, pc, embeds=e, return_hidden=True)
    h16 = PT.forward_seq(pp, pc, embeds=e.bfloat16(), return_hidden=True)
    assert pc.dtype == "bfloat16"
    assert h32.dtype == torch.float32 and h16.dtype == torch.bfloat16
    assert not torch.equal(h32.bfloat16(), h16)


def _ref_prefill_cache(jc, params, emb, pos, T):
    def f(p, e, q):
        _, _, caches = JT.forward_seq(p, jc, embeds=e, positions=q,
                                      want_cache=True)
        return JT.cache_from_prefill(jc, caches, e.shape[1], cache_len=T)
    return jax.tree.map(np.asarray, jax.jit(f)(
        params, jnp.asarray(emb), _opt(pos, jnp.asarray)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_with_embeds_matches_reference(models, arch):
    """Two decode steps with embeddings on float weights against one
    cache (the reference's prefill, bridged); under M-RoPE the position
    rides all three streams. Logits, K/V and positions equal."""
    jc, pc, npp, pp, _, _ = models[arch]
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((B, S + 2, jc.d_model)).astype(np.float32)
    jcache = _ref_prefill_cache(jc, npp, emb[:, :S], _positions(jc), 32)
    pcache = bridge.from_jax_params(jcache)
    jstep = jax.jit(lambda p, c, e, q: JT.decode_step(
        p, jc, c, embeds=e, position=q))
    for j in range(2):
        position = np.full((B,), S + j, np.int32)
        jl, jcache = jstep(npp, jcache, jnp.asarray(emb[:, S + j]),
                           jnp.asarray(position))
        pl, pcache = PT.decode_step(pp, pc, pcache,
                                    embeds=torch.from_numpy(emb[:, S + j]),
                                    position=torch.from_numpy(position))
        assert _rel(_np(pl), np.asarray(jl)) <= TOL_F32
    for k in ("k", "v"):
        assert _rel(_np(pcache[k]), np.asarray(jcache[k], np.float32)) \
            <= TOL_BF16
    assert np.array_equal(pcache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(models, arch, monkeypatch):
    """make_serve_steps on the packed weights with the fused attention:
    the prefill's last-position logits, cache_from_prefill, then 4 decode
    steps, logits against the reference's at each; and the decode step's
    logits against forward_seq's last position over the same S + 1
    embeddings (positions S..: the ring index and, on all three streams,
    the rotary position)."""
    jc, pc, _, _, jq, pq = models[arch]
    jcf = dataclasses.replace(jc, attn_impl="fused", kernel_impl="pallas")
    pcf = pc.replace(attn_impl="fused")
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((B, S + 4, jc.d_model)).astype(np.float32)
    pos = _positions(jc)
    # the reference's steps call forward_seq and decode_step without
    # ``interpret``, so its Pallas kernels could not lower on the CPU
    for name in ("forward_seq", "decode_step"):
        monkeypatch.setattr(JT, name, functools.partial(getattr(JT, name),
                                                        interpret=True))
    jpre, jdec = JS.make_serve_steps(jcf)
    ppre, pdec = PS.make_serve_steps(pcf)

    def ref_prefill(p, e, q):
        logits, caches = jpre(p, {"embeds": e, "positions": q})
        return logits, JT.cache_from_prefill(jcf, caches, S, cache_len=32)
    jl, jcache = jax.jit(ref_prefill)(jq, jnp.asarray(emb[:, :S]),
                                      _opt(pos, jnp.asarray))
    batch = {"embeds": torch.from_numpy(emb[:, :S])}
    if pos is not None:
        batch["positions"] = torch.from_numpy(pos)
    pl, caches = ppre(pq, batch)
    assert pl.shape == (B, jc.vocab_size)
    assert _rel(_np(pl), np.asarray(jl)) <= TOL_BF16
    pcache = PT.cache_from_prefill(pcf, caches, S, cache_len=32)
    jdecode = jax.jit(lambda p, c, e, q: jdec(p, c, {"embeds": e,
                                                     "position": q}))
    for j in range(4):
        position = np.full((B,), S + j, np.int32)
        jl, jcache = jdecode(jq, jcache, jnp.asarray(emb[:, S + j]),
                             jnp.asarray(position))
        pl, pcache = pdec(pq, pcache, {
            "embeds": torch.from_numpy(emb[:, S + j]),
            "position": torch.from_numpy(position)})
        assert _rel(_np(pl), np.asarray(jl)) <= TOL_BF16, j
        if j == 0:
            first = pl
    # the first decode step is forward_seq's position S over S + 1 inputs
    full = None if pos is None else np.concatenate(
        [pos, np.full((3, B, 1), S, np.int32)], axis=2)
    seq = PT.forward_seq(pq, pcf, embeds=torch.from_numpy(emb[:, :S + 1]),
                         positions=_opt(full, torch.from_numpy))
    assert _rel(_np(first), _np(seq[:, -1])) <= TOL_BF16
    assert torch.equal(first.argmax(-1), seq[:, -1].argmax(-1))


def _train_batch(jc, batch=4, seq=16, seed=3):
    rng = np.random.default_rng(seed)
    b = {"embeds": rng.standard_normal((batch, seq, jc.d_model)).astype(
            np.float32),
         "labels": rng.integers(0, jc.vocab_size, (batch, seq)).astype(
            np.int32)}
    if jc.pos_emb == "mrope":
        b["positions"] = mrope_positions(batch, seq)
    return b


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_embeds_matches_reference(models, arch):
    """f32 compute: the loss and every gradient leaf on one batch, then
    one train step in 2 microbatches (M-RoPE positions split on their
    batch axis), its loss, grad norm and update."""
    jc, pc, npp, pp, _, _ = models[arch]
    jc, pc = jc.replace(dtype="float32"), pc.replace(dtype="float32")
    batch = _train_batch(jc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(JS.make_loss_fn(jc),
                                             has_aux=True))(npp, jb)
    pl, _, pg = PS.value_and_grad(PS.make_loss_fn(pc), pp, tb)
    assert abs(float(pl) - float(jl)) <= TOL_LOSS * abs(float(jl))
    jflat = dict(JL._flatten_paths(jax.tree.map(np.asarray, jg)))
    for path, g in PL._flatten_paths(pg):
        want = jflat[path]
        err = np.linalg.norm(_np(g) - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= TOL_GRAD, (path, err)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jo, po = JA.AdamWConfig(**kw), PA.AdamWConfig(**kw)
    js = dict(params=npp, opt=JA.init_state(jo, npp),
              step=jnp.zeros((), jnp.int32))
    ps = dict(params=pp, opt=PA.init_state(po, pp),
              step=torch.zeros((), dtype=torch.int32))
    js2, jm = jax.jit(JS.make_train_step(jc, jo, microbatches=2))(js, jb)
    ps2, pm = PS.make_train_step(pc, po, microbatches=2)(ps, tb)
    for k in ("loss", "grad_norm"):
        assert abs(float(pm[k]) - float(jm[k])) <= TOL_STEP * abs(
            float(jm[k])), k
    jnew = dict(JL._flatten_paths(jax.tree.map(np.asarray, js2["params"])))
    for path, p0 in PL._flatten_paths(pp):
        ju = jnew[path] - np.asarray(dict(JL._flatten_paths(npp))[path])
        pu = _np(dict(PL._flatten_paths(ps2["params"]))[path]) - _np(p0)
        err = np.linalg.norm(pu - ju) / max(np.linalg.norm(ju), 1e-30)
        assert err <= TOL_UPDATE, (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_quality_and_search_match_reference(models, arch,
                                                        monkeypatch):
    """run_calibration, quality_eval and search_policy on embeddings: the
    same (B, S, d) inputs in both packages (the random draws differ)."""
    jc, pc, npp, pp, jq, pq = models[arch]
    jc, pc = jc.replace(dtype="float32"), pc.replace(dtype="float32")
    rng = np.random.default_rng(4)
    cal = [rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
           for _ in range(2)]
    js = JCAL.run_calibration(npp, jc, tokens=cal)
    ps = PCAL.run_calibration(pp, pc, tokens=cal)
    assert ps.names() == js.names() and ps.tokens == js.tokens
    for n in js.names():
        assert _rel(ps.absmax[n], js.absmax[n]) <= TOL_STATS, n
        assert _rel(ps.mean_sq[n], js.mean_sq[n]) <= TOL_STATS, n
    drawn = PCAL.run_calibration(pp, pc, batch=1, seq=8, n_batches=1)
    assert drawn.tokens == 8 * pc.n_layers
    ev = rng.standard_normal((2, 8, jc.d_model)).astype(np.float32)
    assert PQY.eval_tokens(pc, batch=2, seq=16, device="cpu").shape == (
        2, 16, pc.d_model)
    ref = JQY.logit_metrics(
        jnp.asarray(_ref_forward(jc, npp, ev, None, "naive", False)),
        jnp.asarray(_ref_forward(jc, jq, ev, None, "naive", True)))
    got = PQY.quality_eval(pp, pq, pc, inputs=torch.from_numpy(ev))
    for k in ("kl", "pseudo_ppl", "top1"):
        assert abs(got[k] - ref[k]) <= TOL_QUALITY * abs(ref[k]), (k, got,
                                                                   ref)
    check_search(jc, pc, npp, pp, js, ev, monkeypatch,
                 candidates=("q2_k", "q3_k", "none"))


# (expert stack, stacked layers) -> the reference's dequantize, compiled
# once a shape: bf16 for an expert stack, f32 for the rest
_DEQUANTIZE = {
    (expert, stacked): jax.jit(jax.vmap(f) if stacked else f)
    for expert in (False, True) for stacked in (False, True)
    for f in [functools.partial(JQ.dequantize, dtype=jnp.bfloat16
                                if expert else jnp.float32)]}


def check_search(jc, pc, npp, pp, js, ev, monkeypatch, candidates):
    """search_policy in both packages on the same stats and eval inputs,
    scored with ``kernel_impl="ref"`` (dequantize to f32, f32 matmul), as
    ``test_torch_policy_auto`` holds the dense search."""
    ps = PCAL.CalibStats(dict(js.absmax), dict(js.mean_sq), js.tokens)
    monkeypatch.setattr(JQY, "eval_tokens", lambda cfg, **kw: jnp.asarray(ev))
    monkeypatch.setattr(PQY, "eval_tokens",
                        lambda cfg, **kw: torch.from_numpy(ev))
    jcr = dataclasses.replace(jc, kernel_impl="ref")
    pcr = pc.replace(kernel_impl="ref")
    key = "tokens" if jc.embed_input else "embeds"
    fwd = jax.jit(lambda p, x: JT.forward_seq(p, jcr, **{key: x})[0].astype(
        jnp.float32))
    dequantized = {}

    def ref_forward(params, cfg, inputs, interpret=False):
        def deq(leaf, like):
            if not isinstance(leaf, JQ.QTensor):
                return leaf
            if id(leaf) not in dequantized:
                # an MoE expert stack, packed along E*K, dequantizes to
                # bf16 (E, K, N) a layer, as the reference's moe_block
                # does; every other leaf to f32, its "ref" matmul's input
                f = _DEQUANTIZE[(like.ndim == 4, leaf.data["d"].ndim == 3)]
                dequantized[id(leaf)] = (leaf, f(leaf).reshape(like.shape))
            return dequantized[id(leaf)][1]
        return fwd(jax.tree.map(deq, params, npp,
                                is_leaf=lambda x: isinstance(x, JQ.QTensor)),
                   inputs)
    monkeypatch.setattr(JQY, "_forward_logits", ref_forward)

    def ref_quantize_params(params, policy, calib=None):
        report = {}

        def pack(p):
            q, rep = JL.quantize_params(p, policy, calib=calib)
            report.update(rep)
            return q
        return jax.jit(pack)(params), report
    monkeypatch.setattr(JSRCH, "quantize_params", ref_quantize_params)
    kw = dict(arch=jc.name, rounds=1, eval_seq=ev.shape[1], verbose=False,
              candidates=candidates)
    jpol, jinfo = JSRCH.search_policy(jcr, npp, stats=js, **kw)
    ppol, pinfo = PSRCH.search_policy(pcr, pp, stats=ps, device="cpu", **kw)
    jm, pm = jinfo["meta"], pinfo["meta"]
    assert pm["seed"]["bytes"] == jm["seed"]["bytes"]
    assert abs(pm["seed"]["kl"] - jm["seed"]["kl"]) <= \
        SCORE_TOL * jm["seed"]["kl"]
    assert pm["final"]["kl"] <= pm["seed"]["kl"] * (1 + 1e-6)
    assert pm["final"]["bytes"] <= pm["seed"]["bytes"]
    if pinfo["assignment"] != jinfo["assignment"]:
        s = JSRCH._Searcher(jcr, npp, candidates, js, eval_seq=ev.shape[1])
        a = s.evaluate({p: (v if v != "none" else None)
                        for p, v in jinfo["assignment"].items()})
        b = s.evaluate({p: (v if v != "none" else None)
                        for p, v in pinfo["assignment"].items()})
        assert a["bytes"] == b["bytes"]
        assert abs(a["kl"] - b["kl"]) <= SCORE_TOL * a["kl"], (
            jinfo["assignment"], pinfo["assignment"], a, b)
    else:
        assert ppol.rules == jpol.rules
        assert abs(pm["final"]["kl"] - jm["final"]["kl"]) <= \
            SCORE_TOL * jm["final"]["kl"]
        assert pm["final"]["bytes"] == jm["final"]["bytes"]
    return pinfo


@pytest.mark.parametrize("arch", ARCHS)
def test_token_serving_refuses_embedding_families(arch):
    """The launcher exits naming the stub frontend, as the reference's
    does; the engine, which serves token ids, raises."""
    with pytest.raises(SystemExit, match="stub modality frontend"):
        PSERVE.main(["--arch", arch, "--reduced", "--device", "cpu"])
    cfg = PC.get_arch(arch, reduced=True)
    with pytest.raises(ValueError, match="stub modality frontend"):
        Engine(cfg, {}, ServeConfig(), device="cpu")
