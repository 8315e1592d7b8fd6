"""The MoE family in the port, against the reference: olmoe-1b-7b (qk-norm,
no GQA) and granite-moe-3b-a800m (GQA), reduced.

Configs are mirrored field by field and the parameter tree has the
reference's paths and shapes (a ``moe`` block with the router and the
``(L, E, K, N)`` expert stacks in place of ``mlp``). Packed under
``default_serve_mix``, and under a q3_k_o rule with an activation stats
dict tiled over E*K, every payload is bit-exact with the reference's; an
expert stack packs one layer at a time into the bytes of packing the
whole stack.

``moe_block`` on one layer equals the reference's in f32 at ``TOL_F32``
(one bf16 ulp of an expert output: the expert products are bf16 in
every dtype) and in bf16 at ``TOL_BF16``, drop-free (the reduced
``capacity_factor`` of 4.0) and with drops (1.0), where the kept masks
and slots are equal exactly. The router weights are the reference's
seeded ones; the least gap between a token's k-th and (k+1)-th logit is
reported and asserted to sit far above f32 rounding, so no top-k choice
can flip between the frameworks. A zero padding row, which ties every expert and which
``torch.topk`` orders unlike ``jax.lax.top_k``, leaves the valid rows'
outputs unchanged bit for bit: right padding ranks its choices after
every valid one.

The whole model runs its expert products in bf16 whatever its dtype, so
an f32 difference of an ulp upstream can flip the bf16 rounding of a
dispatch value; ``forward_seq``, ``prefill_chunk`` and ``decode_step``
are held at ``TOL_MODEL``, the reference's own tolerance for moe
(``tests/test_models.py``). The engines are held against the reference's
in ``tests/test_torch_moe_engine.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core.policy import get_policy as j_get_policy
from repro.core.policy import make_policy as j_make_policy
from repro.core.qlinear import _flatten_paths as j_flatten_paths
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.core import policy as PP
from repro_torch.core import qlinear as PL
from repro_torch.core import quantize as PQ
from repro_torch.core.quantize import QTensor
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
POLICY = "default_serve_mix"
TOL_F32 = 2.0 ** -8     # moe_block in f32, relative to the largest output:
                        # the expert products are bf16 in every dtype, and
                        # their f32 sums can round one bf16 ulp apart
TOL_BF16 = 2.0 ** -7    # moe_block in bf16: and the output's own rounding
TOL_MODEL = 5e-3        # the reference's own moe tolerance
MIN_ROUTER_GAP = 1e-3   # far above f32 rounding of O(1) logits (~1e-7)
O_RULES = (("*moe/w_*", "q3_k_o"),)


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _same_bytes(a, b: torch.Tensor) -> bool:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
        b = b.view(torch.int16)
    b = b.numpy()
    return a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


def _assert_trees_equal(jq, pq):
    jflat = dict(j_flatten_paths(jq))
    pflat = PL._flatten_paths(pq)
    assert {p for p, _ in pflat} == set(jflat)
    for path, leaf in pflat:
        j = jflat[path]
        if isinstance(leaf, QTensor):
            assert leaf.variant == j.variant and leaf.shape == tuple(j.shape)
            for k in j.data:
                assert _same_bytes(j.data[k], leaf.data[k]), (path, k)
        else:
            assert _same_bytes(j, leaf), path


def _cfgs(arch, **kw):
    return (JC.get_arch(arch, reduced=True).replace(**kw),
            PC.get_arch(arch, reduced=True).replace(**kw))


# ---------------------------------------------------------------------------
# configs, tree, packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirror(arch, reduced):
    j = dataclasses.asdict(JC.get_arch(arch, reduced=reduced))
    p = dataclasses.asdict(PC.get_arch(arch, reduced=reduced))
    assert p == j
    assert arch in PC.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    jcfg, pcfg = _cfgs(arch)
    jtree = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    ptree = PT.init_params(pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jshapes = {p: tuple(a.shape) for p, a in j_flatten_paths(jtree)}
    pshapes = {p: tuple(t.shape) for p, t in PL._flatten_paths(ptree)}
    assert pshapes == jshapes
    L, E, d, fe = pcfg.n_layers, pcfg.n_experts, pcfg.d_model, pcfg.moe_d_ff
    assert pshapes["layers/moe/router"] == (L, d, E)
    assert pshapes["layers/moe/w_gate"] == (L, E, d, fe)
    assert pshapes["layers/moe/w_down"] == (L, E, fe, d)
    assert not any(p.startswith("layers/mlp") for p in pshapes)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference f32 params, the same packed under
    default_serve_mix, its report, the float params moved to the port)."""
    arch = request.param
    cfg = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    params = jax.jit(JT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    qp, report = j_quantize_params(params, j_get_policy(POLICY))
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    return arch, params, qp, report, pparams


def test_quantize_params_matches_reference(model):
    """The report equals the reference's (the router stays float), every
    payload bit-exact, the expert stacks E*K-packed with the layer axis
    kept, each counted once a layer."""
    arch, _, qp, jrep, pparams = model
    pq, prep = PL.quantize_params(pparams, PP.get_policy(POLICY))
    assert prep == jrep
    _assert_trees_equal(qp, pq)
    cfg = PC.get_arch(arch, reduced=True)
    L, E, d, fe = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert prep["layers/moe/router"] is None
    wg = pq["layers"]["moe"]["w_gate"]
    assert wg.shape == (E * d, fe) and wg.num_layers == L
    # the reduced w_down's K (128) is below the packing floor: it stays
    # float, as in the reference
    assert prep["layers/moe/w_down"] is None
    assert PL.variant_counts(prep, pq) == {"q2_k": 2 * L + 1,
                                           "q3_k": 4 * L}
    jpacked = sum(np.asarray(a).nbytes for _, t in j_flatten_paths(qp)
                  if hasattr(t, "variant") for a in t.data.values())
    assert PL.quantized_param_bytes(pq)["packed"] == jpacked


def test_q3_k_o_expert_stats_tiled_over_ek(model):
    """q3_k_o on the expert stacks with per-K-column stats: the stats are
    tiled over E*K, and the bytes equal the reference's (the moe block
    alone, under its own paths)."""
    arch, params, _, _, pparams = model
    params = {"layers": {"moe": params["layers"]["moe"]}}
    pparams = {"layers": {"moe": pparams["layers"]["moe"]}}
    cfg = PC.get_arch(arch, reduced=True)
    rng = np.random.default_rng(3)
    calib = {p: (rng.random(cfg.d_model) * 4 + 0.1).astype(np.float32)
             for p in ("layers/moe/w_gate", "layers/moe/w_up")}
    jq, jrep = j_quantize_params(params, j_make_policy("moe_o", O_RULES),
                                 calib=calib)
    pq, prep = PL.quantize_params(pparams, PP.make_policy("moe_o", O_RULES),
                                  calib=calib)
    assert prep == jrep and prep["layers/moe/w_gate"] == "q3_k_o"
    _assert_trees_equal(jq, pq)
    # the stats moved the sidecar rows: without them the bytes differ
    plain, _ = PL.quantize_params(pparams, PP.make_policy("moe_o", O_RULES))
    a = pq["layers"]["moe"]["w_gate"].data["oidx"]
    assert not torch.equal(a, plain["layers"]["moe"]["w_gate"].data["oidx"])


@pytest.mark.parametrize("variant", ["q2_k", "q3_k", "q3_k_o", "q4_k"])
def test_expert_stack_packs_layer_by_layer(variant):
    """One layer at a time gives the bytes of packing the whole
    (L, E*K, N) stack at once."""
    L, E, K, N = 3, 4, 256, 64
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (L, E, K, N)).astype(np.float32))
    qfn = PQ.quantize_fn(variant)
    got = PL._pack_stack(qfn, w, expert=True)
    whole = qfn(w.reshape(L, E * K, N))
    assert got.shape == (E * K, N) and got.num_layers == L
    assert got.data.keys() == whole.data.keys()
    for k in whole.data:
        assert torch.equal(got.data[k], whole.data[k]), k


@pytest.mark.parametrize("variant", ["q2_k", "q3_k", "q3_k_o", "q4_k"])
def test_layer_stack_packs_layer_by_layer(variant):
    """A stacked (L, K, N) layer weight, packed one layer at a time as
    ``quantize_params`` packs it, gives the bytes of the whole stack."""
    L, K, N = 3, 512, 72
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (L, K, N)).astype(np.float32))
    qfn = PQ.quantize_fn(variant)
    got = PL._pack_stack(qfn, w, expert=False)
    whole = qfn(w)
    assert got.shape == (K, N) and got.num_layers == L
    assert got.data.keys() == whole.data.keys()
    for k in whole.data:
        assert torch.equal(got.data[k], whole.data[k]), k


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

def _least_router_gap(x, router, k):
    """Least gap, over tokens, between adjacent logits among the top k+1
    (in f64): a top-k choice flips only across a gap this small."""
    lg = np.asarray(x, np.float64).reshape(-1, x.shape[-1]) @ np.asarray(
        router, np.float64)
    s = -np.sort(-lg, axis=-1)[:, :k + 1]
    return float(np.min(s[:, :-1] - s[:, 1:]))


def _ref_dispatch(x, router, cfg):
    """The reference's routing on x: (expert, slot, keep) per choice, as
    its vmapped ``row`` computes them (jax.lax.top_k, ranks by cumsum)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    C = JM._capacity(S, k, E, cfg.capacity_factor)
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x, jnp.float32),
                        jnp.asarray(router, jnp.float32))
    _, topi = jax.lax.top_k(logits, k)
    e_flat = topi.reshape(B, S * k)
    oh = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    ranks = jnp.cumsum(oh, axis=1) - oh
    myrank = jnp.take_along_axis(ranks, e_flat[..., None], 2)[..., 0]
    keep = myrank < C
    return (np.asarray(e_flat), np.asarray(jnp.where(keep, myrank, 0)),
            np.asarray(keep))


@pytest.fixture(scope="module")
def moe_layer():
    """Layer 0 of reduced olmoe's reference parameters (numpy) and a
    seeded (3, 24, d) input."""
    cfg = JC.get_arch("olmoe-1b-7b", reduced=True)
    params = jax.jit(JT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["moe"])
    x = np.random.default_rng(5).standard_normal(
        (3, 24, cfg.d_model)).astype(np.float32)
    return lp, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [4.0, 1.0])
def test_moe_block_matches_reference(moe_layer, cf, dtype):
    lp, x = moe_layer
    cfg, pcfg = _cfgs("olmoe-1b-7b", capacity_factor=cf, dtype=dtype)
    jx = jnp.asarray(x).astype(dtype)
    xr = np.array(jx.astype(jnp.float32))              # the rounded input
    gap = _least_router_gap(xr, lp["router"], cfg.n_experts_active)
    print(f"least router top-k gap: {gap:.3e}")
    assert gap > MIN_ROUTER_GAP
    jy, jaux = jax.jit(JM.moe_block, static_argnames=("cfg",))(jx, lp, cfg)
    px = torch.from_numpy(xr).to(getattr(torch, dtype))
    py, paux = PM.moe_block(px, bridge.from_jax_params(lp), pcfg)
    assert py.dtype == px.dtype and py.shape == px.shape
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    assert _rel(py.float().numpy(), jy.astype(jnp.float32)) <= tol
    assert abs(float(paux) - float(jaux)) <= 1e-5 * abs(float(jaux))

    C = PM._capacity(x.shape[1], cfg.n_experts_active, cfg.n_experts, cf)
    _, topi, _ = PM.route(px, bridge.from_jax_params(lp)["router"],
                          cfg.n_experts_active)
    e, slot, keep = PM.dispatch(topi, cfg.n_experts, C)
    je, jslot, jkeep = _ref_dispatch(xr, lp["router"], cfg)
    np.testing.assert_array_equal(e.numpy(), je)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    assert jkeep.all() == (cf == 4.0)           # drops only at cf = 1.0


def test_moe_block_rows_independent_of_batch(moe_layer):
    """Each batch row alone gives its rows of the batched call, bit for
    bit (router and expert products run a row at a time)."""
    lp, x = moe_layer
    pcfg = PC.get_arch("olmoe-1b-7b", reduced=True).replace(
        capacity_factor=1.0)
    p = bridge.from_jax_params(lp)
    xb = torch.from_numpy(x).bfloat16()
    y, _ = PM.moe_block(xb, p, pcfg)
    for b in range(x.shape[0]):
        yb, _ = PM.moe_block(xb[b:b + 1], p, pcfg)
        assert torch.equal(yb[0], y[b]), b


def test_zero_padding_leaves_valid_rows_unchanged(moe_layer):
    """Row 0's last 8 tokens are zero (right padding: every expert ties).
    With drops (cf = 1.0) the valid tokens' choices, slots and outputs
    equal the reference's, and equal the port's with other padding
    values bit for bit: padding ranks after every valid choice."""
    lp, x = moe_layer
    cfg, pcfg = _cfgs("olmoe-1b-7b", capacity_factor=1.0, dtype="float32")
    k, n_valid = cfg.n_experts_active, 16
    xz = x.copy()
    xz[0, n_valid:] = 0.0
    p = bridge.from_jax_params(lp)
    yz, _ = PM.moe_block(torch.from_numpy(xz), p, pcfg)
    jy, _ = jax.jit(JM.moe_block, static_argnames=("cfg",))(
        jnp.asarray(xz), lp, cfg)
    assert _rel(yz[0, :n_valid].numpy(), np.asarray(jy)[0, :n_valid]) \
        <= TOL_F32
    C = PM._capacity(x.shape[1], k, cfg.n_experts, 1.0)
    _, topi, _ = PM.route(torch.from_numpy(xz), p["router"], k)
    e, slot, keep = PM.dispatch(topi, cfg.n_experts, C)
    je, jslot, jkeep = _ref_dispatch(xz, lp["router"], cfg)
    v = slice(0, n_valid * k)
    np.testing.assert_array_equal(e.numpy()[0, v], je[0, v])
    np.testing.assert_array_equal(slot.numpy()[0, v], jslot[0, v])
    np.testing.assert_array_equal(keep.numpy()[0, v], jkeep[0, v])
    xo = xz.copy()
    xo[0, n_valid:] = np.random.default_rng(6).standard_normal(
        (x.shape[1] - n_valid, x.shape[2]))
    yo, _ = PM.moe_block(torch.from_numpy(xo), p, pcfg)
    assert torch.equal(yo[0, :n_valid], yz[0, :n_valid])
    assert torch.equal(yo[1:], yz[1:])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_seq_matches_reference(model):
    arch, params, _, _, pparams = model
    cfg, pcfg = _cfgs(arch, dtype="float32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    jl, _, _ = jax.jit(JT.forward_seq, static_argnames=("cfg",))(
        params, cfg, tokens=jnp.asarray(toks, jnp.int32))
    pl = PT.forward_seq(pparams, pcfg, tokens=torch.from_numpy(toks))
    assert pl.shape == (2, 12, cfg.vocab_size)
    assert _rel(pl.numpy(), jl) <= TOL_MODEL


def test_prefill_then_decode_matches_reference(model):
    """One prefill chunk over a ragged batch, then two decode steps (the
    second with a dead slot): logits, hidden states and the cache."""
    arch, params, _, _, pparams = model
    cfg, pcfg = _cfgs(arch, dtype="float32")
    prefill = jax.jit(JT.prefill_chunk, static_argnames=("cfg",))
    decode = jax.jit(JT.decode_step, static_argnames=("cfg",))
    B, C, Tlen = 2, 8, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, C))
    lengths = np.array([C, 5], np.int32)
    jcache = JT.init_cache(cfg, B, Tlen, dtype=jnp.float32)
    pcache = PT.init_cache(pcfg, B, Tlen, dtype=torch.float32, device="cpu")
    jh, jcache = prefill(params, cfg, jcache,
                         tokens=jnp.asarray(toks, jnp.int32),
                         start=jnp.asarray(0, jnp.int32),
                         lengths=jnp.asarray(lengths))
    ph, pcache = PT.prefill_chunk(pparams, pcfg, pcache,
                                  tokens=torch.from_numpy(toks), start=0,
                                  lengths=torch.from_numpy(lengths).long())
    rows = np.arange(B)
    last = lengths - 1
    assert _rel(ph.numpy()[rows, last], np.asarray(jh)[rows, last]) \
        <= TOL_MODEL
    jl = JT.lm_logits(params, cfg, jh[rows, last])
    pl = PT.lm_logits(pparams, pcfg, ph[torch.arange(B), last])
    assert _rel(pl.numpy(), jl) <= TOL_MODEL

    pos = lengths.copy()
    for step, live in enumerate(([True, True], [True, False])):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = decode(params, cfg, jcache, tokens=jnp.asarray(nxt),
                            position=jnp.asarray(pos),
                            live=jnp.asarray(live))
        pl, pcache = PT.decode_step(pparams, pcfg, pcache,
                                    tokens=torch.from_numpy(nxt).long(),
                                    position=torch.from_numpy(pos).long(),
                                    live=torch.tensor(live))
        rows = np.flatnonzero(live)
        assert _rel(pl.numpy()[rows], np.asarray(jl)[rows]) <= TOL_MODEL, \
            step
        pos = pos + np.asarray(live, np.int32)
    np.testing.assert_array_equal(pcache["pos"].numpy(), jcache["pos"])
    for k in ("k", "v"):
        assert _rel(pcache[k].numpy(), jcache[k]) <= TOL_MODEL, k
