"""The recurrent families in the port, against the reference:
mamba2-2.7b (ssm) and zamba2-1.2b (hybrid: a Mamba2 backbone with one
shared attention block at width 2d after every ``hybrid_attn_every``
layers).

Configs are mirrored field by field, full and reduced. The parameter
tree has the reference's paths, shapes and dtypes (``A_log``, ``D`` and
``dt_bias`` in f32); the reference's tree packed under
``default_serve_mix`` crosses ``bridge`` as it is (stacked ``(L, K, N)``
QTensors keep their layer axis on every payload), and the port's
``quantize_params`` gives the reference's report. The launches a
forward under ``default_serve_mix`` at full width are counted from the
reference's own report (traced with ``jax.eval_shape``, nothing packed):
1 q2_k + 128 q3_k for mamba2-2.7b and 13 q2_k + 112 q3_k for
zamba2-1.2b, whose six shared-block applications run the block's eight
matmuls each. The reduced models, moved across with ``bridge``, are held
on ``forward_seq``, a masked two-chunk ``prefill_chunk`` (a short row, a
length-0 padding row) and three ``decode_step`` calls with a dead slot,
in f32 with f32 caches, unpacked, at 1e-4 relative to the largest value
(the f32 sums run in other orders); the decode caches too. The
checkpoint copies (``cache_scatter_checkpoints``,
``cache_insert_checkpoints``, with padding that drops) equal the
reference's bit for bit, and so do the
decode cache's and the page pool's shapes, dtypes and bytes. The batched
verify pass refuses both families, as the reference's does, and the
launcher serves mamba2-2.7b with its checkpoint pages pinned to the
chunk.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import _flatten_paths as j_flatten_paths
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.core import policy as PP
from repro_torch.core import qlinear as PL
from repro_torch.core.quantize import QTensor
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
POLICY = "default_serve_mix"
TOL = 1e-4
# full-width matmul launches a forward under default_serve_mix
PER_FORWARD = {"mamba2-2.7b": {"q2_k": 1, "q3_k": 128},
               "zamba2-1.2b": {"q2_k": 13, "q3_k": 112}}


def _rel(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _report(params, policy):
    """The reference's quantize report, traced under ``jax.jit`` (or
    ``jax.eval_shape``): the report is a host dict built while tracing."""
    rep = {}

    def pack(p):
        qp, r = j_quantize_params(p, policy)
        rep.update(r)
        return qp
    return pack, rep


def _per_forward(report, cfg):
    """Matmul launches a forward by variant: a stacked layer weight runs
    once a layer, a shared-block weight once an application, the head
    once."""
    napp = len(PT._shared_apps(cfg))
    out = {}
    for path, v in report.items():
        if v is not None:
            n = (cfg.n_layers if path.startswith("layers/")
                 else napp if path.startswith("shared/") else 1)
            out[v] = out.get(v, 0) + n
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_mirror(arch, reduced):
    j = dataclasses.asdict(JC.get_arch(arch, reduced=reduced))
    p = dataclasses.asdict(PC.get_arch(arch, reduced=reduced))
    assert p == j
    assert arch in PC.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_launches_per_forward(arch):
    """The reference's report at full width (traced, nothing packed)
    gives the launch counts chip_smoke asserts, and the port's policy
    assigns every path the same variant."""
    cfg = JC.get_arch(arch)
    tree = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
    pack, rep = _report(tree, j_get_policy(POLICY))
    jax.eval_shape(pack, tree)
    assert _per_forward(rep, cfg) == PER_FORWARD[arch]
    pol = PP.get_policy(POLICY)
    for path, leaf in j_flatten_paths(tree):
        want = rep[path]
        if len(leaf.shape) < 2 or not PL._is_quantizable_path(path):
            assert want is None, path
        else:
            assert pol.variant_for(path, *leaf.shape[-2:]) == want, path


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference cfg, port cfg, reference f32 params, the same packed
    under default_serve_mix under jax.jit, its report, the float params
    moved to the port), reduced, in f32."""
    arch = request.param
    jcfg = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    pcfg = PC.get_arch(arch, reduced=True).replace(dtype="float32")
    params = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    pack, rep = _report(params, j_get_policy(POLICY))
    qp = jax.jit(pack)(params)
    pparams = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    return jcfg, pcfg, params, qp, rep, pparams


def test_init_params_tree_matches_reference(model):
    jcfg, pcfg, params, _, _, _ = model
    ptree = PT.init_params(pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jshapes = {p: (tuple(a.shape), np.dtype(a.dtype).name)
               for p, a in j_flatten_paths(params)}
    pshapes = {p: (tuple(t.shape), str(t.dtype).split(".")[1])
               for p, t in PL._flatten_paths(ptree)}
    assert pshapes == jshapes
    for k in ("A_log", "D", "dt_bias"):
        assert ptree["layers"]["ssm"][k].dtype == torch.float32
    assert ("shared" in ptree) == (pcfg.family == "hybrid")


def test_packed_tree_crosses_the_bridge(model):
    """The reference's packed tree arrives with its variants, logical
    shapes, payload bytes and float dtypes."""
    _, pcfg, _, qp, rep, _ = model
    pqp = bridge.from_jax_params(jax.tree.map(np.asarray, qp))
    jflat = dict(j_flatten_paths(qp))
    pflat = dict(PL._flatten_paths(pqp))
    assert set(pflat) == set(jflat)
    for path, leaf in jflat.items():
        got = pflat[path]
        if rep.get(path) is None:
            assert not isinstance(got, QTensor)
            assert got.dtype == {"float32": torch.float32,
                                 "bfloat16": torch.bfloat16}[
                np.dtype(leaf.dtype).name]
            np.testing.assert_array_equal(_np(got), np.asarray(leaf))
            continue
        assert isinstance(got, QTensor) and got.variant == rep[path]
        assert tuple(got.shape) == tuple(leaf.shape)
        for k, v in leaf.data.items():
            np.testing.assert_array_equal(
                _np(got.data[k].view(torch.int16)
                    if got.data[k].dtype == torch.bfloat16 else got.data[k]),
                np.asarray(v).view(np.int16)
                if np.asarray(v).dtype.name == "bfloat16" else np.asarray(v))
        if path.startswith("layers/"):
            assert got.num_layers == pcfg.n_layers


def test_quantize_report_matches_reference(model):
    """The port's packing of the same float weights: the reference's
    report and variant counts."""
    jcfg, _, _, qp, rep, pparams = model
    pq, prep = PL.quantize_params(pparams, PP.get_policy(POLICY))
    assert prep == rep
    for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w"):
        assert prep[f"layers/ssm/{k}"] is None
    assert (PL.variant_counts(prep, pq)
            == PL.variant_counts(rep, bridge.from_jax_params(
                jax.tree.map(np.asarray, qp))))
    napp = len(PT._shared_apps(jcfg))
    assert _per_forward(prep, jcfg) == {
        "q2_k": 1 + 2 * napp, "q3_k": 2 * jcfg.n_layers + 6 * napp}


def test_forward_seq_matches_reference(model):
    jcfg, pcfg, params, _, _, pparams = model
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    jl = jax.jit(lambda p, t: JT.forward_seq(p, jcfg, tokens=t)[0])(
        params, toks)
    pl = PT.forward_seq(pparams, pcfg, tokens=torch.from_numpy(
        toks).long())
    assert pl.shape == (2, 37, jcfg.vocab_size)
    assert _rel(pl, jl) <= TOL


def test_prefill_then_decode_match_reference(model):
    """Two masked 16-column chunks (row lengths 29, 9, 0: the last a
    group-padding dummy), then three decode steps, the third with slot 1
    dead: hidden states, logits and every cache entry."""
    jcfg, pcfg, params, _, _, pparams = model
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (3, 32)).astype(np.int32)
    lengths = np.array([29, 9, 0], np.int32)
    jchunk = jax.jit(lambda p, c, t, s: JT.prefill_chunk(
        p, jcfg, c, tokens=t, start=s, lengths=jnp.asarray(lengths)))
    jdec = jax.jit(lambda p, c, t, pos, live: JT.decode_step(
        p, jcfg, c, tokens=t, position=pos, live=live))
    jcache = JT.init_cache(jcfg, 3, 64)
    pcache = PT.init_cache(pcfg, 3, 64, device="cpu")
    assert ({k: (tuple(v.shape), str(v.dtype).split(".")[1])
             for k, v in pcache.items()}
            == {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in jcache.items()})
    # f32 caches, so a bf16 rounding of the conv tail or the ring cannot
    # flip by a step between the two
    jcache = JT.init_cache(jcfg, 3, 64, dtype=jnp.float32)
    pcache = PT.init_cache(pcfg, 3, 64, dtype=torch.float32, device="cpu")
    for start in (0, 16):
        t = toks[:, start:start + 16]
        jh, jcache = jchunk(params, jcache, t, start)
        ph, pcache = PT.prefill_chunk(
            pparams, pcfg, pcache, tokens=torch.from_numpy(t).long(),
            start=start, lengths=torch.from_numpy(lengths).long())
        for b in range(2):      # columns past a row's length are garbage
            n = min(max(lengths[b] - start, 0), 16)
            if n:
                assert _rel(ph[b, :n], jh[b, :n]) <= TOL
        for k in pcache:
            assert _rel(pcache[k], jcache[k]) <= TOL, (start, k)
    pos = np.array([29, 9, 0], np.int32)
    tok = np.array([5, 7, 0], np.int32)
    for step in range(3):
        live = np.array([True, step < 2, False])
        jlg, jcache = jdec(params, jcache, tok, pos + step, live)
        plg, pcache = PT.decode_step(
            pparams, pcfg, pcache, tokens=torch.from_numpy(tok).long(),
            position=torch.from_numpy(pos + step).long(),
            live=torch.from_numpy(live))
        assert _rel(plg[:2], jlg[:2]) <= TOL, step
        for k in pcache:
            assert _rel(pcache[k], jcache[k]) <= TOL, (step, k)
    # the dead padding row's state never moved off zero
    assert float(pcache["state"][:, 2].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_copies_match_reference(arch):
    """Restore pool pages into batch rows and record batch rows into pool
    pages, each with a padding entry that drops, against the reference's
    functions bit for bit; pool shapes, dtypes and page bytes too."""
    jcfg = JC.get_arch(arch, reduced=True)
    pcfg = PC.get_arch(arch, reduced=True)
    jpool = JT.cache_page_pool(jcfg, 3, 16)
    ppool = PT.cache_page_pool(pcfg, 3, 16, device="cpu")
    assert set(ppool) == set(jpool) == set(PT.cache_page_keys(pcfg))
    assert PT.cache_page_bytes(pcfg, 16) == JT.cache_page_bytes(jcfg, 16)
    jcache = JT.init_cache(jcfg, 4, 64)
    rng = np.random.default_rng(3)

    def fill(tree):
        return {k: rng.standard_normal(v.shape).astype(
            np.dtype(v.dtype)) if k in ("conv", "state") else np.asarray(v)
            for k, v in tree.items()}
    cache_np, pool_np = fill(jcache), fill(jpool)
    to_t = lambda tree: bridge.from_jax_params(tree)
    # restore: pool pages 2, 0 into rows 3, 1; a pad row (4 = B) drops
    idx, rows = np.array([2, 0, 7]), np.array([3, 1, 4])
    want = JT.cache_scatter_checkpoints(
        jax.tree.map(jnp.asarray, cache_np), jax.tree.map(jnp.asarray,
                                                          pool_np),
        jnp.asarray(idx), jnp.asarray(rows))
    got = PT.cache_scatter_checkpoints(to_t(cache_np), to_t(pool_np), idx,
                                       rows)
    for k in want:
        np.testing.assert_array_equal(
            _np(got[k].float()), np.asarray(want[k], np.float32))
    # record: rows 0, 2 into pages 1, 2; a pad index (3 = n_pages) drops
    rows, idx = np.array([0, 2, 0]), np.array([1, 2, 3])
    want = JT.cache_insert_checkpoints(
        jax.tree.map(jnp.asarray, pool_np), jax.tree.map(jnp.asarray,
                                                         cache_np),
        jnp.asarray(rows), jnp.asarray(idx))
    got = PT.cache_insert_checkpoints(to_t(pool_np), to_t(cache_np), rows,
                                      idx)
    for k in want:
        np.testing.assert_array_equal(
            _np(got[k].float()), np.asarray(want[k], np.float32))


def test_hybrid_applies_the_shared_block_after_full_groups():
    """zamba2-1.2b: 38 layers in groups of 6, six applications (the short
    last group has none); the reduced config: 4 layers, two."""
    full = PC.get_arch("zamba2-1.2b")
    assert PT._hybrid_groups(full) == JT._hybrid_groups(JC.get_arch(
        "zamba2-1.2b")) == [6] * 6 + [2]
    assert PT._shared_apps(full) == {5: 0, 11: 1, 17: 2, 23: 3, 29: 4,
                                     35: 5}
    assert PT._shared_apps(PC.get_arch("zamba2-1.2b", reduced=True)) == {
        1: 0, 3: 1}
    assert PT._shared_apps(PC.get_arch("mamba2-2.7b")) == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_chunk_rejects_recurrent_families(arch):
    """As the reference's ``_masked_chunk``: a dense recurrent state has
    no ring rewind, so the batched verify pass refuses these families."""
    cfg = PC.get_arch(arch, reduced=True)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cache = PT.init_cache(cfg, 1, 16, device="cpu")
    toks = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="KV-cache-only"):
        PT.verify_chunk(params, cfg, cache, tokens=toks,
                        positions=torch.arange(2)[None],
                        valid=torch.ones((1, 2), dtype=torch.bool))


def test_launcher_serves_mamba2_with_checkpoints():
    """``serve --arch mamba2-2.7b`` on the CPU: ``--prefix-page`` is
    ignored (the page is the 16-token chunk), and one-slot admission
    re-hits the shared prefix's checkpoint."""
    from repro_torch.launch import serve as LS
    eng, res = LS.main(["--arch", "mamba2-2.7b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "1",
                        "--cache-len", "64", "--prefill-chunk", "16",
                        "--prompt-len", "6", "--tokens", "3",
                        "--prefix-cache", "--prefix-page", "8",
                        "--shared-prefix", "20"])
    assert eng._page == eng._chunk == 16
    assert sorted(len(t) for t in res.values()) == [3, 3, 3]
    assert eng.stats["prefix_hits"] == 2
