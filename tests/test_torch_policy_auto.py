"""Slice 3 of the port: ``serve --policy auto`` (calibrate, search, pack,
serve) against the reference, on reduced tinyllama.

Parameters come from the reference's ``init_params`` and move into the port
through ``bridge.from_jax_params``; tokens come from a seeded numpy
generator and go to both packages. The reference's functions that reach
its Pallas kernel run under ``jax.jit`` in interpret mode
(``kernel_impl="pallas"``), as ``test_torch_extended.py`` runs them.

Tolerances, relative to the compared tensor's max magnitude:
  * calibration stats (f32 model): 1e-5. Both reduce the same f32
    activations; only the summation order differs. ``tokens`` is exact.
  * forward_seq logits (f32 model, packed with ``paper_llama_mix``):
    2**-7, one bf16 ulp at the max. Both round every matmul input to bf16,
    and an activation that differs in its last f32 bit on a bf16 rounding
    boundary rounds one bf16 step the other way (``test_torch_extended``).
  * quality metrics (KL, pseudo-perplexity, top-1): 1e-3 relative, over
    those logits.
  * search: both packages score candidates with ``kernel_impl="ref"`` in
    an f32 model (dequantize to f32, f32 matmul: the same arithmetic in
    both up to the f32 summation order), so each evaluation agrees to
    about 1e-6 and the same decisions follow. A differing final
    assignment counts as a tie only if the reference scores both within
    ``SCORE_TOL`` of each other, the margin rule of
    ``test_torch_engine.py``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.core import calibrate as JC
from repro.core import policy as JP
from repro.core import quality as JQY
from repro.core import qlinear as JL
from repro.core import quantize as JQ
from repro.launch import policy_search as JS
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs.base import get_arch as p_get_arch
from repro_torch.core import calibrate as PC
from repro_torch.core import policy as PP
from repro_torch.core import quality as PQY
from repro_torch.core import qlinear as PL
from repro_torch.core.quantize import QTensor
from repro_torch.launch import policy_search as PS
from repro_torch.launch import serve as PSERVE
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

TOL_STATS = 1e-5
TOL_LOGITS = 2.0 ** -7
TOL_QUALITY = 1e-3
SCORE_TOL = 1e-3
HAND_MIX = {"name": "hand_mix",
            "rules": [["*attn/wq", "q4_0"], ["*attn/wo", "q5_k"],
                      ["*mlp/w_gate", "q3_k_o"], ["*mlp/w_down", "q8_0"]],
            "default": "q3_k"}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _assert_trees_equal(jtree, ptree):
    jflat = dict(JL._flatten_paths(jtree))
    for path, leaf in PL._flatten_paths(ptree):
        ref = jflat[path]
        if isinstance(leaf, QTensor):
            assert leaf.variant == ref.variant, path
            assert sorted(leaf.data) == sorted(ref.data), path
            for k in ref.data:
                assert _same_bytes(np.asarray(ref.data[k]),
                                   leaf.data[k].numpy()), (path, k)
        else:
            assert _same_bytes(np.asarray(ref), leaf.numpy()), path


@pytest.fixture(scope="module")
def model():
    """Reduced tinyllama in f32: the reference's parameters, bridged."""
    jcfg = dataclasses.replace(j_get_arch("tinyllama-1.1b", reduced=True),
                               dtype="float32")
    pcfg = p_get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32")
    params = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(3)
    tokens = [rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
              for _ in range(2)]
    return jcfg, pcfg, npp, bridge.from_jax_params(npp), tokens


@pytest.fixture(scope="module")
def stats(model):
    jcfg, pcfg, npp, pparams, tokens = model
    return (JC.run_calibration(npp, jcfg, tokens=tokens),
            PC.run_calibration(pparams, pcfg, tokens=tokens))


@pytest.fixture(scope="module")
def mix(model):
    """paper_llama_mix packed by the reference, and bridged."""
    npp = model[2]
    jq = jax.jit(lambda p: JL.quantize_params(
        p, JP.get_policy("paper_llama_mix"))[0])(npp)
    return jq, bridge.from_jax_params(jax.tree.map(np.asarray, jq))


def _ref_logits(jcfg, tree, tokens, attn_impl=None):
    cfg = dataclasses.replace(jcfg, kernel_impl="pallas",
                              attn_impl=attn_impl or jcfg.attn_impl)
    fwd = jax.jit(lambda p, t: JT.forward_seq(p, cfg, tokens=t,
                                              interpret=True)[0])
    return np.asarray(fwd(tree, jnp.asarray(tokens)), np.float32)


def test_calib_stats_match_reference(stats, model):
    js, ps = stats
    jcfg = model[0]
    assert ps.names() == js.names() == sorted(
        ["attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_gate",
         "mlp/w_up", "mlp/w_down", "lm_head"])
    # per-layer taps sum their rows over the layers; tokens = max(rows)
    assert ps.tokens == js.tokens == 2 * 2 * 16 * jcfg.n_layers
    for n in js.names():
        assert ps.absmax[n].dtype == np.float32
        assert _rel(ps.absmax[n], js.absmax[n]) <= TOL_STATS, n
        assert _rel(ps.mean_sq[n], js.mean_sq[n]) <= TOL_STATS, n
        assert ps.outlier_fraction(n) == js.outlier_fraction(n)
    paths = ["layers/attn/wq", "layers/mlp/w_down", "lm_head", "wte"]
    assert sorted(ps.for_paths(paths)) == sorted(js.for_paths(paths))


def test_format_mse_matches_reference(model, stats):
    """The activation-weighted quantization error per (path, candidate):
    the same ranking inputs as the reference, to f32 summation order."""
    _, _, npp, pparams, _ = model
    js, ps = stats
    cands = ("q2_k", "q3_k", "q3_k_o", "q8_0")
    paths = ["layers/attn/wq", "layers/mlp/w_down", "lm_head"]
    ref = JC.format_mse(npp, js, cands, paths=paths)
    got = PC.format_mse(pparams, ps, cands, paths=paths)
    assert sorted(got) == sorted(ref) == sorted(paths)
    for p in paths:
        for v in cands:
            assert abs(got[p][v] - ref[p][v]) <= TOL_STATS * ref[p][v], (p, v)
        assert got[p]["q8_0"] < got[p]["q3_k"] < got[p]["q2_k"]
    assert sorted(PC.format_mse(pparams, None, ("q3_k",))) == sorted(
        JC.format_mse(npp, None, ("q3_k",)))


def test_taps_inert_outside_collection(model):
    _, pcfg, _, pparams, tokens = model
    lg = PT.forward_seq(pparams, pcfg, tokens=torch.from_numpy(tokens[0]))
    assert PC._COLLECTOR is None
    assert lg.shape == (2, 16, pcfg.vocab_size) and lg.dtype == torch.float32
    assert bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("attn_impl", ["naive", "fused"])
def test_forward_seq_matches_reference(model, mix, attn_impl):
    """paper_llama_mix-packed reduced tinyllama; "fused" goes through the
    port's plain prefill attention and the reference's Pallas kernel in
    interpret mode, with q_pos = kv_pos = arange(S)."""
    jcfg, pcfg, _, _, tokens = model
    jq, pq = mix
    ref = _ref_logits(jcfg, jq, tokens[0], attn_impl)
    got = PT.forward_seq(pq, pcfg.replace(attn_impl=attn_impl),
                         tokens=torch.from_numpy(tokens[0]))
    assert _rel(got.numpy(), ref) <= TOL_LOGITS


def test_seq_attention_raises_beyond_naive(model, monkeypatch):
    """Under "auto" a sequence above 2048 takes the reference's blockwise
    path (ported with slice 5), never naive, and agrees with naive to f32
    order (1e-5); an unknown attention impl raises."""
    pcfg = model[1].replace(attn_impl="auto")
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 4, 64, generator=g)
    k = torch.randn(1, 4, 2, 64, generator=g)
    naive = PT._seq_attention(q, k, k, pcfg, 2048)
    assert naive.shape == q.shape
    taken = []
    blockwise = PT.L.blockwise_attention
    monkeypatch.setattr(PT.L, "blockwise_attention", lambda *a, **kw: (
        taken.append(1) or blockwise(*a, **kw)))
    assert _rel(PT._seq_attention(q, k, k, pcfg, 2049), naive) <= 1e-5
    assert taken == [1]
    PT._seq_attention(q, k, k, pcfg.replace(attn_impl="blockwise"), 4)
    assert taken == [1, 1]
    with pytest.raises(ValueError, match="unknown attention impl"):
        PT._seq_attention(q, k, k, pcfg.replace(attn_impl="flash"), 4)


def test_quantize_params_calib_q3_k_o_matches_reference(model, stats):
    """pure q3_k_o with the activation stats: every stacked payload byte
    equal, and the hot activation rows land in the sidecar."""
    _, _, npp, pparams, _ = model
    js, _ = stats
    paths = [p for p, _ in JL._flatten_paths(npp)]
    calib = js.for_paths(paths)
    jq = jax.jit(lambda p: JL.quantize_params(
        p, JP.pure("q3_k_o"), calib=calib)[0])(npp)
    pq, prep = PL.quantize_params(pparams, PP.pure("q3_k_o"), calib=calib)
    _assert_trees_equal(jq, pq)
    assert prep["layers/attn/wq"] == "q3_k_o" and prep["wte"] is None
    # the bridge carries the sidecar (uint8 oidx, fp16 ovals) byte for byte
    bq = bridge.from_jax_params(jax.tree.map(np.asarray, jq))
    for k, v in pq["lm_head"].data.items():
        assert bq["lm_head"].data[k].dtype == v.dtype
        assert torch.equal(bq["lm_head"].data[k].view(torch.uint8),
                           v.view(torch.uint8)), k
    without, _ = PL.quantize_params(pparams, PP.pure("q3_k_o"))
    assert not torch.equal(without["lm_head"].data["oidx"],
                           pq["lm_head"].data["oidx"])


def test_hand_mix_and_q8_0_fallback_match_reference():
    """The hand-written load-branch policy on reduced tinyllama with
    d_ff = 288 (a K that is a multiple of 32 and not of 256): w_down falls
    back to q8_0 in both packages, every other rule packs as written, and
    the bridge carries q4_0, q5_k, q3_k_o and q8_0 (int8 qs, fp16 d)."""
    jcfg = dataclasses.replace(j_get_arch("tinyllama-1.1b", reduced=True),
                               d_ff=288)
    npp = jax.tree.map(np.asarray, jax.jit(
        JT.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(5)))
    pparams = bridge.from_jax_params(npp)
    jpol, ppol = JP.policy_from_dict(HAND_MIX), PP.policy_from_dict(HAND_MIX)
    jrep = {}

    def pack(p):        # the report is filled while jit traces
        q, rep = JL.quantize_params(p, jpol)
        jrep.update(rep)
        return q
    jq = jax.jit(pack)(npp)
    pq, prep = PL.quantize_params(pparams, ppol)
    assert prep == jrep
    assert prep["layers/mlp/w_down"] == "q8_0"         # K = 288
    _assert_trees_equal(jq, pq)
    bq = bridge.from_jax_params(jax.tree.map(np.asarray, jq))
    assert bq["layers"]["mlp"]["w_down"].data["qs"].dtype == torch.int8
    assert bq["layers"]["mlp"]["w_down"].data["d"].dtype == torch.float16
    assert sorted(bq["layers"]["mlp"]["w_gate"].data) == sorted(
        ["qs", "hmask", "scales", "d", "oidx", "ovals"])
    assert PL.variant_counts(prep, pq) == {
        "q4_0": 2, "q5_k": 2, "q3_k_o": 2, "q8_0": 2, "q3_k": 7}


def test_quality_eval_matches_reference(model, mix):
    jcfg, pcfg, npp, pparams, tokens = model
    jq, pq = mix
    t = tokens[1]
    ref = JQY.logit_metrics(jnp.asarray(_ref_logits(jcfg, npp, t)),
                            jnp.asarray(_ref_logits(jcfg, jq, t)))
    got = PQY.quality_eval(pparams, pq, pcfg, inputs=torch.from_numpy(t))
    for k in ("kl", "pseudo_ppl", "top1"):
        assert abs(got[k] - ref[k]) <= TOL_QUALITY * abs(ref[k]), (k, got,
                                                                   ref)
    assert got["kl"] > 0
    # teacher against itself is exact
    inputs, teacher = PQY.teacher_logits_for(pparams, pcfg,
                                             inputs=torch.from_numpy(t))
    assert PQY.logit_metrics(teacher, teacher)["kl"] == 0.0


def test_search_policy_matches_reference(model, stats, monkeypatch):
    jcfg, pcfg, npp, pparams, _ = model
    js, _ = stats
    # the same stats and eval tokens in both packages
    ps = PC.CalibStats(dict(js.absmax), dict(js.mean_sq), js.tokens)
    ev = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    monkeypatch.setattr(JQY, "eval_tokens",
                        lambda cfg, **kw: jnp.asarray(ev))
    monkeypatch.setattr(PQY, "eval_tokens",
                        lambda cfg, **kw: torch.from_numpy(ev))
    jc = dataclasses.replace(jcfg, kernel_impl="ref")
    pc = pcfg.replace(kernel_impl="ref")
    # the reference packs and scores eagerly (a minute here); its packing
    # runs compiled, and the same f32 arithmetic as its "ref" matmul
    # (dequantize to f32, f32 dot) as one compiled forward over the
    # dequantized tree
    fwd = jax.jit(lambda p, t: JT.forward_seq(p, jc, tokens=t)[0].astype(
        jnp.float32))

    dequantized = {}            # the searcher reuses its packed leaves

    def ref_forward(params, cfg, inputs, interpret=False):
        def deq(leaf):
            if not isinstance(leaf, JQ.QTensor):
                return leaf
            if id(leaf) not in dequantized:
                f = JQ.dequantize
                if leaf.data["d"].ndim == 3:             # stacked layers
                    f = jax.vmap(f)
                dequantized[id(leaf)] = (leaf, jax.jit(f)(leaf))
            return dequantized[id(leaf)][1]
        return fwd(jax.tree.map(deq, params,
                                is_leaf=lambda x: isinstance(x, JQ.QTensor)),
                   inputs)
    monkeypatch.setattr(JQY, "_forward_logits", ref_forward)

    def ref_quantize_params(params, policy, calib=None):
        report = {}                 # filled while jit traces, as above

        def pack(p):
            q, rep = JL.quantize_params(p, policy, calib=calib)
            report.update(rep)
            return q
        return jax.jit(pack)(params), report
    monkeypatch.setattr(JS, "quantize_params", ref_quantize_params)
    kw = dict(arch="tinyllama-1.1b", rounds=1, eval_seq=16, verbose=False,
              candidates=("q2_k", "q3_k", "q3_k_o", "none"))
    jpol, jinfo = JS.search_policy(jc, npp, stats=js, **kw)
    ppol, pinfo = PS.search_policy(pc, pparams, stats=ps, device="cpu", **kw)
    jm, pm = jinfo["meta"], pinfo["meta"]
    assert pm["seed"]["bytes"] == jm["seed"]["bytes"]
    assert abs(pm["seed"]["kl"] - jm["seed"]["kl"]) <= \
        SCORE_TOL * jm["seed"]["kl"]
    assert pm["final"]["kl"] <= pm["seed"]["kl"] * (1 + 1e-6)
    assert pm["final"]["bytes"] <= pm["seed"]["bytes"]
    assert pinfo["stats"] is ps and pinfo["evaluations"] > 20
    if pinfo["assignment"] != jinfo["assignment"]:
        # a tie only if the reference scores both assignments alike
        s = JS._Searcher(jc, npp, kw["candidates"], js, eval_seq=16)
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


def test_policy_json_loads_in_either_package(tmp_path):
    """A file written by one package loads in the other to the same rules
    and the same variant_for report, for a hand-written glob policy and a
    searched exact-path one with its meta."""
    paths = ["layers/attn/wq", "layers/attn/wk", "layers/attn/wo",
             "layers/mlp/w_gate", "layers/mlp/w_down", "lm_head", "wte",
             "layers/ln1/w"]
    shapes = [(256, 256), (288, 64), (2048, 5632), (64, 64), (5632, 2048)]
    searched = {"name": "auto_x", "default": "none",
                "rules": [["layers/attn/wq", "q3_k_o"], ["lm_head", "q2_k"],
                          ["layers/mlp/w_down", "none"]],
                "meta": {"seed": {"kl": 0.5}}}
    for i, d in enumerate((HAND_MIX, searched)):
        for save, load in ((JP.save_policy, PP.load_policy),
                           (PP.save_policy, JP.load_policy)):
            f = tmp_path / f"{i}_{save.__module__}.json"
            pol = (JP if save is JP.save_policy else PP).policy_from_dict(d)
            save(pol, f)
            back = load(f)
            assert back.rules == pol.rules and back.default == pol.default
            for p in paths:
                for K, N in shapes:
                    assert back.variant_for(p, K, N) == pol.variant_for(
                        p, K, N), (p, K, N)
    with open(tmp_path / "bad.json", "w") as f:
        json.dump({"rules": [["*", "q9_z"]]}, f)
    for mod in (JP, PP):
        with pytest.raises(ValueError, match="unknown variant"):
            mod.load_policy(tmp_path / "bad.json")


def test_launcher_policy_auto_end_to_end(tmp_path, monkeypatch, capsys):
    """``serve --policy auto`` on the CPU: with no file the search runs,
    writes the file and serves; the same command then loads it; a
    hand-written file with a q3_k_o rule recalibrates and serves; and
    ``policy_search``'s own entry point writes a file the launcher loads."""
    monkeypatch.chdir(tmp_path)
    base = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
            "--requests", "3", "--slots", "2", "--cache-len", "32",
            "--tokens", "4", "--policy", "auto"]
    PSERVE.main(base + ["--search-rounds", "1"])
    out = capsys.readouterr().out
    written = tmp_path / "results" / "auto_tinyllama-1.1b.json"
    assert "searched policy written to" in out and written.exists()
    assert "[final]" in out and out.count("req ") == 3
    d = json.loads(written.read_text())
    assert d["default"] == "none" and "meta" in d
    final, seed = d["meta"]["final"], d["meta"]["seed"]
    assert final["kl"] <= seed["kl"] * (1 + 1e-6)
    assert final["bytes"] <= seed["bytes"]

    PSERVE.main(base)
    out = capsys.readouterr().out
    assert "loaded searched policy from" in out and out.count("req ") == 3

    (tmp_path / "hand.json").write_text(json.dumps(HAND_MIX))
    calls = []
    real = PC.run_calibration
    monkeypatch.setattr(PC, "run_calibration",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    PSERVE.main(base + ["--policy-json", "hand.json"])
    out = capsys.readouterr().out
    assert calls == [1]                     # a q3_k_o rule recalibrates
    assert "'q3_k_o': 2" in out and "'q8_0': 2" in out

    PS.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
             "--rounds", "0", "--eval-seq", "16", "--calib-seq", "16",
             "--calib-batches", "1", "--candidates", "q2_k,q3_k,none",
             "--out", "ps/auto.json"])
    out = capsys.readouterr().out
    assert "wrote ps/auto.json" in out
    PSERVE.main(base + ["--policy-json", "ps/auto.json"])
    assert "loaded searched policy" in capsys.readouterr().out
