"""The port's example flows against the reference's examples, on the CPU.

* ``launch/serve_quantized.py`` against ``examples/serve_quantized.py``:
  reduced tinyllama (bf16) from the reference's weights (bridged), packed
  by each package with ``paper_llama_mix``, six 6-token prompts on 2
  slots. The tensors a variant and the packed bytes are the example's;
  the callbacks fire for the same requests in the same order, and the
  greedy tokens equal the reference engine's under the margin rule of
  ``test_torch_engine.py`` (a divergence only where the reference's own
  top-2 logit margin is below ``MARGIN_TOL``; that request is not compared
  further).
* ``launch/mixed_quant_policy.py`` against
  ``examples/mixed_quant_policy.py``: reduced llama3.2-1b, the same six
  policies on the same (2, 32) tokens. In an f32 model, the conditions
  under which ``test_torch_policy_auto.py::
  test_quality_eval_matches_reference`` states its tolerance, the byte
  sizes equal, byte for byte, and KL(f32 weights || packed) lies within
  that ``TOL_QUALITY`` (1e-3) relative. In the example's own bf16 model
  the sizes equal too and the KLs order the pure variants alike; their
  values are not held: XLA keeps fused elementwise steps in f32 where
  torch rounds each one to bf16, so the two packages' bf16 logits differ
  by about 1.2% of the largest, and pure q6_k's KL (0.0030) by 1.4%,
  where the reference's own bf16 KL lies 3.7% from its f32 one. The
  reference example averages ``p * (log(p + 1e-9) - log q)``; both sides
  here use the packages' ``logit_metrics`` (``p * (log p - log q)``),
  the port's flow's metric.
* ``launch/train_e2e.py`` against ``examples/train_e2e.py``: its ~100M
  config, run and optimizer equal the example's, field for field (read
  from the example's source, which runs on import); and three steps of
  the flow on that config cut to 2 layers of width 192, resuming from
  the reference's initial state (bridged, saved as the flow's step-0
  checkpoint), give the reference ``run_training``'s losses within
  ``TOL_LOSS_BF16`` and its parameters within the bf16 rule of
  ``test_torch_training.py``: each leaf's update (the parameters after
  step 3 less the initial ones) lies within twice the reference's own
  bf16 update against its f32 one (the norm of the difference over the
  norm of the update). The warm-up keeps the first steps' learning rate
  at 2e-5 to 6e-5, so the losses barely move, and bf16's own spread of
  the update (8%) hides much of the optimizer; so the same three steps
  run in f32 compute too, held to that file's f32 rules: losses within
  ``TOL_STEP_F32`` and each leaf's update within ``TOL_UPDATE_F32``.

The reference's runs are made once, in the module's fixture.
"""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.core import policy as JP
from repro.core import quality as JQY
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.core.qlinear import quantized_param_bytes as j_param_bytes
from repro.models import transformer as JT
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.training import steps as JS
from repro.training.loop import run_training as j_run_training
from repro_torch import bridge
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import base as PC
from repro_torch.launch import mixed_quant_policy as PMIX
from repro_torch.launch import serve_quantized as PSERVE
from repro_torch.launch import train_e2e as PTRAIN

torch.set_num_threads(2)

MARGIN_TOL = 0.1
TOL_QUALITY = 1e-3
TOL_LOSS_BF16 = 2e-3
TOL_STEP_F32 = 1e-5
TOL_UPDATE_F32 = 1e-3
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
# the ~100M config cut for the CPU: the same family and head ratio (3 query
# heads a kv head), 2 layers of width 192
TRAIN_CUT = dict(n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, d_head=32,
                 d_ff=512, vocab_size=512)
TRAIN_STEPS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _serve_reference():
    """``examples/serve_quantized.py``'s run: its weights, packing, engine
    and prompts, with every callback recorded in call order."""
    cfg = JC.get_arch("tinyllama-1.1b", reduced=True)
    params = _np(JT.init_params(cfg, jax.random.PRNGKey(0)))
    qp, report = j_quantize_params(params, JP.get_policy("paper_llama_mix"))
    tensors = {}
    for v in report.values():
        if v:
            tensors[v] = tensors.get(v, 0) + 1
    engine = JEngine(cfg, qp, JServeConfig(**PSERVE.SERVE))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 6)]
               for _ in range(6)]
    events = []
    for p in prompts:
        engine.submit(p, on_token=lambda rid, t: events.append((rid, t)))
    results = engine.run()
    return dict(cfg=cfg, params=params, qp=qp, tensors=tensors,
                sizes=j_param_bytes(qp), prompts=prompts, results=results,
                events=events)


def _policy_reference():
    """``examples/mixed_quant_policy.py``'s run on numpy-seeded tokens, in
    an f32 model: (tokens, params, {policy: (sizes, metrics)})."""
    cfg = JC.get_arch("llama3.2-1b", reduced=True).replace(dtype="float32")
    params = _np(JT.init_params(cfg, jax.random.PRNGKey(0)))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (PMIX.BATCH, PMIX.SEQ)).astype(np.int32)
    fwd = jax.jit(lambda p, t: JT.forward_seq(p, cfg, tokens=t)[0])
    teacher = fwd(params, toks)
    rows = {}
    for pol in (JP.pure("q2_k"), JP.pure("q3_k"), JP.pure("q4_k"),
                JP.pure("q6_k"), JP.get_policy("paper_llama_mix"),
                JP.get_policy("extended_mix")):
        qp, _ = j_quantize_params(params, pol)
        rows[pol.name] = (j_param_bytes(qp),
                          JQY.logit_metrics(teacher, fwd(qp, toks)))
    return toks, params, rows


def _example_calls():
    """The keyword arguments of the ``ModelConfig``, ``AdamWConfig`` and
    ``run_training`` calls in ``examples/train_e2e.py``, read from its
    source (the script trains on import); names of ``args`` stay names."""
    tree = ast.parse((EXAMPLES / "train_e2e.py").read_text())
    calls = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            calls[node.func.id] = {
                k.arg: (ast.literal_eval(k.value)
                        if not isinstance(k.value, (ast.Attribute, ast.Call))
                        else ast.unparse(k.value))
                for k in node.keywords}
    return calls


def _flat(tree, prefix=""):
    """{path: f32 numpy leaf} of a parameter tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().to(torch.float32).numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _norm_rel(a, b) -> float:
    """The norm of a - b over the norm of b."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _train_reference():
    """The reference ``run_training`` as the example calls it, on the cut
    config, for ``TRAIN_STEPS`` steps, in the example's bf16 compute and
    in f32: (cut config kwargs, its initial state, {dtype: (losses,
    updates {leaf: params after - params before})})."""
    calls = _example_calls()
    kw = {**calls["ModelConfig"], **TRAIN_CUT}
    cfg = JC.ModelConfig(**kw)
    opt_kw = {k: v for k, v in calls["AdamWConfig"].items()
              if k != "total_steps"}
    opt = JAdamWConfig(total_steps=TRAIN_STEPS, **opt_kw)
    state = _np(JS.init_train_state(cfg, opt, jax.random.PRNGKey(0)))
    p0 = _flat(state["params"])
    run = calls["run_training"]
    runs = {}
    for dtype in ("bfloat16", "float32"):
        res = j_run_training(cfg.replace(dtype=dtype), steps=TRAIN_STEPS,
                             global_batch=run["global_batch"],
                             seq_len=run["seq_len"], opt=opt,
                             log_fn=lambda *_: None)
        runs[dtype] = (res["losses"], {
            k: v - p0[k] for k, v in _flat(res["state"]["params"]).items()})
    return kw, state, runs


@pytest.fixture(scope="module")
def reference():
    return dict(serve=_serve_reference(), policy=_policy_reference(),
                train=_train_reference())


# ---------------------------------------------------------------------------
# the serve flow
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(reference):
    ref = reference["serve"]
    cfg = PC.get_arch("tinyllama-1.1b", reduced=True)
    return PSERVE.run(cfg, bridge.from_jax_params(ref["params"]),
                      device="cpu", log=lambda *_: None)


def _ref_margin(cfg, qp, seq):
    logits, _, _ = JT.forward_seq(qp, cfg, tokens=np.asarray([seq], np.int32))
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


def test_serve_flow_packs_as_the_example(reference, served):
    ref = reference["serve"]
    assert served["tensors"] == ref["tensors"] == {"q2_k": 3, "q3_k": 5}
    assert served["layers"] == {"q2_k": 5, "q3_k": 10}
    assert served["sizes"] == ref["sizes"]
    assert served["prompts"] == ref["prompts"]


def test_serve_flow_streams_the_reference_engines_tokens(reference, served):
    ref = reference["serve"]
    assert served["streamed"] == served["results"]
    # the callbacks fire for the same requests in the same order
    assert [r for r, _ in served["events"]] == [r for r, _ in ref["events"]]
    compared = 0
    for rid, prompt in enumerate(ref["prompts"]):
        want, got = ref["results"][rid], served["results"][rid]
        assert len(got) == len(want) == PSERVE.SERVE["max_new_tokens"]
        for t, (a, b) in enumerate(zip(want, got)):
            if a != b:
                margin = _ref_margin(ref["cfg"], ref["qp"], prompt + want[:t])
                assert margin < MARGIN_TOL, (rid, t, a, b, margin)
                break
            compared += 1
    assert compared >= 0.8 * len(ref["prompts"]) * 10
    s = served["stats"]
    assert s["requests"] == 6 and s["tokens"] == 60
    assert s["host_syncs"] == s["prefill_groups"] + s["chunks"]


# ---------------------------------------------------------------------------
# the mixed-policy flow
# ---------------------------------------------------------------------------

def _policy_rows(reference, dtype):
    toks, params, ref = reference["policy"]
    cfg = PC.get_arch("llama3.2-1b", reduced=True).replace(dtype=dtype)
    rows = PMIX.run(cfg, bridge.from_jax_params(params),
                    torch.from_numpy(toks), log=lambda *_: None)
    assert [r["policy"] for r in rows] == list(ref)
    for r in rows:
        assert r["sizes"] == ref[r["policy"]][0], r["policy"]
    kl = {r["policy"]: r["kl"] for r in rows}
    assert kl["pure_q6_k"] < kl["pure_q4_k"] < kl["pure_q3_k"] \
        < kl["pure_q2_k"]
    return rows, ref


def test_policy_flow_matches_the_example_in_f32(reference):
    rows, ref = _policy_rows(reference, "float32")
    for r in rows:
        want = ref[r["policy"]][1]["kl"]
        assert abs(r["kl"] - want) <= TOL_QUALITY * want, (r["policy"],
                                                           r["kl"], want)


def test_policy_flow_in_the_examples_bf16(reference):
    rows, _ = _policy_rows(reference, "bfloat16")
    assert all(np.isfinite(r["kl"]) and r["kl"] > 0 for r in rows)


# ---------------------------------------------------------------------------
# the train flow
# ---------------------------------------------------------------------------

def test_train_flow_mirrors_the_example():
    calls = _example_calls()
    want = dataclasses.asdict(JC.ModelConfig(**calls["ModelConfig"]))
    assert dataclasses.asdict(PTRAIN.LLAMA_100M) == want
    run = calls["run_training"]
    assert PTRAIN.RUN == {k: run[k] for k in PTRAIN.RUN}
    assert PTRAIN.OPT == {k: v for k, v in calls["AdamWConfig"].items()
                          if k != "total_steps"}
    assert calls["AdamWConfig"]["total_steps"] == "args.steps"
    assert run["steps"] == "args.steps"


def _train_flow(state, cfg, where):
    """Three steps of the flow on ``cfg`` from ``state`` (saved as its
    step-0 checkpoint under ``where``): (losses, updates)."""
    Checkpointer(str(where)).save(0, bridge.from_jax_params(state))
    logs = []
    res = PTRAIN.run(cfg, steps=TRAIN_STEPS, ckpt_dir=str(where),
                     device="cpu", log_fn=logs.append)
    assert logs[0] == "[resume] restored checkpoint step=0"
    assert int(res["state"]["step"]) == TRAIN_STEPS
    p0 = _flat(state["params"])
    return res["losses"], {k: v - p0[k]
                           for k, v in _flat(res["state"]["params"]).items()}


def test_train_flow_losses_match_reference(reference, tmp_path):
    kw, state, runs = reference["train"]
    cfg = PTRAIN.LLAMA_100M.replace(**TRAIN_CUT)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JC.ModelConfig(**kw))
    (want, ref16), (want32, ref32) = runs["bfloat16"], runs["float32"]
    got, moved = _train_flow(state, cfg, tmp_path / "bf16")
    assert len(got) == len(want) == TRAIN_STEPS
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL_LOSS_BF16 * abs(w), (got, want)
    assert moved.keys() == ref16.keys()
    noise = max(_norm_rel(ref16[k], ref32[k]) for k in ref16)
    for k in ref16:
        assert _norm_rel(moved[k], ref16[k]) <= 2 * noise, (k, noise)
    got, moved = _train_flow(state, cfg.replace(dtype="float32"),
                             tmp_path / "f32")
    for g, w in zip(got, want32):
        assert abs(g - w) <= TOL_STEP_F32 * abs(w), (got, want32)
    for k in ref32:
        assert _norm_rel(moved[k], ref32[k]) <= TOL_UPDATE_F32, k


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def test_flow_entry_points_on_the_cpu(capsys):
    out = PSERVE.main(["--device", "cpu"])
    assert out["streamed"] == out["results"] and len(out["results"]) == 6
    rows = PMIX.main(["--device", "cpu"])
    assert [r["policy"] for r in rows][-2:] == ["paper_llama_mix",
                                                "extended_mix"]
    text = capsys.readouterr().out
    assert "quantized tensors by variant" in text and "KL(fp||q)" in text


def test_flow_entry_points_raise_where_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    for main in (PSERVE.main, PMIX.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTRAIN.main(["--steps", "1"])
