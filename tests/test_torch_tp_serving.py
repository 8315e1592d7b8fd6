"""Tensor-parallel serving on the CPU: gloo groups of 2 and 4 ranks.

Mirrors ``tests/test_tp_serving.py`` (whose multi-device cases skip in
this run: JAX sees one CPU device). The "padded" datapath's tokens equal
tp=1's across the speculation x prefix-cache matrix, cold and warm, on
the attention fallback (KH=2 at tp=4), the sliding window, the int8 KV
ring, the self drafter, temperature sampling, paper_llama_mix-packed
weights and gpt2; "sliced" and "sliced_row" logits meet the reference's
tolerances (rtol 1e-4, atol 1e-4 * max|ref| for "sliced" and for
"sliced_row" in f32; 2e-2 in bf16), with the quantized row modes; the
ring matmul and the row-parallel projection against the full product;
cancel, SLO admission and ``run(poll=)``; the KV page hand-off; the
blockwise forward; and tp=2 tokens equal to the reference engine's tp=1
tokens on the same (bridged) weights. The launcher's ``--tp 2
--force-host-devices 2`` equals ``--tp 1``.

Ranks rendezvous through a FileStore in a temporary directory (no TCP
port), every collective has a timeout, and engines share one group of
each size (``GroupCache``), closed when the module ends. Ranks run one
thread each, and so does this process while the module runs.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import bridge
from repro_torch.configs.base import get_arch
from repro_torch.core import quantize as Q
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.group import GroupCache
from repro_torch.launch import serve as launcher
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine, EngineSaturated, ServeConfig

BASE = dict(max_new_tokens=6, cache_len=64, decode_chunk=8, max_slots=3,
            prefill_bucket=4, prefill_chunk=8, prefill_batch=3)
TIMEOUT_S = 120.0


@pytest.fixture(scope="module")
def groups():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = GroupCache(lambda n: ["cpu"] * n, timeout_s=TIMEOUT_S)
    yield cache
    cache.close()
    torch.set_num_threads(threads)


def _init(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


@pytest.fixture(scope="module")
def causal():
    # n_kv_heads=4 so tp=4 shards attention too (the stock KH=2 is the
    # fallback case)
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(n_kv_heads=4)
    return cfg, _init(cfg)


def _prompts(cfg, n, seed=0, lo=2, hi=30, shared=0):
    rng = np.random.default_rng(seed)
    pre = [int(t) for t in rng.integers(0, cfg.vocab_size, shared)]
    return [pre + [int(t) for t in rng.integers(0, cfg.vocab_size,
                                                int(rng.integers(lo, hi)))]
            for _ in range(n)]


def _engine(model, tp, groups, **kw):
    cfg, params = model
    return Engine(cfg, params, ServeConfig(tp=tp, **{**BASE, **kw}),
                  device="cpu", group=groups.get(tp) if tp > 1 else None)


def _serve(model, tp, groups, prompts, runs=1, **kw):
    """(outputs of ``runs`` generate calls, stats of the last, plan)."""
    with _engine(model, tp, groups, **kw) as eng:
        outs = [eng.generate(prompts) for _ in range(runs)]
        return outs, dict(eng.stats), eng._plan


def _parity(model, tp, groups, prompts=None, runs=1, **kw):
    prompts = prompts or _prompts(model[0], 5, seed=1)
    ref = _serve(model, 1, groups, prompts, runs, **kw)
    got = _serve(model, tp, groups, prompts, runs, **kw)
    assert got[0] == ref[0], f"tp={tp} diverged"
    return ref, got


MATRIX = [(False, False), (False, True), (True, False), (True, True)]


def _matrix_case(causal, groups, tp, spec, prefix):
    kw = {}
    if spec:
        kw.update(drafter="ngram", draft_k=3)
    if prefix:
        kw.update(prefix_cache=True, prefix_page=8)
    prompts = _prompts(causal[0], 5, seed=2, shared=24 if prefix else 0,
                       lo=2, hi=8 if prefix else 30)
    (_, s1, _), (_, s2, plan) = _parity(causal, tp, groups, prompts,
                                        runs=2, **kw)
    assert plan.attn and plan.mlp
    if prefix:      # the warm cycle hit, as often at every degree
        assert s1["prefix_hits"] > 0
        assert s1["prefix_hits"] == s2["prefix_hits"]
    if spec:        # the same accept decisions, not just tokens
        assert (s1["draft_tokens"], s1["draft_accepted"]) == (
            s2["draft_tokens"], s2["draft_accepted"])


# ---------------------------------------------------------------------------
# tp = 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,prefix", MATRIX)
def test_greedy_parity_causal_tp2(causal, groups, spec, prefix):
    _matrix_case(causal, groups, 2, spec, prefix)


def test_greedy_parity_sliding_window(groups):
    """Ring wrap under TP: prompts longer than the window (64)."""
    cfg = get_arch("h2o-danube-1.8b", reduced=True)
    _parity((cfg, _init(cfg)), 2, groups,
            _prompts(cfg, 4, seed=3, lo=40, hi=90))


def test_greedy_parity_int8_kv(groups):
    """int8 KV per (token, head): the sharded ring holds the tp=1 ring's
    codes and scales of its kv heads."""
    cfg = get_arch("llama3.2-1b", reduced=True).replace(
        kv_cache_quant=True, dtype="float32")
    model = (cfg, _init(cfg))
    _parity(model, 2, groups)
    with _engine(model, 2, groups) as eng:
        assert eng._cspecs["k_scale"] == SH.KV_HEADS
        eng.generate(_prompts(cfg, 2, seed=4))
        assert eng._cache is None or eng._cache["k"].shape[3] == \
            cfg.n_kv_heads // 2


def test_greedy_parity_self_drafter(causal, groups):
    _parity(causal, 2, groups, drafter="self", draft_k=2, draft_layers=1)


def test_greedy_parity_verify_batched(causal, groups):
    _parity(causal, 2, groups, drafter="ngram", draft_k=3,
            draft_verify="batched")


def test_temperature_parity_tp2(causal, groups):
    """Every rank draws the same uniforms from the numbered stream, and
    the logits are replicated bit for bit, so sampling is too."""
    (ref, _, _), (got, _, _) = _parity(causal, 2, groups, temperature=0.8,
                                       seed=7)
    greedy = _serve(causal, 1, groups, _prompts(causal[0], 5, seed=1))[0]
    assert ref != greedy


def test_quantized_padded_token_parity(causal, groups):
    """paper_llama_mix packed weights, padded datapath: a zero payload
    lane dequantizes to zero and the product keeps its shape."""
    cfg, params = causal
    qp, _ = quantize_params(params, get_policy("paper_llama_mix"))
    _parity((cfg, qp), 2, groups, _prompts(cfg, 4, seed=5, hi=14))


def test_greedy_parity_gpt2_gelu(groups):
    """gpt2: fused qkv keeps attention replicated, the gelu MLP shards
    with b_fc lane-sharded and b_proj added after the gather."""
    cfg = get_arch("gpt2-paper", reduced=True)
    _, (_, _, plan) = _parity((cfg, _init(cfg)), 2, groups,
                              _prompts(cfg, 4, seed=13, hi=14))
    assert not plan.attn and plan.mlp


LOGIT_PROMPTS = dict(n=3, seed=11, lo=9, hi=15)


def _logits(model, tp, groups, mm):
    prompts = _prompts(model[0], **LOGIT_PROMPTS)
    with _engine(model, tp, groups, tp_matmul=mm) as eng:
        return eng.prefill_logits(prompts), eng._plan


def test_sliced_datapath_logit_tolerance(causal, groups):
    ref, _ = _logits(causal, 1, groups, "padded")
    got, _ = _logits(causal, 2, groups, "sliced")
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    pad, _ = _logits(causal, 2, groups, "padded")
    np.testing.assert_array_equal(pad, ref)


def test_sliced_row_logit_tolerance_bf16(causal, groups):
    ref, _ = _logits(causal, 1, groups, "padded")
    got, plan = _logits(causal, 2, groups, "sliced_row")
    assert plan.attn_row == "packed" and plan.mlp_row == "packed"
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-2 * np.abs(ref).max())
    assert np.abs(got - ref).max() <= 1.5e-2 * np.abs(ref).max()


def test_sliced_row_logit_tolerance_f32(groups):
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(
        n_kv_heads=4, dtype="float32")
    model = (cfg, _init(cfg))
    ref, _ = _logits(model, 1, groups, "padded")
    got, _ = _logits(model, 2, groups, "sliced_row")
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_sliced_row_quantized_row_modes(causal, groups):
    """wo (K=256, one super-block) takes "dequant", w_down (K=512)
    "packed"."""
    cfg, params = causal
    qp, _ = quantize_params(params, get_policy("paper_llama_mix"))
    ref, _ = _logits((cfg, qp), 1, groups, "padded")
    got, plan = _logits((cfg, qp), 2, groups, "sliced_row")
    assert plan.attn_row == "dequant" and plan.mlp_row == "packed"
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-2 * np.abs(ref).max())


def test_ring_and_row_matmul_parity(groups):
    """``tp_ring_dense`` (chunks forwarded by batch_isend_irecv, an f32
    carry) and ``tp_row_dense`` (f32 partials, one all-reduce; "packed"
    on this rank's K rows, "dequant" on the replicated packed tensor)
    against the full product, for a packed weight and a plain one, at the
    activation-ulp tolerance of "sliced_row"."""
    size, K, N, M = 2, 512, 256, 8
    g = torch.Generator().manual_seed(3)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    w = torch.randn(K, N, generator=g) * 0.2
    t = Q.quantize("q3_k", w)
    plan = SH.ServeTPPlan(size=size, attn=True, mlp=True,
                          matmul="sliced_row")
    group = groups.get(size)
    kl = K // size
    shifts = group.counts["ring_shift"]
    for weight, full in ((t, Q.dequantize(t, dtype=torch.bfloat16)),
                         (w.to(torch.bfloat16), w.to(torch.bfloat16))):
        ref = (x.float() @ full.float()).to(torch.bfloat16).float()
        args = []
        for r in range(size):
            xl = x[:, r * kl:(r + 1) * kl]
            if isinstance(weight, Q.QTensor):
                args.append((xl, SH.lane_shard_qtensor(weight, r, size),
                             SH.row_shard_qtensor(weight, r, size), weight))
            else:
                args.append((xl, weight[:, r * N // size:(r + 1) * N // size],
                             weight[r * kl:(r + 1) * kl], None))
        outs = group.map(L.tp_ring_dense, [a[:2] for a in args], plan)
        outs += group.map(L.tp_row_dense, [(a[0], a[2], "packed")
                                           for a in args], plan)
        if args[0][3] is not None:
            outs += group.map(L.tp_row_dense, [(a[0], a[3], "dequant")
                                               for a in args], plan)
        for got in outs:
            np.testing.assert_allclose(
                got.float().numpy(), ref.numpy(), rtol=2e-2,
                atol=2e-2 * ref.abs().max().item())
    assert group.counts["ring_shift"] == shifts + 2   # size - 1 a ring


def test_blockwise_and_naive_forward_tp2(groups):
    """``forward_seq`` under the plan on each rank's shard (the
    calibration/training forward, blockwise attention included) equals
    tp=1's logits bit for bit on the padded datapath."""
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(
        n_kv_heads=4, dtype="float32", attn_q_chunk=8, attn_kv_chunk=8)
    params = _init(cfg)
    tokens = torch.as_tensor(_prompts(cfg, 1, seed=6, lo=32, hi=33))
    plan = SH.make_serve_tp_plan(cfg, 2)
    specs = SH.serve_param_specs(params, plan)
    for impl in ("naive", "blockwise"):
        c = cfg.replace(attn_impl=impl)
        ref = T.forward_seq(params, c, tokens=tokens)[0]
        fn = functools.partial(T.forward_seq, tokens=tokens)
        outs = groups.get(2).map(
            fn, [(SH.localize_serve_params(params, specs, 2, r), c)
                 for r in range(2)], plan)
        for o in outs:
            assert torch.equal(o[0], ref), impl


def test_attention_at_full_head_counts_keeps_tp1_bits():
    """Under serve TP the plain attentions run at the single-device head
    counts, a rank's heads zero-embedded (``transformer._full_heads``): a
    rank's heads of the decode and naive prefill attention equal tp=1's
    bit for bit, over random draws, at 2 and 4 ranks (one kv head a rank
    at 4). A batched product's kernel follows its batch count, so the
    same heads in a call of their own need not."""
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(n_kv_heads=4)
    B, C, H, KH, D, R = 4, 8, cfg.n_heads, cfg.n_kv_heads, 64, 96
    g = torch.Generator().manual_seed(21)
    for _ in range(8):
        q = torch.randn(B, C, H, D, generator=g).bfloat16()
        k = torch.randn(B, R, KH, D, generator=g).bfloat16()
        v = torch.randn(B, R, KH, D, generator=g).bfloat16()
        pos = torch.randint(40, 80, (B,), generator=g)
        sp = torch.where(torch.arange(R)[None] <= pos[:, None],
                         torch.arange(R)[None], -1).int()
        qp = pos[:, None] + torch.arange(C)[None]
        calls = ((L.decode_attention, q[:, :1], (sp, pos), {}),
                 (L.naive_attention, q, (), dict(q_positions=qp,
                                                 kv_positions=sp)))
        for fn, qq, rest, kw in calls:
            full = fn(qq, k, v, *rest, **kw)
            for tp in (2, 4):
                plan = SH.ServeTPPlan(size=tp, attn=True)
                n, m = H // tp, KH // tp
                parts = []
                for r in range(tp):
                    with SH.serve_tp(plan, r, group=True):
                        parts.append(T._full_heads(
                            cfg, fn, qq[:, :, r * n:(r + 1) * n],
                            k[:, :, r * m:(r + 1) * m],
                            v[:, :, r * m:(r + 1) * m], *rest, **kw))
                assert torch.equal(torch.cat(parts, 2), full), (fn, tp)


def test_cancel_midstream_under_tp(causal, groups):
    prompts = _prompts(causal[0], 3, seed=9, hi=12)

    def run(tp):
        with _engine(causal, tp, groups) as eng:
            ids, seen = [], {}

            def cb(rid, tok):
                seen[rid] = seen.get(rid, 0) + 1
                if rid == ids[0] and seen[rid] == 2:
                    eng.cancel(ids[1])
            for p in prompts:
                ids.append(eng.submit(p, on_token=cb))
            res = eng.run()
            return [res[i] for i in ids]

    assert run(1) == run(2)


def _slo_script(eng, vocab):
    """Priorities, deadlines, a bounded queue and a preempting arrival
    injected through ``run(poll=)``; what the engine did."""
    p = _prompts(get_arch("tinyllama-1.1b", reduced=True), 7, seed=3,
                 hi=9)
    done, reasons = [], []

    def submit(i, **kw):
        try:
            return eng.submit(p[i], on_done=lambda r: done.append(
                (r.id, r.cancelled, r.preempted, len(r.tokens))), **kw)
        except EngineSaturated as e:
            reasons.append(e.reason)
    for i in range(4):
        submit(i)
    polls = [0]

    def poll():
        polls[0] += 1
        if polls[0] == 3:
            submit(4, priority=1)
            submit(5, priority=1)
        if polls[0] == 5:
            submit(6, priority=-1)
    res = eng.run(poll=poll)
    return sorted(done), reasons, res, eng.stats["preemptions"]


def test_slo_admission_and_poll_under_tp(causal, groups):
    kw = dict(decode_chunk=2, max_slots=2, prefill_batch=2, max_queue=3,
              preempt=True)
    outs = []
    for tp in (1, 2):
        with _engine(causal, tp, groups, **kw) as eng:
            outs.append(_slo_script(eng, causal[0].vocab_size))
    assert outs[0] == outs[1]
    assert outs[0][3] > 0 and outs[0][1] == ["queue_full"]


def test_kv_page_handoff_under_tp(causal, groups):
    """Pages exported by a tp=2 engine are the tp=1 engine's bit for bit
    (kv heads gathered in rank order); imported into a fresh tp=2 engine
    they make a warm admission that serves the cold tokens."""
    prompts = _prompts(causal[0], 2, seed=8, lo=24, hi=25)
    kw = dict(prefix_cache=True, prefix_page=8)
    with _engine(causal, 1, groups, **kw) as e1:
        cold = e1.generate(prompts)
        want = e1.export_kv_pages(prompts[0])
    with _engine(causal, 2, groups, **kw) as e2:
        assert e2.generate(prompts) == cold
        got = e2.export_kv_pages(prompts[0])
    assert got.tokens == want.tokens and got.n_pages == 3
    for k in want.payload:
        assert torch.equal(got.payload[k], want.payload[k]), k
    with _engine(causal, 2, groups, **kw) as e3:
        assert e3.import_kv_pages(want) == 3
        assert e3.generate(prompts) == cold
        assert e3.stats["prefix_hits"] >= 1
        back = e3.export_kv_pages(prompts[0])
    for k in want.payload:
        assert torch.equal(back.payload[k], want.payload[k]), k


def test_reference_engine_tp1_equals_port_tp2(groups):
    """The reference engine's tp=1 tokens on its own weights, moved to
    the port by the bridge, equal the port's tp=1 and tp=2 tokens
    (f32)."""
    jcfg = JC.get_arch("tinyllama-1.1b", reduced=True).replace(
        n_kv_heads=4, dtype="float32")
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(
        n_kv_heads=4, dtype="float32")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = bridge.from_jax_params(jax.tree.map(np.asarray, jp))
    prompts = _prompts(cfg, 3, seed=12, lo=10, hi=11)
    ref = JEngine(jcfg, jp, JServeConfig(**BASE)).generate(prompts)
    ref = [[int(t) for t in r] for r in ref]
    assert _serve((cfg, params), 1, groups, prompts)[0][0] == ref
    assert _serve((cfg, params), 2, groups, prompts)[0][0] == ref


def test_launcher_tp_flags(groups):
    """``--tp 2 --force-host-devices 2`` serves the ``--tp 1`` tokens on
    two CPU ranks; ``--force-host-devices`` with ``--device cuda`` is an
    error."""
    groups.close()          # the launcher's engine opens its own group
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--requests", "3",
            "--slots", "2", "--cache-len", "64", "--tokens", "5"]
    _, one = launcher.main(argv + ["--device", "cpu"])
    eng, two = launcher.main(argv + ["--tp", "2", "--force-host-devices",
                                     "2", "--tp-matmul", "padded"])
    assert two == one and eng.tp_backend == "gloo" and eng._closed
    with pytest.raises(SystemExit):
        launcher.main(argv + ["--tp", "2", "--force-host-devices", "2",
                              "--device", "cuda"])


# ---------------------------------------------------------------------------
# tp = 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,prefix", MATRIX)
def test_greedy_parity_causal_tp4(causal, groups, spec, prefix):
    _matrix_case(causal, groups, 4, spec, prefix)


def test_greedy_parity_fallback_config(groups):
    """Stock reduced tinyllama (KH=2): tp=4 replicates attention and
    shards the MLP, and still serves tp=1's tokens."""
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    _, (_, _, plan) = _parity((cfg, _init(cfg)), 4, groups)
    assert not plan.attn and plan.mlp


def test_temperature_parity_tp4(causal, groups):
    _parity(causal, 4, groups, temperature=0.8, seed=7)
