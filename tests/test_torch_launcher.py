"""The port's serving launcher and its sampling and baseline flags.

``repro_torch.launch.serve.main`` runs on the CPU with ``--reduced
--device cpu`` and each flag the reference launcher has for plain
serving: ``--temperature``, ``--eos-id``, ``--seed``, ``--stream`` and
``--no-quant``; and for speculative decoding, the prefix cache and SLO
admission: ``--drafter``, ``--draft-*``, ``--prefix-*``,
``--shared-prefix``, ``--max-queue`` and ``--preempt``. ``main`` returns
the engine after its run and the ``{request id: tokens}`` it printed.
"""
import re

import pytest
import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels import bfp_matmul as PB
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve

torch.set_num_threads(2)

BASE = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
        "--policy", "paper_llama_mix", "--requests", "3", "--slots", "2",
        "--tokens", "6", "--cache-len", "64"]


@pytest.fixture
def calls(monkeypatch):
    """Counts the packed products (``ops.bfp_matmul``, the kernel's entry
    point on any device) and records the prompts the launcher submits."""
    seen = {"matmuls": 0, "prompts": []}
    orig_matmul, orig_submit = kops.bfp_matmul, serve.Engine.submit

    def matmul(*a, **k):
        seen["matmuls"] += 1
        return orig_matmul(*a, **k)

    def submit(self, prompt, *a, **k):
        seen["prompts"].append(list(prompt))
        return orig_submit(self, prompt, *a, **k)

    monkeypatch.setattr(kops, "bfp_matmul", matmul)
    monkeypatch.setattr(serve.Engine, "submit", submit)
    return seen


def test_stream_prints_every_returned_token(capsys):
    _, res = serve.main(BASE + ["--stream", "--temperature", "0.8"])
    streamed = {}
    for rid, tok in re.findall(r"\[req (\d+)\] \+= (\d+)",
                               capsys.readouterr().out):
        streamed.setdefault(int(rid), []).append(int(tok))
    assert streamed == res and all(len(t) == 6 for t in res.values())


def test_temperature_samples_and_repeats_under_a_seed():
    _, greedy = serve.main(BASE)
    _, a = serve.main(BASE + ["--temperature", "0.8", "--seed", "3"])
    _, b = serve.main(BASE + ["--temperature", "0.8", "--seed", "3"])
    assert a == b and a != greedy


def test_eos_id_ends_a_request():
    _, res = serve.main(BASE + ["--temperature", "0.8"])
    eos = res[0][2]
    eng, res = serve.main(BASE + ["--temperature", "0.8", "--eos-id",
                                  str(eos)])
    assert eng.scfg.eos_id == eos
    assert len(res[0]) <= 3 and res[0][-1] == eos


def test_no_quant_serves_float_weights(calls):
    PB.reset_launches()
    eng, res = serve.main(BASE + ["--no-quant"])
    assert not any(isinstance(t, QTensor) for t in (
        eng.params["layers"]["attn"]["wq"], eng.params["layers"]["mlp"][
            "w_down"]))
    assert calls["matmuls"] == 0 and sum(PB.launches.values()) == 0
    assert all(len(t) == 6 for t in res.values())
    eng, _ = serve.main(BASE)
    assert isinstance(eng.params["layers"]["attn"]["wq"], QTensor)
    assert calls["matmuls"] > 0


def test_seed_changes_weights_and_prompts(calls):
    e0, _ = serve.main(BASE + ["--seed", "0"])
    p0 = calls["prompts"][:]
    e1, _ = serve.main(BASE + ["--seed", "1"])
    p1 = calls["prompts"][len(p0):]
    assert len(p0) == len(p1) == 3 and p0 != p1
    assert not torch.equal(e0.params["wte"], e1.params["wte"])
    assert e0.scfg.seed == 0 and e1.scfg.seed == 1


SPEC = ["--drafter", "self", "--draft-k", "3", "--draft-layers", "1",
        "--draft-ngram", "3", "--draft-verify", "scan"]
PREFIX = ["--prefix-cache", "--prefix-page", "8", "--prefix-bytes",
          str(1 << 20), "--shared-prefix", "20"]


def test_spec_prefix_and_slo_flags_reach_the_engine(calls, capsys):
    _, plain = serve.main(BASE + ["--shared-prefix", "20"])
    capsys.readouterr()
    eng, res = serve.main(BASE + SPEC + PREFIX + ["--max-queue", "8",
                                                  "--preempt", "--chunk",
                                                  "2"])
    s = eng.scfg
    assert (s.drafter, s.draft_k, s.draft_layers, s.draft_ngram,
            s.draft_verify) == ("self", 3, 1, 3, "scan")
    assert (s.prefix_cache, s.prefix_page, s.prefix_bytes) == (True, 8,
                                                               1 << 20)
    assert (s.max_queue, s.preempt) == (8, True)
    assert s.decode_chunk == 4          # raised to fit one verify round
    prompts = calls["prompts"][-3:]
    assert all(p[:20] == prompts[0][:20] and len(p) == 26 for p in prompts)
    assert eng.stats["prefix_hits"] > 0 and eng.stats["spec_rounds"] > 0
    out = capsys.readouterr().out
    assert re.search(r"spec accept \d+% \(\d+/\d+ drafts over \d+ rounds\)",
                     out)
    assert re.search(r"prefix hits \d+% \(\d+ tokens reused", out)
    # greedy speculation (scan verify: decode's logits bit for bit) and
    # the prefix cache keep plain serving's tokens
    assert res == plain
    eng, _ = serve.main(BASE + ["--drafter", "ngram", "--draft-verify",
                                "batched"])
    assert eng.scfg.draft_verify == "batched"
    assert eng.stats["draft_tokens"] > 0


def test_moe_arch_serves_under_the_default_policy(calls, capsys):
    """``--arch olmoe-1b-7b --reduced`` under the default policy
    (default_serve_mix): the expert stacks are packed along E*K and
    counted once a layer, and every request gets its tokens."""
    eng, res = serve.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                           "cpu", "--requests", "3", "--slots", "2",
                           "--tokens", "6", "--cache-len", "64"])
    assert eng.cfg.family == "moe"
    wg = eng.params["layers"]["moe"]["w_gate"]
    L, E, d = eng.cfg.n_layers, eng.cfg.n_experts, eng.cfg.d_model
    assert isinstance(wg, QTensor) and wg.variant == "q3_k"
    assert wg.shape == (E * d, eng.cfg.moe_d_ff) and wg.num_layers == L
    assert "{'q3_k': 8, 'q2_k': 5} matmuls" in capsys.readouterr().out
    assert calls["matmuls"] > 0
    assert len(res) == 3 and all(len(t) == 6 for t in res.values())
