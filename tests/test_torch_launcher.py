"""The port's serving launcher and its sampling and baseline flags.

``repro_torch.launch.serve.main`` runs on the CPU with ``--reduced
--device cpu`` and each flag the reference launcher has for plain
serving: ``--temperature``, ``--eos-id``, ``--seed``, ``--stream`` and
``--no-quant``; and for speculative decoding, the prefix cache and SLO
admission: ``--drafter``, ``--draft-*``, ``--prefix-*``,
``--shared-prefix``, ``--max-queue`` and ``--preempt``; and for
disaggregated serving and the HTTP front end: ``--disagg``,
``--prefill-workers``, ``--decode-workers``, ``--http``, ``--host``,
``--port`` and ``--request-timeout``, also over tensor-parallel workers
(``--disagg --tp 2 --force-host-devices 2``). ``main`` returns the
engine after its run and the ``{request id: tokens}`` it printed.
"""
import re

import pytest
import torch

from repro_torch.core.quantize import QTensor
from repro_torch.kernels import bfp_matmul as PB
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.serving import frontend
from repro_torch.serving.disagg import DisaggEngine

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


DISAGG = ["--disagg", "--prefill-workers", "2", "--decode-workers", "2",
          "--prefix-page", "8", "--shared-prefix", "20", "--prompt-len",
          "10"]


def test_disagg_flags_serve_the_monolithic_tokens(capsys):
    """``--disagg`` serves through the prefill and decode tiers with the
    worker counts asked for, gives the monolithic launcher's tokens, and
    the stats line carries the router's counts."""
    _, mono = serve.main(BASE + DISAGG[5:])
    capsys.readouterr()
    eng, res = serve.main(BASE + DISAGG)
    assert isinstance(eng, DisaggEngine)
    assert (len(eng.prefill_engines), len(eng.decode_engines)) == (2, 2)
    assert eng.device.type == "cpu"
    assert res == mono
    assert eng.stats["router"]["migrated_pages_total"] > 0
    assert re.search(r"router: \d+ pages migrated, prefill hit rates "
                     r"\[.*\], \d+ direct-to-decode, peak depths "
                     r"P\[\d+, \d+\]/D\[\d+, \d+\]", capsys.readouterr().out)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_disagg_refuses_the_recurrent_archs(arch):
    with pytest.raises(ValueError, match="KV-ring family"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--tokens", "2", "--disagg"])


@pytest.mark.parametrize("disagg", [False, True])
def test_http_flags_reach_the_front_end(monkeypatch, disagg):
    """``--http`` hands the engine (monolithic or disaggregated) to
    ``serve_forever`` with ``--host``, ``--port``, ``--request-timeout``,
    the arch as the model name and ``--tokens`` as the default budget,
    instead of draining the synthetic queue."""
    seen = {}

    def fake_serve_forever(engine, fcfg):
        seen.update(engine=engine, fcfg=fcfg)
    monkeypatch.setattr(frontend, "serve_forever", fake_serve_forever)
    eng, res = serve.main(BASE + ["--http", "--host", "0.0.0.0", "--port",
                                  "0", "--request-timeout", "7.5"]
                          + (DISAGG[:1] if disagg else []))
    assert seen["engine"] is eng and res == {}
    assert isinstance(eng, DisaggEngine if disagg else serve.Engine)
    f = seen["fcfg"]
    assert (f.host, f.port, f.request_timeout_s, f.model_name,
            f.max_tokens_default) == ("0.0.0.0", 0, 7.5, "llama3.2-1b", 6)
    assert eng.stats["admissions"] == 0         # nothing was drained


TP_DISAGG = ["--disagg", "--prefix-page", "8", "--shared-prefix", "20",
             "--prompt-len", "10"]


def test_disagg_over_tp2_serves_the_tp1_tokens(capsys):
    """``--disagg --tp 2 --force-host-devices 2``: both tiers on one group
    of two CPU ranks serve the ``--tp 1`` tokens, the stats line carries
    the hand-off, and the launcher closes the engine and its group."""
    _, one = serve.main(BASE + TP_DISAGG)
    capsys.readouterr()
    eng, two = serve.main(BASE + TP_DISAGG + ["--tp", "2",
                                              "--force-host-devices", "2"])
    assert isinstance(eng, DisaggEngine) and eng.group.size == 2
    assert two == one
    assert eng.closed and eng.group.closed
    assert not any(p.is_alive() for p in eng.group._procs)
    out = capsys.readouterr().out
    assert re.search(r"hand-off [\d.]+ ms for [1-9]\d* bytes", out)
    assert "backend gloo" in out


def test_http_over_a_tp2_disagg_engine(monkeypatch):
    """``--http --disagg --tp 2`` hands the tensor-parallel
    ``DisaggEngine`` to the front end and closes it when the server
    stops."""
    seen = {}

    def fake_serve_forever(engine, fcfg):
        seen.update(engine=engine, closed=engine.closed)
    monkeypatch.setattr(frontend, "serve_forever", fake_serve_forever)
    eng, res = serve.main(BASE + ["--http", "--port", "0", "--disagg",
                                  "--tp", "2", "--force-host-devices", "2"])
    assert seen["engine"] is eng and res == {} and not seen["closed"]
    assert isinstance(eng, DisaggEngine) and eng.group.size == 2
    assert eng.closed and eng.group.closed

