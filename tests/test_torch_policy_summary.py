"""The port's last helper mirrors against the reference, on the CPU:

* ``core/quantize.py::qtensor_spec`` against ``src/repro/core/quantize.py``
  ``qtensor_spec``: for all eight formats (and the q8_0 fallback of a K
  that is not a multiple of 256), the same variant, logical shape,
  payload names, payload shapes and dtypes, bytes and bits a weight;
  exact. The port's payloads are meta tensors (nothing allocated).
* ``core/policy.py::summarize`` against ``src/repro/core/policy.py``
  ``summarize``: the same layer counts, parameter counts and sizes,
  exactly, over ``model_matmuls`` of each package (equal inventories):
  the paper's three models, reduced, under ``paper_llama_mix``,
  ``extended_mix`` and ``default_serve_mix``, with and without the
  embedding and gpt2's learned positions as fp16 extras; olmoe-1b-7b and
  mamba2-2.7b, reduced, whose inventories keep the reference's quirks
  (one expert's MLP a layer; mamba2's zero-width rows beside its LM head);
  and full-width tinyllama-1.1b under ``paper_llama_mix`` (the paper's 45
  q2_k + 110 q3_k), which is arithmetic only.
* ``kernels/bfp_matmul.py::smem_bytes`` (alias ``vmem_bytes``), the
  matmul's on-chip budget, read from ``csrc/bfp_matmul.cu``: the
  launcher's five schedules a variant, each a positive figure within the
  H100's 227 KB a block, staged rows that match each format's payloads,
  no nvcc needed. The card's own figures are held against it by
  ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

The reference's results are made once, in the module's fixture.
"""
import numpy as np
import pytest
import torch

from benchmarks.shapes import model_matmuls as j_model_matmuls
from repro.configs.base import get_arch as j_get_arch
from repro.core import policy as JP
from repro.core import quantize as JQ
from repro_torch.benchmarks.shapes import model_matmuls
from repro_torch.configs.base import get_arch
from repro_torch.core import formats as PF
from repro_torch.core import policy as PP
from repro_torch.core import quantize as PQ
from repro_torch.kernels import bfp_matmul as PB

torch.set_num_threads(2)

VARIANTS = ("q2_k", "q3_k", "q3_k_o", "q4_0", "q4_k", "q5_k", "q6_k", "q8_0")
SPEC_SHAPES = ((512, 384), (2048, 5632), (2080, 256))   # the last: fallback
PAPER = ("gpt2-paper", "tinyllama-1.1b", "mobilellama-1.4b")
POLICIES = ("paper_llama_mix", "extended_mix", "default_serve_mix")
# (arch, reduced, policy): the paper's models reduced under each mix, one
# MoE and one recurrent config, and full-width tinyllama (Table III)
CASES = ([(a, True, p) for a in PAPER for p in POLICIES]
         + [("olmoe-1b-7b", True, "default_serve_mix"),
            ("mamba2-2.7b", True, "default_serve_mix"),
            ("mamba2-2.7b", True, "paper_llama_mix"),
            ("tinyllama-1.1b", False, "paper_llama_mix"),
            ("gpt2-paper", False, "paper_gpt2_mix")])
SMEM_PER_BLOCK = 227 * 1024


def _extras(cfg):
    """The non-matmul fp16 tensors of Table III's size count."""
    if cfg.pos_emb == "learned":
        return [("wpe", cfg.max_position * cfg.d_model)]
    return []


def _spec_fields(t):
    """(variant, shape, {payload: (shape, numpy dtype)}, bytes, bits a
    weight) of a reference or port QTensor stand-in."""
    def dtype(v):
        return np.dtype(str(v.dtype).removeprefix("torch."))
    return (t.variant, tuple(t.shape),
            {k: (tuple(int(s) for s in v.shape), dtype(v))
             for k, v in t.data.items()},
            t.nbytes, t.bits_per_weight)


@pytest.fixture(scope="module")
def reference():
    """The reference's specs and summaries of every case."""
    specs = {(v, K, N): _spec_fields(JQ.qtensor_spec(v, K, N))
             for v in VARIANTS for K, N in SPEC_SHAPES}
    summaries = {}
    for arch, reduced, pol in CASES:
        cfg = j_get_arch(arch, reduced=reduced)
        for emb in (False, True):
            mms = j_model_matmuls(cfg, include_embedding=emb)
            summaries[(arch, reduced, pol, emb)] = (mms, JP.summarize(
                JP.get_policy(pol), mms, extra_f16=_extras(cfg)))
    return dict(specs=specs, summaries=summaries)


@pytest.mark.parametrize("shape", SPEC_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", VARIANTS)
def test_qtensor_spec_matches_reference(reference, variant, shape):
    K, N = shape
    got = PQ.qtensor_spec(variant, K, N)
    assert all(v.device.type == "meta" for v in got.data.values())
    assert _spec_fields(got) == reference["specs"][(variant, K, N)]
    want_variant = PF.pick_fallback(variant, K)
    assert got.variant == want_variant
    assert got.nbytes == PF.get_format(want_variant).nbytes(K, N)


def test_qtensor_spec_raises_as_reference():
    for fn in (PQ.qtensor_spec, JQ.qtensor_spec):
        with pytest.raises(ValueError):
            fn("q2_k", 300, 64)          # K % 32 != 0: not quantizable


@pytest.mark.parametrize("emb", [False, True], ids=["matmuls", "with_wte"])
@pytest.mark.parametrize("arch,reduced,policy", CASES,
                         ids=[f"{a}-{'reduced' if r else 'full'}-{p}"
                              for a, r, p in CASES])
def test_summarize_matches_reference(reference, arch, reduced, policy, emb):
    mms_ref, want = reference["summaries"][(arch, reduced, policy, emb)]
    cfg = get_arch(arch, reduced=reduced)
    mms = model_matmuls(cfg, include_embedding=emb)
    assert mms == mms_ref
    got = PP.summarize(PP.get_policy(policy), mms, extra_f16=_extras(cfg))
    assert got == want
    assert type(got["size_bytes"]) is int
    assert sum(got["counts"].values()) == len(mms)


def test_summarize_table3_counts_at_full_width(reference):
    """The paper's Table III layer counts (pure arithmetic at full width)."""
    for arch, policy, q2, q3 in (("tinyllama-1.1b", "paper_llama_mix", 45,
                                  110),
                                 ("gpt2-paper", "paper_gpt2_mix", 25, 24)):
        got = PP.summarize(PP.get_policy(policy),
                           model_matmuls(get_arch(arch)))
        assert got["counts"] == {"q2_k": q2, "q3_k": q3}


def test_summarize_mirrors_the_inventory_quirks():
    """What the reference's inventory lists, summarize counts: olmoe's
    MLP rows are one expert's (d_ff), mamba2's attention and MLP rows have
    zero width and land under "f16" with no parameters."""
    olmoe = get_arch("olmoe-1b-7b", reduced=True)
    rows = {path: (K, N) for path, K, N in model_matmuls(olmoe)}
    assert rows["layers/mlp/w_up"] == (olmoe.d_model, olmoe.d_ff)
    assert olmoe.n_experts > 1
    mamba = get_arch("mamba2-2.7b", reduced=True)
    got = PP.summarize(PP.get_policy("default_serve_mix"),
                       model_matmuls(mamba))
    assert got["counts"]["f16"] == 7 * mamba.n_layers
    assert got["params"]["f16"] == 0
    assert got["params"]["q2_k"] == mamba.d_model * mamba.vocab_size


# ---------------------------------------------------------------------------
# the matmul's on-chip budget
# ---------------------------------------------------------------------------

def test_budget_schedules_are_the_launchers():
    assert PB.schedules() == [(1, False), (2, False), (4, False), (8, False),
                              (8, True)]
    assert PB.vmem_bytes is PB.smem_bytes
    with pytest.raises(ValueError, match="schedule"):
        PB.smem_bytes("q2_k", 3)
    with pytest.raises(ValueError, match="schedule"):
        PB.smem_bytes("q2_k", 4, fold=True)


@pytest.mark.parametrize("variant", VARIANTS)
def test_budget_within_a_block(variant):
    rows = [r for r in PB.budget() if r["variant"] == variant]
    assert [(r["groups"], r["fold"]) for r in rows] == PB.schedules()
    for r in rows:
        assert r["static"] == 0
        assert 0 < r["total"] == r["dynamic"] <= SMEM_PER_BLOCK, r
        assert r["dynamic"] == max(r["staged"], r["out_tile"])
        assert r["staged"] == 2 * r["tile"] >= 2 * (r["x_tile"]
                                                     + r["w_packed_tile"])
        # the token tile's bf16 rows: 8 tokens a group, 264 values a row
        assert r["x_tile"] == r["tokens"] * 264 * 2
        assert "card" not in r
    # more tokens a tile, more shared memory; folding stages the same
    totals = [r["total"] for r in rows]
    assert totals[:4] == sorted(totals[:4]) and totals[3] == totals[4]


@pytest.mark.parametrize("variant", VARIANTS)
def test_budget_stages_each_payload(variant):
    """The staged rows of one 256-row tile of every payload the kernel
    reads (bytes a0.. then fp16 h0..) are the format's K // k_div rows,
    each of 128 columns: the source's Fmt table agrees with the format."""
    lay = PB._layout()
    fmt = lay["fmts"][PB._CODE_NAMES[variant]]
    byte_rows = [fmt[k] for k in ("kR0", "kR1", "kR2", "kR3") if fmt[k]]
    half_rows = [fmt[k] for k in ("kH0", "kH1") if fmt[k]]
    want_b, want_h = [], []
    for name, dtype, kdiv in PB._PAYLOADS[variant]:
        (want_h if dtype == torch.float16 else want_b).append(256 // kdiv)
    assert byte_rows == want_b and half_rows == want_h
    assert fmt["kSuper"] == PF.get_format(variant).super_block
    assert lay["consts"]["kBN"] == PB.BLOCK_N and lay["consts"]["kSB"] == \
        PB.SUPER_BLOCK


def test_kernel_attributes_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.kernel_attributes("q2_k", 1)


def test_summarize_small_and_ragged_tensors_match_reference():
    """Tensors below the quantization floor (K < 256, N < 32, K % 32 != 0)
    count as f16, a ragged K falls back to q8_0, extras add 2 bytes a
    value: as the reference's, on a hand inventory under every preset."""
    mms = [("layers/attn/wq", 256, 256), ("layers/attn/wk", 64, 64),
           ("layers/mlp/w_down", 2080, 256), ("lm_head", 256, 31),
           ("layers/attn/wv", 300, 64)]
    for name in sorted(PP.POLICIES):
        got = PP.summarize(PP.get_policy(name), mms, extra_f16=[("c", 10)])
        assert got == JP.summarize(JP.get_policy(name), mms,
                                   extra_f16=[("c", 10)]), name
