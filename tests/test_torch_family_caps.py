"""The family capability table and its one validation pass in the port
(``repro_torch.models.state``), against the reference's
``repro.models.state``.

``CAPS`` equals the reference's row by row, ``KV_FAMILIES`` and
``FEATURES`` too; ``validate_serve_features`` returns the same row or
raises the reference's exact message for every family x feature cell, on
each family's reference config moved over by value. ``DecodeState``
asserts on a missing capability as the reference's does, and its
checkpoint methods delegate to the model for the recurrent families. The
engine runs the validation pass before anything else, so a recurrent
family asking for speculation gets the reference's ValueError; vlm and
audio, which take embeddings, not token ids, raise a ValueError naming
their stub frontend, and the recurrent ones construct. ``--policy auto``
on a MoE, ssm or hybrid arch no longer raises: its load branch packs
from a policy file (the search is held in
``test_torch_policy_auto_families``).
"""
import dataclasses
import json
import types

import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.models import state as JS
from repro_torch.configs.base import ModelConfig, get_arch
from repro_torch.core import qlinear as PL
from repro_torch.launch import serve as LS
from repro_torch.models import state as PS
from repro_torch.models import transformer as PT
from repro_torch.serving.engine import Engine, ServeConfig

# one reference arch per family, as the reference's test_family_caps.py
ARCH_FOR = {
    "dense": "llama3.2-1b",
    "gpt2": "gpt2-paper",
    "vlm": "qwen2-vl-72b",
    "audio": "musicgen-large",
    "moe": "granite-moe-3b-a800m",
    "ssm": "mamba2-2.7b",
    "hybrid": "zamba2-1.2b",
}
EMBEDDING_INPUT = ("vlm", "audio")
RECURRENT = ("ssm", "hybrid")
FEATURE_KW = {
    "tensor-parallel serving": dict(tp=2),
    "speculative decoding": dict(drafter=True),
    "prefix caching": dict(prefix_cache=True),
}


def _pair(family):
    """(reference reduced config, the same config in the port)."""
    j = j_get_arch(ARCH_FOR[family], reduced=True)
    return j, ModelConfig(**dataclasses.asdict(j))


def _ref_fields(row):
    """A port row's fields that the reference's rows have."""
    names = {f.name for f in dataclasses.fields(JS.FamilyCaps)}
    return {k: v for k, v in dataclasses.asdict(row).items() if k in names}


def test_caps_table_equals_reference_row_by_row():
    """Every reference field equal; the port's one extra field,
    ``capacity_follows_chunk``, is set for moe alone."""
    assert list(PS.CAPS) == list(JS.CAPS)
    for fam, row in JS.CAPS.items():
        assert _ref_fields(PS.CAPS[fam]) == dataclasses.asdict(row)
        assert PS.CAPS[fam].capacity_follows_chunk == (fam == "moe")
    assert ({f.name for f in dataclasses.fields(PS.FamilyCaps)}
            - {f.name for f in dataclasses.fields(JS.FamilyCaps)}
            == {"capacity_follows_chunk"})
    assert PS.KV_FAMILIES == JS.KV_FAMILIES
    assert PS.FEATURES == JS.FEATURES
    assert set(ARCH_FOR) == set(PS.CAPS)


def test_unknown_family_rejected():
    with pytest.raises(ValueError, match="unknown model family"):
        get_arch("olmoe-1b-7b", reduced=True).replace(family="rwkv")
    with pytest.raises(ValueError, match="unknown model family"):
        PS.family_caps(types.SimpleNamespace(family="rwkv"))


@pytest.mark.parametrize("family", sorted(ARCH_FOR))
@pytest.mark.parametrize("feature", sorted(FEATURE_KW))
def test_matrix_cell_matches_reference(family, feature):
    """Every cell: the same row back, or the reference's exact message."""
    jcfg, pcfg = _pair(family)
    kw = FEATURE_KW[feature]
    try:
        jrow = JS.validate_serve_features(jcfg, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as p:
            PS.validate_serve_features(pcfg, **kw)
        assert str(p.value) == str(e)
        assert f"{feature} needs a KV-ring family (got {family!r})" in str(e)
    else:
        row = PS.validate_serve_features(pcfg, **kw)
        assert _ref_fields(row) == dataclasses.asdict(jrow)
        assert row is PS.CAPS[family]
    assert PS.validate_serve_features(pcfg) is PS.CAPS[family]


def test_decode_state_asserts_on_missing_capability():
    """The ring methods assert on a recurrent row; the checkpoint methods
    assert on a KV row and, on a recurrent one, copy whole-state rows
    through the model (pool page 1 into batch row 0, then batch row 1
    into pool page 0)."""
    cfg = get_arch("mamba2-2.7b", reduced=True)
    ssm = PS.DecodeState(cfg)
    with pytest.raises(AssertionError):
        ssm.ring_snapshot({}, None)              # no ring to snapshot
    with pytest.raises(AssertionError):
        ssm.ring_rewind({}, {}, None, None)
    cache = ssm.init(2, 16, device="cpu")
    pool = ssm.page_pool(2, 16, device="cpu")
    for k in ("conv", "state"):
        pool[k][:, 1] = 3.0
        cache[k][:, 1] = 5.0
    assert ssm.scatter_checkpoints(cache, pool, [1], [0]) is cache
    assert ssm.insert_checkpoints(pool, cache, [1], [0]) is pool
    for k in ("conv", "state"):
        assert bool((cache[k][:, 0] == 3).all())
        assert bool((pool[k][:, 0] == 5).all())
    dense = PS.DecodeState(get_arch("tinyllama-1.1b", reduced=True))
    with pytest.raises(AssertionError):
        dense.scatter_checkpoints({}, {}, None, None)  # pages, not ckpts
    with pytest.raises(AssertionError):
        dense.insert_checkpoints({}, {}, None, None)


def test_decode_state_delegates_to_the_model():
    """A MoE DecodeState's cache, pages and page bytes are the model's."""
    cfg = get_arch("olmoe-1b-7b", reduced=True)
    st = PS.DecodeState(cfg)
    assert st.caps is PS.CAPS["moe"] and st.caps.expert_parallel
    cache = st.init(2, 16, device="cpu")
    ref = PT.init_cache(cfg, 2, 16, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == {
        k: (v.shape, v.dtype) for k, v in ref.items()}
    pool = st.page_pool(3, 4, device="cpu")
    assert pool["k"].shape == (cfg.n_layers, 3, 4, cfg.n_kv_heads,
                               cfg.d_head)
    assert st.page_bytes(4) == PT.cache_page_bytes(cfg, 4)


@pytest.mark.parametrize("family", EMBEDDING_INPUT + RECURRENT)
def test_engine_rejects_unported_families(family):
    """vlm and audio, whose params have no token embedding, raise a
    ValueError naming their stub frontend (the model itself is ported:
    ``init_params`` makes its tree); the recurrent families construct,
    with their capability row, a chunk clamped to a divisor of the ring
    and the page pinned to it."""
    _, cfg = _pair(family)
    if family in EMBEDDING_INPUT:
        params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        assert "wte" not in params
        with pytest.raises(ValueError, match="stub modality frontend"):
            Engine(cfg, params, ServeConfig(), device="cpu")
        return
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = Engine(cfg, params, ServeConfig(cache_len=60, prefill_chunk=16,
                                          prefix_cache=True, prefix_page=4),
                 device="cpu")
    assert eng._caps is PS.CAPS[family] and eng._caps.recurrent
    assert eng._chunk == eng._page == 15        # 60 % 16 != 0


def test_engine_validates_features_first():
    """As the reference's engine: the one validation pass runs at
    construction, before the port's family check."""
    _, cfg = _pair("ssm")
    with pytest.raises(ValueError,
                       match="speculative decoding needs a KV-ring family"):
        Engine(cfg, {}, ServeConfig(drafter="ngram"), device="cpu")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m",
                                  "mamba2-2.7b", "zamba2-1.2b"])
def test_policy_auto_on_moe_raises(arch, tmp_path):
    """The refusal is gone: ``resolve_policy``'s load branch returns the
    file's policy for every arch (no calibration without a q3_k_o rule),
    and it packs."""
    cfg = get_arch(arch, reduced=True)
    path = tmp_path / "mix.json"
    path.write_text(json.dumps({"name": "mix", "default": "q3_k",
                                "rules": [["*lm_head*", "q2_k"]]}))
    params = PT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    pol, calib, info = LS.resolve_policy(cfg, params, policy="auto",
                                         arch=arch, policy_json=str(path),
                                         device="cpu")
    assert pol.rules == (("*lm_head*", "q2_k"),) and pol.default == "q3_k"
    assert calib is None and info is None
    _, report = PL.quantize_params(params, pol)
    assert report["lm_head"] == "q2_k"
