"""The engine's schedule-fuzz contract over the port's tensor-parallel
engines, on CPU gloo groups (``tests/test_engine_fuzz.py``'s TP axes,
which skip in the reference's one-device run; here they run).

The randomized wave schedules of ``test_torch_engine_fuzz.py`` (ragged
submits, queued cancels, speculation toggles) go through:

* a "padded" engine at tp = 2 and 4, batched, against the tp = 1
  sequential engine: "padded" keeps the single-device product shapes, so
  every schedule agrees token for token, speculation included;
* "sliced" and "sliced_row" at tp = 2, batched against the same datapath
  at tp = 2 sequential (the datapaths agree with tp = 1 only to
  tolerances; batched admission is exact within one datapath);
* a 1P+1D ``DisaggEngine`` at tp = 2, both tiers on one group, against
  the tp = 1 sequential engine.

Engines share one process group of each size (``GroupCache``); each
example builds its engines on it and closes them. Ranks run one thread
each, and so does this process while the module runs.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs.base import get_arch
from repro_torch.distributed.group import GroupCache
from repro_torch.serving.disagg import DisaggEngine
from repro_torch.serving.engine import Engine, ServeConfig
from test_torch_engine_fuzz import BASE, SPEC, drive_waves, init_params

TIMEOUT_S = 120.0
TP_BASE = dict(BASE, **SPEC)


@pytest.fixture(scope="module")
def groups():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cache = GroupCache(lambda n: ["cpu"] * n, timeout_s=TIMEOUT_S)
    yield cache
    cache.close()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    """Stock reduced tinyllama (KH = 2): tp = 2 shards attention and the
    MLP, tp = 4 replicates attention and shards the MLP."""
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    return cfg, init_params(cfg)


def _engine(model, groups, tp, batch, **kw):
    cfg, params = model
    return Engine(cfg, params, ServeConfig(prefill_batch=batch, tp=tp,
                                           **dict(TP_BASE, **kw)),
                  device="cpu", group=groups.get(tp) if tp > 1 else None)


@pytest.mark.parametrize("mm", ["sliced", "sliced_row"])
@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2**20))
def test_fuzz_schedule_parity_tp2_sliced(model, groups, mm, seed):
    """Within one sliced datapath batched and sequential runs differ only
    in the products' row counts, which the port computes row by row."""
    with _engine(model, groups, 2, 3, tp_matmul=mm) as batched, \
            _engine(model, groups, 2, 1, tp_matmul=mm) as seq:
        drive_waves(model[0], batched, seq, np.random.default_rng(seed))


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**20))
def test_fuzz_disagg_tp2_against_sequential(model, groups, seed):
    """1P+1D at tp = 2 on one group (prefill_batch 3) against tp = 1 one
    request at a time: the hand-off gathers and splits the kv heads, and
    the routed tokens are still the sequential engine's."""
    cfg, params = model
    scfg = ServeConfig(prefill_batch=3, tp=2, prefix_page=8, **TP_BASE)
    with DisaggEngine(cfg, params, scfg, device="cpu",
                      group=groups.get(2)) as dis, \
            _engine(model, groups, 1, 1) as seq:
        drive_waves(cfg, dis, seq, np.random.default_rng(seed))


@pytest.mark.parametrize("tp", [2, 4])
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**20))
def test_fuzz_schedule_parity_under_tp(model, groups, tp, seed):
    with _engine(model, groups, tp, 3) as batched, \
            _engine(model, groups, 1, 1) as seq:
        drive_waves(model[0], batched, seq, np.random.default_rng(seed))
