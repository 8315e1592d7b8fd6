"""``forward_seq(want_cache=True)`` and ``cache_from_prefill`` in the port
against the reference's, for every family (reduced configs, f32).

The payload (post-RoPE K/V a layer; ssm's final conv and SSM state;
hybrid's states and shared-block K/V) is held against the reference's at
1e-4 relative to its largest magnitude, ``test_torch_dense_family``'s
f32 bound; MoE's at 2**-8 (``test_torch_moe``'s f32 bound: its expert
products are bf16 in every dtype, so the layers after the first inherit
a bf16 ulp). The conversion is held on the same input: the reference's
payload, bridged, goes through the port's ``cache_from_prefill`` and
must give the reference's cache bit for bit (bf16 K/V, int8 codes and
their scales, positions), with the ring shorter than the prefill (S >=
T) and longer (S < T).

One reference quirk is not mirrored. Where S > T the reference keeps the
last T positions and rolls them by ``-((S - T) % T)``, which puts
position p in slot p % T only when (S - T) % T is 0 or T / 2; a decode
step at position S then overwrites a slot other than the oldest
position's. The port rolls by ``+((S - T) % T)``, so slot p % T holds
position p, as ``decode_step`` writes it: the same ring as the
reference's, rolled by 2 ((S - T) % T).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

TOL = 1e-4
TOL_MOE = 2.0 ** -8
ARCH_FOR = {"dense": "tinyllama-1.1b", "gpt2": "gpt2-paper",
            "moe": "olmoe-1b-7b", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-1.2b", "vlm": "qwen2-vl-72b",
            "audio": "musicgen-large"}
B, S = 2, 12


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(
        f"u{a.dtype.itemsize}")


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _prefill(family):
    """(reference config, the port's, reference payload as numpy, the
    port's payload)."""
    arch = ARCH_FOR[family]
    jc = JC.get_arch(arch, reduced=True).replace(dtype="float32")
    pc = PC.get_arch(arch, reduced=True).replace(dtype="float32")
    params = jax.jit(JT.init_params, static_argnums=0)(
        jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    if jc.embed_input:
        x = {"tokens": rng.integers(0, jc.vocab_size, (B, S)).astype(
            np.int32)}
    else:
        x = {"embeds": rng.standard_normal((B, S, jc.d_model)).astype(
            np.float32)}
    if jc.pos_emb == "mrope":
        t = np.arange(S)
        x["positions"] = np.broadcast_to(
            np.stack([t // 4, t % 4, (t * 3) % 5])[:, None],
            (3, B, S)).astype(np.int32)
    ref = jax.jit(lambda p, kw: JT.forward_seq(p, jc, want_cache=True,
                                               **kw)[2])(
        params, {k: jnp.asarray(v) for k, v in x.items()})
    pp = bridge.from_jax_params(jax.tree.map(np.asarray, params))
    _, _, got = PT.forward_seq(pp, pc, want_cache=True,
                               **{k: torch.from_numpy(v)
                                  for k, v in x.items()})
    return jc, pc, jax.tree.map(np.asarray, ref), got


@pytest.mark.parametrize("family", sorted(ARCH_FOR))
def test_cache_from_prefill_matches_reference(family):
    jc, pc, ref, got = _prefill(family)
    jleaves = jax.tree.leaves(ref)
    pleaves = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    assert [tuple(a.shape) for a in pleaves] == [a.shape for a in jleaves]
    tol = TOL_MOE if family == "moe" else TOL
    for a, b in zip(pleaves, jleaves):
        assert _rel(a.numpy(), b) <= tol
    bridged = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref)
    kv = family not in ("ssm", "hybrid")
    # S < T (padded), S == T, and S > T where the reference's roll puts
    # position p in slot p % T ((S - T) % T == T / 2)
    rings = (S + 4, S, 8) if kv else (S + 4, S)
    for quant in ((False, True) if kv else (False,)):
        jq = dataclasses.replace(jc, kv_cache_quant=quant)
        pq = pc.replace(kv_cache_quant=quant)
        for T in rings:
            want = JT.cache_from_prefill(jq, ref, S, cache_len=T)
            have = PT.cache_from_prefill(pq, bridged, S, cache_len=T)
            assert sorted(have) == sorted(want)
            for k in want:
                assert np.array_equal(_bits(_np(have[k])), _bits(want[k])), \
                    (T, quant, k)
            if kv:
                assert have["k"].dtype == (torch.int8 if quant
                                           else torch.bfloat16)
    if family == "hybrid":
        with pytest.raises(ValueError, match="longer than the cache"):
            PT.cache_from_prefill(pc, bridged, S, cache_len=S - 1)


@pytest.mark.parametrize("family", ["dense", "vlm"])
def test_ring_keeps_position_p_in_slot_p_mod_T(family):
    """S = 12 into T = 5 (the reference's quirk case): the last five
    positions stay, position p in slot p % T, its K/V the payload's at p;
    the reference's ring holds the same entries rolled by 2 (S - T) % T."""
    jc, pc, ref, got = _prefill(family)
    T = 5
    shift = (S - T) % T
    cache = PT.cache_from_prefill(pc, got, S, cache_len=T,
                                  dtype=torch.float32)
    pos = cache["pos"].numpy()
    for p in range(S - T, S):
        assert (pos[:, p % T] == p).all()
        assert torch.equal(cache["k"][:, :, p % T], got[0][:, :, p])
        assert torch.equal(cache["v"][:, :, p % T], got[1][:, :, p])
    want = JT.cache_from_prefill(jc, ref, S, cache_len=T,
                                 dtype=jnp.float32)
    assert np.array_equal(np.roll(np.asarray(want["pos"]), 2 * shift, 1),
                          pos)
    bridged = tuple(torch.from_numpy(np.array(a)) for a in ref)
    mine = PT.cache_from_prefill(pc, bridged, S, cache_len=T,
                                 dtype=torch.float32)
    for k in ("k", "v"):
        assert np.array_equal(np.roll(np.asarray(want[k]), 2 * shift, 2),
                              mine[k].numpy())
