"""The port's compressed gradient all-reduce against the reference's.

Holds ``repro_torch.distributed.compress.compressed_psum`` (4 gloo ranks
on the CPU, a ``TPGroup``) against ``repro.distributed.compress.
compressed_psum`` (src/repro/distributed/compress.py:31) on a 4-device
host mesh in a subprocess, each device holding its own gradients (made
from a seed with numpy): two steps, the second fed the first's error
state.

Tolerance: the error-feedback state is computed on each rank alone (an
f32 add, a cast to bf16 and back, a subtraction), so it must match bit
for bit; so, then, do the four bf16 wire values w_r of every element.
The reduced mean sums them: gloo adds them in its own order and rounds
each partial sum to bf16, XLA in its own. Each of the three additions
rounds by at most 2^-8 of its partial sum, at most (1 + 2^-7) sum_r |w_r|
of that element, so either sum is within 3 * 2^-8 * (1 + 2^-7) sum_r
|w_r| of the exact one. Per element, then, the two means differ by at
most 1.5 * 2^-8 * (1 + 2^-7) sum_r |w_r|, held here as 2^-7 sum_r |w_r|,
and each lies within 2^-8 sum_r |w_r| of the exact mean of the wire
values. Both bounds are the element's own, so a rank's term cannot hide
behind another rank's larger gradients elsewhere in the tensor.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.distributed.compress import compressed_psum, wire_bytes
from repro_torch.distributed.group import TPGroup

REPO = Path(__file__).resolve().parent.parent
N_RANKS = 4
SHAPES = {"w": (64, 48), "b": (48,), "emb": (7, 33)}

REF = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, "src")
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.distributed.compress import compressed_psum
n = int(sys.argv[1]); shapes = json.loads(sys.argv[2]); out = sys.argv[3]
mesh = jax.make_mesh((n,), ("data",), axis_types=(AxisType.Auto,))
sh = NamedSharding(mesh, P())
def per_device(arrs):
    return jax.make_array_from_single_device_arrays(
        arrs[0].shape, sh, [jax.device_put(a, d)
                            for a, d in zip(arrs, mesh.devices.flat)])
def grads(step):
    rs = [np.random.default_rng(1000 * step + r) for r in range(n)]
    return {k: [(rs[r].standard_normal(s) * 10.0 ** rs[r].integers(-3, 3))
                .astype(np.float32) for r in range(n)]
            for k, s in shapes.items()}
res = {}
err = None
for step in range(2):
    g = {k: per_device(v) for k, v in grads(step).items()}
    red, err = compressed_psum(g, mesh, error=err)
    for k in shapes:
        res[f"red{step}_{k}"] = [np.asarray(s.data) for s in
                                 red[k].addressable_shards]
        res[f"err{step}_{k}"] = [np.asarray(s.data) for s in
                                 err[k].addressable_shards]
np.savez(out, **{k: np.stack(v) for k, v in res.items()})
"""


def _grads(step, r):
    rng = np.random.default_rng(1000 * step + r)
    return {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 3))
            .astype(np.float32) for k, s in SHAPES.items()}


def test_compressed_psum_matches_reference(tmp_path):
    out = tmp_path / "ref.npz"
    env = dict(os.environ, XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={N_RANKS}"),
        JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF, str(N_RANKS),
                        json.dumps(SHAPES), str(out)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(out))

    with TPGroup(N_RANKS, "cpu", timeout_s=120.0) as group:
        errs = [None] * N_RANKS
        for step in range(2):
            args = [({k: torch.from_numpy(v) for k, v in
                      _grads(step, rk).items()}, None, torch.bfloat16,
                     errs[rk]) for rk in range(N_RANKS)]
            got = group.map(compressed_psum, args)
            errs = [e for _, e in got]
            for k in SHAPES:
                wire = np.stack([torch.from_numpy(
                    (_grads(step, rk)[k] + (0 if step == 0 else
                     ref[f"err0_{k}"][rk])).astype(np.float32)).to(
                        torch.bfloat16).to(torch.float32).numpy()
                    for rk in range(N_RANKS)]).astype(np.float64)
                scale = np.abs(wire).sum(axis=0)
                exact = wire.sum(axis=0) / N_RANKS
                for rk in range(N_RANKS):
                    red, err = got[rk][0][k].numpy(), got[rk][1][k].numpy()
                    assert red.dtype == np.float32
                    np.testing.assert_array_equal(
                        err, ref[f"err{step}_{k}"][rk])
                    assert np.all(np.abs(red - ref[f"red{step}_{k}"][rk])
                                  <= 2.0 ** -7 * scale), (step, k, rk)
                    assert np.all(np.abs(red - exact)
                                  <= 2.0 ** -8 * scale), (step, k, rk)
                    # every rank holds the same mean
                    np.testing.assert_array_equal(red,
                                                  got[0][0][k].numpy())


def test_error_feedback_single_rank_steps():
    """One rank: the mean is bf16(g) and g = mean + error; a second step
    fed that error gives back the residual (the reference's own check)."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        g = {"w": torch.tensor([[1.0004883, -2.0], [0.5, 3.141592]])}
        red, err = compressed_psum(g)
        torch.testing.assert_close(
            red["w"], g["w"].to(torch.bfloat16).to(torch.float32),
            rtol=0, atol=0)
        torch.testing.assert_close(red["w"] + err["w"], g["w"], rtol=1e-6,
                                   atol=0)
        red2, err2 = compressed_psum(g, error=err)
        torch.testing.assert_close(red2["w"] + err2["w"], g["w"] + err["w"],
                                   rtol=1e-5, atol=0)
        assert wire_bytes(g) == 4 * 2
    finally:
        dist.destroy_process_group()
