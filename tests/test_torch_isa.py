"""The port's micro-ISA driver and simulator against the reference.

The driver's opcode stream (``generate_stream``: opcodes, config
registers, tile ranges, ``n_sbs``) and the simulator's byte-traffic model
(``SimStats``) must equal the reference's exactly; ``qtensor_tile`` must
cut the same bytes. The simulator's output is held against the
reference's at 1e-5 relative to the output's max, the reference's own
``test_isa.py`` tolerance (the integer dots are exact on both sides; the
f32 rescaling and sums may round in another order). The shapes are the
paper models' reduced MatMuls (``benchmarks.shapes.model_matmuls``). The
simulator runs on the CPU here (``device="cpu"``), where SCHEDULE's Q8_K
quantization is the kernel's plain version. The five tests of
``tests/test_isa.py`` are ported at the end, and the quickstart runs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.shapes import model_matmuls as j_model_matmuls
from repro.configs.base import get_arch as j_get_arch
from repro.core import isa as JI
from repro.core import quantize as JQ
from repro_torch.benchmarks.shapes import model_matmuls
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.core import isa as PI
from repro_torch.core import quantize as PQ
from repro_torch.kernels import ref as PR
from repro_torch.launch import quickstart

torch.set_num_threads(2)

TOL = 1e-5
# plans: the driver's default (whole input, one K tile per weight tile),
# and forced tiling (input streamed per tile, K split, small tiles)
PLANS = {"default": {},
         "tiled": dict(input_buf_bytes=100, weight_buf_bytes=6000,
                       tile_m=3, tile_n=64)}


def _insn(i):
    d = dataclasses.asdict(i)
    d["op"] = int(i.op)
    return d


def _packed(variant, K, N, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.2).astype(np.float32)
    pt = PQ.quantize(variant, torch.from_numpy(w))
    jt = JQ.QTensor(variant, (K, N),
                    {k: jnp.asarray(v.numpy()) for k, v in pt.data.items()})
    return pt, jt


def _reduced_shapes():
    """Every (K, N) of the reduced inventories, but the zero-width ones:
    the inventory (the reference's too) lists an attention-free config's
    absent attention and MLP at N = 0 or K = 0 (mamba2-2.7b has
    ``n_heads=0``, ``d_ff=0``), which no instruction stream tiles."""
    seen = []
    for arch in ARCH_IDS:
        for _, K, N in model_matmuls(get_arch(arch, reduced=True)):
            if K and N and (K, N) not in seen:
                seen.append((K, N))
    return seen


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_model_matmuls_match_reference(arch, reduced):
    assert (model_matmuls(get_arch(arch, reduced=reduced))
            == j_model_matmuls(j_get_arch(arch, reduced=reduced)))


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("variant", ["q2_k", "q3_k"])
def test_stream_equals_reference(plan, variant):
    """Instruction by instruction, for M = 1, 4 and 130 (past one 128-row
    output tile) over every reduced paper-model shape."""
    for K, N in _reduced_shapes():
        for M in (1, 4, 130):
            pp = PI.plan_tiling(M, K, N, variant, **PLANS[plan])
            jp = JI.plan_tiling(M, K, N, variant, **PLANS[plan])
            assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
            ps = PI.generate_stream(M, K, N, variant, pp)
            js = JI.generate_stream(M, K, N, variant, jp)
            assert list(map(_insn, ps)) == list(map(_insn, js)), (M, K, N)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("variant", ["q2_k", "q3_k", "q4_k"])
def test_sim_matches_reference(plan, variant):
    """SimStats equal exactly and the outputs agree, on the integer
    datapath (q2_k, q3_k) and the dequant datapath (q4_k)."""
    M, K, N = 6, 512, 160
    pt, jt = _packed(variant, K, N, 5)
    x = np.random.default_rng(6).standard_normal((M, K)).astype(np.float32)
    kw = PLANS[plan]
    po, ps = PI.run_matmul(x, pt, PI.plan_tiling(M, K, N, variant, **kw),
                           device="cpu")
    jo, js = JI.run_matmul(x, jt, JI.plan_tiling(M, K, N, variant, **kw))
    assert dataclasses.asdict(ps) == dataclasses.asdict(js)
    assert ps.total_stream_bytes == js.total_stream_bytes
    assert po.shape == (M, N) and po.dtype == torch.float32
    assert float(np.abs(po.numpy() - jo).max() / np.abs(jo).max()) <= TOL


@pytest.mark.parametrize("variant", ["q2_k", "q3_k"])
def test_qtensor_tile_byte_equal(variant):
    pt, jt = _packed(variant, 768, 96, 7)
    for k0, k1, n0, n1 in ((256, 768, 32, 64), (0, 256, 0, 96),
                           (512, 768, 80, 96)):
        p = PI.qtensor_tile(pt, k0, k1, n0, n1)
        j = JI.qtensor_tile(jt, k0, k1, n0, n1)
        assert p.shape == j.shape and p.nbytes == j.nbytes
        for k in j.data:
            a, b = np.asarray(j.data[k]), p.data[k].numpy()
            assert a.shape == b.shape
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k
    with pytest.raises(ValueError, match="super-block"):
        PI.qtensor_tile(pt, 128, 768, 0, 96)


# -- the reference's tests/test_isa.py, ported --------------------------------

def _setup(variant="q2_k", M=24, K=512, N=192, key=0):
    rng = np.random.default_rng(key)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = PQ.quantize(variant, torch.from_numpy(
        (rng.standard_normal((K, N)) * 0.2).astype(np.float32)))
    return x, w


def test_stream_structure_follows_paper():
    """CONFIG first; whole-input load when it fits; output-stationary
    LOAD_W/SCHEDULE sweeps; STORE per output tile."""
    plan = PI.plan_tiling(24, 512, 192, "q2_k", input_buf_bytes=1 << 30,
                          tile_n=64)
    stream = PI.generate_stream(24, 512, 192, "q2_k", plan)
    assert stream[0].op == PI.Op.CONFIG
    assert stream[0].weight_type == "q2_k"
    assert stream[1].op == PI.Op.LOAD_I        # input fits -> sent once
    kinds = [i.op for i in stream]
    assert kinds.count(PI.Op.STORE) == 3       # N/64 x M/128 output tiles
    assert PI.Op.SCHEDULE in kinds


def test_sim_matches_integer_reference():
    x, w = _setup("q2_k")
    out, stats = PI.run_matmul(x, w, device="cpu")
    expect = PR.matmul_q8k_ref(PQ.quantize_q8_k(torch.from_numpy(x)), w)
    assert float((out - expect).abs().max() / expect.abs().max()) <= TOL
    assert stats.schedules >= 1


@pytest.mark.parametrize("variant", ["q2_k", "q3_k"])
def test_sim_tiled_equals_untiled(variant):
    """Output-stationary tiling must not change results (paper §III-C)."""
    x, w = _setup(variant, M=40, K=768, N=160)
    plan_small = PI.plan_tiling(40, 768, 160, variant,
                                input_buf_bytes=100,   # forces tiling
                                weight_buf_bytes=60000,
                                tile_m=16, tile_n=64)
    assert not plan_small.whole_input
    out_t, stats_t = PI.run_matmul(x, w, plan_small, device="cpu")
    out_u, _ = PI.run_matmul(x, w, device="cpu")
    assert float((out_t - out_u).abs().max() / out_u.abs().max()) <= TOL
    assert stats_t.schedules > 1


def test_sim_rejects_wrong_weight_type():
    x, w = _setup("q2_k")
    stream = PI.generate_stream(24, 512, 192, "q3_k")
    sim = PI.FBFQSimulator(torch.from_numpy(x), w)
    with pytest.raises(ValueError, match="weight_type"):
        sim.run(stream)


def test_stream_byte_accounting():
    """Weight stream bytes == packed tensor bytes when each tile is sent
    once (the accelerator's bandwidth model)."""
    x, w = _setup("q3_k", M=16, K=512, N=128)
    plan = PI.plan_tiling(16, 512, 128, "q3_k", tile_m=16, tile_n=128)
    _, stats = PI.run_matmul(x, w, plan, device="cpu")
    assert stats.weight_bytes == w.nbytes
    assert stats.output_bytes == 16 * 128 * 4


def test_qtensor_tile_slicing():
    _, w = _setup("q3_k", K=768, N=96)
    t = PI.qtensor_tile(w, 256, 768, 32, 64)
    assert t.shape == (512, 32)
    full = PQ.dequantize(w)
    part = PQ.dequantize(t)
    assert torch.equal(part, full[256:768, 32:64])


def test_quickstart_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.quickstart --device cpu``: the
    reference example's lines, with the integer datapath within the Q8_K
    rounding of the oracle and the simulator's two schedules."""
    quickstart.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 8
    for variant, block in zip(("q2_k", "q3_k"), (lines[:4], lines[4:])):
        assert all(ln.startswith(f"[{variant}] ") for ln in block)
        assert "packed 2.00 MiB fp32" in block[0]
        assert float(block[1].rsplit(" ", 1)[1]) < 1e-2   # bf16 rounding
        assert float(block[2].rsplit(" ", 1)[1]) < 2e-2   # Q8_K rounding
        assert "ISA sim: 2 schedules" in block[3]


def test_quickstart_without_device_raises_where_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
