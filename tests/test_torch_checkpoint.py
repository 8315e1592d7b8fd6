"""The port's checkpointing and fault-tolerant loop: the reference's
``tests/test_checkpoint.py`` ported, and checkpoints crossing between the
two packages.

Both packages write ``step_<N>/process_0.npz`` + ``MANIFEST`` with the
same ``\\x1d``-joined sorted keys, so an f32 train state written by one
restores in the other bit for bit. bf16 leaves are stored as 2-byte
void arrays, as ``np.savez`` stores the reference's own bf16 leaves, and
the port reads those back as bf16 bit for bit.

Resume: 6 steps straight against 3 + restart + 3 end on the same loss
within 1e-4, the reference's own bound (on the CPU both runs are the
same ops on the same inputs, so the bits agree).
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as JCheckpointer
from repro.configs import base as JC
from repro.optim import adamw as JA
from repro.training import steps as JS
from repro_torch import bridge
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs.base import get_arch
from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map
from repro_torch.training.loop import run_training

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn(8, 8, generator=g),
                  "b": torch.arange(3)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal_trees(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
        return
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    b = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(5, t)
    step, r = ck.restore_latest()
    assert step == 5
    _equal_trees(t, r)
    assert (tmp_path / "step_5" / "process_0.npz").is_file()
    manifest = (tmp_path / "step_5" / "MANIFEST").read_text()
    assert manifest.startswith("step=5\nprocesses=1\n")


def test_async_save_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _tree(s))
    ck.wait()
    assert ck.all_steps() == [3, 4]
    _equal_trees(ck.restore(4), _tree(4))


def test_async_save_copies_before_returning(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = t["a"]["w"].clone()
    ck.save_async(1, t)
    t["a"]["w"].fill_(0)            # the next step may reuse the memory
    ck.wait()
    assert torch.equal(ck.restore(1)["a"]["w"], want)


def test_torn_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    # simulate a torn write: step dir without MANIFEST
    os.makedirs(tmp_path / "step_9")
    np.savez(tmp_path / "step_9" / "process_0.npz", x=np.zeros(3))
    os.makedirs(tmp_path / "step_12.tmp")
    step, _ = ck.restore_latest()
    assert step == 1


def test_bf16_leaves_round_trip(tmp_path):
    t = {"m": torch.randn(5, 3).to(torch.bfloat16),
         "v": torch.rand(4).to(torch.bfloat16), "step": torch.tensor(2)}
    ck = Checkpointer(str(tmp_path))
    ck.save(2, t)
    _equal_trees(ck.restore(2), t)
    with np.load(tmp_path / "step_2" / "process_0.npz") as z:
        assert z["m"].dtype == np.dtype("V2")


def test_reference_bf16_leaves_restore_as_bf16(tmp_path):
    x = jnp.asarray(np.random.default_rng(0).standard_normal((6, 2)),
                    jnp.bfloat16)
    JCheckpointer(str(tmp_path)).save(3, {"opt": {"m": x}})
    got = Checkpointer(str(tmp_path)).restore(3)["opt"]["m"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(x).view(np.int16))


def _ref_train_state():
    cfg = JC.get_arch("tinyllama-1.1b", reduced=True)
    opt = JA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = JS.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    step = jax.jit(JS.make_train_step(cfg, opt))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    state, _ = step(state, batch)           # moments not zero
    return jax.tree.map(np.asarray, state)


def test_f32_train_state_crosses_between_the_packages(tmp_path):
    ref = _ref_train_state()
    JCheckpointer(str(tmp_path / "jax")).save(1, ref)
    step, got = Checkpointer(str(tmp_path / "jax")).restore_latest()
    assert step == 1
    _equal_trees(got, bridge.from_jax_params(ref))
    assert got["opt"]["step"].dtype == torch.int32

    Checkpointer(str(tmp_path / "torch")).save(1, got)
    step, back = JCheckpointer(str(tmp_path / "torch")).restore_latest()
    assert step == 1
    flat_ref = jax.tree.leaves(ref)
    flat_back = jax.tree.leaves(back)
    assert len(flat_ref) == len(flat_back)
    for a, b in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_resume_continues_bit_identical(tmp_path):
    """Train 6 steps straight vs 3 + restart + 3: identical final loss
    (checkpoint/restart fault tolerance + deterministic data)."""
    cfg = get_arch("llama3.2-1b", reduced=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    kw = dict(global_batch=4, seq_len=32, opt=opt, seed=3,
              log_fn=lambda *_: None, device="cpu")
    res_a = run_training(cfg, steps=6, **kw)

    d1 = tmp_path / "resume"
    run_training(cfg, steps=3, ckpt_dir=str(d1), ckpt_every=3, **kw)
    res_b2 = run_training(cfg, steps=6, ckpt_dir=str(d1), ckpt_every=3,
                          **kw)
    assert len(res_b2["losses"]) == 3          # resumed from step 3
    assert abs(res_a["losses"][-1] - res_b2["losses"][-1]) < 1e-4
    for a, b in zip(tree_leaves(res_a["state"]),
                    tree_leaves(res_b2["state"])):
        assert torch.equal(a, b)


def test_restore_onto_the_device_asked_for(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    got = ck.restore(1, device=torch.device("cpu"))
    assert all(x.device.type == "cpu" for x in tree_leaves(got))
    assert tree_map(lambda x: x.dtype, got)["step"] == torch.int32


PREEMPT_ARGS = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                "--steps", "100", "--batch", "4", "--seq", "32", "--lr",
                "1e-3", "--warmup", "2", "--ckpt-every", "5", "--seed", "3"]


def test_sigterm_preemption_saves_and_resumes(tmp_path):
    """The launcher in a subprocess, preempted after step 10: it saves
    and says so; a restart finishes the remaining steps."""
    ckdir = str(tmp_path / "pre")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *PREEMPT_ARGS,
         "--ckpt-dir", ckdir], cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.time()
        saw_step = False
        while time.time() - t0 < 120:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("step "):
                saw_step = True
            if line.startswith("step    10"):
                break
        assert saw_step
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert "[preempt] SIGTERM at step" in out
    steps = Checkpointer(ckdir).all_steps()
    assert steps, "preemption must leave a checkpoint"
    assert steps[-1] < 100
    # restart completes from the saved step
    cfg = get_arch("llama3.2-1b", reduced=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    res = run_training(cfg, steps=100, global_batch=4, seq_len=32, opt=opt,
                       ckpt_dir=ckdir, ckpt_every=50, seed=3,
                       log_fn=lambda *_: None, device="cpu")
    assert len(res["losses"]) == 100 - steps[-1]
    assert Checkpointer(ckdir).all_steps()[-1] == 100


def test_sigterm_handler_restored():
    before = signal.getsignal(signal.SIGTERM)
    cfg = get_arch("llama3.2-1b", reduced=True)
    run_training(cfg, steps=1, global_batch=2, seq_len=8,
                 log_fn=lambda *_: None, device="cpu")
    assert signal.getsignal(signal.SIGTERM) is before


TWO_PROCESS_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.data.pipeline import DataConfig, DataPipeline


def worker(rank, addr, out):
    dist.init_process_group("gloo", init_method=addr, rank=rank,
                            world_size=2)
    try:
        cfg = DataConfig(vocab_size=512, seq_len=8, global_batch=6, seed=4)
        rows = DataPipeline(cfg).batch(2)["tokens"]
        np.save(f"{out}/rows_{rank}.npy", rows)
        # each process on its own directory, as each host of a pod on its
        # own disk: the layout does not coordinate writers of one directory
        ck = Checkpointer(f"{out}/ck{rank}")
        ck.save(1, {"w": torch.full((2,), float(rank))})
        assert float(ck.restore(1)["w"][0]) == rank
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(sys.argv[1], sys.argv[2]), nprocs=2)
"""


def test_two_processes_split_rows_and_write_their_own_files(tmp_path):
    """Under torch.distributed (gloo, two processes on this host) each
    process gets its rows of the global batch, and saves and restores its
    own ``process_<rank>.npz`` under a MANIFEST that counts both."""
    import socket
    from repro.data import pipeline as JD
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "two.py"
    script.write_text(TWO_PROCESS_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script),
                          f"tcp://127.0.0.1:{port}", str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    whole = JD.DataPipeline(JD.DataConfig(vocab_size=512, seq_len=8,
                                          global_batch=6, seed=4)).batch(2)
    for rank in (0, 1):
        got = np.load(tmp_path / f"rows_{rank}.npy")
        assert np.array_equal(got, whole["tokens"][3 * rank:3 * rank + 3])
        step_dir = tmp_path / f"ck{rank}" / "step_1"
        assert sorted(p.name for p in step_dir.iterdir()) == [
            "MANIFEST", f"process_{rank}.npz"]
        assert "processes=2" in (step_dir / "MANIFEST").read_text()
