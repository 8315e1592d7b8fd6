"""``serve --policy auto`` on the MoE, ssm and hybrid families: the
port's ``search_policy`` against the reference's on reduced olmoe-1b-7b,
mamba2-2.7b and zamba2-1.2b, and the launcher's search and load branches
end to end on olmoe.

Both packages get the same calibration stats (the reference's, from the
same seeded tokens) and the same eval tokens, and score candidates with
``kernel_impl="ref"`` in an f32 model, as ``test_torch_policy_auto``
holds the dense search (``test_torch_embed_families.check_search``): the
seed's bytes equal and its KL within 1e-3, the final policy weakly
dominates the seed, and the final assignments are equal, or a tie under
the reference's own scores within 1e-3. On olmoe the candidates include
``q3_k_o``, whose stats tile over E*K on an expert stack; the recurrent
configs search the paper's two variants and float.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_embed_families import check_search
from repro.configs import base as JC
from repro.core import calibrate as JCAL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import base as PC
from repro_torch.launch import serve as PSERVE

torch.set_num_threads(2)

CANDIDATES = {"olmoe-1b-7b": ("q2_k", "q3_k", "q3_k_o", "none"),
              "mamba2-2.7b": ("q2_k", "q3_k", "none"),
              "zamba2-1.2b": ("q2_k", "q3_k", "none")}


@pytest.mark.parametrize("arch", sorted(CANDIDATES))
def test_search_policy_matches_reference(arch, monkeypatch):
    jc = dataclasses.replace(JC.get_arch(arch, reduced=True),
                             dtype="float32")
    pc = PC.get_arch(arch, reduced=True).replace(dtype="float32")
    npp = jax.tree.map(np.asarray, jax.jit(
        JT.init_params, static_argnums=0)(jc, jax.random.PRNGKey(0)))
    pp = bridge.from_jax_params(npp)
    rng = np.random.default_rng(3)
    tokens = [rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
              for _ in range(2)]
    js = JCAL.run_calibration(npp, jc, tokens=tokens)
    ev = rng.integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    info = check_search(jc, pc, npp, pp, js, ev, monkeypatch,
                        CANDIDATES[arch])
    assert info["evaluations"] > len(info["assignment"])


def test_launcher_policy_auto_on_moe(tmp_path, monkeypatch, capsys):
    """``--policy auto`` on reduced olmoe: the search runs, writes the
    file and serves; the same command then loads the file and serves the
    same tokens."""
    monkeypatch.chdir(tmp_path)
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--requests", "2", "--slots", "2", "--cache-len", "32",
            "--tokens", "3", "--policy", "auto", "--search-rounds", "1"]
    _, searched = PSERVE.main(argv)
    out = capsys.readouterr().out
    written = tmp_path / "results" / "auto_olmoe-1b-7b.json"
    assert "searched policy written to" in out and written.exists()
    assert "[final]" in out and out.count("req ") == 2
    _, loaded = PSERVE.main(argv)
    out = capsys.readouterr().out
    assert "loaded searched policy from" in out
    assert loaded == searched and all(len(t) == 3 for t in loaded.values())
