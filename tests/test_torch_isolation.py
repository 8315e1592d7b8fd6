"""The port stands alone: no JAX, nothing of the JAX package.

An AST scan of every module of ``src/repro_torch`` (the ``distributed``
package included) and of ``chip_smoke.py`` finds no import of ``jax`` and
none of ``repro`` (as against ``repro_torch``); the serving engine imports
in a fresh interpreter where ``import jax`` fails; a tensor-parallel
worker rank, spawned by its entry point and serving an engine, has
imported neither; and the entry points refuse to run without a GPU
unless the caller asks for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_reference_imports(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top != "jax" and top != "jaxlib", (path, mod)
        assert top != "repro", (path, mod)   # repro_torch's top is distinct


def test_engine_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.launch.policy_search, repro_torch.core.calibrate, "
            "repro_torch.core.quality, repro_torch.bridge, "
            "repro_torch.core.isa, repro_torch.launch.quickstart, "
            "repro_torch.benchmarks.shapes, repro_torch.serving.router, "
            "repro_torch.serving.disagg, repro_torch.serving.frontend, "
            "repro_torch.training.steps, repro_torch.training.loop, "
            "repro_torch.optim.adamw, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.ckpt, repro_torch.launch.train, "
            "repro_torch.distributed.sharding, repro_torch.distributed.group; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_engine_without_device_raises_where_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    from repro_torch.configs.base import get_arch
    from repro_torch.serving.engine import Engine, ServeConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(get_arch("tinyllama-1.1b", reduced=True), {}, ServeConfig())


def test_policy_entry_points_raise_where_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    from repro_torch.configs.base import get_arch
    from repro_torch.core import quality
    from repro_torch.launch import policy_search, serve
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        policy_search.search_policy(cfg, {}, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality.eval_tokens(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--policy",
                    "auto"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--disagg"])


def test_tp_worker_imports_neither_jax_nor_reference():
    """A worker rank (``distributed.group._worker_main``, spawned) that
    holds an engine and has served a request: its process imported no
    ``jax`` and no ``repro`` (this process may have: the tests do)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed.group import TPGroup, imported_top_modules
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, ServeConfig
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with TPGroup(2, "cpu", timeout_s=120.0) as group:
        scfg = ServeConfig(tp=2, max_new_tokens=2, cache_len=32)
        with Engine(cfg, params, scfg, device="cpu", group=group) as eng:
            eng.generate([[1, 2, 3]])
        mods = group.map(imported_top_modules, [(), ()])
    assert "repro_torch" in mods[0]
    assert "repro_torch" in mods[1] and "torch" in mods[1]
    assert "jax" not in mods[1] and "jaxlib" not in mods[1]
    assert "repro" not in mods[1]
