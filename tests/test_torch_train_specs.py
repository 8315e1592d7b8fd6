"""The port's training-side shard rules against the reference's.

Holds ``repro_torch.distributed.sharding`` (``param_specs``,
``opt_state_specs``, ``batch_specs``, ``cache_specs``, ``tp_off``,
``activation_axes``, ``constrain``) against
``repro.distributed.sharding`` (src/repro/distributed/sharding.py:40-420),
``repro_torch.configs.base.input_specs`` against
src/repro/configs/base.py:161 and ``repro_torch.core.qlinear.
spec_like_quantized`` against src/repro/core/qlinear.py:122. Every arch at
full width, built without allocation (the reference's ``eval_shape``
tree, the port's meta tree), on both production meshes and two small
ones, with FSDP on and off, inside and outside ``tp_off``, under every
``kv_shard`` mode, and packed under ``default_serve_mix``. The reference's
rules read only axis names and sizes, so its meshes are ``AbstractMesh``es:
no devices, no subprocess.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as JC
from repro.core.policy import get_policy as j_get_policy
from repro.core.qlinear import spec_like_quantized as j_spec_like_quantized
from repro.core.quantize import QTensor as JQTensor
from repro.distributed import sharding as JSH
from repro.models import transformer as JT
from repro_torch.configs import base as PC
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import spec_like_quantized
from repro_torch.core.quantize import QTensor
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as PT

torch.set_num_threads(2)

MESHES = ((("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (4, 4)),
          (("pod", "data", "model"), (2, 2, 4)))
KV_MODES = ("auto", "heads", "head_dim", "seq", "replicated")


def _meshes():
    for names, sizes in MESHES:
        yield AbstractMesh(sizes, names), SH.MeshShape(names, sizes)


def _roles():
    """(reference context, port context) pairs: TP on, then tp_off."""
    import contextlib
    yield contextlib.nullcontext(), contextlib.nullcontext()
    yield JSH.tp_off(), SH.tp_off()


_J_SDS = {}


def _j_params(arch):
    if arch not in _J_SDS:
        cfg = JC.get_arch(arch)
        _J_SDS[arch] = jax.eval_shape(
            lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
    return _J_SDS[arch]


def _p_params(arch):
    return PT.init_params(PC.get_arch(arch), torch.Generator(),
                          device="meta")


def _np_dtype(t):
    return np.dtype(str(t).replace("torch.", ""))


def _same_shapes(j, p, path=""):
    if isinstance(j, dict):
        assert sorted(j) == sorted(p), path
        for k in j:
            _same_shapes(j[k], p[k], f"{path}/{k}")
        return
    if isinstance(j, JQTensor):
        assert isinstance(p, QTensor), path
        assert (j.variant, tuple(j.shape)) == (p.variant, tuple(p.shape)), \
            path
        assert sorted(j.data) == sorted(p.data), path
        for k in j.data:
            assert tuple(j.data[k].shape) == tuple(p.data[k].shape), \
                f"{path}:{k}"
            assert np.dtype(j.data[k].dtype) == _np_dtype(p.data[k].dtype), \
                f"{path}:{k}"
        return
    assert tuple(j.shape) == tuple(p.shape), path


def _same_specs(j, p, path=""):
    if isinstance(j, dict):
        assert sorted(j) == sorted(p), path
        for k in j:
            _same_specs(j[k], p[k], f"{path}/{k}")
        return
    if isinstance(j, JQTensor):
        assert isinstance(p, SH.QSpec), path
        assert (j.variant, tuple(j.shape)) == (p.variant, p.shape), path
        assert {k: tuple(v) for k, v in j.data.items()} == p.data, path
        return
    assert tuple(j) == tuple(p), f"{path}: {tuple(j)} != {p}"


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_param_and_opt_specs(arch):
    """Float parameters at full width: the meta tree has the reference's
    shapes, and every leaf's spec is the reference's on four meshes, with
    FSDP on and off, with TP and under tp_off; the optimizer state's
    specs follow."""
    j, p = _j_params(arch), _p_params(arch)
    _same_shapes(j, p)
    for jm, pm in _meshes():
        for (jc, pc) in _roles():
            with jc, pc:
                for fsdp in (True, False):
                    js = JSH.param_specs(j, jm, fsdp=fsdp)
                    ps = SH.param_specs(p, pm, fsdp=fsdp)
                    _same_specs(js, ps, f"{arch} {pm} fsdp={fsdp}")
                    jo, po = JSH.opt_state_specs(js), SH.opt_state_specs(ps)
                    _same_specs(jo["m"], po["m"])
                    assert tuple(jo["step"]) == po["step"]


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_quantized_specs(arch):
    """``spec_like_quantized`` under default_serve_mix: the same QTensors,
    payload for payload (shape and dtype, E*K-stacked experts included),
    and the same payload specs (lanes, or whole super-blocks of K rows)
    on every mesh, with TP and under tp_off."""
    j = j_spec_like_quantized(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, np.float32),
                     _j_params(arch)), j_get_policy("default_serve_mix"))
    p = spec_like_quantized(_p_params(arch), get_policy("default_serve_mix"))
    _same_shapes(j, p)
    n_q = sum(isinstance(v, QTensor) for v in _leaves(p))
    assert n_q > 0
    for jm, pm in _meshes():
        for jc, pc in _roles():
            with jc, pc:
                _same_specs(JSH.param_specs(j, jm, fsdp=False),
                            SH.param_specs(p, pm, fsdp=False),
                            f"{arch} {pm}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", PC.ARCH_IDS)
def test_cache_specs(arch):
    """Decode caches at decode_32k (B = 128) and long_500k (B = 1, the
    sequence over dp), with and without the int8 KV ring, under every
    kv_shard mode, on four meshes, with TP and under tp_off."""
    jcfg, pcfg = JC.get_arch(arch), PC.get_arch(arch)
    for quant in (False, True):
        if quant and jcfg.family in ("ssm", "hybrid"):
            continue
        jc_, pc_ = (jcfg.replace(kv_cache_quant=quant),
                    pcfg.replace(kv_cache_quant=quant))
        for B, S in ((128, 32768), (1, 524288)):
            j = jax.eval_shape(lambda: JT.init_cache(jc_, B, S))
            p = PT.init_cache(pc_, B, S, device="meta")
            _same_shapes(j, p)
            for jm, pm in _meshes():
                for jc, pc in _roles():
                    with jc, pc:
                        for mode in KV_MODES:
                            _same_specs(
                                JSH.cache_specs(j, jm, kv_shard=mode),
                                SH.cache_specs(p, pm, kv_shard=mode),
                                f"{arch} B={B} {mode} {pm}")


@pytest.mark.parametrize("shape", list(PC.SHAPES))
def test_input_and_batch_specs(shape):
    """``input_specs`` gives the reference's shapes and dtypes for every
    arch, and ``batch_specs`` the reference's specs on every mesh."""
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in PC.SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind)
        for k, v in JC.SHAPES.items()}
    for arch in PC.ARCH_IDS:
        jcfg, pcfg = JC.get_arch(arch), PC.get_arch(arch)
        assert PC.shape_applicable(pcfg, PC.SHAPES[shape]) == \
            JC.shape_applicable(jcfg, JC.SHAPES[shape])
        j = JC.input_specs(jcfg, JC.SHAPES[shape])
        p = PC.input_specs(pcfg, PC.SHAPES[shape])
        assert list(j) == list(p)
        for k in j:
            assert tuple(j[k].shape) == tuple(p[k].shape), (arch, k)
            assert np.dtype(j[k].dtype) == _np_dtype(p[k].dtype), (arch, k)
            assert p[k].device.type == "meta"
        for jm, pm in _meshes():
            for jc, pc in _roles():
                with jc, pc:
                    _same_specs(JSH.batch_specs(j, jm),
                                SH.batch_specs(p, pm))


def test_meta_walk_matches_init_params():
    """The shape-only walk (``init_params`` on the meta device) gives the
    shapes and dtypes that ``init_params`` allocates, at reduced size."""
    for arch in PC.ARCH_IDS:
        cfg = PC.get_arch(arch, reduced=True)
        real = PT.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        meta = PT.init_params(cfg, torch.Generator(), device="meta")
        for (pa, a), (pb, b) in zip(_flat(real), _flat(meta)):
            assert pa == pb
            assert (a.shape, a.dtype) == (b.shape, b.dtype), (arch, pa)
            assert b.device.type == "meta"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_roles_and_axes():
    """Axis roles as the reference's, reentrant contexts, and the named
    placements (the pod axis major)."""
    m = SH.MeshShape(("pod", "data", "model"), (2, 4, 4))
    jm = AbstractMesh((2, 4, 4), ("pod", "data", "model"))
    assert SH.dp_axes(m) == JSH.dp_axes(jm) == ("pod", "data")
    assert SH.model_axis(m) == JSH.model_axis(jm) == "model"
    off = SH.tp_off()
    with off:
        with off:                       # reentrant
            assert SH.dp_axes(m) == ("pod", "data", "model")
            assert SH.model_axis(m) is None
        assert SH.model_axis(m) is None
    assert SH.model_axis(m) == "model"
    assert SH.axis_size(m, ("pod", "data")) == 8
    assert SH.local_shape((16, 8, 12), (("pod", "data"), None, "model"),
                          m) == (2, 8, 3)
    with pytest.raises(RuntimeError):
        SH.tp_off().__exit__(None, None, None)


def test_named_placements():
    """A spec's DTensor placements: a dim over ("pod", "data") is Shard on
    both mesh dims, in the mesh's order; an out-of-order entry raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = SH.MeshShape(("pod", "data", "model"), (2, 2, 4))
    assert SH.named((("pod", "data"), None, "model"), m) == [
        Shard(0), Shard(0), Shard(2)]
    assert SH.named((), m) == [Replicate()] * 3
    with pytest.raises(ValueError):
        SH.named((("data", "pod"),), m)


def test_constrain_identity_outside_context():
    """``constrain`` returns its argument unchanged outside
    ``activation_axes``, and on a plain tensor inside it."""
    x = torch.randn(4, 3, 8)
    assert SH.constrain(x, "dp", None, "model") is x
    with SH.activation_axes(SH.MeshShape(("data", "model"), (2, 2))):
        assert SH.constrain(x, "dp", None, "model") is x
    assert SH.gather_dp(x) is x
