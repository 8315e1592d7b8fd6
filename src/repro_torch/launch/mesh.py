"""Mesh descriptions: production and elastic.

Counterpart of ``repro.launch.mesh``. A mesh here is a
``distributed.sharding.MeshShape``: axis names and sizes only, with no
devices and no process group, so building one allocates nothing and
needs no card. The dry run builds a ``DeviceMesh`` of that shape only
when a cell runs (``launch/dryrun.py``).
"""
from __future__ import annotations

from repro_torch.distributed.sharding import MeshShape, mesh_shape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_elastic_mesh(model_parallel: int = 1,
                      world_size: int = 1) -> MeshShape:
    """A (data, model) mesh over ``world_size`` ranks, degrading the
    model-parallel size to the largest divisor of the rank count: the
    elastic-scaling entry point (a failed host shrinks the mesh and
    training resumes from the last checkpoint)."""
    n = world_size
    mp = max(d for d in range(1, model_parallel + 1) if n % d == 0)
    return MeshShape(("data", "model"), (n // mp, mp))


def validate_mesh(mesh, global_batch: int) -> None:
    sizes = mesh_shape(mesh)
    dp = 1
    for a in ("pod", "data"):
        if a in sizes:
            dp *= sizes[a]
    if global_batch % dp and global_batch != 1:
        raise ValueError(
            f"global_batch {global_batch} not divisible by data-parallel "
            f"size {dp} of mesh {dict(sizes)}")
    # global_batch == 1 (long-context decode): the batch replicates; the
    # cache sequence dim shards over dp instead (sharding.cache_specs)


def parse_mesh(text: str) -> MeshShape:
    """"16x16" -> ("data", "model"); "2x16x16" -> ("pod", "data", "model")
    (a small mesh of the production shape, for a quick run on the CPU)."""
    sizes = tuple(int(x) for x in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(sizes))
    if names is None or min(sizes) < 1:
        raise ValueError(f"mesh {text!r}: give 2 or 3 positive sizes, "
                         "as 16x16 or 2x16x16")
    return MeshShape(names, sizes)
