"""Specs and mesh axes: what the sharding rules (``launch/shardings.py``)
and the layers (``models/distributed.py``) both read.

A spec is JAX's ``PartitionSpec`` as a plain tuple: one entry per tensor
dim, each ``None`` (replicated), a mesh axis name, or a tuple of axis
names (the dim split over several mesh axes, the first the major one);
trailing ``None`` entries are dropped. :func:`placements` turns a spec
into DTensor placements (``Shard(d)`` / ``Replicate()``) on a
``DeviceMesh``.

The functions take any ``mesh`` that gives its axis sizes: a
``DeviceMesh`` (``mesh_dim_names`` and the rank grid ``mesh.mesh``), a
mapping of axis name to size, or an object whose ``shape`` is such a
mapping (JAX's ``Mesh`` and its stand-ins in tests).
"""

from __future__ import annotations

import math

__all__ = ["BATCH_AXES", "MODEL_AXIS", "mesh_shape", "batch_axes",
           "axis_size", "fit_spec", "local_shape", "placements"]

# the mesh axes of ``launch/mesh.py``: the batch is split over "pod" and
# "data" (those the mesh has), tensor and expert parallelism use "model"
BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name → size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(mesh.shape)


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh_shape(mesh))


def axis_size(sizes: dict, axis) -> int:
    """The number of shards of a spec entry (None, a name or a tuple)."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(axis_size(sizes, a) for a in axis)
    return sizes[axis]


def fit_spec(mesh, shape: tuple[int, ...], spec: tuple) -> tuple:
    """Drop axes that don't divide their dim (replicate instead)."""
    sizes = mesh_shape(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        kept: list[str] = []
        for a in axes:
            size = axis_size(sizes, a)
            cur = math.prod(axis_size(sizes, k) for k in kept)
            if size > 1 and dim % (cur * size) == 0:
                kept.append(a)
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def local_shape(mesh, shape: tuple[int, ...], spec: tuple
                ) -> tuple[int, ...]:
    """The per-rank shape of a tensor of ``shape`` placed by ``spec``
    (each dim divided by the sizes of the axes that split it)."""
    sizes = mesh_shape(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, entries):
        n = axis_size(sizes, axis)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axis} ({n})")
        out.append(dim // n)
    return tuple(out)


def placements(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on
    each mesh dim that splits tensor dim d, ``Replicate()`` elsewhere. A
    dim split over two axes lists them in mesh order, major first, which
    is DTensor's default order for two mesh dims sharding one dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec entry {entry} lists mesh axes out of mesh order")
        for i in idx:
            out[i] = Shard(d)
    return out
