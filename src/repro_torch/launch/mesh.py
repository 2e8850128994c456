"""Production mesh construction + topology-aware device ordering (port of
``repro/launch/mesh.py``).

``make_production_mesh`` builds the ``DeviceMesh`` of the JAX package's
production layouts: 16×16 ("data","model") per pod, (2,16,16)
("pod","data","model") across two pods; other shapes (the (2,2) of the
CPU test, the (1,1) of one card) come through ``shape``. With
``topology_aware=True`` the ranks are permuted by the paper's priority
walk (core/placement.py) before the mesh is built, so the high-traffic
"model" axis lands on minimal-hop rings of the modelled topology and the
coordinator (logical position 0) sits at its centroid — the thread→core
binding of §IV, chip-granular. Rank r stands for core r of the modelled
topology, as the JAX package's device id d does.

Building a mesh needs an initialised ``torch.distributed`` world of the
mesh's size (``init_process_group`` with an explicit address, world size
and rank; the dry run's fake process group for placeholder ranks).
Importing this module touches no process group.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import placement
from repro_torch.core import topology as topo_mod
from repro_torch.core.routing import expert_steal_table

__all__ = ["make_production_mesh", "production_topology",
           "mesh_steal_table", "coordinator_device", "mesh_axes",
           "POD_SHAPE"]

POD_SHAPE = (16, 16)          # the JAX package's pod (2-D torus of chips)


def mesh_axes(multi_pod: bool = False) -> tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def production_topology(multi_pod: bool = False,
                        shape: tuple[int, ...] | None = None
                        ) -> topo_mod.Topology:
    """Modelled hop-distance topology matching the mesh (the production
    one unless ``shape`` says otherwise). Rank r is core r (pods
    enumerate consecutively, row-major within a pod)."""
    if shape is None:
        shape = (2, *POD_SHAPE) if multi_pod else POD_SHAPE
    if multi_pod:
        return topo_mod.multi_pod(*shape)
    return topo_mod.tpu_pod_2d(*shape)


def make_production_mesh(*, multi_pod: bool = False,
                         topology_aware: bool = False,
                         device_type: str = "cuda",
                         shape: tuple[int, ...] | None = None):
    """The ``DeviceMesh`` of the production layout (or of ``shape``) over
    the first ranks of the current world (all of them, on a real one); its
    rank grid is ``perm.reshape(shape)`` with ``perm`` the priority order
    when ``topology_aware``, else rank order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if shape is None:
        shape = (2, *POD_SHAPE) if multi_pod else POD_SHAPE
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    ranks = np.arange(n, dtype=np.int64)
    if topology_aware:
        ranks = placement.device_order_priority(
            production_topology(multi_pod, shape), shape)
    grid = torch.as_tensor(ranks.reshape(shape))
    return DeviceMesh(device_type, grid, mesh_dim_names=mesh_axes(multi_pod))


def coordinator_device(mesh) -> int:
    """The 'master thread' analogue: checkpoint leader / RNG seeder.

    Logical position (0, ..., 0): under topology-aware ordering the
    highest-priority (most central) rank, so broadcast-style traffic
    (init, restore fan-out) starts from the centroid (first-touch
    analogue)."""
    return int(mesh.mesh.reshape(-1)[0])


def mesh_steal_table(mesh, num_experts: int, policy: str = "dfwspt",
                     seed: int = 0) -> np.ndarray:
    """Expert steal order for a mesh with experts on the 'model' axis.

    Expert e lives on model-axis block e·M/E (M = model axis size); its
    owning rank (representative: pod 0, data row 0, read from the mesh's
    rank grid) indexes the modelled topology. Returns the (E, E-1) table
    for core/routing.route.
    """
    grid = np.asarray(mesh.mesh)
    axes = tuple(mesh.mesh_dim_names)
    model_ax = axes.index("model")
    M = grid.shape[model_ax]
    index = [0] * grid.ndim
    reps = []
    for m in range(M):
        index[model_ax] = m
        reps.append(int(grid[tuple(index)]))
    reps = np.asarray(reps)
    if num_experts >= M:
        if num_experts % M:
            raise ValueError(f"experts {num_experts} % model axis {M} != 0")
        expert_device = reps[(np.arange(num_experts) * M) // num_experts]
    else:
        if M % num_experts:
            raise ValueError(f"model axis {M} % experts {num_experts} != 0")
        expert_device = reps[np.arange(num_experts) * (M // num_experts)]
    topo = production_topology("pod" in axes, grid.shape)
    return expert_steal_table(topo, expert_device, policy=policy, seed=seed)
