"""Topology-aware placement — the paper's §IV applied at two levels (own
copy of ``repro/core/placement.py``).

1. **Faithful level**: first-touch spill sets — where the OS puts large
   master-allocated arrays — and the thread→core binding from
   :func:`repro_torch.core.priority.allocate_threads`.

2. **Device adaptation** (used by ``launch/mesh.py``): assignment of
   logical mesh coordinates to physical devices (ranks). The paper binds
   OpenMP threads to cores so communicating threads are few hops apart;
   here *logical mesh positions* are bound to *chips* so that the
   heavy-collective axis ("model") maps onto minimal-hop rings and the
   master/coordinator sits at the topology centroid (first-touch
   analogue: initialization, RNG seeding and checkpoint leadership happen
   there).

All functions are pure and run at launch time only.
"""

from __future__ import annotations

import numpy as np

from .priority import PriorityResult, allocate_threads, priorities
from .topology import Topology

__all__ = [
    "first_touch_spill",
    "master_node",
    "device_order_baseline",
    "device_order_priority",
    "layout_cost",
]


def first_touch_spill(topo: Topology, start_node: int, num_nodes: int,
                      pr: PriorityResult | None = None) -> list[int]:
    """Nodes receiving pages of a large allocation first-touched on
    ``start_node``; the OS falls back to the *closest* nodes as each
    fills (paper §V.B). Ties by priority when given, else by node id —
    baseline Linux walks node ids."""
    d = topo.node_distance[start_node].astype(np.float64)
    if pr is not None:
        node_pr = np.zeros(topo.num_nodes)
        for n in range(topo.num_nodes):
            cs = topo.cores_on_node(n)
            node_pr[n] = max(pr.total[cs]) if cs else -np.inf
        order = np.lexsort((-node_pr, d))
    else:
        order = np.lexsort((np.arange(topo.num_nodes), d))
    return [int(n) for n in order[:num_nodes]]


def master_node(topo: Topology, seed: int = 0) -> int:
    """Node of the master thread under the paper's allocation."""
    master_core = allocate_threads(topo, 1, seed=seed)[0]
    return int(topo.core_node[master_core])


# ----------------------------------------------------------------------
# Device adaptation: logical mesh coordinate → physical device ordering
# ----------------------------------------------------------------------

def device_order_baseline(topo: Topology) -> np.ndarray:
    """Devices in enumeration order (rank order)."""
    return np.arange(topo.num_cores, dtype=np.int64)


def device_order_priority(topo: Topology, mesh_shape: tuple[int, ...],
                          major_axis_last: bool = True,
                          seed: int = 0) -> np.ndarray:
    """Order physical devices so that reshaping to ``mesh_shape`` puts
    consecutive last-axis (highest-traffic, e.g. "model") positions on
    minimal-hop neighbors.

    The paper's worker-placement loop, applied *per ring*: within each
    window of ``mesh_shape[-1]`` logical positions (one "model" ring) we
    seed at the best unassigned device and repeatedly take the unassigned
    device closest to the previous one (ties by priority, then id) — the
    paper's "place new workers as close as possible" rule. Each following
    ring seeds at the unassigned device closest to the previous ring's
    seed, so the slowly-varying ("data"/"pod") axes stay compact too.

    Returns a permutation ``perm`` with ``perm[i]`` = physical device id
    of logical position ``i`` (row-major over ``mesh_shape``).
    """
    n = int(np.prod(mesh_shape))
    if n != topo.num_cores:
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, "
                         f"topology has {topo.num_cores}")
    ring = int(mesh_shape[-1]) if len(mesh_shape) > 1 else n
    pr = priorities(topo)
    total = pr.total
    dist = topo.core_distance_matrix()
    rng = np.random.RandomState(seed)

    unassigned = np.ones(n, bool)

    def pick(dvec):
        d = dvec.astype(np.float64).copy()
        d[~unassigned] = np.inf
        cand = np.nonzero(d == d.min())[0]
        pbest = total[cand].max()
        cand = cand[total[cand] == pbest]
        return int(cand[0])

    order: list[int] = []
    prev_seed = None
    for _ in range(n // ring):
        if prev_seed is None:
            best = total[unassigned].max()
            ties = np.nonzero((total == best) & unassigned)[0]
            cur = int(ties[rng.randint(ties.size)])
        else:
            cur = pick(dist[prev_seed])
        prev_seed = cur
        order.append(cur)
        unassigned[cur] = False
        for _ in range(ring - 1):
            cur = pick(dist[cur])
            order.append(cur)
            unassigned[cur] = False
    return np.asarray(order, np.int64)


def layout_cost(topo: Topology, perm: np.ndarray,
                mesh_shape: tuple[int, ...],
                axis_traffic: tuple[float, ...] | None = None) -> float:
    """Hop-weighted collective cost of a device layout.

    For each mesh axis, collectives (all-reduce / all-gather rings) run
    between devices adjacent along that axis; cost is the mean hop count
    of those ring edges, weighted by relative axis traffic (default: last
    axis carries 8× — TP/EP collectives dominate gradient sync per step).
    Used by benchmarks and by §Perf to compare baseline vs priority
    layouts.
    """
    shape = tuple(mesh_shape)
    if axis_traffic is None:
        axis_traffic = tuple([1.0] * (len(shape) - 1) + [8.0])
    grid = np.asarray(perm).reshape(shape)
    dist = topo.core_distance_matrix()
    total, weight = 0.0, 0.0
    for ax, w in enumerate(axis_traffic):
        if shape[ax] == 1:
            continue
        a = np.moveaxis(grid, ax, 0)
        nxt = np.roll(a, -1, axis=0)  # ring neighbor along this axis
        hops = dist[a.ravel(), nxt.ravel()].astype(np.float64)
        total += w * hops.mean()
        weight += w
    return total / max(weight, 1e-12)
