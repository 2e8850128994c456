"""NUMA-aware work-stealing victim orders (paper §VI); own copy of
``repro/core/stealing.py``.

Both of the paper's schedulers steal from victims ranked by hop distance
from the idle thread's core; they differ only in tie-breaking at equal
distance:

  * DFWSPT  — ties broken by ascending thread id ("threads with smaller
    id are placed first").
  * DFWSRPT — ties broken by a fresh random permutation each time the
    thread goes stealing ("victim thread is picked randomly" among the
    equally-close), which avoids convoys on the lowest-id victim.
  * DFWSHIER — the policy layer's hierarchical variant: equal-distance
    ties are randomized at *node* granularity — a sweep probes all of
    one NUMA node's threads (id asc) before moving to the next node,
    so consecutive probes share victim-node memory.

``priority_list`` builds the static DFWSPT list; ``victim_order`` yields
the per-attempt order for any policy. The same orders drive the MoE
overflow re-routing in :mod:`repro_torch.core.routing`, where "threads"
are expert-owning devices.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .topology import Topology

__all__ = ["priority_list", "victim_order", "steal_order_matrix"]


def priority_list(topo: Topology, thread_cores: Sequence[int],
                  thread: int) -> list[int]:
    """DFWSPT static priority list for ``thread``.

    Returns other threads' ids ordered by (hop distance from this thread's
    core asc, thread id asc). This is computed once at startup, exactly as
    the paper prescribes.
    """
    me = thread_cores[thread]
    dist = topo.core_distance_matrix()
    others = [t for t in range(len(thread_cores)) if t != thread]
    return sorted(others, key=lambda t: (dist[me, thread_cores[t]], t))


def victim_order(topo: Topology, thread_cores: Sequence[int], thread: int,
                 policy: str, rng: np.random.RandomState) -> list[int]:
    """Victim id order for one stealing sweep.

    policy: 'dfwspt' (deterministic ties), 'dfwsrpt' (random ties), or
    'dfwshier' (node-granular random ties, node members contiguous).
    """
    me = thread_cores[thread]
    dist = topo.core_distance_matrix()
    others = [t for t in range(len(thread_cores)) if t != thread]
    if policy == "dfwspt":
        return sorted(others, key=lambda t: (dist[me, thread_cores[t]], t))
    if policy == "dfwsrpt":
        jitter = rng.permutation(len(thread_cores))
        return sorted(others, key=lambda t: (dist[me, thread_cores[t]], jitter[t]))
    if policy == "dfwshier":
        # One sweep of the policy layer's node_hier grouping (the same
        # code the engines compile), so an ahead-of-time order from a
        # fresh RandomState(seed) equals the engine's first sweep.
        from .sim.policy import _victim_groups
        order: list[int] = []
        for units in _victim_groups("node_hier", topo, thread_cores)[thread]:
            if len(units) > 1:
                units = list(units)
                rng.shuffle(units)
            for u in units:
                order.extend(u)
        return order
    raise ValueError(f"unknown stealing policy {policy!r}")


def steal_order_matrix(topo: Topology, thread_cores: Sequence[int],
                       policy: str = "dfwspt",
                       seed: int = 0) -> np.ndarray:
    """(T, T-1) matrix: row t = victim order for thread t.

    For 'dfwsrpt' the random tie-break is drawn once per row from ``seed``
    — the *ahead-of-time* form of the routing adaptation, where the steal
    order is fixed before the step runs.
    """
    rng = np.random.RandomState(seed)
    rows = [victim_order(topo, thread_cores, t, policy, rng)
            for t in range(len(thread_cores))]
    return np.asarray(rows, np.int64)
