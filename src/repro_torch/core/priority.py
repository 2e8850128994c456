"""The paper's priority-based thread→core allocation (§IV, Figs 2–4); own
copy of ``repro/core/priority.py``.

Faithful reproduction of the two-level priority computation:

  Level 1 (Fig 2):  V1(c) = Σ_i α_i · N_i(c)
      α_i is a weight per hop distance i with α_i > α_{i+1} (and α beyond
      max-numa-distance = 0); N_i(c) is the number of cores at i hops
      from core c. A first "node size" term is granted before V1: cores on
      the socket with the most cores attached to one NUMA node get the
      highest base priority (paper: "assign high priority to cores of the
      socket/chip having the largest number of cores attached to the same
      NUMA memory node").

  Level 2 (Fig 3):  V2(c) = Σ_i Σ_j α_i · P_ij
      folds in the previously computed priorities P of cores at each hop —
      useful when several hop distances exist, the machine is
      heterogeneous, or some cores are already occupied.

  Final priority = base + V1 + V2 (paper Fig 4 accumulates levels in
  place; we keep the levels separable for analysis/tests).

Master/worker placement (paper §IV, end):
  * master binds to the max-priority core (ties → random, seeded);
  * each next worker binds as close as possible to the master's core,
    ties by higher priority, remaining ties random.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .topology import Topology, lazy_cache

__all__ = [
    "default_weights",
    "priorities",
    "PriorityResult",
    "allocate_threads",
]


def default_weights(max_distance: int) -> np.ndarray:
    """α_i for i in [0, max_distance], strictly decreasing, α_{max+1}=0.

    The paper leaves the coefficients free ("a coefficient number
    decreasing with growing number of hops"); we use a geometric decay
    α_i = 2^{-i} which satisfies α_i > α_{i+1} > 0 over the support.
    """
    return 0.5 ** np.arange(max_distance + 1, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class PriorityResult:
    base: np.ndarray    # node-size term, per core
    v1: np.ndarray      # Fig 2 term, per core
    v2: np.ndarray      # Fig 3 term, per core
    total: np.ndarray   # base + v1 + v2

    def ranking(self) -> np.ndarray:
        """Core ids sorted by descending priority (stable: id asc ties)."""
        # argsort is ascending; sort by (-total, id) for deterministic order.
        order = np.lexsort((np.arange(self.total.size), -self.total))
        return order


def _memo_key(weights, available, *rest):
    """Hashable cache key for the per-topology memo tables below."""
    wk = None if weights is None else tuple(np.asarray(weights,
                                                      np.float64).tolist())
    ak = None if available is None else tuple(int(c) for c in available)
    return (wk, ak) + rest


def priorities(topo: Topology,
               weights: np.ndarray | None = None,
               available: Sequence[int] | None = None,
               occupied_penalty: float = 0.0) -> PriorityResult:
    """Compute per-core priorities on ``topo`` per the paper's algorithm.

    Memoized on the (immutable) topology per (weights, available,
    occupied_penalty) — like ``_root_dist_cache`` — because benchmark
    sweeps recompute the identical result hundreds of times per grid.
    The returned arrays are shared; treat them as read-only.

    Args:
      topo: the machine.
      weights: α_i per hop distance; defaults to ``default_weights``.
      available: optional subset of core ids considered free. Cores outside
        the subset contribute nothing to N_i / P_ij (paper: "in case some
        cores have already been allocated for other work") and get -inf
        total so they are never selected.
      occupied_penalty: subtractive weight for occupied cores (0 = simply
        excluded, matching the strict reading).
    """
    cache = lazy_cache(topo, "_priority_cache")
    key = _memo_key(weights, available, float(occupied_penalty))
    hit = cache.get(key)
    if hit is not None:
        return hit
    n = topo.num_cores
    dist = topo.core_distance_matrix()
    maxd = topo.max_distance()
    if weights is None:
        weights = default_weights(maxd)
    weights = np.asarray(weights, np.float64)
    if weights.size < maxd + 1:
        raise ValueError(f"need weights for hop 0..{maxd}")
    if np.any(np.diff(weights) >= 0):
        raise ValueError("weights must be strictly decreasing (α_i > α_{i+1})")

    free = np.ones(n, bool)
    if available is not None:
        free[:] = False
        free[list(available)] = True

    # --- base term: size of the core's NUMA node (socket with the most
    # cores attached to the same memory node → highest base priority).
    node_sizes = np.bincount(topo.core_node, weights=free.astype(np.float64),
                             minlength=topo.num_nodes)
    base = node_sizes[topo.core_node]
    # Paper: "If all nodes have equal number of cores ... same priority".
    if np.all(node_sizes[np.unique(topo.core_node)] ==
              node_sizes[np.unique(topo.core_node)][0]):
        base = np.zeros(n)

    # --- V1 (Fig 2): Σ_i α_i N_i over *other*, free cores.
    w_of_pair = weights[dist]                      # (n, n) α_{dist(a,b)}
    contrib = w_of_pair * free[None, :]
    np.fill_diagonal(contrib, 0.0)                 # N_i counts other cores
    v1 = contrib.sum(axis=1)

    p_old = base + v1

    # --- V2 (Fig 3): Σ_i Σ_j α_i P_ij with P the already-found priorities.
    pc = np.where(free, p_old, occupied_penalty)
    contrib2 = w_of_pair * pc[None, :]
    np.fill_diagonal(contrib2, 0.0)
    v2 = contrib2.sum(axis=1)

    total = p_old + v2
    total = np.where(free, total, -np.inf)
    result = PriorityResult(base=base, v1=v1, v2=v2, total=total)
    for arr in (result.base, result.v1, result.v2, result.total):
        arr.flags.writeable = False     # the memoized arrays are shared
    cache[key] = result
    return result


def allocate_threads(topo: Topology,
                     num_threads: int,
                     weights: np.ndarray | None = None,
                     available: Sequence[int] | None = None,
                     seed: int = 0) -> list[int]:
    """Bind ``num_threads`` threads to cores per the paper's policy.

    Returns core ids, index = thread id; thread 0 is the master.

    Policy (paper §IV): master → highest-priority core (random among
    ties); worker k → unbound core closest to the master's core, ties by
    higher priority, then random.

    Memoized on the topology per (num_threads, weights, available,
    seed): the O(n²) allocation is identical across the hundreds of
    sweep configs that share a thread count, so it is computed once.
    """
    cache = lazy_cache(topo, "_alloc_cache")
    key = _memo_key(weights, available, int(num_threads), int(seed))
    hit = cache.get(key)
    if hit is not None:
        return list(hit)
    pr = priorities(topo, weights=weights, available=available)
    rng = np.random.RandomState(seed)
    total = pr.total
    n = topo.num_cores
    if num_threads > np.isfinite(total).sum():
        raise ValueError("more threads than available cores")

    dist = topo.core_distance_matrix()
    bound: list[int] = []
    is_free = np.isfinite(total)

    # master
    best = total.max()
    ties = np.nonzero((total == best) & is_free)[0]
    master = int(ties[rng.randint(ties.size)])
    bound.append(master)
    is_free[master] = False

    for _ in range(1, num_threads):
        d = dist[master].astype(np.float64)
        d[~is_free] = np.inf
        dmin = d.min()
        cand = np.nonzero(d == dmin)[0]
        # ties by higher priority
        pbest = total[cand].max()
        cand = cand[total[cand] == pbest]
        pick = int(cand[rng.randint(cand.size)])
        bound.append(pick)
        is_free[pick] = False
    cache[key] = tuple(bound)
    return bound
