"""Declarative scheduler-policy layer for the NANOS simulator (own copy of
``repro/core/sim/policy.py``).

A scheduler is no longer an opaque string dispatched through parallel
if/elif chains in the runtime and both engines — it is a
:class:`SchedulerSpec`: a small set of orthogonal fields

  * ``queue``  — where spawned tasks wait:
      ``"shared"``  one global FIFO behind a serializing lock (the
                    Nanos breadth-first pool);
      ``"local"``   per-thread LIFO deques with work stealing.
  * ``spawn``  — what the spawning thread does next:
      ``"child_first"``   dive into the first child immediately
                          (work-first / depth-first execution);
      ``"parent_first"``  queue every child and continue the parent
                          (re-acquiring from its own pool).
  * ``victim`` — how an idle thread sweeps victims (``"local"`` queues
      only):
      ``"none"``         never steal (only meaningful with ``"shared"``);
      ``"random"``       fresh uniform permutation of all other threads
                         per sweep (stock cilk/wf);
      ``"dist_id"``      static: hop distance asc, thread id asc ties
                         (the paper's DFWSPT);
      ``"dist_random"``  hop distance asc, ties re-randomized per sweep
                         (the paper's DFWSRPT);
      ``"node_hier"``    hierarchical: own NUMA node first, then
                         outward tier by tier; equally-distant *nodes*
                         are visited in fresh random order per sweep but
                         each node's threads are probed together
                         (id asc) before moving on — steals concentrate
                         node-by-node instead of scattering over a tier.

A spec is compiled **once** per (topology, thread binding) into a
:class:`VictimPlan` — a per-thread list of *shuffle groups*, each a list
of *units*, each a contiguous run of victim ids. One sweep emits the
groups in order; a group with more than one unit has its unit order
freshly shuffled (one ``RandomState.shuffle`` of the unit list — draw
consumption therefore depends only on the unit count, which is how the
five stock schedulers remain bit-exact against the seed fixtures). The
same plan drives both engines: the plain loop interprets the
pre-lowered group list, the card's kernel walks the flattened
``group_off/unit_off/victim_off/victims`` arrays.

Registering a new scheduler is one call — no engine edits::

    from repro_torch.core.sim import policy
    policy.register(policy.SchedulerSpec(
        "mysched", queue="local", spawn="child_first",
        victim="node_hier"))
    simulate(topo, cores, wl, "mysched")
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..topology import Topology, lazy_cache

__all__ = [
    "SchedulerSpec", "VictimPlan", "SCHEDULERS",
    "register", "get_spec", "compile_victim_plan",
    "QUEUES", "SPAWNS", "VICTIMS",
]

QUEUES = ("shared", "local")
SPAWNS = ("child_first", "parent_first")
VICTIMS = ("none", "random", "dist_id", "dist_random", "node_hier")

# Python-engine group tags (see VictimPlan.py_groups)
GROUP_STATIC = 0    # payload: flat victim list, emitted as-is
GROUP_FLAT = 1      # payload: flat victim list, shuffled per sweep
GROUP_UNITS = 2     # payload: list of victim-run lists; unit order
                    # shuffled per sweep, runs emitted intact


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    """A scheduler as orthogonal policy fields (see module docstring)."""
    name: str
    queue: str = "local"
    spawn: str = "child_first"
    victim: str = "random"

    def __post_init__(self):
        if self.queue not in QUEUES:
            raise ValueError(f"queue={self.queue!r}: expected one of {QUEUES}")
        if self.spawn not in SPAWNS:
            raise ValueError(f"spawn={self.spawn!r}: expected one of {SPAWNS}")
        if self.victim not in VICTIMS:
            raise ValueError(
                f"victim={self.victim!r}: expected one of {VICTIMS}")
        if self.queue == "shared" and self.victim != "none":
            raise ValueError("a shared-queue scheduler has no victim sweep; "
                             "use victim='none'")
        if self.queue == "shared" and self.spawn != "parent_first":
            raise ValueError("child_first requires per-thread local queues")


class VictimPlan:
    """Compiled per-thread victim sweep program (both engine forms).

    ``py_groups[th]``: list of ``(tag, payload)`` groups (tags above).
    ``static_order[th]``: the full sweep as one list when no group ever
    shuffles (so the hot loop skips list building entirely), else None.
    ``flat()``: lazily flattened int64 arrays for the card's kernel —
    ``group_off`` (T+1), ``unit_off`` (G+1), ``victim_off`` (U+1),
    ``victims`` (total victim slots).
    """

    __slots__ = ("T", "groups", "py_groups", "static_order", "_flat")

    def __init__(self, T: int, groups: list[list[list[int]]]):
        # groups[th] = list of groups; each group = list of units;
        # each unit = list of victim ids.
        self.T = T
        self.groups = groups
        self.py_groups = []
        self.static_order = []
        for per_thread in groups:
            lowered = []
            static = True
            for units in per_thread:
                if len(units) <= 1:
                    lowered.append((GROUP_STATIC,
                                    [v for u in units for v in u]))
                elif all(len(u) == 1 for u in units):
                    lowered.append((GROUP_FLAT, [u[0] for u in units]))
                    static = False
                else:
                    lowered.append((GROUP_UNITS, [list(u) for u in units]))
                    static = False
            self.py_groups.append(lowered)
            self.static_order.append(
                [v for _, payload in lowered for v in payload]
                if static else None)
        self._flat = None

    def flat(self):
        if self._flat is None:
            import numpy as np
            group_off = [0]
            unit_off = [0]
            victim_off = [0]
            victims: list[int] = []
            for per_thread in self.groups:
                for units in per_thread:
                    for u in units:
                        victims.extend(u)
                        victim_off.append(len(victims))
                    unit_off.append(len(victim_off) - 1)
                group_off.append(len(unit_off) - 1)
            self._flat = (
                np.ascontiguousarray(group_off, dtype=np.int64),
                np.ascontiguousarray(unit_off, dtype=np.int64),
                np.ascontiguousarray(victim_off, dtype=np.int64),
                np.ascontiguousarray(victims, dtype=np.int64),
            )
        return self._flat


def _victim_groups(victim: str, topo: Topology,
                   cores: Sequence[int]) -> list[list[list[int]]]:
    """Build the raw group/unit/victim nesting for one policy."""
    T = len(cores)
    dist = topo.core_distance_matrix()
    core_node = topo.core_node
    out: list[list[list[int]]] = []
    for th in range(T):
        others = [v for v in range(T) if v != th]
        if victim == "none" or not others:
            out.append([])
        elif victim == "random":
            # one group of singleton units, ascending id — a sweep is one
            # shuffle of T-1 elements, exactly the stock cilk/wf draw.
            out.append([[[v] for v in others]])
        elif victim == "dist_id":
            order = sorted(others,
                           key=lambda v: (dist[cores[th], cores[v]], v))
            out.append([[order]])  # one group, one unit: fully static
        elif victim == "dist_random":
            by_d: dict[int, list[int]] = {}
            for v in others:
                by_d.setdefault(int(dist[cores[th], cores[v]]), []).append(v)
            # one group per distance tier (asc), singleton units — one
            # shuffle per tier of tier-size elements, the DFWSRPT draws.
            out.append([[[v] for v in by_d[d]] for d in sorted(by_d)])
        elif victim == "node_hier":
            by_d = {}
            for v in others:
                by_d.setdefault(int(dist[cores[th], cores[v]]), []).append(v)
            per_thread = []
            for d in sorted(by_d):
                by_node: dict[int, list[int]] = {}
                for v in by_d[d]:
                    by_node.setdefault(int(core_node[cores[v]]), []).append(v)
                per_thread.append(list(by_node.values()))
            out.append(per_thread)
        else:  # pragma: no cover - guarded by SchedulerSpec validation
            raise ValueError(f"unknown victim policy {victim!r}")
    return out


def compile_victim_plan(spec: SchedulerSpec, topo: Topology,
                        thread_cores: Sequence[int]) -> VictimPlan:
    """Compile (and cache) the victim plan for a spec on a thread binding.

    The cache lives on the (frozen, immutable) topology object, keyed by
    the victim policy and the exact core binding — a benchmark sweep
    re-uses one plan across every (workload, seed, placement) config
    that shares a binding — and in the persistent :mod:`.compile_cache`.
    """
    cores = tuple(int(c) for c in thread_cores)
    cache = lazy_cache(topo, "_victim_plan_cache")
    key = (spec.victim, cores)
    plan = cache.get(key)
    if plan is None:
        # persist the raw nesting across processes keyed by (topology
        # fingerprint, victim policy, binding); VictimPlan's derived
        # forms (py_groups/static_order/flat) recompute deterministically
        from .compile_cache import digest_key, get_cache
        pcache = get_cache()
        pkey = None
        groups = None
        if pcache is not None:
            pkey = digest_key("victim_plan", topo.fingerprint(),
                              spec.victim, cores)
            groups = pcache.get_victim_groups(pkey)
            if groups is not None and len(groups) != len(cores):
                groups = None
        if groups is None:
            groups = _victim_groups(spec.victim, topo, cores)
            if pcache is not None:
                pcache.put_victim_groups(pkey, groups)
        plan = VictimPlan(len(cores), groups)
        cache[key] = plan
    return plan


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

SCHEDULERS: dict[str, SchedulerSpec] = {}


def register(spec: SchedulerSpec, *, replace: bool = False) -> SchedulerSpec:
    """Register ``spec`` under ``spec.name``; returns it for chaining."""
    if not replace and spec.name in SCHEDULERS:
        raise ValueError(f"scheduler {spec.name!r} already registered "
                         "(pass replace=True to override)")
    SCHEDULERS[spec.name] = spec
    return spec


def get_spec(scheduler: "str | SchedulerSpec") -> SchedulerSpec:
    """Resolve a scheduler name (or pass a spec through)."""
    if isinstance(scheduler, SchedulerSpec):
        return scheduler
    spec = SCHEDULERS.get(scheduler)
    if spec is None:
        raise ValueError(f"unknown scheduler {scheduler!r}; registered: "
                         f"{sorted(SCHEDULERS)}")
    return spec


# The three stock Nanos schedulers the paper benchmarks against, the two
# NUMA-aware schedulers it contributes, and the hierarchical variant this
# layer makes expressible (Thibault et al. / Wittmann & Hager style).
register(SchedulerSpec("bf", queue="shared", spawn="parent_first",
                       victim="none"))
register(SchedulerSpec("cilk", queue="local", spawn="parent_first",
                       victim="random"))
register(SchedulerSpec("wf", queue="local", spawn="child_first",
                       victim="random"))
register(SchedulerSpec("dfwspt", queue="local", spawn="child_first",
                       victim="dist_id"))
register(SchedulerSpec("dfwsrpt", queue="local", spawn="child_first",
                       victim="dist_random"))
register(SchedulerSpec("dfwshier", queue="local", spawn="child_first",
                       victim="node_hier"))
