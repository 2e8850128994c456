"""Declarative execution contexts: who runs where, where data lives (own
copy of ``repro/core/sim/context.py``).

The paper's contribution is two-sided — a priority-based *thread
allocation* method (§IV) and NUMA-aware *task scheduling* (§VI) — over
an explicit first-touch *data placement* model (§V.B). The scheduling
side became declarative in ``policy.py`` (:class:`SchedulerSpec`); this
module does the same for the other two sides, the way BubbleSched
treats scheduling strategies as pluggable policies over a hierarchical
machine model:

  * :class:`BindingSpec` — how N threads map to cores:
      ``"paper"``      the paper's priority-based allocation
                       (:func:`repro_torch.core.priority.allocate_threads`);
      ``"linear"``     cores 0..N-1 in id order (baseline Nanos:
                       whatever the OS enumerates first);
      ``"scatter"``    round-robin across NUMA nodes (one core per node
                       per round, node/core ids ascending);
      ``"node_fill"``  fill each node's cores before moving to the
                       next (node/core ids ascending);
      explicit         a literal core list (``"cores:0,2,4"`` or any
                       int sequence).

  * :class:`PlacementSpec` — where the benchmark's root arrays live:
      ``"first_touch"``  the master thread's node (Linux first-touch);
      ``"spill:K"``      K-node first-touch spill from the *master's*
                         node, closest-first with priority tie-breaks
                         (the paper's §V.B model under NUMA-aware
                         allocation);
      ``"spill:K@N"``    K-node spill from explicit node N with
                         baseline node-id tie-breaks (stock Linux — the
                         paper's unmodified-Nanos variant);
      ``"interleave"``   pages interleaved over every node;
      explicit           literal node(s) (``"node:3"``, ``"nodes:1,3"``
                         or any int / int sequence).

Both are frozen dataclasses with name→spec registries
(:data:`BINDINGS` / :data:`PLACEMENTS`) mirroring ``SCHEDULERS``, and
both *lower* — once per (topology, thread count, seed), cached on the
topology like ``_root_dist_cache`` — into plain core/node tuples that
the engines consume.

An :class:`ExecContext` is the compiled pair plus the runtime-data and
migration knobs: one immutable value that fully answers "who runs
where, where does data live" for a simulation.  ``simulate()`` and
``run_sweep()`` consume ``ExecContext`` internally; the
:class:`~.machine.Machine` facade compiles and caches them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..placement import first_touch_spill
from ..priority import allocate_threads, priorities
from ..topology import Topology, lazy_cache
from .faults import get_faults

__all__ = [
    "BindingSpec", "PlacementSpec", "ExecContext",
    "BINDINGS", "PLACEMENTS",
    "register_binding", "register_placement",
    "get_binding", "get_placement",
    "BINDING_KINDS", "PLACEMENT_KINDS",
]

BINDING_KINDS = ("paper", "linear", "scatter", "node_fill", "explicit")
PLACEMENT_KINDS = ("first_touch", "spill", "interleave", "explicit")
SPILL_TIES = ("priority", "id")


# ----------------------------------------------------------------------
# BindingSpec
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BindingSpec:
    """How ``num_threads`` threads map to cores (see module docstring).

    ``lower()`` resolves the spec on a concrete topology into a core
    tuple (index = thread id, thread 0 = master). Lowerings are cached
    on the topology per (spec, T, seed); only ``"paper"`` consumes the
    seed (its tie-breaks are randomized like the paper's).
    """
    name: str
    kind: str = "paper"
    cores: Optional[tuple] = None     # for kind="explicit"

    def __post_init__(self):
        if self.kind not in BINDING_KINDS:
            raise ValueError(
                f"binding kind={self.kind!r}: expected one of {BINDING_KINDS}")
        if self.kind == "explicit":
            if not self.cores:
                raise ValueError("explicit binding needs a non-empty "
                                 "core tuple")
            object.__setattr__(self, "cores",
                               tuple(int(c) for c in self.cores))
        elif self.cores is not None:
            raise ValueError(f"binding kind={self.kind!r} takes no "
                             "explicit core list")

    def lower(self, topo: Topology, num_threads: Optional[int] = None,
              seed: int = 0) -> tuple:
        """Resolve to a core tuple on ``topo`` (cached on the topology)."""
        if self.kind == "explicit":
            if num_threads is not None and num_threads != len(self.cores):
                raise ValueError(
                    f"binding {self.name!r} pins {len(self.cores)} cores "
                    f"but threads={num_threads} was requested")
            cores = self.cores
            bad = [c for c in cores if not 0 <= c < topo.num_cores]
            if bad:
                raise ValueError(f"binding {self.name!r}: cores {bad} "
                                 f"outside topology ({topo.num_cores} cores)")
            if len(set(cores)) != len(cores):
                raise ValueError(f"binding {self.name!r}: duplicate cores")
            return cores
        if num_threads is None:
            raise ValueError(f"binding {self.name!r} needs threads=N")
        if not 1 <= num_threads <= topo.num_cores:
            raise ValueError(
                f"threads={num_threads} out of range for {topo.name} "
                f"({topo.num_cores} cores)")
        cache = lazy_cache(topo, "_binding_cache")
        key = (self, num_threads, seed if self.kind == "paper" else 0)
        cores = cache.get(key)
        if cores is None:
            # the paper binding's priority allocation is the one
            # non-trivial lowering — persist it across processes keyed
            # by (topology fingerprint, spec, T, seed)
            pcache = pkey = None
            if self.kind == "paper":
                from .compile_cache import digest_key, get_cache
                pcache = get_cache()
                if pcache is not None:
                    pkey = digest_key("binding", topo.fingerprint(),
                                      repr(self), num_threads, seed)
                    stored = pcache.get_int_tuple("contexts", pkey)
                    if stored is not None and len(stored) == num_threads:
                        cache[key] = stored
                        return stored
            cores = self._lower_uncached(topo, num_threads, seed)
            cache[key] = cores
            if pcache is not None:
                pcache.put_int_tuple("contexts", pkey, cores)
        return cores

    def _lower_uncached(self, topo: Topology, T: int, seed: int) -> tuple:
        if self.kind == "paper":
            return tuple(allocate_threads(topo, T, seed=seed))
        if self.kind == "linear":
            return tuple(range(T))
        core_ids = np.arange(topo.num_cores)
        if self.kind == "node_fill":
            order = np.lexsort((core_ids, topo.core_node))
            return tuple(int(c) for c in order[:T])
        if self.kind == "scatter":
            # round-robin: one core per node per round, node ids asc,
            # cores within a node in id order; exhausted nodes skipped.
            per_node = [topo.cores_on_node(n)
                        for n in range(topo.num_nodes)]
            out: list = []
            while len(out) < T:
                for q in per_node:
                    if q and len(out) < T:
                        out.append(q.pop(0))
            return tuple(out)
        raise ValueError(f"unknown binding kind {self.kind!r}"
                         )  # pragma: no cover - guarded in __post_init__


# ----------------------------------------------------------------------
# PlacementSpec
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Where the benchmark's root arrays live (see module docstring).

    ``spill_nodes`` is the spill-set size K (≈ dataset GB / node GB,
    paper §V); ``start`` is the first-touch node — ``"master"`` (the
    master thread's node, resolved at lower time) or an explicit node
    id; ``ties`` picks the fallback walk when several nodes are equally
    close: ``"priority"`` (the paper's prioritized allocation) or
    ``"id"`` (stock Linux walks node ids).
    """
    name: str
    kind: str = "first_touch"
    spill_nodes: int = 1
    start: "str | int" = "master"
    ties: str = "priority"
    nodes: Optional[tuple] = None     # for kind="explicit"

    def __post_init__(self):
        if self.kind not in PLACEMENT_KINDS:
            raise ValueError(f"placement kind={self.kind!r}: expected one "
                             f"of {PLACEMENT_KINDS}")
        if self.ties not in SPILL_TIES:
            raise ValueError(f"placement ties={self.ties!r}: expected one "
                             f"of {SPILL_TIES}")
        if self.kind == "spill":
            if self.spill_nodes < 1:
                raise ValueError(f"spill needs ≥1 node, got "
                                 f"{self.spill_nodes}")
            if self.start != "master" and not isinstance(self.start, int):
                raise ValueError(f"spill start={self.start!r}: expected "
                                 "'master' or a node id")
        if self.kind == "explicit":
            if not self.nodes:
                raise ValueError("explicit placement needs a non-empty "
                                 "node tuple")
            object.__setattr__(self, "nodes",
                               tuple(int(n) for n in self.nodes))
        elif self.nodes is not None:
            raise ValueError(f"placement kind={self.kind!r} takes no "
                             "explicit node list")

    def lower(self, topo: Topology, master_core: int) -> Optional[tuple]:
        """Resolve to the root-data node tuple (``None`` = first-touch
        on the master's node, the engine default). Cached on the
        topology per (spec, master node)."""
        if self.kind == "first_touch":
            return None
        if self.kind == "explicit":
            bad = [n for n in self.nodes if not 0 <= n < topo.num_nodes]
            if bad:
                raise ValueError(f"placement {self.name!r}: nodes {bad} "
                                 f"outside topology ({topo.num_nodes} nodes)")
            return self.nodes
        if self.kind == "interleave":
            return tuple(range(topo.num_nodes))
        # kind == "spill"
        if self.spill_nodes > topo.num_nodes:
            raise ValueError(
                f"placement {self.name!r}: spill over {self.spill_nodes} "
                f"nodes but {topo.name} has {topo.num_nodes}")
        start = (int(topo.core_node[master_core])
                 if self.start == "master" else int(self.start))
        if not 0 <= start < topo.num_nodes:
            raise ValueError(f"placement {self.name!r}: start node {start} "
                             f"outside topology ({topo.num_nodes} nodes)")
        cache = lazy_cache(topo, "_placement_cache")
        key = (self, start)
        nodes = cache.get(key)
        if nodes is None:
            from .compile_cache import digest_key, get_cache
            pcache = get_cache()
            pkey = None
            if pcache is not None:
                pkey = digest_key("placement", topo.fingerprint(),
                                  repr(self), start)
                stored = pcache.get_int_tuple("contexts", pkey)
                if stored is not None and len(stored) == self.spill_nodes:
                    cache[key] = stored
                    return stored
            pr = priorities(topo) if self.ties == "priority" else None
            nodes = tuple(first_touch_spill(topo, start, self.spill_nodes,
                                            pr))
            cache[key] = nodes
            if pcache is not None:
                pcache.put_int_tuple("contexts", pkey, nodes)
        return nodes


# ----------------------------------------------------------------------
# Registries + string forms
# ----------------------------------------------------------------------

BINDINGS: dict = {}
PLACEMENTS: dict = {}


def register_binding(spec: BindingSpec, *,
                     replace: bool = False) -> BindingSpec:
    """Register ``spec`` under ``spec.name``; returns it for chaining."""
    if not replace and spec.name in BINDINGS:
        raise ValueError(f"binding {spec.name!r} already registered "
                         "(pass replace=True to override)")
    BINDINGS[spec.name] = spec
    return spec


def register_placement(spec: PlacementSpec, *,
                       replace: bool = False) -> PlacementSpec:
    """Register ``spec`` under ``spec.name``; returns it for chaining."""
    if not replace and spec.name in PLACEMENTS:
        raise ValueError(f"placement {spec.name!r} already registered "
                         "(pass replace=True to override)")
    PLACEMENTS[spec.name] = spec
    return spec


def _int_list(text: str, what: str) -> tuple:
    try:
        return tuple(int(p) for p in text.split(",") if p != "")
    except ValueError:
        raise ValueError(f"malformed {what} list {text!r}") from None


def get_binding(binding) -> BindingSpec:
    """Resolve a binding: a spec, a registered/parametrized name, or an
    explicit core sequence."""
    if isinstance(binding, BindingSpec):
        return binding
    if isinstance(binding, str):
        spec = BINDINGS.get(binding)
        if spec is not None:
            return spec
        if binding.startswith("cores:"):
            return BindingSpec(binding, kind="explicit",
                              cores=_int_list(binding[6:], "core"))
        raise ValueError(f"unknown binding {binding!r}; registered: "
                         f"{sorted(BINDINGS)} (or 'cores:a,b,...')")
    if isinstance(binding, (list, tuple, np.ndarray, range)):
        cores = tuple(int(c) for c in binding)
        return BindingSpec(f"cores:{','.join(map(str, cores))}",
                           kind="explicit", cores=cores)
    raise TypeError(f"cannot interpret {binding!r} as a thread binding")


def get_placement(placement) -> PlacementSpec:
    """Resolve a placement: a spec, a registered/parametrized name
    (``spill:K``, ``spill:K@N``, ``node:N``, ``nodes:a,b``), an explicit
    node / node sequence, or ``None`` (first-touch)."""
    if placement is None:
        return PLACEMENTS["first_touch"]
    if isinstance(placement, PlacementSpec):
        return placement
    if isinstance(placement, str):
        spec = PLACEMENTS.get(placement)
        if spec is not None:
            return spec
        if placement.startswith("spill:"):
            body = placement[6:]
            if "@" in body:
                k_s, _, n_s = body.partition("@")
                try:
                    k, start = int(k_s), int(n_s)
                except ValueError:
                    raise ValueError(
                        f"malformed placement {placement!r}; expected "
                        "'spill:K@N'") from None
                # pinning the start node models stock Linux first-touch:
                # the fallback walk is by node id, not priority
                return PlacementSpec(placement, kind="spill", spill_nodes=k,
                                     start=start, ties="id")
            try:
                k = int(body)
            except ValueError:
                raise ValueError(f"malformed placement {placement!r}; "
                                 "expected 'spill:K'") from None
            return PlacementSpec(placement, kind="spill", spill_nodes=k)
        if placement.startswith("node:"):
            return PlacementSpec(placement, kind="explicit",
                                 nodes=_int_list(placement[5:], "node"))
        if placement.startswith("nodes:"):
            return PlacementSpec(placement, kind="explicit",
                                 nodes=_int_list(placement[6:], "node"))
        raise ValueError(f"unknown placement {placement!r}; registered: "
                         f"{sorted(PLACEMENTS)} (or 'spill:K', 'spill:K@N', "
                         "'node:N', 'nodes:a,b,...')")
    if isinstance(placement, (int, np.integer)):
        return PlacementSpec(f"node:{int(placement)}", kind="explicit",
                             nodes=(int(placement),))
    if isinstance(placement, (list, tuple, np.ndarray, range)):
        nodes = tuple(int(n) for n in placement)
        return PlacementSpec(f"nodes:{','.join(map(str, nodes))}",
                             kind="explicit", nodes=nodes)
    raise TypeError(f"cannot interpret {placement!r} as a data placement")


register_binding(BindingSpec("paper", kind="paper"))
register_binding(BindingSpec("linear", kind="linear"))
register_binding(BindingSpec("scatter", kind="scatter"))
register_binding(BindingSpec("node_fill", kind="node_fill"))

register_placement(PlacementSpec("first_touch", kind="first_touch"))
register_placement(PlacementSpec("interleave", kind="interleave"))


# ----------------------------------------------------------------------
# ExecContext
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecContext:
    """A compiled execution context: binding + placement lowered onto a
    topology, plus the runtime-data and migration knobs.

    ``thread_cores`` / ``root_data_nodes`` are the lowered tuples the
    engines consume; ``binding`` / ``placement`` keep the declarative
    identity for display and grid keys. Build with
    :meth:`ExecContext.compile` (full resolution + validation) or let
    :class:`~.machine.Machine` cache them.
    """
    topo: Topology
    params: object                      # SimParams (duck-typed: no cycle)
    binding: BindingSpec
    placement: PlacementSpec
    thread_cores: tuple
    root_data_nodes: Optional[tuple]
    runtime_data_node: Optional[int] = None
    migration_rate: float = 0.0
    bind_seed: int = 0
    # declarative fault models (FaultSpec tuple); lowered per simulation
    # seed into a compiled FaultPlan by the engine entry point.
    faults: tuple = ()

    @property
    def threads(self) -> int:
        return len(self.thread_cores)

    @property
    def master_core(self) -> int:
        return self.thread_cores[0]

    @property
    def master_node(self) -> int:
        return int(self.topo.core_node[self.thread_cores[0]])

    def label(self) -> str:
        """Compact display identity, e.g. ``paper/spill:2``."""
        return f"{self.binding.name}/{self.placement.name}"

    def fingerprint(self) -> str:
        """Stable content digest of everything this context makes the
        engines observe: the topology fingerprint, the *lowered*
        core/node tuples (so ``binding="paper"`` and an explicit core
        list that lowers identically share one identity), the
        runtime-data/migration knobs, the fault model fields, and the
        cost-model constants from ``params``. Execution knobs that
        cannot change a result (``SimParams.workers``,
        ``SimParams.trace`` — tracing is purely observational) are
        excluded. The persistent result store keys cells on this; the
        digest equals the JAX package's for the same context, so a
        journal written by either package resumes in the other. Cached
        (the context is frozen and shared across sweep cells).
        """
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            import hashlib
            pfields = tuple(
                (f.name, getattr(self.params, f.name))
                for f in dataclasses.fields(self.params)
                if f.name not in ("workers", "trace"))
            material = (self.topo.fingerprint(), self.thread_cores,
                        self.root_data_nodes, self.runtime_data_node,
                        self.migration_rate,
                        tuple(dataclasses.astuple(f) for f in self.faults),
                        pfields)
            fp = hashlib.blake2b(repr(material).encode(),
                                 digest_size=16).hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    @classmethod
    def compile(cls, topo: Topology, params, threads: Optional[int] = None,
                binding="paper", placement="first_touch",
                runtime_data="local", migration_rate: float = 0.0,
                bind_seed: int = 0, faults=()) -> "ExecContext":
        """Resolve + lower + validate a declarative context description.

        ``runtime_data``: ``"local"`` (each thread's runtime structures
        on its own node — the paper's modification), ``"master"`` (all
        on the master's node), or an explicit node id (baseline Nanos
        first-touches everything on the initializing node).

        ``faults``: fault model(s) — specs, parametrized strings
        (``"straggler:0.5@2"``, ``"preempt:2@10"``, ``"fail:1"``), or a
        sequence composing several. Validated here; the stochastic
        lowering into a :class:`~.faults.FaultPlan` happens per
        simulation seed at run time.
        """
        bspec = get_binding(binding)
        pspec = get_placement(placement)
        cores = bspec.lower(topo, threads, seed=bind_seed)
        nodes = pspec.lower(topo, cores[0])
        fault_specs = get_faults(faults)
        for fspec in fault_specs:
            fspec.validate(topo, len(cores))
        if runtime_data == "local" or runtime_data is None:
            rt_node = None
        elif runtime_data == "master":
            rt_node = int(topo.core_node[cores[0]])
        elif isinstance(runtime_data, (int, np.integer)):
            rt_node = int(runtime_data)
            if not 0 <= rt_node < topo.num_nodes:
                raise ValueError(f"runtime_data node {rt_node} outside "
                                 f"topology ({topo.num_nodes} nodes)")
        else:
            raise ValueError(f"runtime_data={runtime_data!r}: expected "
                             "'local', 'master', or a node id")
        if not 0.0 <= migration_rate <= 1.0:
            raise ValueError(f"migration_rate={migration_rate} outside "
                             "[0, 1]")
        return cls(topo=topo, params=params, binding=bspec, placement=pspec,
                   thread_cores=cores, root_data_nodes=nodes,
                   runtime_data_node=rt_node, migration_rate=migration_rate,
                   bind_seed=bind_seed, faults=fault_specs)

    @classmethod
    def from_raw(cls, topo: Topology, params, thread_cores: Sequence[int],
                 root_data_nodes=None, runtime_data_node: Optional[int] = None,
                 migration_rate: float = 0.0) -> "ExecContext":
        """Wrap legacy ``simulate()`` arguments without re-lowering.

        The binding/placement identities become explicit specs; no
        registry parsing, no validation beyond normalization — this is
        the hot-path shim under the positional ``simulate()``.
        """
        cores = tuple(int(c) for c in thread_cores)
        if root_data_nodes is None:
            nodes = None
            pspec = PLACEMENTS["first_touch"]
        else:
            if isinstance(root_data_nodes, (int, np.integer)):
                nodes = (int(root_data_nodes),)
            else:
                nodes = tuple(int(n) for n in root_data_nodes)
            pspec = PlacementSpec(
                f"nodes:{','.join(map(str, nodes))}", kind="explicit",
                nodes=nodes)
        bspec = BindingSpec(f"cores:{','.join(map(str, cores))}",
                            kind="explicit", cores=cores)
        return cls(topo=topo, params=params, binding=bspec, placement=pspec,
                   thread_cores=cores, root_data_nodes=nodes,
                   runtime_data_node=runtime_data_node,
                   migration_rate=migration_rate)
