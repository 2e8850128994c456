"""The ``Machine`` facade: declarative contexts, runs, and figure grids
(own copy of ``repro/core/sim/machine.py``).

One object ties the whole execution-context layer together::

    m = Machine(topology.sunfire_x4600())

    # compile + cache a context: who runs where, where data lives
    ctx = m.context(threads=16, binding="paper", placement="spill:2")
    r = m.run(wl, "dfwsrpt", context=ctx)

    # or inline — equivalent, the context is cached either way
    r = m.run(wl, "dfwsrpt", threads=16, binding="paper",
              placement="spill:2")

    # a whole paper figure as one declarative call: the cartesian
    # product expands straight into a batched SweepPlan
    g = m.grid(workloads=[wl], schedulers=("wf", "dfwspt", "dfwsrpt"),
               threads=(2, 4, 8, 16), placements=("spill:2",))
    speedups = {k: r.speedup for k, r in g.run().items()}

Contexts are compiled once per (threads, binding, placement,
runtime-data, migration, seed) and cached on the ``Machine``; the
underlying binding/placement lowerings are additionally cached on the
(immutable) topology, so several ``Machine`` instances over one
topology share them. Grid cells with mixed variants (the paper's
baseline-Nanos vs NUMA-aware comparisons) pass ``contexts=``: a mapping
of variant label → context keywords, each variant crossed with every
workload, scheduler, thread count, and seed.

A ``Machine`` runs on the card unless it is given ``device="cpu"``: a
grid is then one launch of the simulation kernel, one thread per cell,
and a single run a launch of one cell. On the host the plain version
runs the cells one after another, with the same results bit for bit.
"""

from __future__ import annotations

import collections
import itertools
from typing import Optional, Sequence

from ..topology import Topology
from . import policy
from .context import ExecContext
from .faults import get_faults
from .runtime import SimParams, SimResult, Workload, run_context
from .runtime import serial_time as _serial_time
from .sweep import CellStats, SweepPlan, aggregate

__all__ = ["Machine", "Grid", "GridKey"]


GridKey = collections.namedtuple(
    "GridKey", ["workload", "scheduler", "context", "threads", "seed",
                "faults"], defaults=("none",))
GridKey.__doc__ = """One cell of a :meth:`Machine.grid`.

``workload``/``scheduler`` are names, ``context`` is the variant label
(``bindings × placements`` gives ``"binding/placement"``; an explicit
``contexts=`` mapping gives its keys), ``threads``/``seed`` are ints,
``faults`` is the fault-axis label (``"none"`` when unperturbed).
"""


def _fault_label(specs: tuple) -> str:
    return ",".join(s.name for s in specs) if specs else "none"


def _sched_name(scheduler) -> str:
    return scheduler.name if hasattr(scheduler, "name") else str(scheduler)


class Grid:
    """A compiled figure grid: a batched :class:`SweepPlan` plus the
    :class:`GridKey` of every cell, in plan order, and the device it
    runs on (its machine's). ``store`` (set at construction via
    ``Machine.grid(..., store=)`` or per run) makes every run durable —
    see :meth:`run`."""

    def __init__(self, plan: SweepPlan, keys: list, device=None,
                 store=None):
        self.plan = plan
        self.keys = keys
        self.device = device
        self.store = store

    def __len__(self) -> int:
        return len(self.keys)

    @staticmethod
    def concat(grids: Sequence["Grid"]) -> "Grid":
        """Fuse several grids into one batch (single engine call) —
        e.g. per-workload grids whose placements differ (``spill:K``
        with K per benchmark) but that belong to one paper figure.
        The merged grid runs on the first grid's device and keeps the
        first non-None ``store``."""
        merged = Grid(SweepPlan(), [], grids[0].device if grids else None)
        for g in grids:
            merged.plan.configs.extend(g.plan.configs)
            merged.keys.extend(g.keys)
            if merged.store is None:
                merged.store = g.store
        return merged

    def run(self, strict: bool = True, workers: "int | None" = None,
            *, store=None, resume: "str | None" = None,
            timeout: "float | None" = None,
            retry=None) -> "dict[GridKey, SimResult]":
        """Run the whole grid in one batched engine call.

        Returns ``{GridKey: SimResult}`` in cell order — bit-identical,
        cell for cell, to looping ``simulate()`` over the same grid (see
        :func:`~.sweep.run_sweep`; ``workers`` changes nothing in the
        port). Under ``strict=False`` a failing cell maps to a
        :class:`~.sweep.CellError` instead of aborting the batch.

        Durable execution: ``store`` (a :class:`~.store.ResultStore`
        or journal path; default: the grid's own) journals every
        completed cell and replays already-journaled ones, so
        ``resume="campaign.jsonl"`` — sugar for ``store=`` — picks an
        interrupted campaign back up bit-identically, re-simulating
        only the incomplete cells. ``timeout`` (per-cell wall-clock
        seconds) stops a cell that overruns as a
        :class:`~.sweep.CellTimeout`, and ``retry`` (a
        :class:`~.sweep.RetryPolicy`) re-attempts transient failures on
        the same device; see :func:`~.sweep.run_sweep`.
        """
        if len(set(self.keys)) != len(self.keys):
            seen: set = set()
            dup = next(k for k in self.keys if k in seen or seen.add(k))
            raise ValueError(
                f"grid has duplicate cells (e.g. {dup}); the result dict "
                "would silently drop them — dedupe schedulers/seeds or "
                "the grids passed to Grid.concat")
        if resume is not None:
            if store is not None:
                raise ValueError("pass either store= or resume=, not both")
            store = resume
        if store is None:
            store = self.store
        return dict(zip(self.keys,
                        self.plan.run(strict=strict, workers=workers,
                                      store=store, timeout=timeout,
                                      retry=retry, device=self.device)))

    def run_stats(self, strict: bool = True,
                  workers: "int | None" = None, *, store=None,
                  resume: "str | None" = None,
                  timeout: "float | None" = None,
                  retry=None) -> "dict[GridKey, CellStats]":
        """Run the grid and fold the Monte-Carlo seed axis into stats.

        Replicas — cells identical up to ``seed`` — aggregate into one
        :class:`~.sweep.CellStats` (mean/std/min/max/CI95 per metric,
        raw per-seed results in ``.results``), keyed by the cell's
        :class:`GridKey` with ``seed=None``. Under ``strict=False``
        failed replicas land in ``.errors`` and the stats cover the
        survivors. Durability knobs as in :meth:`run`.
        """
        res = self.run(strict=strict, workers=workers, store=store,
                       resume=resume, timeout=timeout, retry=retry)
        groups: "dict[GridKey, list]" = {}
        for k, r in res.items():
            groups.setdefault(k._replace(seed=None), []).append(r)
        return {k: aggregate(rs) for k, rs in groups.items()}


class Machine:
    """A topology + cost model with compiled-context caching (see
    module docstring), on ``device`` (``None``: the card; ``"cpu"``: the
    plain version on the host)."""

    def __init__(self, topo: Topology, params: Optional[SimParams] = None,
                 *, bind_seed: int = 0, device=None):
        from ... import default_device
        self.topo = topo
        self.params = params or SimParams()
        self.bind_seed = bind_seed
        self.device = default_device(device)
        self._contexts: dict = {}

    def __repr__(self) -> str:
        return (f"Machine({self.topo.name}: {self.topo.num_cores} cores / "
                f"{self.topo.num_nodes} nodes on {self.device}, "
                f"{len(self._contexts)} cached contexts)")

    @property
    def compile_cache(self):
        """The process-wide persistent compile cache handle (or None).

        Every machine — and every grid cell run through one — shares
        this handle, so its ``stats()`` aggregate table/serial/context
        hits across a whole campaign.
        """
        from .compile_cache import get_cache
        return get_cache()

    # ------------------------------------------------------------------
    def context(self, threads: Optional[int] = None, *,
                binding="paper", placement="first_touch",
                runtime_data="local", migration_rate: float = 0.0,
                bind_seed: Optional[int] = None,
                faults=()) -> ExecContext:
        """Compile (and cache) one execution context.

        Args:
          threads: thread count N (optional for explicit core-list
            bindings, which pin their own length).
          binding: :class:`~.context.BindingSpec`, registered name
            (``"paper"``, ``"linear"``, ``"scatter"``, ``"node_fill"``),
            ``"cores:a,b,..."``, or an explicit core sequence.
          placement: :class:`~.context.PlacementSpec`, registered name
            (``"first_touch"``, ``"interleave"``), parametrized form
            (``"spill:K"``, ``"spill:K@N"``, ``"node:N"``,
            ``"nodes:a,b"``), an explicit node / node sequence, or None.
          runtime_data: ``"local"`` (paper's per-thread runtime data),
            ``"master"``, or an explicit node id (baseline Nanos).
          migration_rate: per-task OS thread-migration probability
            (baseline Nanos leaves threads unbound).
          bind_seed: tie-break seed for the ``"paper"`` binding
            (default: the Machine's).
          faults: declarative fault model(s) — :class:`~.faults.FaultSpec`,
            a parametrized string (``"straggler:0.5@2"``, ``"preempt:2@10"``,
            ``"fail:1@30"``), or a sequence composing several. The
            stochastic lowering happens per simulation seed at run time.
        """
        if bind_seed is None:
            bind_seed = self.bind_seed
        binding = tuple(int(c) for c in binding) \
            if isinstance(binding, (list, range)) else binding
        placement = tuple(int(n) for n in placement) \
            if isinstance(placement, (list, range)) else placement
        faults = get_faults(faults)     # normalized: hashable + validated
        key = (threads, binding, placement, runtime_data, migration_rate,
               bind_seed, faults)
        try:
            ctx = self._contexts.get(key)
        except TypeError:           # unhashable spec forms: compile fresh
            key, ctx = None, None
        if ctx is None:
            ctx = ExecContext.compile(
                self.topo, self.params, threads, binding, placement,
                runtime_data, migration_rate, bind_seed, faults)
            if key is not None:
                self._contexts[key] = ctx
        return ctx

    # ------------------------------------------------------------------
    def run(self, workload: Workload, scheduler, *, seed: int = 0,
            context: Optional[ExecContext] = None,
            serial_reference: Optional[float] = None,
            store=None, **context_kwargs) -> SimResult:
        """Simulate ``workload`` under ``scheduler`` on this machine's
        device.

        Pass a pre-compiled ``context=`` or any :meth:`context` keywords
        (``threads=16, binding="paper", placement="spill:2"``) inline.
        With ``store=`` (a :class:`~.store.ResultStore` or journal
        path) the cell goes through the durable sweep path: an
        already-journaled result is replayed without simulating, a
        fresh one is committed before returning.
        """
        if context is None:
            context = self.context(**context_kwargs)
        elif context_kwargs:
            raise ValueError("pass either context= or context keywords, "
                             f"not both: {sorted(context_kwargs)}")
        if store is not None:
            plan = SweepPlan()
            plan.add_context(context, workload, scheduler, seed=seed,
                             serial_reference=serial_reference)
            return plan.run(store=store, device=self.device)[0]
        return run_context(context, workload, scheduler, seed,
                           serial_reference, self.device)

    def serial_time(self, workload: Workload, *, core: int = 0,
                    placement="first_touch") -> float:
        """Single-thread reference time on ``core`` under ``placement``
        (the paper measures one serial time per benchmark, on the
        boot core with the baseline data placement)."""
        from .context import get_placement
        nodes = get_placement(placement).lower(self.topo, core)
        return _serial_time(self.topo, workload, core, nodes, self.params)

    # ------------------------------------------------------------------
    def grid(self, *, workloads, schedulers, threads=None,
             bindings=("paper",), placements=("first_touch",),
             contexts=None, seeds=(0,), runtime_data="local",
             migration_rate: float = 0.0, faults=None,
             serial_reference=None, store=None) -> Grid:
        """Expand a cartesian product into one batched :class:`Grid`.

        Args:
          workloads: one :class:`Workload`, a sequence of them (keyed by
            ``.name``), or a ``{name: Workload}`` mapping.
          schedulers: scheduler names / specs.
          threads: thread count(s); a single int is broadcast.
          bindings, placements: context variants, crossed with
            everything else; each cell's variant label is
            ``"binding/placement"``.
          contexts: ``{label: {context kwargs}}`` — replaces the
            bindings × placements cross for heterogeneous variants
            (e.g. the paper's baseline-vs-NUMA figures, where binding,
            placement, runtime data, and migration all change together);
            mutually exclusive with non-default bindings/placements.
            A variant may pin its own ``threads``; that variant then
            emits one set of cells at the pinned count instead of one
            per grid-level count.
          seeds: simulation seeds — a sequence of explicit seeds, or an
            int ``n`` as Monte-Carlo shorthand for ``range(n)`` (``n``
            replicas per cell; aggregate with :meth:`Grid.run_stats`).
          runtime_data, migration_rate: defaults for every variant
            (``contexts=`` values override per variant).
          faults: a fault *axis* crossed with everything else — a
            sequence of fault descriptions (each a spec, string, ``()``
            / ``None`` for the unperturbed baseline, or a sequence
            composing several); ``None`` (default) keeps every cell
            fault-free. Cell keys carry the fault label (``"none"``
            for the baseline).
          serial_reference: speedup denominator — ``None`` (per-cell
            default), one float for every cell, or ``{workload name:
            float}`` (the paper's one-serial-per-benchmark convention).
          store: a :class:`~.store.ResultStore` (or journal path) every
            run of the returned grid journals to / replays from — the
            durable-sweep default for this grid (``Grid.run`` can still
            override per call).

        Validation is aggregated: every invalid cell in the expansion —
        unknown scheduler, bad binding/placement, malformed fault — is
        collected and reported in one ``ValueError`` listing each
        offending (workload, scheduler, context) label, instead of
        failing fast on the first.

        Returns a :class:`Grid` on this machine's device; ``.run()``
        gives ``{GridKey: SimResult}``, bit-identical to the hand-written
        per-cell loop.
        """
        if isinstance(workloads, Workload):
            workloads = [workloads]
        if isinstance(workloads, dict):
            wl_items = list(workloads.items())
        else:
            wl_items = [(wl.name, wl) for wl in workloads]
        names = [n for n, _ in wl_items]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate workload names {names}; pass a "
                             "{name: workload} mapping to disambiguate")
        if isinstance(schedulers, (str, policy.SchedulerSpec)):
            schedulers = [schedulers]
        if threads is None:
            thread_counts: Sequence = (None,)
        elif isinstance(threads, int):
            thread_counts = (threads,)
        else:
            thread_counts = tuple(threads)
        # Monte-Carlo shorthand: seeds=32 means 32 replicas per cell
        # (seeds 0..31); pass an explicit sequence for specific seeds.
        if isinstance(seeds, int):
            seeds = tuple(range(seeds))

        if contexts is None:
            contexts = {}
            for b, p in itertools.product(bindings, placements):
                label = (f"{getattr(b, 'name', b)}/"
                         f"{getattr(p, 'name', p)}")
                contexts[label] = dict(binding=b, placement=p)
        elif tuple(bindings) != ("paper",) or \
                tuple(placements) != ("first_touch",):
            raise ValueError("pass either contexts= or bindings=/"
                             "placements=, not both — contexts would "
                             "silently win")
        base_kw = dict(runtime_data=runtime_data,
                       migration_rate=migration_rate)
        errors: list = []

        # the fault axis: each entry lowers to a normalized spec tuple
        # + display label; malformed entries join the aggregated report
        fault_axis: list = []
        for f in ([None] if faults is None else faults):
            try:
                specs = get_faults(f)
            except (ValueError, TypeError) as e:
                errors.append(f"fault axis entry {f!r}: {e}")
                continue
            fault_axis.append((specs, _fault_label(specs)))

        def serial_for(name):
            if serial_reference is None:
                return None
            if isinstance(serial_reference, dict):
                return serial_reference[name]
            return serial_reference

        plan = SweepPlan()
        keys: list = []
        for (wl_name, wl), (label, ctx_kw) in itertools.product(
                wl_items, contexts.items()):
            ctx_kw = dict(ctx_kw)
            pinned = ctx_kw.pop("threads", None)
            serial = serial_for(wl_name)
            for T, (fspecs, flabel) in itertools.product(
                    (thread_counts if pinned is None else (pinned,)),
                    fault_axis):
                try:
                    ectx = self.context(
                        T, **{**base_kw, **ctx_kw, "faults": fspecs})
                except (ValueError, TypeError) as e:
                    errors.append(f"grid cell (*/{label}/T={T}"
                                  f"/faults={flabel}): {e}")
                    continue
                for sched, seed in itertools.product(schedulers, seeds):
                    cell = (f"grid cell ({wl_name}/{_sched_name(sched)}/"
                            f"{label}/T={ectx.threads}/seed={seed}"
                            f"/faults={flabel})")
                    cfg = plan.add_context(ectx, wl, sched, seed=seed,
                                           serial_reference=serial,
                                           label=cell, errors=errors)
                    if cfg is not None:
                        keys.append(GridKey(wl_name, _sched_name(sched),
                                            label, ectx.threads, seed,
                                            flabel))
        if errors:
            uniq = list(dict.fromkeys(errors))
            raise ValueError(
                f"{len(errors)} invalid grid cell(s):\n  "
                + "\n  ".join(uniq))
        return Grid(plan, keys, self.device, store=store)
