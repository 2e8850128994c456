"""Discrete-event simulator of the NANOS task runtime on a NUMA machine.

This is the *paper-faithful* reproduction layer: OpenMP-style tasking with
per-thread LIFO task pools, the three stock Nanos schedulers the paper
benchmarks against (breadth-first, Cilk-based, work-first), and the two
NUMA-aware schedulers the paper contributes (DFWSPT, DFWSRPT), running on
an explicit hop-distance topology with a first-touch memory model.

Machine/cost model (constants in :class:`SimParams`):

* executing a task on core ``c`` costs::

      work * (1 + mem_intensity * hop_lambda *
                 (f_root * d(c, root_data_node) + f_parent * d(c, parent_exec_node)))

  ``root_data_node`` is where the benchmark's big arrays were allocated —
  the node of the *master thread's* core under Linux first-touch (paper
  §V.B); ``parent_exec_node`` is where the task's parent ran (temporaries
  + hot caches), so depth-first execution on the same core is free of the
  second term, exactly the locality the paper exploits.

* the breadth-first scheduler's single shared queue is a serialized
  resource (a lock): every push/pop waits for the previous holder. With
  millions of tiny tasks this serialization collapses scalability — the
  paper's FFT observation (speedup 4.43x@6 cores → 2.39x@16).

* a steal probe on a victim at ``d`` hops costs
  ``steal_time * (1 + hop_lambda_steal * d)`` — remote queue metadata
  lives in the victim's node memory.

The simulator is deterministic given (workload, params, seed).

Engine architecture (this module is the public API; own copy of
``repro/core/sim/runtime.py``):

* :class:`TaskSpec` trees are compiled once per workload into a flat
  CSR :class:`TaskTable` (structure-of-arrays; see ``table.py``) and
  cached on the :class:`Workload`. Paper-scale workloads (millions of
  tasks) are built directly as tables without ever materializing a
  Python tree (see ``bots.make(name, "paper")``).
* schedulers are **declarative policies**, not engine branches: a
  :class:`~.policy.SchedulerSpec` names a queue discipline, a spawn
  order and a victim policy, and ``policy.compile_victim_plan`` lowers
  the victim policy once per (topology, binding) into group/unit arrays
  that both engines consume identically.
* the event loop runs where the caller's device says, with no engine
  variable and no fallback: on a CUDA device every cell is a thread of
  the hand-written kernel ``kernels/csrc/sim.cu`` (through
  :mod:`repro_torch.kernels.sim`, which launches it or raises); on
  ``device="cpu"`` the plain version ``_engine_py`` runs on the host.
  Both match the JAX package's C engine bit for bit — same rng draw
  sequence, same event ordering, same float association — and
  ``SimResult.engine`` names the one that ran (``"cuda"`` or
  ``"plain"``).
* the *execution context* — who runs where, where data lives — is
  declarative too (:mod:`.context`): a binding and a placement lower
  once per (topology, T, seed) into an immutable
  :class:`~.context.ExecContext`. :func:`run_context` consumes one; the
  positional :func:`simulate` wraps its raw arguments into one; the
  :class:`~.machine.Machine` facade compiles, caches and sweeps them.
* many-config grids (the paper's figure sweeps) go through
  :mod:`.sweep`: a ``SweepPlan`` shares every compiled artifact across
  configs and the card runs the whole batch in one kernel launch (or a
  few waves, where device memory asks for them).
* ``SimParams(trace=True)`` records every committed execution, steal
  and migration (:mod:`.trace`); on the card it launches the kernel's
  traced instantiation, whose untraced twin carries no per-event
  bookkeeping. Compiled tables, serial references, context lowerings
  and victim plans persist across processes in :mod:`.compile_cache`;
  :mod:`.store` journals sweep results, and :func:`resolve_timeout`
  gives each cell a wall-clock deadline.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np

from ..topology import Topology, lazy_cache
from . import policy
from .context import ExecContext
from .faults import compile_fault_plan
from .policy import SCHEDULERS, SchedulerSpec
from .table import TaskTable, compile_tree

__all__ = [
    "TaskSpec", "Workload", "SimParams", "SimResult", "SimStalled",
    "simulate", "run_context", "serial_time", "run_cells",
    "resolve_timeout", "SCHEDULERS", "SchedulerSpec", "TaskTable",
    "ensure_table",
]


class SimStalled(RuntimeError):
    """The event loop did not complete the workload.

    ``reason`` is ``"watchdog"`` (the step-count budget — see
    ``SimParams.max_steps`` — was exhausted: a hung loop became this
    diagnosable error instead of spinning forever) or ``"stranded"``
    (the loop drained with tasks left unexecuted — work was lost, e.g.
    by a fault model no thread survived to clean up after).
    ``scheduler``, ``last_t`` (last event time), ``steps``, and the
    optional sweep ``cell`` label identify the offending run.
    """

    def __init__(self, reason: str, scheduler: str, last_t: float,
                 steps: int, executed: int, tasks: int,
                 cell: "str | None" = None):
        self.reason = reason
        self.scheduler = scheduler
        self.last_t = last_t
        self.steps = steps
        self.executed = executed
        self.tasks = tasks
        self.cell = cell
        where = f"{cell}: " if cell else ""
        if reason == "watchdog":
            msg = (f"{where}simulation stalled under scheduler "
                   f"{scheduler!r}: step watchdog fired after {steps} "
                   f"events at t={last_t:.6g} "
                   f"({executed}/{tasks} tasks executed)")
        else:
            msg = (f"{where}simulation under scheduler {scheduler!r} "
                   f"drained with stranded work: {executed}/{tasks} "
                   f"tasks executed, last event t={last_t:.6g}")
        super().__init__(msg)

    def with_cell(self, cell: str) -> "SimStalled":
        """A copy naming the sweep cell the stall occurred in."""
        return SimStalled(self.reason, self.scheduler, self.last_t,
                          self.steps, self.executed, self.tasks, cell)


@dataclasses.dataclass
class TaskSpec:
    """A node of the benchmark's task tree.

    work_pre:  compute units before spawning children.
    work_post: compute units of the join continuation (0 = no taskwait).
    f_root:    fraction of this task's memory traffic hitting the root
               arrays (allocated by master at startup, first-touch).
    f_parent:  fraction hitting the parent's temporaries / caches.
    children:  sub-tasks spawned after work_pre.
    """
    work_pre: float
    work_post: float = 0.0
    f_root: float = 0.0
    f_parent: float = 0.0
    children: list["TaskSpec"] = dataclasses.field(default_factory=list)
    # spawned when all ``children`` complete (BOTS-style parallel combine
    # wave after a taskwait); ``work_post`` runs after *these* complete.
    post_children: list["TaskSpec"] = dataclasses.field(default_factory=list)

    def count(self) -> int:
        stack, n = [self], 0
        while stack:
            t = stack.pop()
            n += 1
            stack.extend(t.children)
            stack.extend(t.post_children)
        return n

    def total_work(self) -> float:
        stack, w = [self], 0.0
        while stack:
            t = stack.pop()
            w += t.work_pre + t.work_post
            stack.extend(t.children)
            stack.extend(t.post_children)
        return w


@dataclasses.dataclass
class Workload:
    name: str
    root: Optional[TaskSpec]
    mem_intensity: float  # µ — how memory-bound the benchmark is (0..~1)
    # compiled flat form; populated lazily from ``root`` (cached), or
    # directly by the paper-scale builders (which have no tree).
    table: Optional[TaskTable] = None


def ensure_table(workload: Workload) -> TaskTable:
    """Compile (once) and return the workload's flat task table."""
    tbl = workload.table
    if tbl is None:
        if workload.root is None:
            raise ValueError(f"workload {workload.name!r} has neither a "
                             "task tree nor a compiled table")
        tbl = compile_tree(workload.root)
        workload.table = tbl
    return tbl


@dataclasses.dataclass(frozen=True)
class SimParams:
    hop_lambda: float = 0.4         # NUMA factor slope per hop (exec)
    hop_lambda_steal: float = 2.0   # per-hop slope for steal probes
    lock_time: float = 0.25         # serialized shared-queue op cost
    deque_lock_time: float = 0.4    # victim-deque serialized op cost
    steal_time: float = 1.5         # base steal probe cost
    spawn_time: float = 0.02        # per-child task-creation overhead
    wake_latency: float = 0.05      # parked thread wake-up latency
    qop_time: float = 0.05          # local task-pool push/pop cost
    cache_refill: float = 4.0       # work units lost per thread migration
    # event-loop watchdog budget; <= 0 sizes it automatically from the
    # workload (generous — legitimate runs never trip it). A hung loop
    # raises SimStalled instead of spinning forever.
    max_steps: int = 0
    # the JAX package's batch worker count. The port runs a grid as one
    # kernel launch (one thread per cell) on the card and serially on
    # the host, so this changes nothing; kept so the field set matches.
    workers: int = 0
    # record a full event trace (see trace.TraceBuffer) on SimResult.trace.
    # Purely observational: metrics are bit-identical traced vs untraced
    # (the card's untraced instantiation carries no per-event
    # bookkeeping), and both engines record the same events.
    trace: bool = False


@dataclasses.dataclass
class SimResult:
    makespan: float
    serial_time: float
    speedup: float
    tasks: int
    steals: int
    failed_probes: int
    remote_work_fraction: float  # share of exec time that was NUMA penalty
    queue_wait: float            # total time spent waiting on the bf lock
    # ---- fault accounting (all zero on fault-free runs) ----
    reclaimed: int = 0           # tasks made re-stealable by offline threads
    reexec: int = 0              # executions aborted mid-run and re-executed
    fault_lost: float = 0.0      # partial work discarded by preemption/failure
    # ---- always-on locality aggregates (cheap O(1) counters; excluded
    # from equality like ``engine`` so golden fixtures stay valid) ----
    # successful steals by hop distance: steal_hops[d] = steals at d hops
    steal_hops: tuple = dataclasses.field(default=(), compare=False)
    # per exec node: tasks executed there / NUMA penalty time paid there
    node_tasks: tuple = dataclasses.field(default=(), compare=False)
    node_remote: tuple = dataclasses.field(default=(), compare=False)
    # which engine actually ran ('cuda' or 'plain'); excluded from
    # equality so cross-engine parity checks compare metrics only.
    engine: str = dataclasses.field(default="", compare=False)
    # full event trace (a trace.TraceBuffer) when SimParams(trace=True);
    # observational, so excluded from equality like ``engine``.
    trace: "object | None" = dataclasses.field(default=None, compare=False,
                                               repr=False)


def _root_data_setup(topo: Topology, core: int, root_data_nodes):
    """Normalize ``root_data_nodes`` and compute per-node mean distance.

    None → the node of ``core`` (Linux first-touch by the master thread);
    int → a single explicit node. Large inputs spill over several nodes
    and pages are interleaved over the spill set, so the access distance
    is the mean over it (paper §V.B). The mean-distance vector is cached
    on the topology per spill set — sweeps hit the same handful of
    placements across hundreds of configs.
    """
    if root_data_nodes is None:
        root_data_nodes = [int(topo.core_node[core])]
    elif isinstance(root_data_nodes, (int, np.integer)):
        root_data_nodes = [int(root_data_nodes)]
    else:
        root_data_nodes = [int(n) for n in root_data_nodes]
    cache = lazy_cache(topo, "_root_dist_cache")
    key = tuple(root_data_nodes)
    root_dist = cache.get(key)
    if root_dist is None:
        root_dist = np.ascontiguousarray(
            topo.node_distance[:, root_data_nodes].mean(axis=1),
            dtype=np.float64)
        cache[key] = root_dist
    return root_data_nodes, root_dist


def serial_time(topo: Topology, workload: Workload, core: int,
                root_data_nodes, params: "SimParams | None" = None) -> float:
    """Single-thread execution time on ``core`` under the NUMA cost model.

    Depth-first on one core ⇒ parent data always local (d_parent = 0);
    only the root-array distance (incl. spill interleave) is paid.

    The traversal runs over the compiled task table in the same stack
    order as the original tree walk (bit-identical sum), and the result
    is cached on the table per (distance, µ, λ) key — benchmark scripts
    call this with identical arguments hundreds of times — *and* in the
    persistent :mod:`~.compile_cache` keyed by (table fingerprint,
    topology fingerprint, root distance, µ, λ), so the full serial walk
    runs once per machine (JSON round-trips the float exactly). It runs
    on the host: one walk a workload, as the JAX package's does.
    """
    p = params or SimParams()
    _, root_dist = _root_data_setup(topo, core, root_data_nodes)
    d_root = float(root_dist[topo.core_node[core]])
    tbl = ensure_table(workload)
    key = (d_root, workload.mem_intensity, p.hop_lambda)
    cached = tbl._serial_cache.get(key)
    if cached is not None:
        return cached
    # consult the persistent cache *before* tbl.lists() — materializing
    # the list views of a paper-scale table costs ~1 s by itself
    from .compile_cache import digest_key, get_cache
    pcache = get_cache()
    pkey = None
    if pcache is not None:
        pkey = digest_key("serial", tbl.fingerprint(), topo.fingerprint(),
                          d_root, float(workload.mem_intensity),
                          float(p.hop_lambda))
        stored = pcache.get_serial(pkey)
        if stored is not None:
            tbl._serial_cache[key] = stored
            return stored
    mu_lam = workload.mem_intensity * p.hop_lambda
    coef = [(mu_lam * fr) * d_root for fr in tbl.cls_f_root.tolist()]
    wp_l, wpo_l, fc_l, nc_l, fpw_l, npw_l, _, cls_l = tbl.lists()
    total = 0.0
    stack = [0]
    pop = stack.pop
    extend = stack.extend
    while stack:
        i = pop()
        total += (wp_l[i] + wpo_l[i]) * (1.0 + coef[cls_l[i]])
        nk = nc_l[i]
        if nk:
            base = fc_l[i]
            extend(range(base, base + nk))
        kp = npw_l[i]
        if kp:
            base = fpw_l[i]
            extend(range(base, base + kp))
    tbl._serial_cache[key] = total
    if pcache is not None:
        pcache.put_serial(pkey, total)
    return total


def resolve_timeout(timeout: "float | None" = None) -> "float | None":
    """Resolve the per-cell wall-clock timeout (seconds, or None).

    Precedence: explicit ``timeout`` argument > the ``REPRO_SIM_TIMEOUT``
    env var > None (no deadline). ``0`` or negative disables. Each cell's
    clock starts when that cell starts: on the card when its thread
    begins the cell (``%globaltimer``), on the host when the plain
    version takes it up. Both check the deadline every few thousand
    events and stop the cell with a :class:`~.sweep.CellTimeout`; its
    siblings run on untouched.
    """
    if timeout is not None:
        return float(timeout) if timeout > 0 else None
    env = os.environ.get("REPRO_SIM_TIMEOUT")
    if env is not None and env.strip():
        try:
            t = float(env)
        except ValueError:
            raise ValueError(
                f"REPRO_SIM_TIMEOUT={env!r}: expected seconds") from None
        return t if t > 0 else None
    return None


def _prepare_ctx(ectx: ExecContext,
                 workload: Workload,
                 spec: SchedulerSpec,
                 seed: int) -> dict:
    """Lower one :class:`ExecContext` into an engine-ready dict.

    Every compiled artifact is cached where sweeps can share it: the
    task table on the workload, the victim plan and root-distance
    vectors on the topology, the serial reference on the table.
    """
    topo = ectx.topo
    p = ectx.params
    cores = [int(c) for c in ectx.thread_cores]
    tbl = ensure_table(workload)
    root_data_nodes, root_dist = _root_data_setup(topo, cores[0],
                                                  ectx.root_data_nodes)
    ctx: dict = dict(
        table=tbl, T=len(cores), cores=cores, seed=seed,
        queue_shared=spec.queue == "shared",
        child_first=spec.spawn == "child_first",
        vplan=policy.compile_victim_plan(spec, topo, cores),
        num_cores=topo.num_cores, num_nodes=topo.num_nodes,
        core_node_arr=np.ascontiguousarray(topo.core_node, dtype=np.int64),
        node_dist_flat=np.ascontiguousarray(topo.node_distance,
                                            dtype=np.int64).ravel(),
        root_dist=root_dist,
        root_data_nodes=root_data_nodes,
        root_node0=int(root_data_nodes[0]),
        runtime_data_node=ectx.runtime_data_node,
        migration_rate=ectx.migration_rate,
        mem_intensity=workload.mem_intensity,
        hop_lambda=p.hop_lambda, hop_lambda_steal=p.hop_lambda_steal,
        lock_time=p.lock_time, deque_lock_time=p.deque_lock_time,
        steal_time=p.steal_time, spawn_time=p.spawn_time,
        wake_latency=p.wake_latency, qop_time=p.qop_time,
        cache_refill=p.cache_refill,
    )
    # fault plan: compiled (and cached on the topology) per (specs,
    # binding, seed) from a dedicated RNG stream — the engine rng below
    # is untouched, keeping fault-free runs golden-exact.
    faults = getattr(ectx, "faults", ())
    fplan = compile_fault_plan(faults, topo, cores, seed) if faults else None
    ctx["fault_plan"] = fplan
    ms = getattr(p, "max_steps", 0)
    if ms <= 0:
        nw = fplan.n_windows if fplan is not None else 0
        ms = 10_000 + 1_000 * len(cores) + 50 * (tbl.n + nw)
    ctx["max_steps"] = int(ms)
    ctx["scheduler_name"] = spec.name
    # trace capture flag + hop-histogram width (max hop distance + 1);
    # the always-on aggregates need the width even when tracing is off.
    ctx["trace"] = bool(getattr(p, "trace", False))
    ctx["max_hop"] = int(ctx["node_dist_flat"].max())
    # Fresh per-config stream, seeded exactly as the seed engine did.
    # Victim-plan compilation consumes no draws, so the engine always
    # starts from RandomState(seed)'s initial state.
    ctx["rng"] = np.random.RandomState(seed)
    return ctx


def _finish_result(ctx: dict, out: dict, serial: float,
                   engine: str) -> SimResult:
    status = out.get("status", 0)
    if status:
        raise SimStalled("watchdog" if status == 1 else "stranded",
                         ctx.get("scheduler_name", "?"),
                         out.get("last_t", 0.0), out.get("steps", 0),
                         out.get("executed", 0), ctx["table"].n)
    makespan = out["makespan"]
    rf = out["remote"] / max(out["total_exec"], 1e-12)
    tr = out.get("trace")
    if tr is not None:
        tr.meta.update(
            scheduler=ctx.get("scheduler_name", "?"), seed=int(ctx["seed"]),
            engine=engine, threads=int(ctx["T"]),
            num_nodes=int(ctx["num_nodes"]), num_cores=int(ctx["num_cores"]),
            tasks=int(ctx["table"].n), makespan=float(makespan))
    return SimResult(
        makespan=makespan,
        serial_time=serial,
        speedup=serial / makespan if makespan > 0 else float("nan"),
        tasks=ctx["table"].n,
        steals=out["steals"],
        failed_probes=out["failed"],
        remote_work_fraction=rf,
        queue_wait=out["queue_wait"],
        reclaimed=out.get("reclaimed", 0),
        reexec=out.get("reexec", 0),
        fault_lost=out.get("fault_lost", 0.0),
        steal_hops=tuple(int(x) for x in out.get("steal_hops", ())),
        node_tasks=tuple(int(x) for x in out.get("node_tasks", ())),
        node_remote=tuple(float(x) for x in out.get("node_remote", ())),
        engine=engine,
        trace=tr,
    )


def run_cells(ctxs: list, device, timeout: "float | None" = None) -> tuple:
    """Run prepared contexts on ``device``: one entry per context, the
    raw result dict or the exception that cell raised.

    A CUDA device runs the whole batch in the card's kernel
    (:func:`repro_torch.kernels.sim.run_batch`, which launches or
    raises: a build or launch failure propagates, no cell falls back to
    the host); ``cpu`` runs the plain version, one cell after another.
    ``timeout`` (seconds, or None) is each cell's wall-clock deadline: a
    cell that passes it gets a :class:`~.sweep.CellTimeout` in its slot.
    Returns ``(results, engine)``.
    """
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        from ...kernels import sim as sim_kernel
        return sim_kernel.run_batch(ctxs, dev, timeout=timeout), "cuda"
    if dev.type != "cpu":
        raise ValueError(f"the simulator runs on 'cuda' or 'cpu', not "
                         f"{dev.type!r}")
    from . import _engine_py
    return _engine_py.run_batch(ctxs, timeout=timeout), "plain"


def run_context(ectx: ExecContext,
                workload: Workload,
                scheduler: "str | SchedulerSpec",
                seed: int = 0,
                serial_reference: float | None = None,
                device=None) -> SimResult:
    """Run ``workload`` under a compiled :class:`ExecContext`.

    This is the engine entry point everything funnels through:
    :func:`simulate` wraps its raw arguments into a context,
    :meth:`.machine.Machine.run` passes cached ones, and
    :func:`.sweep.run_sweep` batches many.

    ``serial_reference`` overrides the speedup denominator; the default
    is :func:`serial_time` on the context's master core with the
    context's data placement. Pass one common value when comparing
    variants like the paper does. ``device``: ``None`` (the card) or
    ``"cpu"`` (the plain version on the host); see :func:`run_cells`.
    """
    from ... import default_device
    dev = default_device(device)
    spec = policy.get_spec(scheduler)
    ctx = _prepare_ctx(ectx, workload, spec, seed)
    (out,), engine = run_cells([ctx], dev)
    if isinstance(out, Exception):
        raise out

    # serial reference: one thread on the master core, same data placement.
    if serial_reference is not None:
        serial = serial_reference
    else:
        serial = serial_time(ectx.topo, workload, ectx.thread_cores[0],
                             ctx["root_data_nodes"], ectx.params)
    return _finish_result(ctx, out, serial, engine)


def simulate(topo: Topology,
             thread_cores: Sequence[int],
             workload: Workload,
             scheduler: "str | SchedulerSpec",
             params: SimParams | None = None,
             seed: int = 0,
             root_data_nodes: int | Sequence[int] | None = None,
             runtime_data_node: int | None = None,
             migration_rate: float = 0.0,
             serial_reference: float | None = None,
             device=None) -> SimResult:
    """Run ``workload`` on ``len(thread_cores)`` threads; return metrics.

    Legacy positional form — a thin shim that wraps the raw arguments
    into an explicit :class:`ExecContext` and delegates to
    :func:`run_context`. New code should prefer the
    :class:`~.machine.Machine` facade, which compiles and caches
    declarative contexts (``binding="paper"``, ``placement="spill:2"``).

    Args:
      thread_cores: core id per thread; thread 0 is the master (its node
        receives the root arrays under first-touch unless overridden).
      scheduler: a registered scheduler name (see ``SCHEDULERS``) or a
        :class:`SchedulerSpec` directly.
      root_data_nodes: node(s) holding the benchmark's big arrays. Large
        inputs spill over several nodes (Linux first-touch falls back to
        nearby nodes when one fills — paper §V.B); pages are interleaved
        over the spill set, so the access distance is the mean over it.
        Default: the master thread's node (no spill).
      runtime_data_node: baseline Nanos first-touches *runtime* structures
        (task pools, descriptors) on the initializing master's node — pass
        that node to model it. ``None`` models the paper's modification:
        each thread's runtime data lives on its own node (paper §IV end).
      migration_rate: probability per task that the OS migrates the
        executing thread to another core (baseline Nanos does not pin
        threads; the paper's extension binds them). A migration pays a
        cache-refill cost and lands the depth-first chain on a new node.
      serial_reference: serial time for the speedup denominator. Default:
        :func:`serial_time` on the master core with the same data nodes.
        Pass one common value when comparing variants like the paper does.
      device: ``None`` runs on the card, ``"cpu"`` the plain version.
    """
    ectx = ExecContext.from_raw(topo, params or SimParams(), thread_cores,
                                root_data_nodes, runtime_data_node,
                                migration_rate)
    return run_context(ectx, workload, scheduler, seed, serial_reference,
                       device)
