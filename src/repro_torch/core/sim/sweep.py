"""Batched simulation sweeps (own copy of ``repro/core/sim/sweep.py``).

The paper-reproduction scripts run *grids*: every figure is a cartesian
sweep over (topology, thread binding, workload, scheduler, data
placement, seed). A :class:`SweepPlan` prepares every config up front —
sharing the compiled task tables (cached on the workload), victim plans
and root-distance vectors (cached on the topology), and serial-time
references (cached on the table) — and hands the whole batch to the
engine in one call. On a CUDA device that is one launch of the card's
kernel, one thread per cell (:func:`repro_torch.kernels.sim.run_batch`;
a grid that does not fit the device's memory runs in a few waves).

Results are bit-identical to the per-call loop: each config gets its own
``RandomState(seed)`` stream and the engines are untouched — batching
changes *when* work is dispatched, never *what* runs.

Configs are validated at :meth:`SweepPlan.add` time — an unknown
scheduler, a core outside the topology, or a bad spill node fails
immediately with the offending grid cell named.

Every config lowers to an immutable :class:`~.context.ExecContext`
before running; :meth:`SweepPlan.add_context` takes one directly (the
:class:`~.machine.Machine` facade builds plans this way), while
:meth:`SweepPlan.add` keeps the legacy ``simulate()`` argument tuple.

Example::

    plan = SweepPlan()
    for T in (2, 4, 8, 16):
        for sched in ("wf", "dfwspt", "dfwsrpt"):
            plan.add(topo, priority.allocate_threads(topo, T), wl, sched,
                     root_data_nodes=spill, serial_reference=serial)
    results = plan.run()        # list[SimResult], one per add() order

or, declaratively (one call per paper figure)::

    Machine(topo).grid(workloads=[wl], schedulers=("wf", "dfwsrpt"),
                       threads=(2, 4, 8, 16), placements=("spill:2",))

Durable sweeps: ``store=`` journals every completed cell and replays
journaled ones without preparing a context or launching (:mod:`.store`);
``timeout=`` gives each cell a wall-clock deadline, checked inside the
cell on the card and on the host alike. The JAX package runs a timed
batch on a fork pool of killable workers and has ``WorkerDied``; the
port has no worker processes, so it has neither.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional, Sequence

import numpy as np

from . import policy
from .context import ExecContext
from .runtime import (SimParams, SimResult, SimStalled, Workload,
                      _finish_result, _prepare_ctx, resolve_timeout,
                      run_cells, serial_time)

__all__ = ["SweepConfig", "SweepPlan", "CellError", "CellTimeout",
           "RetryPolicy", "run_sweep", "Stat", "CellStats", "aggregate"]


class CellTimeout(RuntimeError):
    """A cell exceeded its wall-clock budget and was stopped.

    Recorded in the cell's slot (a :class:`CellError` under
    ``strict=False``) — this is the *wall-clock* complement of the step
    watchdog: the watchdog catches a sim-logic stall inside a running
    loop, the timeout a loop that makes steps too slowly to ever trip
    it. The cell itself checks its deadline (every few thousand events:
    ``%globaltimer`` on the card, ``time.monotonic`` on the host) and
    stops; the other cells of the batch run on untouched.
    """

    def __init__(self, timeout: float, engine: str):
        self.timeout = timeout
        self.engine = engine
        super().__init__(
            f"cell exceeded the {timeout:g}s wall-clock timeout on the "
            f"{engine!r} engine; the cell stopped at its deadline")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry policy for transient cell failures.

    A failed cell gets up to ``retries`` re-attempts beyond the first,
    with ``backoff * 2**k`` seconds of sleep before retry round ``k``
    (capped at ``max_backoff``); a :class:`CellTimeout` counts as
    transient, as in the JAX package. A retry runs on the same device as
    the first attempt: the port has no ``degrade`` ladder, so a cell that
    failed on the card is never re-run by the plain version on the
    host. Deterministic failures (:class:`~.runtime.SimStalled`, bad
    configs, engine exceptions like ``ValueError``) are never retried —
    they would fail identically every time.
    """
    retries: int = 2
    backoff: float = 0.25
    max_backoff: float = 4.0


# Failure types worth re-attempting: environmental, not deterministic.
_TRANSIENT = (MemoryError, OSError, CellTimeout)


@dataclasses.dataclass
class CellError:
    """A failed sweep cell under ``strict=False``: the grid label of the
    offending config plus the error it raised. Takes the cell's slot in
    the result list so the add()-order ↔ result mapping survives.

    ``engine`` is the engine the final attempt ran on and ``attempts``
    records every attempt as ``(engine, "ErrType: message")``.
    """
    label: str
    index: int
    error: Exception
    engine: str = ""
    attempts: "tuple[tuple[str, str], ...]" = ()

    def __repr__(self) -> str:
        via = f" [{self.engine}]" if self.engine else ""
        if len(self.attempts) > 1:
            trail = " -> ".join(f"{e}: {m.split(':')[0]}"
                                for e, m in self.attempts)
            via = f" [{len(self.attempts)} attempts: {trail}]"
        return (f"CellError({self.label!r}{via}: "
                f"{type(self.error).__name__}: {self.error})")


@dataclasses.dataclass(frozen=True, eq=False)
class SweepConfig:
    """One cell of a sweep grid — the ``simulate()`` argument tuple.

    ``context``, when set, is the pre-compiled :class:`ExecContext` the
    cell runs under (the raw fields then mirror its lowered values);
    otherwise one is derived from the raw fields at run time.
    """
    topo: object
    thread_cores: tuple
    workload: Workload
    scheduler: object            # registered name or SchedulerSpec
    params: Optional[SimParams] = None
    seed: int = 0
    root_data_nodes: object = None
    runtime_data_node: Optional[int] = None
    migration_rate: float = 0.0
    serial_reference: Optional[float] = None
    context: Optional[ExecContext] = None
    label: Optional[str] = None  # grid-cell display name for errors

    def to_context(self) -> ExecContext:
        """The :class:`ExecContext` this cell runs under."""
        if self.context is not None:
            return self.context
        return ExecContext.from_raw(
            self.topo, self.params or SimParams(), self.thread_cores,
            self.root_data_nodes, self.runtime_data_node,
            self.migration_rate)

    def validate(self, cell: str = "sweep config") -> None:
        """Raise ``ValueError`` naming ``cell`` on any bad field."""
        def bad(msg):
            raise ValueError(f"{cell}: {msg}")

        try:
            policy.get_spec(self.scheduler)
        except ValueError as e:
            bad(e)
        topo = self.topo
        cores = self.thread_cores
        if not cores:
            bad("empty thread binding")
        outside = [c for c in cores if not 0 <= int(c) < topo.num_cores]
        if outside:
            bad(f"cores {outside} outside topology "
                f"({topo.num_cores} cores)")
        if len(set(cores)) != len(cores):
            bad(f"duplicate cores in binding {cores}")
        nodes = self.root_data_nodes
        if nodes is not None:
            if isinstance(nodes, (int, np.integer)):
                nodes = (int(nodes),)
            outside = [n for n in nodes if not 0 <= int(n) < topo.num_nodes]
            if outside:
                bad(f"root data nodes {outside} outside topology "
                    f"({topo.num_nodes} nodes)")
        rt = self.runtime_data_node
        if rt is not None and not 0 <= int(rt) < topo.num_nodes:
            bad(f"runtime_data_node {rt} outside topology "
                f"({topo.num_nodes} nodes)")
        if not 0.0 <= self.migration_rate <= 1.0:
            bad(f"migration_rate {self.migration_rate} outside [0, 1]")
        if self.params is not None and not isinstance(self.params,
                                                      SimParams):
            bad(f"params is {type(self.params).__name__}, not SimParams")


class SweepPlan:
    """An ordered batch of :class:`SweepConfig`; results match add() order."""

    def __init__(self, configs: Sequence[SweepConfig] = ()):
        self.configs: list[SweepConfig] = list(configs)

    def _cell_name(self, workload, scheduler, T) -> str:
        sched = scheduler.name if hasattr(scheduler, "name") else scheduler
        return (f"sweep cell #{len(self.configs)} "
                f"({workload.name}/{sched}/T={T})")

    def add(self, topo, thread_cores, workload, scheduler, *,
            errors: "list | None" = None, **kwargs) -> "SweepConfig | None":
        """Append one cell from ``simulate()``-style arguments.

        Validates eagerly: a bad scheduler name, core id, or data node
        raises here — naming this grid cell — not mid-batch in the
        engine. Pass ``errors=[...]`` to *collect* the failure message
        instead of raising (the cell is skipped, ``None`` returned) —
        grid expansions use this to report every offending cell in one
        error instead of failing fast on the first.
        """
        cfg = SweepConfig(topo, tuple(int(c) for c in thread_cores),
                          workload, scheduler, **kwargs)
        cell = cfg.label or self._cell_name(workload, scheduler,
                                            len(cfg.thread_cores))
        try:
            cfg.validate(cell)
        except ValueError as e:
            if errors is None:
                raise
            errors.append(str(e))
            return None
        self.configs.append(cfg)
        return cfg

    def add_context(self, context: ExecContext, workload, scheduler, *,
                    seed: int = 0,
                    serial_reference: Optional[float] = None,
                    label: Optional[str] = None,
                    errors: "list | None" = None) -> "SweepConfig | None":
        """Append one cell running under a compiled :class:`ExecContext`.

        Only the scheduler needs checking here — the context itself was
        validated when :meth:`ExecContext.compile` lowered it. With
        ``errors=[...]`` a failure is collected instead of raised and
        the cell skipped (see :meth:`add`).
        """
        try:
            policy.get_spec(scheduler)
        except ValueError as e:
            cell = label or self._cell_name(workload, scheduler,
                                            context.threads)
            if errors is None:
                raise ValueError(f"{cell}: {e}") from None
            errors.append(f"{cell}: {e}")
            return None
        cfg = SweepConfig(context.topo, context.thread_cores, workload,
                          scheduler, params=context.params, seed=seed,
                          root_data_nodes=context.root_data_nodes,
                          runtime_data_node=context.runtime_data_node,
                          migration_rate=context.migration_rate,
                          serial_reference=serial_reference,
                          context=context, label=label)
        self.configs.append(cfg)
        return cfg

    def __len__(self) -> int:
        return len(self.configs)

    def __iter__(self):
        return iter(self.configs)

    def run(self, strict: bool = True, workers: "int | None" = None,
            *, store=None, timeout: "float | None" = None,
            retry: "RetryPolicy | None" = None,
            device=None) -> "list[SimResult | CellError]":
        return run_sweep(self, strict=strict, workers=workers,
                         store=store, timeout=timeout, retry=retry,
                         device=device)


def _cell_label(cfg: SweepConfig, i: int) -> str:
    if cfg.label:
        return cfg.label
    sched = cfg.scheduler.name if hasattr(cfg.scheduler, "name") \
        else cfg.scheduler
    return (f"sweep cell #{i} ({cfg.workload.name}/{sched}/"
            f"T={len(cfg.thread_cores)})")


def run_sweep(plan: "SweepPlan | Sequence[SweepConfig]",
              strict: bool = True,
              workers: "int | None" = None,
              *, store=None,
              timeout: "float | None" = None,
              retry: "RetryPolicy | None" = None,
              device=None) -> "list[SimResult | CellError]":
    """Run every config in ``plan``; returns results in config order.

    ``device``: ``None`` runs the batch on the card — one launch of the
    simulation kernel for every cell (waves where device memory demands);
    a build or launch failure raises, and no cell ever falls back to the
    host. ``"cpu"`` runs the plain version on the host, cell after cell.
    Each cell runs on its own ``RandomState(seed)`` stream into its own
    result slot, so results are bit-identical either way.

    ``workers`` is accepted for the JAX package's signature and changes
    nothing here: the card runs every cell of the batch at once (one
    thread each) and the host runs them one after another.

    Per-cell error isolation: under ``strict=False`` a failing cell —
    bad config lowering, an engine failure in that cell (on the card, an
    overflow of its workspace), or a :class:`SimStalled` watchdog trip —
    becomes a :class:`CellError` naming its grid label in that cell's
    result slot, and the rest of the batch still runs. A build or launch
    failure of the card's kernel is no cell's failure: it raises. Under
    ``strict=True`` (default) the first failure raises, with the cell
    label attached (``SimStalled.cell`` for stalls).

    Durable execution (all opt-in, golden paths untouched):

    * ``store`` — a :class:`~.store.ResultStore` (or a journal path):
      cells whose :func:`~.store.cell_key` is already journaled are
      *replayed* from the store — no context preparation, no launch —
      and every newly completed cell is committed as its result is
      unpacked. A fully warm store answers the whole sweep without
      touching the device. Only successes are journaled; failures are
      re-attempted on the next run. A traced result's events go to the
      store's sidecar ``.npz`` (``ResultStore.get_trace``).
    * ``timeout`` — per-cell wall-clock seconds (default: the
      ``REPRO_SIM_TIMEOUT`` env var; see
      :func:`~.runtime.resolve_timeout`). A cell that overruns stops
      itself and is recorded as a :class:`CellTimeout`; its siblings
      run on untouched. The JAX package kills a fork worker instead;
      the port's cells run in the kernel or in this process, so the
      cell checks its own deadline.
    * ``retry`` — a :class:`RetryPolicy`: transient failures (memory
      pressure, a timeout) are re-attempted with capped exponential
      backoff on the same device. Deterministic failures never retry.
    """
    from ... import default_device
    configs = list(plan.configs if isinstance(plan, SweepPlan) else plan)
    if not configs:
        return []
    if store is not None and not hasattr(store, "get"):
        from .store import ResultStore
        store = ResultStore(os.fspath(store))
    timeout = resolve_timeout(timeout)
    n = len(configs)
    results: "list[SimResult | CellError | None]" = [None] * n

    # Pass 1: resolve config → context and serial reference, satisfy
    # store hits, collect the cells that actually need simulating. No
    # device is touched until a miss demands one.
    pending: list = []           # per-cell mutable descriptor dicts
    for i, cfg in enumerate(configs):
        try:
            spec = policy.get_spec(cfg.scheduler)
            ectx = cfg.to_context()
            if cfg.serial_reference is not None:
                serial = cfg.serial_reference
            else:
                # identical to the value derived from a prepared ctx:
                # serial_time normalizes root_data_nodes the same way
                serial = serial_time(ectx.topo, cfg.workload,
                                     ectx.thread_cores[0],
                                     ectx.root_data_nodes, ectx.params)
            key = None
            if store is not None:
                from .store import cell_key
                key = cell_key(ectx, cfg.workload, spec, cfg.seed, serial)
                hit = store.get(key)
                if hit is not None:
                    results[i] = hit
                    continue
        except Exception as e:
            if strict:
                raise
            results[i] = CellError(_cell_label(cfg, i), i, e)
            continue
        pending.append(dict(i=i, cfg=cfg, spec=spec, ectx=ectx,
                            serial=serial, key=key, attempts=[]))
    if not pending:
        return results           # fully warm store: nothing ran
    dev = default_device(device)
    max_attempts = 1 + (retry.retries if retry is not None else 0)

    def record_failure(cell, err, eng):
        i, cfg = cell["i"], cell["cfg"]
        cell["attempts"].append((eng, f"{type(err).__name__}: {err}"))
        if isinstance(err, _TRANSIENT) \
                and len(cell["attempts"]) < max_attempts:
            return cell          # re-attempt next round, same device
        label = _cell_label(cfg, i)
        if isinstance(err, SimStalled):
            err = err.with_cell(label)
            label = err.cell
        if strict:
            raise err
        results[i] = CellError(label, i, err, engine=eng,
                               attempts=tuple(cell["attempts"]))
        return None

    round_no = 0
    while pending:
        if round_no > 0 and retry is not None and retry.backoff > 0:
            time.sleep(min(retry.backoff * (2 ** (round_no - 1)),
                           retry.max_backoff))
        round_no += 1
        cells, pending = pending, []
        # contexts are prepared fresh every round: a failed attempt
        # consumed its rng stream and may have migrated its cores
        ready, ctxs = [], []
        for c in cells:
            try:
                ctx = _prepare_ctx(c["ectx"], c["cfg"].workload, c["spec"],
                                   c["cfg"].seed)
            except Exception as e:
                nxt = record_failure(c, e, "")
                if nxt is not None:
                    pending.append(nxt)
                continue
            ready.append(c)
            ctxs.append(ctx)
        if not ctxs:
            continue
        outs, eng = run_cells(ctxs, dev, timeout)
        for cell, ctx, out in zip(ready, ctxs, outs):
            if isinstance(out, Exception):
                nxt = record_failure(cell, out, eng)
                if nxt is not None:
                    pending.append(nxt)
                continue
            try:
                res = _finish_result(ctx, out, cell["serial"], eng)
            except SimStalled as e:
                # deterministic: the same stall reproduces on every
                # attempt, so it is never retried
                nxt = record_failure(cell, e, eng)
                assert nxt is None
                continue
            if store is not None:
                store.put(cell["key"], res)
            results[cell["i"]] = res
    return results


# ------------------------------------------------------------------ #
# Monte-Carlo aggregation: per-cell replica statistics               #
# ------------------------------------------------------------------ #

@dataclasses.dataclass(frozen=True)
class Stat:
    """Summary statistics of one metric over Monte-Carlo replicas.

    ``ci95`` is the normal-approximation 95% confidence half-width of
    the mean, ``1.96 * std / sqrt(n)`` (0 for a single replica); report
    values as ``mean ± ci95``. ``std`` is the sample standard deviation
    (ddof=1).
    """
    mean: float
    std: float
    min: float
    max: float
    ci95: float


def _stat(xs: Sequence[float]) -> Stat:
    n = len(xs)
    if n == 0:
        nan = float("nan")
        return Stat(nan, nan, nan, nan, nan)
    mean = math.fsum(xs) / n
    if n > 1:
        var = math.fsum((x - mean) ** 2 for x in xs) / (n - 1)
        std = math.sqrt(var)
    else:
        std = 0.0
    return Stat(mean=mean, std=std, min=min(xs), max=max(xs),
                ci95=1.96 * std / math.sqrt(n))


_CELLSTAT_METRICS = ("makespan", "speedup", "steals", "failed_probes",
                     "remote_work_fraction", "queue_wait", "reclaimed",
                     "reexec", "fault_lost")


@dataclasses.dataclass(frozen=True)
class CellStats:
    """One grid cell's Monte-Carlo replica results, aggregated.

    Every :class:`~.runtime.SimResult` metric gets a :class:`Stat`
    (mean/std/min/max/CI95 over the successful replicas); the raw
    per-seed results stay available in ``results`` (add order) and any
    failed replicas (``strict=False``) in ``errors``. ``n`` counts the
    successful replicas the stats are computed over.
    """
    n: int
    makespan: Stat
    speedup: Stat
    steals: Stat
    failed_probes: Stat
    remote_work_fraction: Stat
    queue_wait: Stat
    reclaimed: Stat
    reexec: Stat
    fault_lost: Stat
    results: "tuple[SimResult, ...]" = ()
    errors: "tuple[CellError, ...]" = ()


def aggregate(results: "Sequence[SimResult | CellError]") -> CellStats:
    """Aggregate one cell's replica results into a :class:`CellStats`."""
    ok = [r for r in results if isinstance(r, SimResult)]
    errs = tuple(r for r in results if isinstance(r, CellError))
    stats = {m: _stat([float(getattr(r, m)) for r in ok])
             for m in _CELLSTAT_METRICS}
    return CellStats(n=len(ok), results=tuple(ok), errors=errs, **stats)
