"""Event-trace capture: structure-of-arrays record of one simulation (own
copy of ``repro/core/sim/trace.py``; same columns, dtypes and ``.npz``
layout, so a trace written by either package loads through the other's
:meth:`TraceBuffer.load_npz`).

``SimParams(trace=True)`` makes both of the port's engines record, per
run:

* **exec events** — one per *committed* task execution (the commit point
  after fault preemption checks): task id, executing thread / core /
  NUMA node, queue depth sampled at commit, and the ``[start, end)``
  interval on the simulated clock. Aborted (re-executed) attempts are
  not exec events; join continuations fold into the task's accounting
  and emit none either.
* **steal events** — one per successful steal: time, thief and victim
  threads, stolen task id, and the hop distance between the thieving
  and victim cores' nodes.
* **migration events** — one per OS thread migration: time, thread,
  from-core, to-core.

The layout is structure-of-arrays (one flat numpy array per column).
The card's kernel (``kernels/csrc/sim.cu``, its traced instantiation)
writes each cell's events into the cell's own slice of flat device
columns, sized before the launch so that nothing grows or is dropped;
the wrapper copies each wave's columns off the card and wraps every
cell's rows with :meth:`TraceBuffer.from_arrays`. The plain version
appends row tuples to flat lists and columnizes once
(:meth:`TraceBuffer.from_flat`).

Tracing is purely observational — a traced run's :class:`~.runtime.
SimResult` metrics are bit-identical to the untraced run, and both
engines produce identical traces event-for-event.

:meth:`TraceBuffer.save_npz` / :meth:`TraceBuffer.load_npz` round-trip
a trace through a single ``.npz`` file — the sidecar format the result
store uses to spill traces next to its journal (see ``store.py``).
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["TraceBuffer", "plan_capacity", "EXEC_COLS", "STEAL_COLS",
           "MIG_COLS", "ALL_COLS", "EVENT_BYTES"]

# (column, dtype) per event family; the single source of truth for the
# npz schema, pickling, and parity comparison.
EXEC_COLS = (("ex_task", np.int64), ("ex_thread", np.int64),
             ("ex_core", np.int64), ("ex_node", np.int64),
             ("ex_qlen", np.int64), ("ex_start", np.float64),
             ("ex_end", np.float64))
STEAL_COLS = (("st_time", np.float64), ("st_thief", np.int64),
              ("st_victim", np.int64), ("st_task", np.int64),
              ("st_dist", np.int64))
MIG_COLS = (("mg_time", np.float64), ("mg_thread", np.int64),
            ("mg_from", np.int64), ("mg_to", np.int64))
ALL_COLS = EXEC_COLS + STEAL_COLS + MIG_COLS
# bytes one event of each family holds (exec, steal, migration)
EVENT_BYTES = tuple(8 * len(c) for c in (EXEC_COLS, STEAL_COLS, MIG_COLS))


def plan_capacity(n_tasks: int) -> "tuple[int, int, int]":
    """Initial (exec, steal, migration) capacities for an ``n_tasks`` run.

    Every task commits exactly one exec event on a completed run, so the
    exec family is allocated exactly once up front; steals and
    migrations are workload-dependent, so they start small and grow
    geometrically (in the plain version's recorder; the card's kernel
    sizes each cell from its bounds instead, see ``kernels/sim.py``).
    """
    n = max(int(n_tasks), 1)
    return n, max(n // 8, 64), 64


class TraceBuffer:
    """One run's event trace (see module docstring for semantics).

    Column arrays are exposed as attributes (``ex_task``, ``st_time``,
    ...), trimmed to the recorded event counts ``n_exec`` / ``n_steal``
    / ``n_mig``. ``meta`` carries run identity (scheduler, seed, engine,
    threads, topology sizes) for the analysis layer.
    """

    def __init__(self, n_tasks: int = 0, meta: "dict | None" = None):
        ex_cap, st_cap, mg_cap = plan_capacity(n_tasks)
        for name, dt in EXEC_COLS:
            setattr(self, name, np.empty(ex_cap, dtype=dt))
        for name, dt in STEAL_COLS:
            setattr(self, name, np.empty(st_cap, dtype=dt))
        for name, dt in MIG_COLS:
            setattr(self, name, np.empty(mg_cap, dtype=dt))
        self.n_exec = 0
        self.n_steal = 0
        self.n_mig = 0
        self.meta: dict = dict(meta or {})
        self._final = False

    # ---- recording, one event at a time ----

    def _grow(self, cols) -> None:
        for name, _ in cols:
            a = getattr(self, name)
            b = np.empty(max(len(a) * 2, 64), dtype=a.dtype)
            b[:len(a)] = a
            setattr(self, name, b)

    def add_exec(self, task: int, thread: int, core: int, node: int,
                 qlen: int, start: float, end: float) -> None:
        i = self.n_exec
        if i >= len(self.ex_task):
            self._grow(EXEC_COLS)
        self.ex_task[i] = task
        self.ex_thread[i] = thread
        self.ex_core[i] = core
        self.ex_node[i] = node
        self.ex_qlen[i] = qlen
        self.ex_start[i] = start
        self.ex_end[i] = end
        self.n_exec = i + 1

    def add_steal(self, time: float, thief: int, victim: int, task: int,
                  dist: int) -> None:
        i = self.n_steal
        if i >= len(self.st_time):
            self._grow(STEAL_COLS)
        self.st_time[i] = time
        self.st_thief[i] = thief
        self.st_victim[i] = victim
        self.st_task[i] = task
        self.st_dist[i] = dist
        self.n_steal = i + 1

    def add_mig(self, time: float, thread: int, frm: int, to: int) -> None:
        i = self.n_mig
        if i >= len(self.mg_time):
            self._grow(MIG_COLS)
        self.mg_time[i] = time
        self.mg_thread[i] = thread
        self.mg_from[i] = frm
        self.mg_to[i] = to
        self.n_mig = i + 1

    # ---- finalization / construction ----

    def finalize(self) -> "TraceBuffer":
        """Trim column arrays to the recorded counts (views, no copy)."""
        if not self._final:
            for name, _ in EXEC_COLS:
                setattr(self, name, getattr(self, name)[:self.n_exec])
            for name, _ in STEAL_COLS:
                setattr(self, name, getattr(self, name)[:self.n_steal])
            for name, _ in MIG_COLS:
                setattr(self, name, getattr(self, name)[:self.n_mig])
            self._final = True
        return self

    @classmethod
    def from_flat(cls, ex_flat, st_flat, mg_flat,
                  meta: "dict | None" = None) -> "TraceBuffer":
        """Build from flat row-major event buffers (the plain version).

        The engine records an event by ``list.extend``-ing one row
        tuple onto a flat list — the cheapest per-event operation
        available in pure Python — and this constructor columnizes
        each family in two vectorized steps (one bulk float64
        conversion, one strided ``astype`` per column). Integer ids
        round-trip exactly through float64 (they are far below 2**53).
        """
        from array import array

        def cols(flat, spec):
            # array('d', list) converts in C measurably faster than
            # np.asarray on a list of Python scalars
            m = np.frombuffer(array("d", flat) if flat else b"",
                              dtype=np.float64).reshape(-1, len(spec))
            return {name: m[:, i].astype(dt, copy=True)
                    for i, (name, dt) in enumerate(spec)}
        arrays = cols(ex_flat, EXEC_COLS)
        arrays.update(cols(st_flat, STEAL_COLS))
        arrays.update(cols(mg_flat, MIG_COLS))
        return cls.from_arrays(arrays, meta=meta)

    @classmethod
    def from_arrays(cls, arrays: dict,
                    meta: "dict | None" = None) -> "TraceBuffer":
        """Wrap pre-built column arrays (no copy where the dtype already
        matches): the card's columns once copied off, a loaded sidecar."""
        tb = cls.__new__(cls)
        for name, dt in ALL_COLS:
            setattr(tb, name, np.asarray(arrays[name], dtype=dt))
        tb.n_exec = int(len(tb.ex_task))
        tb.n_steal = int(len(tb.st_time))
        tb.n_mig = int(len(tb.mg_time))
        tb.meta = dict(meta or {})
        tb._final = True
        return tb

    # ---- persistence / transport ----

    def __getstate__(self):
        # copy columns so a pickle never carries oversized capacity
        # arrays or views of a larger wave buffer
        self.finalize()
        state = {name: np.ascontiguousarray(getattr(self, name))
                 for name, _ in ALL_COLS}
        state["meta"] = self.meta
        return state

    def __setstate__(self, state):
        meta = state.pop("meta", {})
        tb = TraceBuffer.from_arrays(state, meta=meta)
        self.__dict__.update(tb.__dict__)

    def save_npz(self, path) -> None:
        """Write the trace (columns + meta) to one deflated ``.npz``
        file, as the JAX package writes it."""
        self.finalize()
        cols = {name: np.ascontiguousarray(getattr(self, name))
                for name, _ in ALL_COLS}
        cols["meta_json"] = np.frombuffer(
            json.dumps(self.meta, sort_keys=True).encode(), dtype=np.uint8)
        np.savez_compressed(path, **cols)

    @classmethod
    def load_npz(cls, path) -> "TraceBuffer":
        with np.load(path) as z:
            meta = {}
            if "meta_json" in z.files:
                meta = json.loads(bytes(z["meta_json"]).decode())
            arrays = {name: z[name] for name, _ in ALL_COLS}
        return cls.from_arrays(arrays, meta=meta)

    # ---- introspection ----

    def nbytes(self) -> int:
        """Bytes of the recorded events (56 / 40 / 32 B an event)."""
        return (EVENT_BYTES[0] * self.n_exec + EVENT_BYTES[1] * self.n_steal
                + EVENT_BYTES[2] * self.n_mig)

    def __eq__(self, other):
        if not isinstance(other, TraceBuffer):
            return NotImplemented
        self.finalize()
        other.finalize()
        return all(np.array_equal(getattr(self, n), getattr(other, n))
                   for n, _ in ALL_COLS)

    __hash__ = None

    def __repr__(self):
        return (f"TraceBuffer(exec={self.n_exec}, steals={self.n_steal}, "
                f"migrations={self.n_mig})")
