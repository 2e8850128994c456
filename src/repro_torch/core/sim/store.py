"""Persistent, content-addressed result store for simulation sweeps (own
copy of ``repro/core/sim/store.py``: the same journal format, keys and
sidecars, so a journal written by either package resumes in the other).

Paper-scale campaigns (32-seed Monte-Carlo replicas over 1M+-task
tables) take long enough that a hung cell, a killed worker, or an
interrupted process must not cost the whole grid. This module gives
:func:`~.sweep.run_sweep` a durable substrate:

* :func:`cell_key` — a stable digest of *everything that determines a
  cell's result*: the topology fingerprint, the compiled task table,
  the lowered execution context (binding, placement, runtime data,
  migration, faults, cost-model constants), the scheduler policy
  fields, the seed, and the serial reference the speedup is computed
  against. Two cells with equal keys are bit-identical by construction
  (the engines are deterministic in exactly these inputs), so a stored
  result can stand in for a simulation — on the card or on the host,
  and from a journal the JAX package wrote.
* :class:`ResultStore` — an append-only JSONL journal of completed
  :class:`~.runtime.SimResult` values plus an in-memory index. Appends
  are one ``write()`` + ``flush()`` of a single ``\\n``-terminated line
  (atomic enough for a single writer: a crash can only tear the *last*
  line, and loading tolerates a torn tail), so an interrupted campaign
  resumes from its journal losing at most the cell that was mid-commit.

Only *successes* are journaled. Failures (stalls, engine errors,
timeouts, overflows of a cell's workspace on the card) are represented
in the run's return value but never persisted, so a resumed campaign
always re-attempts them.

Event traces (``SimResult.trace``, present under ``SimParams(trace=
True)``) do not belong in a JSONL line: a paper-scale trace is tens of
MB of flat arrays. ``put`` spills them to *sidecar* ``.npz`` files —
``<journal stem>.traces/<cell key>.npz`` — and journals the result with
``trace=None``; :meth:`ResultStore.get_trace` loads a sidecar back by
cell key (the analysis layer's journal entry point, which reads the
port's sidecars through the same ``.npz`` layout). Sidecar
writes are atomic (tmp + rename) and first-write-wins like the journal.

Floats round-trip exactly: ``json`` serializes Python floats via
``repr``, which is shortest-round-trip, and parses back to the same
IEEE-754 double — a replayed result is bit-identical to the simulated
one, which the resume tests pin.

Journal format (one JSON document per line)::

    {"format": "repro-sim-store", "version": 1}          # header
    {"k": "<32-hex cell key>", "r": {...SimResult fields...}}
    ...
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import warnings

from .runtime import SimResult, ensure_table

__all__ = ["ResultStore", "cell_key", "workload_fingerprint"]

_HEADER = {"format": "repro-sim-store", "version": 1}


def workload_fingerprint(workload) -> str:
    """Content digest of a workload: the compiled table + µ.

    The table fingerprint covers the task structure (work, memory
    profiles, tree shape); ``mem_intensity`` scales every NUMA penalty
    and lives on the workload, not the table. The workload *name* is
    excluded — a renamed but identical benchmark hits the same cells.
    """
    tbl = ensure_table(workload)
    return hashlib.blake2b(
        (tbl.fingerprint() + repr(float(workload.mem_intensity))).encode(),
        digest_size=16).hexdigest()


def cell_key(ectx, workload, spec, seed: int,
             serial: "float | None" = None) -> str:
    """Stable key of one sweep cell's result (see module docstring).

    ``spec`` contributes its three *policy* fields, not its name: two
    registered names with identical (queue, spawn, victim) run the same
    program. ``serial`` is the speedup denominator actually used —
    ``SimResult.speedup`` depends on it, so cells differing only in
    their serial reference must not collide.
    """
    material = (ectx.fingerprint(), workload_fingerprint(workload),
                spec.queue, spec.spawn, spec.victim, int(seed),
                None if serial is None else float(serial))
    return hashlib.blake2b(repr(material).encode(),
                           digest_size=16).hexdigest()


class ResultStore:
    """Append-only JSONL journal of completed cell results.

    Open (or create) a journal at ``path``; existing entries are loaded
    into the in-memory index, tolerating a torn final line from a
    killed writer. ``sync=True`` adds an ``fsync`` per commit for
    crash-consistency against power loss (the default survives process
    death, which is the failure mode sweeps actually hit).

    First write wins: a ``put`` under an already-present key is a
    no-op, so concurrent or repeated campaigns can share a journal
    without rewriting history (all writers compute bit-identical
    results for a given key, so which one landed is immaterial).
    """

    def __init__(self, path: "str | os.PathLike", sync: bool = False):
        self.path = os.fspath(path)
        self.sync = sync
        self.hits = 0            # get() calls that found a result
        self._index: "dict[str, SimResult]" = {}
        self._load()
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        if self._fh.tell() == 0:
            self._commit(json.dumps(_HEADER, separators=(",", ":")))

    # ------------------------------------------------------------------
    def _load(self) -> None:
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return
        lines = raw.split("\n")
        torn = lines.pop() if lines and not raw.endswith("\n") else ""
        bad = 0
        for line in lines:
            if not line:
                continue
            try:
                doc = json.loads(line)
                if "k" not in doc:
                    continue     # header / future metadata line
                res = SimResult(**doc["r"])
                # JSON round-trips the aggregate tuples as lists;
                # normalize so a replayed result matches a fresh one
                res.steal_hops = tuple(res.steal_hops)
                res.node_tasks = tuple(res.node_tasks)
                res.node_remote = tuple(res.node_remote)
            except (ValueError, TypeError):
                bad += 1
                continue
            self._index.setdefault(doc["k"], res)
        if torn or bad:
            what = []
            if torn:
                what.append("a torn final line (interrupted write)")
            if bad:
                what.append(f"{bad} malformed line(s)")
            warnings.warn(
                f"result store {self.path}: skipped {' and '.join(what)}; "
                f"{len(self._index)} entries loaded",
                RuntimeWarning, stacklevel=3)
        if torn:
            # drop the torn tail so the next append starts clean and a
            # later load doesn't re-report the fragment as malformed
            os.truncate(self.path, len(raw.encode()) - len(torn.encode()))

    def _commit(self, line: str) -> None:
        self._fh.write(line + "\n")
        self._fh.flush()
        if self.sync:
            os.fsync(self._fh.fileno())

    # ------------------------------------------------------------------
    def get(self, key: str) -> "SimResult | None":
        res = self._index.get(key)
        if res is not None:
            self.hits += 1
        return res

    def put(self, key: str, result: SimResult) -> None:
        if key in self._index:
            return               # first write wins
        tr = getattr(result, "trace", None)
        if tr is not None:
            # spill the event trace to its sidecar and journal the
            # result without it (a trace is MBs of arrays, not a line)
            self._spill_trace(key, tr)
            result = dataclasses.replace(result, trace=None)
        self._index[key] = result
        self._commit(json.dumps(
            {"k": key, "r": dataclasses.asdict(result)},
            separators=(",", ":")))

    # ------------------------------------------------------------------
    def trace_dir(self) -> str:
        """Sidecar directory for spilled event traces."""
        stem = self.path
        if stem.endswith(".jsonl"):
            stem = stem[:-len(".jsonl")]
        return stem + ".traces"

    def trace_path(self, key: str) -> str:
        """Sidecar ``.npz`` path for ``key`` (may not exist)."""
        return os.path.join(self.trace_dir(), f"{key}.npz")

    def _spill_trace(self, key: str, tr) -> None:
        path = self.trace_path(key)
        if os.path.exists(path):
            return               # first write wins, like the journal
        d = self.trace_dir()
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".npz", dir=d)
        os.close(fd)
        try:
            tr.save_npz(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get_trace(self, key: str):
        """Load the spilled event trace for ``key``, or None."""
        path = self.trace_path(key)
        if not os.path.exists(path):
            return None
        from .trace import TraceBuffer
        return TraceBuffer.load_npz(path)

    def keys(self):
        """Journaled cell keys (insertion order)."""
        return iter(self._index)

    def items(self):
        """(key, SimResult) pairs for every journaled cell."""
        return self._index.items()

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def __repr__(self) -> str:
        return (f"ResultStore({self.path!r}: {len(self._index)} entries, "
                f"{self.hits} hits)")

    def flush(self) -> None:
        self._fh.flush()
        if self.sync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "ResultStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
