"""The NANOS simulator's event loop: the wrapper of the Hopper kernel
``csrc/sim.cu``.

It replaces the JAX package's C engine, ``repro/core/sim/_csim.c:743``
``sim_run_batch`` (bound by ``repro/core/sim/_csim.py``): one thread of the
card runs one prepared cell (see ``core/sim/runtime.py``
``_prepare_ctx``) from ignition to its last event, and every cell of a
batch runs in one launch. :func:`run_batch` packs the prepared contexts
into device buffers (the work of ``_csim.py``'s ``_marshal``):

  * every task table the batch uses, once, as one 64-byte record a task
    (:data:`TASK_RECORD`: five int32 ids, four doubles), read through the
    read-only path;
  * one float64 and one int32 buffer holding, once each, every topology
    array, root-distance vector, victim plan and fault plan the batch
    uses (shared read-only by the cells that use them), each cell's 11
    double and 13 int32 parameters and a copy of its ``cores``
    (migration writes it);
  * a descriptor row of offsets per cell (``DESC`` names the fields, in
    ``sim.cu``'s order), the cells longest first (by task count, then by
    table and thread count), so that the last cells to start are the
    short ones and the threads of a warp read one table;
  * one zeroed device workspace per cell (:func:`workspace_bytes`): a
    16-byte record a task (deque links, pending, node, phase); a batch
    whose workspaces do not fit half the device's free memory runs in
    waves, one launch each.

Each cell's hot state (:func:`hot_bytes`: the RNG, the event heap, the
parked set, the deque ends, the per-thread arrays, its ``cores`` copy and
its aggregates) lives in a slice of its block's shared memory, sized per
wave from the wave's largest cell. A cell whose hot state does not fit a
block's shared memory (``sim_shared_limit``: 227 KB on an H100; or
``SHARED_CELL_MAX`` where set, which forces it) runs the same loop with
its hot state at the front of its workspace, in launches of their own:
``route_launches`` counts ``"untraced"`` / ``"traced"`` (hot state in
shared memory, the main route) apart from ``"untraced_workspace"`` /
``"traced_workspace"``.

The launch shape (cells a warp) is chosen per wave: one cell a warp
where the device keeps the whole wave resident that way (no two cells of
a warp diverge), else ``WIDE_CELLS_PER_WARP``; ``CELLS_PER_WARP``, where
set, forces a shape (``compare_sim`` times each).

It then unpacks ``dout`` / ``iout`` and the three aggregates into the
result dicts the plain version returns, and writes each cell's final
core binding back into its context. A cell whose structures overflow
(a negative return code, which the layout's bounds rule out) gets a
``RuntimeError`` naming it in its slot, as the plain version's
``run_batch`` gives a failing cell its exception, and the other cells
keep their results; statuses 1 and 2 (watchdog, stranded work) are
results that ``runtime._finish_result`` turns into ``SimStalled``.

Traced cells (``ctx["trace"]``, from ``SimParams(trace=True)``) launch
the traced instantiation of the loop. :func:`trace_caps` sizes each
cell's slice of the flat trace columns from bounds its events cannot
pass, the wave planner counts those bytes (56 / 40 / 32 B an exec /
steal / migration event) beside the workspaces, and after each wave the
cells' events are gathered on the card, copied off before the next wave,
and wrapped per cell with ``TraceBuffer.from_arrays``. A ``timeout``
launches the timed instantiation: each cell reads ``%globaltimer`` when
it starts and stops with a code past its deadline, which :func:`unpack`
makes a ``CellTimeout(timeout, engine="cuda")`` in that cell's slot.

:func:`run_batch` takes a CUDA device only (``runtime.run_cells`` sends
``cpu`` to the plain version): it launches the kernel or raises, and
nothing falls back to the host. ``launches`` counts kernel launches (one
a wave) and nothing else, ``route_launches`` the same by route;
``last_run`` keeps the last batch's waves, bytes, launch shapes, resident
cells and kernel time (CUDA events), and the host's seconds packing, on
the device (copies, launches and the wait for them) and unpacking. The
three self-tests (:func:`mt_selftest`, :func:`shuffle_selftest`,
:func:`set_selftest`) run the kernel's replicas of numpy's MT19937, its
shuffle and CPython's set on the card. ``sim.cu`` also builds as host
C++ (no ``__CUDACC__``): :func:`build_host` compiles it and
:func:`run_batch_host` runs a batch through that build on the CPU, by the
same wave loop as the card's with numpy buffers in place of device ones
and a host slice of the shared layout, filled with garbage before each
cell, in place of shared memory (the tests hold it to the plain version
and to the JAX package's engines that way).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from . import _build

__all__ = ["run_batch", "pack", "unpack", "workspace_bytes", "hot_bytes",
           "trace_caps", "task_records", "resident_cells", "DESC",
           "TASK_RECORD", "TASK_STATE_BYTES", "CELLS_PER_WARP",
           "WIDE_CELLS_PER_WARP", "SHARED_CELL_MAX", "HOST_SHARED_LIMIT",
           "MAX_WAVE_BYTES", "WAVE_SHARE", "launches", "route_launches",
           "last_run", "mt_selftest", "shuffle_selftest", "set_selftest",
           "RC_MEANING", "build_host", "run_batch_host", "ptxas_registers"]

# the descriptor fields, in sim.cu's `enum Desc` order
DESC = ("out", "dpar", "ipar", "tab", "core_node", "node_dist", "root_dist",
        "cores", "goff", "uoff", "voff", "victims", "fspeed", "fwoff",
        "fwstart", "fwend", "hops", "node_tasks", "node_remote", "ws",
        "ws_bytes", "ex_off", "ex_cap", "st_off", "st_cap", "mg_off",
        "mg_cap")
_D = {name: i for i, name in enumerate(DESC)}
# one task's read-only row (sim.cu `TaskRO`), 64 bytes
TASK_RECORD = np.dtype([("wp", "<f8"), ("wpo", "<f8"), ("fr", "<f8"),
                        ("fp", "<f8"), ("par", "<i4"), ("fc", "<i4"),
                        ("nc", "<i4"), ("fpw", "<i4"), ("npw", "<i4"),
                        ("pad", "<i4", (3,))])
# one task's mutable state in one cell (sim.cu `TaskState`)
TASK_STATE_BYTES = 16
_MAX_TASKS = 2 ** 31 - 1          # task ids are int32
_MAX_NODES = 2 ** 15 - 1          # a task's node is int16

RC_TRACE_OVERFLOW, RC_TIMED_OUT = -5, -6
RC_MEANING = {-2: "event heap overflow (or a second event queued for one "
                  "thread)",
              -3: "parked-set overflow",
              -4: "workspace or shared slice shorter than the cell's layout",
              RC_TRACE_OVERFLOW: "trace columns shorter than the cell's "
                                 "events (nothing was truncated)",
              -7: "more than 2^32 - 1 events pushed (the kernel's uint32 "
                  "event sequence)"}
# per event family (exec, steal, migration): int64 and double columns
_TRACE_FAMILIES = (("ex", 5, 2), ("st", 4, 1), ("mg", 3, 1))

# cells that share a warp (a power of two up to 32): None chooses per
# wave (one a warp where the device keeps the whole wave resident so,
# else WIDE_CELLS_PER_WARP, the fastest shape of compare_sim's grid runs
# in PERF.md §6); an int forces that shape on every wave
CELLS_PER_WARP: "int | None" = None
WIDE_CELLS_PER_WARP = 2
# hot-state bytes above which a cell runs with its hot state in its
# workspace (None: the device's shared memory a block may have; 0 sends
# every cell there)
SHARED_CELL_MAX: "int | None" = None
# the shared memory a block may have on an H100 (227 KB), which the host
# build's placement takes as its limit
HOST_SHARED_LIMIT = 232448
# the share of the device's free memory a wave's workspaces may take, and
# a cap of a wave's workspace bytes (None: none) that forces more waves
WAVE_SHARE = 0.5
MAX_WAVE_BYTES = None

launches = 0
route_launches = {"untraced": 0, "traced": 0, "untraced_workspace": 0,
                  "traced_workspace": 0}
last_run: dict = {}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_RUN_ARGTYPES = [_I64, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I,
                 _I64, _I, _I, _I64, _P, _P]


# --------------------------------------------------------------------
# the layouts (sim.cu `hot_layout`, `cell_ws_bytes`)
# --------------------------------------------------------------------

def _align(x: int, a: int) -> int:
    return (x + a - 1) & ~(a - 1)


def _set_cap(T: int) -> int:
    """The largest set table CPython's resize rule reaches with at most
    T keys (4 x used slots up to 50 000 keys, 2 x used above)."""
    t = max(int(T), 0)
    minused = 4 * min(t, 50000)
    if t > 50000:
        minused = max(minused, 2 * t)
    size = 8
    while size <= minused:
        size <<= 1
    return size


def hot_bytes(T: int, nodes: int, hop_bins: int) -> int:
    """Bytes of one cell's hot state for ``T`` threads, ``nodes`` NUMA
    nodes and ``hop_bins`` steal-distance bins (a multiple of 16): the
    heap (16 B an entry, T entries), dl_free and node_remote (doubles),
    the RNG (624 + 1 words), each thread's queued task, two set tables of
    int32 keys, the deques' heads, tails and lengths, wcur, order, uidx,
    cores and each thread's node (int32 a thread) and the hop and node
    counts (int32)."""
    t1 = max(int(T), 1)
    sc = _set_cap(T)
    parts = [(16 * t1, 16), (8 * t1, 8), (8 * nodes, 8), (4 * 625, 8),
             (4 * t1, 8), (8 * sc, 8)]
    parts += [(4 * (t1 + 1), 8)] * 3 + [(4 * t1, 8)] * 5
    parts += [(4 * hop_bins, 8), (4 * nodes, 8)]
    o = 0
    for size, a in parts:
        o = _align(o + size, a)
    return _align(o, 16)


def workspace_bytes(n: int, T: int = 1, nodes: int = 1, hop_bins: int = 1,
                    in_workspace: bool = False) -> int:
    """Bytes of one cell's device workspace for ``n`` tasks: a 16-byte
    record a task, after the cell's hot state (:func:`hot_bytes`) when it
    lives there (``in_workspace``)."""
    hot = hot_bytes(T, nodes, hop_bins) if in_workspace else 0
    return _align(hot, 16) + _align(TASK_STATE_BYTES * int(n), 16)


def _cell_hot(ctx) -> int:
    return hot_bytes(int(ctx["T"]), int(ctx["num_nodes"]), _hop_bins(ctx))


def _hop_bins(ctx) -> int:
    max_hop = ctx.get("max_hop")
    if max_hop is None:
        max_hop = int(np.max(ctx["node_dist_flat"]))
    return int(max_hop) + 1


def trace_caps(ctx) -> "tuple[int, int, int]":
    """Events one traced cell can record at most: (exec, steal,
    migration). Every task commits once (exec <= n). A steal takes a task
    off a deque, and a task enters one when spawned (the root never) or
    when a fault window takes its thread offline with it in hand, which
    happens at most once a window: steals <= n - 1 + W, none under a
    shared queue. A migration draw comes with each execution attempt,
    committed or aborted by a window: migrations <= n + W, none at rate
    0. W is the fault plan's windows."""
    n = int(ctx["table"].n)
    fplan = ctx.get("fault_plan")
    w = int(fplan.n_windows) if fplan is not None else 0
    steal = 0 if ctx["queue_shared"] else max(n - 1, 0) + w
    mig = n + w if ctx["migration_rate"] > 0.0 else 0
    return n, steal, mig


def _trace_bytes(caps) -> int:
    from ..core.sim.trace import EVENT_BYTES
    return sum(b * c for b, c in zip(EVENT_BYTES, caps))


# --------------------------------------------------------------------
# packing
# --------------------------------------------------------------------

class _Buf:
    """A growing list of arrays of one dtype and their running offset."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)
        self.parts: list = []
        self.size = 0

    def add(self, arr) -> int:
        a = np.ascontiguousarray(arr, dtype=self.dtype).ravel()
        off = self.size
        self.parts.append(a)
        self.size += a.shape[0]
        return off

    def array(self) -> np.ndarray:
        pad = np.zeros(1, self.dtype)
        if not self.parts:
            return pad
        return np.concatenate(self.parts + [pad])


def task_records(tbl) -> np.ndarray:
    """The table's rows as :data:`TASK_RECORD` records (one a task)."""
    rec = np.zeros(int(tbl.n), TASK_RECORD)
    rec["wp"], rec["wpo"] = tbl.work_pre, tbl.work_post
    rec["fr"], rec["fp"] = tbl.f_root, tbl.f_parent
    rec["par"], rec["fc"], rec["nc"] = (tbl.parent, tbl.first_child,
                                        tbl.num_children)
    rec["fpw"], rec["npw"] = tbl.first_post, tbl.num_post
    return rec


def _dpar(ctx) -> list:
    return [ctx["hop_lambda"], ctx["hop_lambda_steal"], ctx["lock_time"],
            ctx["deque_lock_time"], ctx["steal_time"], ctx["spawn_time"],
            ctx["wake_latency"], ctx["qop_time"], ctx["cache_refill"],
            ctx["mem_intensity"], ctx["migration_rate"]]


def _ipar(ctx) -> np.ndarray:
    """The cell's int32 parameters in sim.cu's `enum Ipar` order, as
    int32 bits: the seed as its low 32 bits (the C engine's uint32_t
    cast), max_steps as two words."""
    rdn = ctx["runtime_data_node"]
    ms = int(ctx.get("max_steps") or 0) & (2 ** 64 - 1)
    vals = [ctx["T"], ctx["num_cores"], ctx["num_nodes"], ctx["table"].n,
            int(ctx["queue_shared"]), int(ctx["child_first"]),
            int(ctx["seed"]) & 0xFFFFFFFF, -1 if rdn is None else int(rdn),
            ctx["root_node0"], int(ctx.get("fault_plan") is not None),
            ms & 0xFFFFFFFF, ms >> 32, _hop_bins(ctx)]
    return np.array([int(v) & 0xFFFFFFFF for v in vals],
                    dtype=np.uint32).view(np.int32)


def _check_cell(i: int, ctx) -> None:
    """Raise, naming the cell's table or topology, where the kernel's
    int32 task ids (int16 nodes) cannot hold the cell."""
    n = int(ctx["table"].n)
    if n > _MAX_TASKS:
        raise ValueError(
            f"sim kernel: the task table of cell {i} "
            f"({ctx.get('scheduler_name', '?')}, T={ctx['T']}) has {n} "
            f"tasks; task ids are int32, so a table holds fewer than 2^31")
    if int(ctx["num_nodes"]) > _MAX_NODES:
        raise ValueError(f"sim kernel: cell {i}'s topology has "
                         f"{ctx['num_nodes']} nodes; a task's node is int16")


def _check_vplan(vp, T: int) -> None:
    """Raise where a sweep of the plan would pass the T entries of the
    hot state's order and uidx arrays."""
    goff, uoff, voff, _ = vp.flat()
    per_thread = voff[uoff[goff[1:]]] - voff[uoff[goff[:-1]]]
    units = np.diff(uoff)
    if (per_thread.size and per_thread.max() > T) or \
            (units.size and units.max() > T):
        raise ValueError("sim kernel: a victim sweep longer than the "
                         f"thread count {T}")


def pack(ctxs, max_wave_bytes: "int | None" = None,
         traced: bool = False, in_workspace: bool = False) -> dict:
    """Lower prepared contexts into the kernel's buffers (numpy, host).

    Returns dict(desc (n, len(DESC)) int64 in launch order, tab (the
    task records), dbuf, ibuf (int32; its first ``n_cores`` entries every
    cell's ``cores``, in cell order), aggi, aggd, waves (launch-order
    [start, stop) ranges), each wave's workspace bytes and hot-state
    slice bytes (``wave_hot``: its largest cell's), and per cell its
    cores offset and aggregate slices). ``traced`` gives each cell a
    slice of the trace columns (:func:`trace_caps`; offsets relative to
    its wave) and each wave its column lengths in ``wave_trace`` (exec,
    steal, migration events). ``in_workspace`` puts each cell's hot state
    in its workspace (counted in its bytes). ``max_wave_bytes`` caps a
    wave's workspace and trace bytes (default: no cap). Raises
    ``ValueError`` for a table of 2^31 tasks or more.
    """
    for i, ctx in enumerate(ctxs):
        _check_cell(i, ctx)
    n = len(ctxs)
    tab = _Buf(TASK_RECORD)
    dbuf, ibuf = _Buf(np.float64), _Buf(np.int32)
    aggi, aggd = _Buf(np.int64), _Buf(np.float64)
    # per-cell cores first, so one copy brings every binding back
    cores_off = [ibuf.add(ctx["cores"]) for ctx in ctxs]
    n_cores = ibuf.size
    shared: dict = {}

    def once(key, add):
        got = shared.get(key)
        if got is None:
            got = shared[key] = add()
        return got

    rows, aggs, table_rank, hots = [], [], {}, []
    for i, ctx in enumerate(ctxs):
        tbl = ctx["table"]
        T = int(ctx["T"])
        d = [0] * len(DESC)
        d[_D["out"]] = i
        d[_D["dpar"]] = dbuf.add(_dpar(ctx))
        d[_D["ipar"]] = ibuf.add(_ipar(ctx))
        d[_D["tab"]] = once(("table", id(tbl)),
                            lambda: tab.add(task_records(tbl)))
        table_rank.setdefault(id(tbl), len(table_rank))
        cn = np.ascontiguousarray(ctx["core_node_arr"], np.int32)
        nd = np.ascontiguousarray(ctx["node_dist_flat"], np.int32)
        rd = np.ascontiguousarray(ctx["root_dist"], np.float64)
        d[_D["core_node"]] = once(("cn", cn.tobytes()), lambda: ibuf.add(cn))
        d[_D["node_dist"]] = once(("nd", nd.tobytes()), lambda: ibuf.add(nd))
        d[_D["root_dist"]] = once(("rd", rd.tobytes()), lambda: dbuf.add(rd))
        d[_D["cores"]] = cores_off[i]
        vp = ctx["vplan"]

        def add_vplan(vp=vp, T=T):
            _check_vplan(vp, T)
            return tuple(ibuf.add(a) for a in vp.flat())
        (d[_D["goff"]], d[_D["uoff"]], d[_D["voff"]],
         d[_D["victims"]]) = once(("vplan", id(vp)), add_vplan)
        fplan = ctx.get("fault_plan")
        if fplan is not None:
            (d[_D["fspeed"]], d[_D["fwoff"]], d[_D["fwstart"]],
             d[_D["fwend"]]) = once(("fplan", id(fplan)), lambda: (
                 dbuf.add(fplan.speed), ibuf.add(fplan.win_off),
                 dbuf.add(fplan.win_start), dbuf.add(fplan.win_end)))
        nh = _hop_bins(ctx)
        NN = int(ctx["num_nodes"])
        d[_D["hops"]] = aggi.add(np.zeros(nh, np.int64))
        d[_D["node_tasks"]] = aggi.add(np.zeros(NN, np.int64))
        d[_D["node_remote"]] = aggd.add(np.zeros(NN, np.float64))
        aggs.append((d[_D["hops"]], nh, d[_D["node_tasks"]],
                     d[_D["node_remote"]], NN))
        d[_D["ws_bytes"]] = workspace_bytes(tbl.n, T, NN, nh, in_workspace)
        hots.append(hot_bytes(T, NN, nh))
        caps = trace_caps(ctx) if traced else (0, 0, 0)
        d[_D["ex_cap"]], d[_D["st_cap"]], d[_D["mg_cap"]] = caps
        rows.append(d)

    # launch order: longest first (task count), then by workload (first
    # appearance) and thread count
    order = sorted(range(n), key=lambda i: (
        -int(ctxs[i]["table"].n), table_rank[id(ctxs[i]["table"])],
        int(ctxs[i]["T"]), i))
    fam = ("ex", "st", "mg")
    waves, wave_bytes, wave_trace, wave_hot = [], [], [], []
    start, used, hot = 0, 0, 0
    lens = [0, 0, 0]
    for k, i in enumerate(order):
        row = rows[i]
        caps = [row[_D[f + "_cap"]] for f in fam]
        b = row[_D["ws_bytes"]]
        if k > start and max_wave_bytes is not None and \
                used + b + _trace_bytes(lens) + _trace_bytes(caps) \
                > max_wave_bytes:
            waves.append((start, k))
            wave_bytes.append(used)
            wave_trace.append(tuple(lens))
            wave_hot.append(hot)
            start, used, hot, lens = k, 0, 0, [0, 0, 0]
        row[_D["ws"]] = used
        used += b
        hot = max(hot, hots[i])
        for j, f in enumerate(fam):
            row[_D[f + "_off"]] = lens[j]
            lens[j] += caps[j]
    waves.append((start, n))
    wave_bytes.append(used)
    wave_trace.append(tuple(lens))
    wave_hot.append(hot)
    desc = np.asarray([rows[i] for i in order], dtype=np.int64).reshape(
        n, len(DESC))
    return dict(desc=desc, tab=tab.array(), dbuf=dbuf.array(),
                ibuf=ibuf.array(), aggi=aggi.array(), aggd=aggd.array(),
                waves=waves, wave_bytes=wave_bytes, wave_trace=wave_trace,
                wave_hot=wave_hot, n_cores=n_cores, cores_off=cores_off,
                aggs=aggs)


def _cell_columns(slots, offs, cnts, cols) -> dict:
    """``{cell slot: {column name: array}}`` for cells whose events of
    family j sit at ``offs[j][k]``, ``cnts[j][k]`` of them, in ``cols[j]``
    (the family's int64 (k, L) and double (k', L) host arrays)."""
    from ..core.sim.trace import EXEC_COLS, MIG_COLS, STEAL_COLS
    # the kernel's column order within each family's two blocks
    names = ((EXEC_COLS[:5], EXEC_COLS[5:]), (STEAL_COLS[1:], STEAL_COLS[:1]),
             (MIG_COLS[1:], MIG_COLS[:1]))
    out = {}
    for k, slot in enumerate(slots):
        arrays = {}
        for j, (ints, dbls) in enumerate(cols):
            o, c = int(offs[j][k]), int(cnts[j][k])
            for (name, _), col in zip(names[j][0], ints):
                arrays[name] = col[o:o + c]
            for (name, _), col in zip(names[j][1], dbls):
                arrays[name] = col[o:o + c]
        out[int(slot)] = arrays
    return out


def unpack(ctxs, packed: dict, dout, iout, rc, aggi, aggd,
           cores, traces: "dict | None" = None,
           timeout: "float | None" = None) -> list:
    """The result dicts of a finished batch (numpy outputs, cell order);
    writes each cell's final core binding back into its context. A cell
    whose kernel run stopped with a negative code gets, in its slot, a
    ``RuntimeError`` naming it (``run_sweep`` maps it to its cell), or,
    past its deadline, a ``CellTimeout(timeout, "cuda")``. ``traces``
    maps a traced cell's slot to its event columns, which become the
    result's ``TraceBuffer``."""
    from ..core.sim.sweep import CellTimeout
    from ..core.sim.trace import TraceBuffer
    out = []
    for i, ctx in enumerate(ctxs):
        code = int(rc[i])
        if code == RC_TIMED_OUT:
            out.append(CellTimeout(timeout if timeout is not None else 0.0,
                                   "cuda"))
            continue
        if code != 0:
            out.append(RuntimeError(
                f"sim kernel: cell {i} of {len(ctxs)} "
                f"({ctx.get('scheduler_name', '?')}, T={ctx['T']}, "
                f"seed={ctx['seed']}, {ctx['table'].n} tasks) stopped with "
                f"code {code}: {RC_MEANING.get(code, 'unknown')}"))
            continue
        T = int(ctx["T"])
        off = packed["cores_off"][i]
        ctx["cores"][:] = [int(c) for c in cores[off:off + T]]
        h0, nh, t0, r0, NN = packed["aggs"][i]
        d, iv = dout[i], iout[i]
        out.append(dict(
            makespan=float(d[0]), remote=float(d[1]),
            total_exec=float(d[2]), queue_wait=float(d[3]),
            fault_lost=float(d[4]), last_t=float(d[5]),
            steals=int(iv[0]), failed=int(iv[1]), reclaimed=int(iv[2]),
            reexec=int(iv[3]), executed=int(iv[4]), steps=int(iv[5]),
            status=int(iv[6]),
            steal_hops=[int(x) for x in aggi[h0:h0 + nh]],
            node_tasks=[int(x) for x in aggi[t0:t0 + NN]],
            node_remote=[float(x) for x in aggd[r0:r0 + NN]]))
        if traces is not None and i in traces:
            out[-1]["trace"] = TraceBuffer.from_arrays(traces[i])
    return out


# --------------------------------------------------------------------
# the card
# --------------------------------------------------------------------

def _device(device):
    """``device`` as a torch.device, a CUDA one with its index."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _deadline_ns(timeout: "float | None") -> int:
    """The kernel's deadline argument for ``timeout`` seconds: -1 (no
    deadline) for None or <= 0, as ``runtime.resolve_timeout`` reads them;
    else the nanoseconds, rounded down (so a timeout under 1 ns is a 0 ns
    deadline, which every cell has passed at its first check)."""
    return -1 if timeout is None or timeout <= 0 else int(timeout * 1e9)


def ptxas_registers(log: str) -> dict:
    """{instantiation: (registers, spill store bytes, spill load bytes)}
    of a ``-Xptxas -v`` log of ``csrc/sim.cu``; an instantiation is named
    by its template flags, "untraced"/"traced" and "untimed"/"timed", and
    "/workspace" where its hot state is in device memory."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            f = re.search(
                r"sim_batch_kernelILb([01])ELb([01])E(?:Lb([01])E)?", m[1])
            name = None if f is None else (
                ("traced" if f[1] == "1" else "untraced") + "/"
                + ("timed" if f[2] == "1" else "untimed")
                + ("/workspace" if f[3] == "0" else ""))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, [0, 0, 0])[1:] = [int(m[1]), int(m[2])]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, [0, 0, 0])[0] = int(m[1])
    return {k: tuple(v) for k, v in out.items()}


def _route(traced: bool, in_workspace: bool) -> str:
    return ("traced" if traced else "untraced") + (
        "_workspace" if in_workspace else "")


def resident_cells(device, traced: bool, timed: bool, cells_per_warp: int,
                   hot: int, in_workspace: bool = False) -> int:
    """Cells ``device`` keeps resident at once for a launch of that
    instantiation and shape whose cells take ``hot`` bytes of hot state
    each (CUDA's occupancy of the kernel's blocks)."""
    dev = _device(device)
    with _build.on_device(dev):
        return _Card(dev).resident(traced, timed, cells_per_warp, hot,
                                   in_workspace)


def run_batch(ctxs, device, timeout: "float | None" = None) -> list:
    """Run prepared contexts on the CUDA ``device``: one entry per
    context, its result dict or, for a cell that overflowed, the
    ``RuntimeError`` naming it (past ``timeout`` seconds of its own, a
    ``CellTimeout``).

    Every cell runs in the kernel, its hot state in shared memory where
    it fits (else in its workspace, on a route of its own), in as few
    waves as ``WAVE_SHARE`` of the device's free memory allows
    (``MAX_WAVE_BYTES``, where set, caps a wave further); the traced
    cells of a batch (``ctx["trace"]``) in launches of the traced
    instantiation of their own. A build or launch failure raises:
    nothing falls back to the host.
    """
    import torch
    if torch.device(device).type != "cuda":
        raise ValueError(f"the sim kernel runs on a CUDA device, not "
                         f"{device}")
    dev = _device(device)
    ctxs = list(ctxs)
    if not ctxs:
        return []
    with _build.on_device(dev):
        out, stats = _drive(ctxs, _Card(dev), timeout)
    last_run.clear()
    last_run.update(stats)
    return out


class _Card:
    """The card's side of :func:`_drive`: torch buffers on ``dev``, the
    ``sim_run_batch`` entry on the current stream, timed by CUDA events,
    the launch shape from the device's occupancy, and the launch
    counts."""

    def __init__(self, dev):
        import torch
        self.torch, self.dev = torch, dev
        self.stream = torch.cuda.current_stream(dev)
        self.entry = _build.kernel_function("sim", "sim_run_batch",
                                            _RUN_ARGTYPES)

    def wave_cap(self) -> int:
        free, _ = self.torch.cuda.mem_get_info(self.dev)
        cap = int(free * WAVE_SHARE)
        return cap if MAX_WAVE_BYTES is None else min(cap,
                                                      int(MAX_WAVE_BYTES))

    def shared_limit(self) -> int:
        got = ctypes.c_int64(0)
        _build.kernel_function("sim", "sim_shared_limit", [_P])(
            ctypes.addressof(got))
        return int(got.value)

    def resident(self, traced, timed, cpw, hot, in_ws) -> int:
        got = ctypes.c_int64(0)
        _build.kernel_function("sim", "sim_resident_cells",
                               [_I, _I, _I, _I64, _I, _P])(
            int(traced), int(timed), cpw, hot, int(in_ws),
            ctypes.addressof(got))
        return int(got.value)

    def up(self, a):
        return self.torch.from_numpy(a).to(self.dev)

    def up_bytes(self, a):
        return self.up(a.view(np.uint8))

    def alloc(self, shape, dtype, zero: bool = True):
        t = self.torch
        dt = t.from_numpy(np.empty(0, dtype)).dtype
        return (t.zeros if zero else t.empty)(shape, dtype=dt,
                                              device=self.dev)

    @staticmethod
    def ptr(t) -> int:
        return t.data_ptr()

    @staticmethod
    def down(t) -> np.ndarray:
        return t.cpu().numpy()

    @staticmethod
    def take(cols, idx):
        return cols.index_select(1, idx)

    def launch(self, n, bufs, nbytes, traced, deadline, targs, cpw, hot,
               in_ws):
        global launches
        e0 = self.torch.cuda.Event(enable_timing=True)
        e1 = self.torch.cuda.Event(enable_timing=True)
        e0.record(self.stream)
        desc, dbuf, ibuf, tab, ws, dout, iout, aggi, aggd, rc = (
            t.data_ptr() for t in bufs)
        self.entry(n, desc, dbuf, ibuf, tab, ws, nbytes, dout, iout, aggi,
                   aggd, rc, cpw, hot, int(in_ws), int(traced), deadline,
                   None if targs is None else targs.ctypes.data,
                   self.stream.cuda_stream)
        e1.record(self.stream)
        launches += 1
        route_launches[_route(traced, in_ws)] += 1
        return e0, e1

    @staticmethod
    def wait(tok) -> None:
        tok[1].synchronize()

    @staticmethod
    def ms(tok) -> float:
        return tok[0].elapsed_time(tok[1])


class _Host:
    """The host build's side of :func:`_drive`: numpy buffers and ``lib``'s
    ``sim_run_batch_host``, timed on the host's clock, the H100's shared
    memory a block (or ``limit``) as the placement's limit, no launch
    counted."""

    def __init__(self, lib, max_wave_bytes, limit=None):
        self.lib, self.max_wave_bytes = lib, max_wave_bytes
        self.limit = HOST_SHARED_LIMIT if limit is None else int(limit)

    def wave_cap(self):
        return self.max_wave_bytes

    def shared_limit(self) -> int:
        return self.limit

    @staticmethod
    def resident(traced, timed, cpw, hot, in_ws):
        return None

    @staticmethod
    def up(a):
        return a

    @staticmethod
    def up_bytes(a):
        return a

    @staticmethod
    def alloc(shape, dtype, zero: bool = True):
        return np.zeros(shape, dtype)

    @staticmethod
    def ptr(a) -> int:
        return a.ctypes.data

    @staticmethod
    def down(a) -> np.ndarray:
        return a

    @staticmethod
    def take(cols, idx):
        return np.take(cols, idx, axis=1)

    def launch(self, n, bufs, nbytes, traced, deadline, targs, cpw, hot,
               in_ws):
        desc, dbuf, ibuf, tab, ws, dout, iout, aggi, aggd, rc = (
            a.ctypes.data for a in bufs)
        t0 = time.perf_counter()
        self.lib.sim_run_batch_host(
            n, desc, dbuf, ibuf, tab, ws, nbytes, dout, iout, aggi, aggd, rc,
            hot, int(in_ws), int(traced), deadline,
            None if targs is None else targs.ctypes.data)
        return t0, time.perf_counter()

    @staticmethod
    def wait(tok) -> None:
        pass

    @staticmethod
    def ms(tok) -> float:
        return (tok[1] - tok[0]) * 1e3


# the stats of a batch that are not summed over its groups
_KEPT = ("cells_per_warp", "hot_bytes", "resident_cells", "shared_limit")


def _drive(ctxs, side, timeout) -> tuple:
    """Run prepared contexts through ``side`` (:class:`_Card` or
    :class:`_Host`): one group of launches per route, the untraced cells
    in launches of the untraced instantiation and the traced ones
    (``ctx["trace"]``) in launches of the traced one, each with its hot
    state in shared memory where the cell's fits the limit and in its
    workspace where it does not. Returns (one entry per context, the
    batch's stats; ``groups`` the stats of each route's group)."""
    out: list = [None] * len(ctxs)
    stats: dict = {"groups": []}
    limit = side.shared_limit()
    if SHARED_CELL_MAX is not None:
        limit = min(limit, int(SHARED_CELL_MAX))
    for traced in (False, True):
        for in_ws in (False, True):
            idx = [i for i, c in enumerate(ctxs)
                   if bool(c.get("trace")) == traced
                   and (_cell_hot(c) > limit) == in_ws]
            if not idx:
                continue
            res, run = _run_group([ctxs[i] for i in idx], side, traced,
                                  in_ws, timeout)
            run["shared_limit"] = limit
            for i, r in zip(idx, res):
                out[i] = r
            stats["groups"].append(dict(run, route=_route(traced, in_ws)))
            for k, v in run.items():
                stats[k] = v if k in _KEPT else stats.get(k, 0) + v
    return out, stats


def _shape(side, n: int, traced: bool, timed: bool, hot: int,
           in_ws: bool) -> tuple:
    """(cells a warp, resident cells at that shape) for a wave of ``n``
    cells: ``CELLS_PER_WARP`` where set; else one a warp where the device
    keeps all ``n`` resident that way, else ``WIDE_CELLS_PER_WARP``."""
    if CELLS_PER_WARP is not None:
        cpw = int(CELLS_PER_WARP)
        return cpw, side.resident(traced, timed, cpw, hot, in_ws)
    one = side.resident(traced, timed, 1, hot, in_ws)
    if one is None or n <= one:
        return 1, one
    cpw = WIDE_CELLS_PER_WARP
    return cpw, side.resident(traced, timed, cpw, hot, in_ws)


def _run_group(ctxs, side, traced: bool, in_ws: bool, timeout) -> tuple:
    """One route's waves over ``ctxs``: (results, stats)."""
    t0 = time.perf_counter()
    packed = pack(ctxs, side.wave_cap(), traced=traced, in_workspace=in_ws)
    t1 = time.perf_counter()
    n = len(ctxs)
    desc, dbuf, ibuf, aggi, aggd = (side.up(packed[k]) for k in (
        "desc", "dbuf", "ibuf", "aggi", "aggd"))
    tab = side.up_bytes(packed["tab"])
    dout = side.alloc((n, 6), np.float64)
    iout = side.alloc((n, 7), np.int64)
    rc = side.alloc(n, np.int64)
    ws = side.alloc(max(packed["wave_bytes"]), np.uint8, zero=False)
    cols, counts, targs = None, None, None
    if traced:
        # one set of columns, as long as the longest wave's, reused
        lens = [max(max(w[j] for w in packed["wave_trace"]), 1)
                for j in range(3)]
        cols = [(side.alloc((ki, L), np.int64, zero=False),
                 side.alloc((kd, L), np.float64, zero=False))
                for (_, ki, kd), L in zip(_TRACE_FAMILIES, lens)]
        counts = side.alloc((n, 3), np.int64)
        targs = np.array([side.ptr(t) for pair in cols for t in pair]
                         + lens + [side.ptr(counts)], dtype=np.int64)
    deadline = _deadline_ns(timeout)
    toks, traces = [], {}
    trace_s, trace_bytes = 0.0, 0
    cpw, resident = 1, None
    for (a, b), nbytes, hot in zip(packed["waves"], packed["wave_bytes"],
                                   packed["wave_hot"]):
        cpw, resident = _shape(side, b - a, traced, deadline >= 0, hot,
                               in_ws)
        tok = side.launch(b - a, (desc[a:b], dbuf, ibuf, tab, ws, dout, iout,
                                  aggi, aggd, rc), nbytes, traced, deadline,
                          targs, cpw, hot, in_ws)
        toks.append(tok)
        if traced:
            # copy this wave's events off before the next one writes
            side.wait(tok)
            t2 = time.perf_counter()
            got, nb = _gather_wave(packed["desc"][a:b], counts, cols, side)
            traces.update(got)
            trace_bytes += nb
            trace_s += time.perf_counter() - t2
    outs = [side.down(t) for t in (dout, iout, rc, aggi, aggd)]
    cores = side.down(ibuf[:packed["n_cores"]])
    kernel_ms = sum(side.ms(tok) for tok in toks)
    t2 = time.perf_counter()
    res = unpack(ctxs, packed, *outs, cores, traces if traced else None,
                 timeout)
    run = dict(
        cells=n, waves=len(packed["waves"]), cells_per_warp=cpw,
        hot_bytes=int(max(packed["wave_hot"])),
        resident_cells=resident if resident is not None else 0,
        kernel_ms=kernel_ms, workspace_bytes=int(sum(packed["wave_bytes"])),
        wave_workspace_bytes=int(max(packed["wave_bytes"])),
        input_bytes=int(sum(packed[k].nbytes for k in (
            "desc", "tab", "dbuf", "ibuf"))),
        steps=int(outs[1][:, 5].sum()), pack_s=t1 - t0,
        device_s=t2 - t1, unpack_s=time.perf_counter() - t2,
        traced_cells=n if traced else 0, trace_bytes=trace_bytes,
        trace_cap_bytes=int(sum(_trace_bytes(w)
                                for w in packed["wave_trace"])),
        trace_copy_s=trace_s)
    return res, run


def _gather_wave(desc, counts, cols, side) -> tuple:
    """The events of one wave's cells (``desc``, their descriptor rows),
    gathered where they were written into one run per family (cell after
    cell) and brought to the host: ({slot: columns}, bytes copied)."""
    slots = desc[:, _D["out"]]
    cnt = side.down(counts)[slots]
    offs, cnts, host, nbytes = [], [], [], 0
    for j, (f, _, _) in enumerate(_TRACE_FAMILIES):
        c = cnt[:, j]
        starts = np.cumsum(c) - c
        src = side.up(np.repeat(desc[:, _D[f + "_off"]] - starts, c)
                      + np.arange(int(c.sum())))
        ints, dbls = cols[j]
        hi = side.down(side.take(ints, src))
        hd = side.down(side.take(dbls, src))
        nbytes += hi.nbytes + hd.nbytes
        offs.append(starts)
        cnts.append(c)
        host.append((hi, hd))
    return _cell_columns(slots, offs, cnts, host), nbytes


def _rng_state(dev):
    import torch
    fn = _build._library("sim").sim_rng_state_bytes
    fn.restype = ctypes.c_int64
    return torch.empty(int(fn()), dtype=torch.uint8, device=dev)


def mt_selftest(seed: int, n: int, device) -> np.ndarray:
    """n raw MT19937 draws from ``seed`` by the kernel's replica on the
    card (numpy: ``RandomState(seed).randint(0, 2**32, n, uint32)``)."""
    import torch
    dev = _device(device)
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    fn = _build.kernel_function("sim", "sim_mt_selftest",
                                [ctypes.c_uint32, _I64, _P, _P, _P])
    with _build.on_device(dev):
        st = _rng_state(dev)
        fn(seed, n, out.data_ptr(), st.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
        return out.cpu().numpy().view(np.uint32)


def shuffle_selftest(seed: int, n: int, reps: int, device) -> np.ndarray:
    """(reps, n): arange(n) shuffled ``reps`` times by the kernel's replica
    from ``seed`` (numpy: ``RandomState(seed).shuffle`` of a list)."""
    import torch
    dev = _device(device)
    out = torch.zeros((reps, n), dtype=torch.int64, device=dev)
    fn = _build.kernel_function("sim", "sim_shuffle_selftest",
                                [ctypes.c_uint32, _I64, _I64, _P, _P, _P])
    with _build.on_device(dev):
        st = _rng_state(dev)
        fn(seed, n, reps, out.data_ptr(), st.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
        return out.cpu().numpy()


def set_selftest(ops, max_key: int, device) -> list:
    """The kernel's CPython-set replica over ``ops`` (>= 0 adds, -1 pops
    when not empty): the popped keys, in order. Keys lie below
    ``max_key``."""
    import torch
    dev = _device(device)
    ops_t = torch.as_tensor(np.asarray(ops, np.int64), device=dev)
    out = torch.zeros(max(len(ops), 1), dtype=torch.int64, device=dev)
    npop = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _build._library("sim")
    lib.sim_set_workspace_bytes.restype = ctypes.c_int64
    lib.sim_set_workspace_bytes.argtypes = [ctypes.c_int64]
    fn = _build.kernel_function("sim", "sim_set_selftest",
                                [_I64, _P, _I64, _P, _P, _P, _P])
    with _build.on_device(dev):
        ws = torch.zeros(int(lib.sim_set_workspace_bytes(max_key)),
                         dtype=torch.uint8, device=dev)
        fn(len(ops), ops_t.data_ptr(), max_key, out.data_ptr(),
           npop.data_ptr(), ws.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
        k = int(npop.item())
        if k < 0:
            raise RuntimeError("set self-test: keys outgrew the tables")
        return out[:k].cpu().tolist()


# --------------------------------------------------------------------
# the kernel's loop built for the host (tests, no card)
# --------------------------------------------------------------------

def build_host(out_dir) -> ctypes.CDLL:
    """Compile ``csrc/sim.cu`` as host C++ (``-O2 -ffp-contract=off``, as
    the JAX package's C engine is built) into ``out_dir`` and load it:
    the kernel's loop, every instantiation and both placements, run on
    the CPU."""
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found")
    out = Path(out_dir) / "libsim_host.so"
    src = Path(__file__).resolve().parent / "csrc" / "sim.cu"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    for name, res, args in (
            ("sim_run_batch_host", None,
             [_I64] + [_P] * 5 + [_I64] + [_P] * 5 + [_I64, _I, _I, _I64,
                                                      _P]),
            ("sim_hot_bytes", _I64, [_I64, _I64, _I64]),
            ("sim_workspace_bytes", _I64, [_I64, _I64, _I64, _I64, _I]),
            ("sim_task_record_bytes", _I64, []),
            ("sim_task_state_bytes", _I64, []),
            ("sim_mt_selftest_host", None, [ctypes.c_uint32, _I64, _P]),
            ("sim_shuffle_selftest_host", None,
             [ctypes.c_uint32, _I64, _I64, _P]),
            ("sim_set_selftest_host", _I64, [_I64, _P, _I64, _P, _P]),
            ("sim_set_workspace_bytes", _I64, [_I64])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def run_batch_host(ctxs, lib, timeout: "float | None" = None,
                   max_wave_bytes: "int | None" = None,
                   limit: "int | None" = None) -> list:
    """:func:`run_batch` through the host build ``lib`` (:func:`build_host`):
    the same code (packing, routes, placements, waves, trace columns and
    their gather, unpacking) with numpy buffers in place of the card's,
    a garbage-filled host slice in place of shared memory and
    ``sim_run_batch_host`` in place of the launch. ``limit`` is the
    shared memory a block may have (default :data:`HOST_SHARED_LIMIT`;
    ``SHARED_CELL_MAX`` applies too)."""
    return _drive(list(ctxs), _Host(lib, max_wave_bytes, limit), timeout)[0]
