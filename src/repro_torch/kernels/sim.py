"""The NANOS simulator's event loop: the wrapper of the Hopper kernel
``csrc/sim.cu``.

It replaces the JAX package's C engine, ``repro/core/sim/_csim.c:743``
``sim_run_batch`` (bound by ``repro/core/sim/_csim.py``): one thread of the
card runs one prepared cell (see ``core/sim/runtime.py``
``_prepare_ctx``) from ignition to its last event, and every cell of a
batch runs in one launch. :func:`run_batch` packs the prepared contexts
into device buffers (the work of ``_csim.py``'s ``_marshal``):

  * one float64 and one int64 buffer holding, once each, every task table,
    topology array, root-distance vector, victim plan and fault plan the
    batch uses (shared read-only by the cells that use them), each cell's
    11 + 11 parameters and a copy of its ``cores`` (migration writes it);
  * a descriptor row of offsets per cell (``DESC`` names the fields, in
    ``sim.cu``'s order), the cells sorted by workload so that the threads
    of a warp read one table;
  * one zeroed workspace per cell (:func:`workspace_bytes`, the layout
    ``sim.cu`` carves: event heap, parked set, per-task state and the
    linked task deques); a batch whose workspaces do not fit half the
    device's free memory runs in waves, one launch each.

It then unpacks ``dout`` / ``iout`` and the three aggregates into the
result dicts the plain version returns, and writes each cell's final
core binding back into its context. A cell whose structures overflow
(a negative return code, which the workspace bound rules out) gets a
``RuntimeError`` naming it in its slot, as the plain version's
``run_batch`` gives a failing cell its exception, and the other cells
keep their results; statuses 1 and 2 (watchdog, stranded work) are
results that ``runtime._finish_result`` turns into ``SimStalled``.

:func:`run_batch` takes a CUDA device only (``runtime.run_cells`` sends
``cpu`` to the plain version): it launches the kernel or raises, and
nothing falls back to the host. ``launches`` counts kernel
launches (one a wave) and nothing else; ``last_run`` keeps the last
batch's waves, bytes and kernel time (CUDA events), and the host's
seconds packing, on the device (copies, launches and the wait for
them) and unpacking. The three self-tests
(:func:`mt_selftest`, :func:`shuffle_selftest`, :func:`set_selftest`)
run the kernel's replicas of numpy's MT19937, its shuffle and CPython's
set on the card. ``sim.cu`` also builds as host C++ (no ``__CUDACC__``):
``tests/test_torch_sim_engine.py`` runs :func:`pack`'s buffers through
that build on the CPU, where there is no card.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np

from . import _build

__all__ = ["run_batch", "pack", "unpack", "workspace_bytes", "DESC",
           "CELLS_PER_WARP", "MAX_WAVE_BYTES", "WAVE_SHARE", "launches",
           "last_run", "mt_selftest",
           "shuffle_selftest", "set_selftest", "RC_MEANING"]

# the descriptor fields, in sim.cu's `enum Desc` order
DESC = ("out", "dpar", "ipar", "wp", "wpo", "fr", "fp", "fc", "nc", "fpw",
        "npw", "par", "core_node", "node_dist", "root_dist", "cores", "goff",
        "uoff", "voff", "victims", "fspeed", "fwoff", "fwstart", "fwend",
        "hops", "node_tasks", "node_remote", "ws", "ws_bytes")
_D = {name: i for i, name in enumerate(DESC)}
RC_MEANING = {-2: "event heap overflow", -3: "parked-set overflow",
              -4: "workspace shorter than the cell's layout"}

# cells that share a warp (a power of two up to 32), chosen from the
# figure grid's kernel times at 1, 2, 4, 8 and 32 (PERF.md §6): with
# every lane a cell the threads diverge by event and a warp runs them
# one after another (about 3x slower); with one a warp, 234 registers a
# thread leave 8 warps an SM and too few cells run at once.
CELLS_PER_WARP = 2
# the share of the device's free memory a wave's workspaces may take, and
# a cap of a wave's workspace bytes (None: none) that forces more waves
WAVE_SHARE = 0.5
MAX_WAVE_BYTES = None

launches = 0
last_run: dict = {}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_RUN_ARGTYPES = [_I64, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _I, _P]


# --------------------------------------------------------------------
# the workspace layout (sim.cu `cell_layout`)
# --------------------------------------------------------------------

def _align8(x: int) -> int:
    return (x + 7) & ~7


def _set_cap(T: int) -> int:
    minused = 2 * T if T > 50000 else 4 * T
    size = 8
    while size <= minused:
        size <<= 1
    return size


def workspace_bytes(n: int, T: int) -> int:
    """Bytes of one cell's workspace for ``n`` tasks on ``T`` threads:
    the RNG state (624 + 1 words), a heap of 2T + 8 events of 32 bytes,
    two set tables of keys and states, five per-thread arrays, the
    deques' heads, tails and lengths, and per task pending, exec_node and
    the two deque links (int32) and phase (uint8)."""
    t1 = max(T, 1)
    sc = _set_cap(T)
    parts = [4 * 625, (2 * T + 8) * 32, sc * 8, sc * 8, sc, sc,
             t1 * 8, t1 * 8, t1 * 8, t1 * 8, (t1 + 1) * 4, (t1 + 1) * 4,
             (t1 + 1) * 8, n * 4, n * 4, n * 4, n * 4, n]
    o = 0
    for p in parts:
        o = _align8(o + p)
    return o


# --------------------------------------------------------------------
# packing
# --------------------------------------------------------------------

class _Buf:
    """A growing list of arrays of one dtype and their running offset."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.parts: list = []
        self.size = 0

    def add(self, arr) -> int:
        a = np.ascontiguousarray(arr, dtype=self.dtype).ravel()
        off = self.size
        self.parts.append(a)
        self.size += a.shape[0]
        return off

    def array(self) -> np.ndarray:
        if not self.parts:
            return np.zeros(1, self.dtype)
        return np.concatenate(self.parts + [np.zeros(1, self.dtype)])


def _dpar(ctx) -> list:
    return [ctx["hop_lambda"], ctx["hop_lambda_steal"], ctx["lock_time"],
            ctx["deque_lock_time"], ctx["steal_time"], ctx["spawn_time"],
            ctx["wake_latency"], ctx["qop_time"], ctx["cache_refill"],
            ctx["mem_intensity"], ctx["migration_rate"]]


def _ipar(ctx) -> list:
    rdn = ctx["runtime_data_node"]
    return [ctx["T"], ctx["num_cores"], ctx["num_nodes"], ctx["table"].n,
            int(ctx["queue_shared"]), int(ctx["child_first"]),
            int(ctx["seed"]), -1 if rdn is None else int(rdn),
            ctx["root_node0"], int(ctx.get("fault_plan") is not None),
            int(ctx.get("max_steps") or 0)]


def pack(ctxs, max_wave_bytes: "int | None" = None) -> dict:
    """Lower prepared contexts into the kernel's buffers (numpy, host).

    Returns dict(desc (n, len(DESC)) int64 in launch order, dbuf, ibuf
    (its first ``n_cores`` entries every cell's ``cores``, in cell
    order), aggi, aggd, waves (launch-order [start, stop) ranges), wave
    workspace bytes, and per cell its cores offset and aggregate slices).
    ``max_wave_bytes`` caps a wave's workspaces (default: no cap).
    """
    n = len(ctxs)
    dbuf, ibuf = _Buf(np.float64), _Buf(np.int64)
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

    rows, aggs, table_rank = [], [], {}
    for i, ctx in enumerate(ctxs):
        tbl = ctx["table"]
        d = [0] * len(DESC)
        d[_D["out"]] = i
        d[_D["dpar"]] = dbuf.add(_dpar(ctx))
        d[_D["ipar"]] = ibuf.add(_ipar(ctx))
        (d[_D["wp"]], d[_D["wpo"]], d[_D["fr"]], d[_D["fp"]], d[_D["fc"]],
         d[_D["nc"]], d[_D["fpw"]], d[_D["npw"]], d[_D["par"]]) = once(
            ("table", id(tbl)), lambda: (
                dbuf.add(tbl.work_pre), dbuf.add(tbl.work_post),
                dbuf.add(tbl.f_root), dbuf.add(tbl.f_parent),
                ibuf.add(tbl.first_child), ibuf.add(tbl.num_children),
                ibuf.add(tbl.first_post), ibuf.add(tbl.num_post),
                ibuf.add(tbl.parent)))
        table_rank.setdefault(id(tbl), len(table_rank))
        cn = np.ascontiguousarray(ctx["core_node_arr"], np.int64)
        nd = np.ascontiguousarray(ctx["node_dist_flat"], np.int64)
        rd = np.ascontiguousarray(ctx["root_dist"], np.float64)
        d[_D["core_node"]] = once(("cn", cn.tobytes()), lambda: ibuf.add(cn))
        d[_D["node_dist"]] = once(("nd", nd.tobytes()), lambda: ibuf.add(nd))
        d[_D["root_dist"]] = once(("rd", rd.tobytes()), lambda: dbuf.add(rd))
        d[_D["cores"]] = cores_off[i]
        vp = ctx["vplan"]
        (d[_D["goff"]], d[_D["uoff"]], d[_D["voff"]],
         d[_D["victims"]]) = once(("vplan", id(vp)), lambda: tuple(
             ibuf.add(a) for a in vp.flat()))
        fplan = ctx.get("fault_plan")
        if fplan is not None:
            (d[_D["fspeed"]], d[_D["fwoff"]], d[_D["fwstart"]],
             d[_D["fwend"]]) = once(("fplan", id(fplan)), lambda: (
                 dbuf.add(fplan.speed), ibuf.add(fplan.win_off),
                 dbuf.add(fplan.win_start), dbuf.add(fplan.win_end)))
        max_hop = ctx.get("max_hop")
        if max_hop is None:
            max_hop = int(ctx["node_dist_flat"].max())
        NN = int(ctx["num_nodes"])
        d[_D["hops"]] = aggi.add(np.zeros(max_hop + 1, np.int64))
        d[_D["node_tasks"]] = aggi.add(np.zeros(NN, np.int64))
        d[_D["node_remote"]] = aggd.add(np.zeros(NN, np.float64))
        aggs.append((d[_D["hops"]], max_hop + 1, d[_D["node_tasks"]],
                     d[_D["node_remote"]], NN))
        d[_D["ws_bytes"]] = workspace_bytes(tbl.n, int(ctx["T"]))
        rows.append(d)

    # launch order: by workload (first appearance), then thread count
    order = sorted(range(n), key=lambda i: (
        table_rank[id(ctxs[i]["table"])], int(ctxs[i]["T"]), i))
    waves, wave_bytes, start, used = [], [], 0, 0
    for k, i in enumerate(order):
        b = rows[i][_D["ws_bytes"]]
        if k > start and max_wave_bytes is not None \
                and used + b > max_wave_bytes:
            waves.append((start, k))
            wave_bytes.append(used)
            start, used = k, 0
        rows[i][_D["ws"]] = used
        used += b
    waves.append((start, n))
    wave_bytes.append(used)
    desc = np.asarray([rows[i] for i in order], dtype=np.int64).reshape(
        n, len(DESC))
    return dict(desc=desc, dbuf=dbuf.array(), ibuf=ibuf.array(),
                aggi=aggi.array(), aggd=aggd.array(), waves=waves,
                wave_bytes=wave_bytes, n_cores=n_cores, cores_off=cores_off,
                aggs=aggs)


def unpack(ctxs, packed: dict, dout, iout, rc, aggi, aggd,
           cores) -> list:
    """The result dicts of a finished batch (numpy outputs, cell order);
    writes each cell's final core binding back into its context. A cell
    whose kernel run stopped with a negative code gets, in its slot, a
    ``RuntimeError`` naming it (``run_sweep`` maps it to its cell)."""
    out = []
    for i, ctx in enumerate(ctxs):
        code = int(rc[i])
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


def run_batch(ctxs, device) -> list:
    """Run prepared contexts on the CUDA ``device``: one entry per
    context, its result dict or, for a cell that overflowed, the
    ``RuntimeError`` naming it.

    Every cell runs in the kernel, ``CELLS_PER_WARP`` cells a warp, in as
    few waves as ``WAVE_SHARE`` of the device's free memory allows
    (``MAX_WAVE_BYTES``, where set, caps a wave further). A build or
    launch failure raises: nothing falls back to the host.
    """
    import torch
    if torch.device(device).type != "cuda":
        raise ValueError(f"the sim kernel runs on a CUDA device, not "
                         f"{device}")
    dev = _device(device)
    global launches
    ctxs = list(ctxs)
    if not ctxs:
        return []
    cpw = CELLS_PER_WARP
    with _build.on_device(dev):
        free, _ = torch.cuda.mem_get_info(dev)
        cap = int(free * WAVE_SHARE)
        if MAX_WAVE_BYTES is not None:
            cap = min(cap, int(MAX_WAVE_BYTES))
        t0 = time.perf_counter()
        packed = pack(ctxs, cap)
        t1 = time.perf_counter()
        n = len(ctxs)

        def up(a):
            return torch.from_numpy(a).to(dev)
        desc, dbuf, ibuf = up(packed["desc"]), up(packed["dbuf"]), \
            up(packed["ibuf"])
        aggi, aggd = up(packed["aggi"]), up(packed["aggd"])
        dout = torch.zeros((n, 6), dtype=torch.float64, device=dev)
        iout = torch.zeros((n, 7), dtype=torch.int64, device=dev)
        rc = torch.zeros(n, dtype=torch.int64, device=dev)
        ws = torch.empty(max(packed["wave_bytes"]), dtype=torch.uint8,
                         device=dev)
        launch = _build.kernel_function("sim", "sim_run_batch",
                                        _RUN_ARGTYPES)
        stream = torch.cuda.current_stream(dev)
        events = []
        for (a, b), nbytes in zip(packed["waves"], packed["wave_bytes"]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
            launch(b - a, desc[a:b].data_ptr(), dbuf.data_ptr(),
                   ibuf.data_ptr(), ws.data_ptr(), nbytes, dout.data_ptr(),
                   iout.data_ptr(), aggi.data_ptr(), aggd.data_ptr(),
                   rc.data_ptr(), cpw, stream.cuda_stream)
            e1.record(stream)
            launches += 1
            events.append((e0, e1))
        outs = [t.cpu().numpy() for t in (dout, iout, rc, aggi, aggd)]
        cores = ibuf[:packed["n_cores"]].cpu().numpy()
        kernel_ms = sum(e0.elapsed_time(e1) for e0, e1 in events)
        t2 = time.perf_counter()
    out = unpack(ctxs, packed, *outs, cores)
    last_run.clear()
    last_run.update(
        cells=n, waves=len(packed["waves"]), cells_per_warp=cpw,
        kernel_ms=kernel_ms, workspace_bytes=int(sum(packed["wave_bytes"])),
        wave_workspace_bytes=int(ws.numel()),
        input_bytes=int(8 * (packed["dbuf"].size + packed["ibuf"].size
                             + packed["desc"].size)),
        steps=int(outs[1][:, 5].sum()), pack_s=t1 - t0,
        device_s=t2 - t1, unpack_s=time.perf_counter() - t2)
    return out


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
