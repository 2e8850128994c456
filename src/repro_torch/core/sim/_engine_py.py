"""The plain version of the card's simulation kernel: the pure-Python
flat-array engine (own copy of ``repro/core/sim/_engine_py.py``, its
``run`` and a serial ``run_batch``).

It preserves the original (seed) engine's behavior draw-for-draw — same
event ordering, same ``numpy.random.RandomState`` consumption, same
float-operation association — over integer indices into the compiled
:class:`~.table.TaskTable` arrays, with precomputed lookup tables:

  * per-class × node NUMA penalty rows
    ``mu_lambda * (f_root * d_root[n] + f_parent * d(n, parent_node))``
    built lazily (only (class, exec-node) pairs that actually occur);
  * per-core queue-op and steal-probe costs;
  * ``collections.deque`` task pools.

Scheduler identity never reaches this loop: the context carries the
spec's ``queue_shared`` / ``child_first`` flags and a compiled
:class:`~.policy.VictimPlan`, whose pre-lowered group list is
interpreted per steal sweep (a fully static plan skips even that).
Fault injection works the same way through a compiled
:class:`~.faults.FaultPlan` (per-core speed multipliers + per-thread
merged offline windows), consulted when a thread's event fires and when
an execution cost is known. All fault randomness was drawn at plan
compile time from a dedicated stream, so the engine's own
``RandomState(seed)`` draw order is untouched.

A step-count watchdog (``ctx["max_steps"]``) converts a hung event loop
into a diagnosable ``status=1`` return; ``status=2`` reports a drained
loop that completed fewer tasks than the table holds (stranded work).
A wall-clock ``timeout`` is checked every :data:`DEADLINE_EVERY` events
(the first included), as the card's kernel checks its ``%globaltimer``,
and a cell past it raises :class:`~.sweep.CellTimeout`. The loop makes
no call that could wedge, so the check needs no worker process: the
port has no fork pool and no ``WorkerDied``.

Under ``ctx["trace"]`` the loop records exec, steal and migration
events at the JAX package's three points (:mod:`.trace`), extending
flat row-major lists and columnizing once at the end.

This is what the host runs (``device="cpu"``) and what the card's
kernel, ``csrc/sim.cu`` (a transcription of the JAX package's C engine,
itself a transcription of this loop), is held against bit for bit.
Nothing calls it when the simulation runs on a CUDA device.
"""

from __future__ import annotations

import heapq
import time
from collections import deque

__all__ = ["run", "run_batch", "DEADLINE_EVERY"]

# events between two reads of the clock under a timeout (a power of two;
# the kernel's kDeadlineEvery)
DEADLINE_EVERY = 4096


def run(ctx, timeout: "float | None" = None) -> dict:
    heappush = heapq.heappush
    heappop = heapq.heappop
    tbl = ctx["table"]
    (wp_l, wpo_l, fc_l, nc_l, fpw_l, npw_l, par_l, cls_l) = tbl.lists()
    n_tasks = tbl.n
    T = ctx["T"]
    cores = ctx["cores"]          # mutated in place under migration
    rng = ctx["rng"]
    core_node_l = ctx["core_node_arr"].tolist()
    NN = ctx["num_nodes"]
    nd_l = [ctx["node_dist_flat"][n * NN:(n + 1) * NN].tolist()
            for n in range(NN)]
    root_dist_l = ctx["root_dist"].tolist()
    rnode0 = ctx["root_node0"]
    num_cores_m = ctx["num_cores"]
    rdn = ctx["runtime_data_node"]
    migration_rate = ctx["migration_rate"]
    hop_lambda_steal = ctx["hop_lambda_steal"]
    lock_time = ctx["lock_time"]
    deque_lock_time = ctx["deque_lock_time"]
    steal_time = ctx["steal_time"]
    spawn_time = ctx["spawn_time"]
    wake_latency = ctx["wake_latency"]
    qop_time = ctx["qop_time"]
    cache_refill = ctx["cache_refill"]
    mu_lam = ctx["mem_intensity"] * ctx["hop_lambda"]
    depth_first = not ctx["queue_shared"]
    wf_like = ctx["child_first"]
    vplan = ctx["vplan"]
    plan_groups = vplan.py_groups
    static_orders = vplan.static_order
    shuffle = rng.shuffle
    INF = float("inf")
    max_steps = ctx.get("max_steps") or (1 << 62)
    fplan = ctx.get("fault_plan")
    have_faults = fplan is not None
    if have_faults:
        fspeed = fplan.speed.tolist()
        fwstart = fplan.win_start.tolist()
        fwend = fplan.win_end.tolist()
        fwoff = fplan.win_off.tolist()
        wcur = fwoff[:T]          # per-thread window cursor (monotone)
        wlim = fwoff[1:T + 1]

    # --- precomputed cost tables (exact seed expressions) ---
    cls_fr = tbl.cls_f_root.tolist()
    cls_fp = tbl.cls_f_parent.tolist()
    PEN: list[list] = [[None] * NN for _ in range(tbl.num_classes)]

    def pen_row(c: int, n: int) -> list[float]:
        fr = cls_fr[c]
        fp = cls_fp[c]
        dr = root_dist_l[n]
        nd_n = nd_l[n]
        row = [mu_lam * (fr * dr + fp * nd_n[pn]) for pn in range(NN)]
        PEN[c][n] = row
        return row

    if rdn is None:
        qop_c = [qop_time] * num_cores_m
    else:
        qop_c = [qop_time * (1.0 + hop_lambda_steal
                             * nd_l[core_node_l[c]][rdn])
                 for c in range(num_cores_m)]
    # steal-probe cost per (thief core, victim core); rows built lazily
    if rdn is None:
        probe_rows: list = [None] * num_cores_m

        def probe_row(ct: int) -> list[float]:
            tn = core_node_l[ct]
            row = [steal_time * (1.0 + hop_lambda_steal
                                 * float(nd_l[tn][core_node_l[cv]]))
                   for cv in range(num_cores_m)]
            probe_rows[ct] = row
            return row
    else:
        probe_const = [steal_time * (1.0 + hop_lambda_steal
                                     * float(nd_l[core_node_l[ct]][rdn]))
                       for ct in range(num_cores_m)]

    # --- mutable simulation state (flat arrays, no objects) ---
    local = [deque() for _ in range(T)]
    shared: deque = deque()
    sl_free = 0.0
    sl_waited = 0.0
    dl_free = [0.0] * T
    parked: set[int] = set()
    events: list = []
    seq = 0
    steals = 0
    failed = 0
    remote = 0.0
    total_exec = 0.0
    live = 1
    makespan = 0.0
    pending = [0] * n_tasks
    exec_node = [0] * n_tasks
    phase = bytearray(n_tasks)
    reclaimed = 0
    reexec = 0
    fault_lost = 0.0
    executed = 0
    steps = 0
    status = 0
    last_t = 0.0
    # always-on locality aggregates (O(1) per event; see SimResult)
    steal_hops = [0] * (ctx.get("max_hop", 0) + 1)
    node_tasks = [0] * NN
    node_remote = [0.0] * NN
    # event tracing: extend flat row-major lists in the hot loop,
    # columnize once at the end (TraceBuffer.from_flat) — an order of
    # magnitude cheaper per event than indexed array stores
    tracing = bool(ctx.get("trace"))
    ex_ev: list = []
    st_ev: list = []
    mg_ev: list = []
    ex_append, st_append, mg_append = \
        ex_ev.extend, st_ev.extend, mg_ev.extend
    # None or <= 0: no deadline (runtime.resolve_timeout's reading)
    deadline = None if timeout is None or timeout <= 0 \
        else time.monotonic() + timeout
    clock_mask = DEADLINE_EVERY - 1

    def go_offline(now, th, task, cidx):
        # Thread `th` hits offline window `cidx` at `now`, carrying
        # `task` if >= 0. The in-hand task is re-queued (stealable);
        # queued tasks stay in place but one thief is woken per task so
        # they are reclaimed by stealing. A finite window resumes the
        # thread with a fresh acquire at the window end; end == inf is a
        # permanent failure — no resume, and an empty-handed dead thread
        # passes a consumed wake on so live work cannot strand.
        nonlocal seq, reclaimed
        nq = len(local[th]) if depth_first else 0
        if task >= 0:
            nq += 1
            if depth_first:
                local[th].append(task)
            else:
                shared.append(task)
        reclaimed += nq
        while nq > 0 and parked:
            seq += 1
            heappush(events, (now + wake_latency, seq, parked.pop(), -1))
            nq -= 1
        if fwend[cidx] != INF:
            seq += 1
            heappush(events, (fwend[cidx], seq, th, -1))
        elif task < 0 and parked:
            seq += 1
            heappush(events, (now, seq, parked.pop(), -1))

    # ignition: master (thread 0) runs the root; workers go hunting
    seq += 1
    heappush(events, (0.0, seq, 0, 0))
    for th in range(1, T):
        seq += 1
        heappush(events, (0.0, seq, th, -1))

    while events:
        t, _, th, task = heappop(events)
        steps += 1
        if steps > max_steps:
            status = 1
            last_t = t
            break
        if deadline is not None and steps & clock_mask == 1 \
                and time.monotonic() >= deadline:
            from .sweep import CellTimeout
            raise CellTimeout(timeout, "plain")
        if have_faults:
            c = wcur[th]
            lim = wlim[th]
            while c < lim and fwend[c] <= t:
                c += 1
            wcur[th] = c
            if c < lim and fwstart[c] <= t:
                go_offline(t, th, task, c)
                continue
        if task < 0:
            # ---- acquire: local pop / steal sweep / shared FIFO ----
            if depth_first:
                lp = local[th]
                if lp:
                    task = lp.pop()
                    t += qop_c[cores[th]]
                else:
                    order = static_orders[th]
                    if order is None:
                        # interpret the compiled sweep: one shuffle per
                        # group with >1 unit, draws matching the seed.
                        order = []
                        for tag, payload in plan_groups[th]:
                            if tag == 0:          # static run
                                order.extend(payload)
                            elif tag == 1:        # singleton units
                                g = list(payload)
                                shuffle(g)
                                order.extend(g)
                            else:                 # multi-victim units
                                units = list(payload)
                                shuffle(units)
                                for u in units:
                                    order.extend(u)
                    ct = cores[th]
                    if rdn is None:
                        prow = probe_rows[ct]
                        if prow is None:
                            prow = probe_row(ct)
                        pc = None
                    else:
                        pc = probe_const[ct]
                    task = -1
                    for v in order:
                        t += prow[cores[v]] if pc is None else pc
                        lv = local[v]
                        if lv:
                            f = dl_free[v]
                            t = (f if f > t else t) + deque_lock_time
                            dl_free[v] = t
                            steals += 1
                            task = lv.popleft()  # steal from the back
                            # hop distance thief-core → victim-core (the
                            # stolen task's data locality, independent of
                            # the probe cost, which models queue metadata)
                            d = nd_l[core_node_l[ct]][core_node_l[cores[v]]]
                            steal_hops[d] += 1
                            if tracing:
                                st_append((t, th, v, task, d))
                            break
                        failed += 1
                    if task < 0:
                        if live > 0:
                            parked.add(th)
                        continue
            else:
                # breadth-first: peek cheaply, then serialize on the lock
                if not shared:
                    if live > 0:
                        parked.add(th)
                    continue
                start = sl_free if sl_free > t else t
                sl_waited += start - t
                t = start + lock_time
                sl_free = t
                if not shared:
                    if live > 0:
                        parked.add(th)
                    continue
                task = shared.popleft()

        # ---- run `task` on thread th at time t ----
        if migration_rate > 0.0 and rng.random_sample() < migration_rate:
            oldc = cores[th]
            cores[th] = int(rng.randint(num_cores_m))
            t += cache_refill
            if tracing:
                mg_append((t, th, oldc, cores[th]))
        core = cores[th]
        n = core_node_l[core]
        exec_node[task] = n
        pr = par_l[task]
        pn = exec_node[pr] if pr >= 0 else rnode0
        row = PEN[cls_l[task]][n]
        if row is None:
            row = pen_row(cls_l[task], n)
        pen = row[pn]
        w = wp_l[task]
        cost = w * (1.0 + pen)
        if have_faults:
            cost = cost * fspeed[core]
            c = wcur[th]
            lim = wlim[th]
            # t advanced during acquire (probes, locks): windows may
            # have closed — or opened — since the top-of-loop check.
            while c < lim and fwend[c] <= t:
                c += 1
            wcur[th] = c
            if c < lim and fwstart[c] < t + cost:
                # preempted/killed mid-execution: partial work is lost
                # and the task re-executes (here after the window, or
                # wherever it is stolen to meanwhile).
                s = fwstart[c]
                if s < t:
                    s = t
                fault_lost += s - t
                reexec += 1
                go_offline(s, th, task, c)
                continue
        remote += w * pen
        total_exec += cost
        node_tasks[n] += 1
        node_remote[n] += w * pen
        if tracing:
            ex_append((task, th, core, n,
                       len(local[th]) if depth_first else len(shared),
                       t, t + cost))
        t += cost
        executed += 1

        nk = nc_l[task]
        if nk:
            base = fc_l[task]
            pending[task] = nk
            live += nk
            t += spawn_time * nk
            qc = qop_c[core]
            if wf_like:
                # work-first: dive into the first child, queue the rest
                lp = local[th]
                for k in range(base + nk - 1, base, -1):
                    t += qc
                    lp.append(k)
                    if parked:
                        seq += 1
                        heappush(events,
                                 (t + wake_latency, seq, parked.pop(), -1))
                seq += 1
                heappush(events, (t, seq, th, base))
                continue
            if depth_first:  # cilk: queue all, re-acquire own front
                lp = local[th]
                for k in range(base + nk - 1, base - 1, -1):
                    t += qc
                    lp.append(k)
                    if parked:
                        seq += 1
                        heappush(events,
                                 (t + wake_latency, seq, parked.pop(), -1))
            else:  # bf: shared FIFO in spawn order, one lock op each
                for k in range(base, base + nk):
                    start = sl_free if sl_free > t else t
                    sl_waited += start - t
                    t = start + lock_time
                    sl_free = t
                    shared.append(k)
                    if parked:
                        seq += 1
                        heappush(events,
                                 (t + wake_latency, seq, parked.pop(), -1))
            seq += 1
            heappush(events, (t, seq, th, -1))
            continue

        # ---- leaf: propagate completion up the tree ----
        live -= 1
        node = task
        while True:
            parent = par_l[node]
            if parent < 0:
                break
            pd = pending[parent] - 1
            pending[parent] = pd
            if pd > 0:
                break
            if phase[parent] == 0 and npw_l[parent]:
                # taskwait passed: spawn the combine wave here — this
                # thread just finished the last child, hottest caches.
                phase[parent] = 1
                k = npw_l[parent]
                fp0 = fpw_l[parent]
                pending[parent] = k
                live += k
                t += spawn_time * k
                if depth_first:
                    qc = qop_c[cores[th]]
                    lp = local[th]
                    for j in range(fp0 + k - 1, fp0 - 1, -1):
                        t += qc
                        lp.append(j)
                        if parked:
                            seq += 1
                            heappush(events, (t + wake_latency, seq,
                                              parked.pop(), -1))
                else:
                    for j in range(fp0 + k - 1, fp0 - 1, -1):
                        start = sl_free if sl_free > t else t
                        sl_waited += start - t
                        t = start + lock_time
                        sl_free = t
                        shared.append(j)
                        if parked:
                            seq += 1
                            heappush(events, (t + wake_latency, seq,
                                              parked.pop(), -1))
                break
            w2 = wpo_l[parent]
            if w2 > 0.0:
                # join continuation with the parent's locality profile
                pn2 = exec_node[parent]
                row2 = PEN[cls_l[parent]][n]
                if row2 is None:
                    row2 = pen_row(cls_l[parent], n)
                pen2 = row2[pn2]
                c2 = w2 * (1.0 + pen2)
                if have_faults:
                    c2 = c2 * fspeed[core]
                remote += w2 * pen2
                total_exec += c2
                node_remote[n] += w2 * pen2
                t += c2
            node = parent
        if t > makespan:
            makespan = t
        seq += 1
        heappush(events, (t, seq, th, -1))

    if status == 0 and executed != n_tasks:
        status = 2          # loop drained with work stranded
        last_t = makespan
    elif status == 0:
        last_t = makespan
    out = dict(makespan=makespan, remote=remote, total_exec=total_exec,
               queue_wait=sl_waited, steals=steals, failed=failed,
               reclaimed=reclaimed, reexec=reexec, fault_lost=fault_lost,
               executed=executed, steps=steps, status=status, last_t=last_t,
               steal_hops=steal_hops, node_tasks=node_tasks,
               node_remote=node_remote)
    if tracing:
        from .trace import TraceBuffer
        out["trace"] = TraceBuffer.from_flat(ex_ev, st_ev, mg_ev)
    return out


def run_batch(ctxs, timeout: "float | None" = None) -> list:
    """Run many prepared contexts one after another on the host.

    Returns one entry per context: the result dict, or the exception the
    cell raised (callers map these to ``CellError``), so one bad cell
    cannot stop the batch. ``timeout`` is each cell's own wall-clock
    budget, counted from the moment that cell starts (None or <= 0:
    none).
    """
    out = []
    for ctx in ctxs:
        try:
            out.append(run(ctx, timeout))
        except Exception as e:       # noqa: BLE001 — isolate the cell
            out.append(e)
    return out


