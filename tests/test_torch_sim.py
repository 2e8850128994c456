"""The port's simulator (``repro_torch.core.sim``) against the JAX
package's (``repro.core.sim``) on the host: the BOTS task tables (each
built by the port's builder and by ``table_from_arrays`` from JAX's
arrays), victim plans, bindings and placements, fault plans, serial times
and steal orders equal array for array; a figure grid and its
Monte-Carlo aggregates equal result for result. Then the device
dispatch: a CUDA device runs the card's kernel and never the plain
version, whatever the environment says, and a kernel failure raises.
Under 10 s in one process."""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

from repro.core import stealing as jstealing
from repro.core import topology as jtopology
from repro.core.sim import Machine as JMachine
from repro.core.sim import bots as jbots
from repro.core.sim import context as jcontext
from repro.core.sim import faults as jfaults
from repro.core.sim import policy as jpolicy
from repro.core.sim import runtime as jruntime
from repro.core.sim.table import TaskTable as JTaskTable

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import stealing, topology  # noqa: E402
from repro_torch.core.sim import (CellError, Machine, RetryPolicy,  # noqa: E402
                                  SimParams, SweepPlan, bots, context,
                                  faults, policy, runtime, run_sweep)
from repro_torch.core.sim import _engine_py  # noqa: E402
from repro_torch.core.sim.table import table_from_arrays  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import sim as sim_kernel  # noqa: E402
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401

TOPOS = {"sunfire": (topology.sunfire_x4600, jtopology.sunfire_x4600, ()),
         "tpu2x4": (topology.tpu_pod_2d, jtopology.tpu_pod_2d, (2, 4))}
SCHEDS = ("bf", "cilk", "wf", "dfwspt", "dfwsrpt", "dfwshier")


def _topos(name):
    mk, jmk, args = TOPOS[name]
    return mk(*args), jmk(*args)


# ----------------------------------------------------------------------
# tables
# ----------------------------------------------------------------------

BUILDERS = {
    "fft": ("fft", dict(n=1 << 10, cutoff=8)),
    "sort": ("sort", dict(n=1 << 10, cutoff=16)),
    "strassen": ("strassen", dict(depth=3)),
    "nqueens": ("nqueens", dict(n=8)),
    "floorplan": ("floorplan", dict(depth=4)),
    "sparselu": ("sparselu", dict(n=8)),
    "fft_flat": ("fft_flat", dict(n=1 << 10, cutoff=8)),
    "sort_flat": ("sort_flat", dict(n=1 << 10, cutoff=16)),
    "strassen_flat": ("strassen_flat", dict(depth=3)),
    "nqueens_flat": ("nqueens_flat", dict(n=8, cutoff_depth=3)),
    "sparselu_flat": ("sparselu_flat", dict(n=10)),
}


def _table_equal(got, want):
    assert got.n == want.n
    for field in JTaskTable.ARRAY_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_bots_table_equals_jax_both_ways(name):
    fn, kw = BUILDERS[name]
    wl, jwl = getattr(bots, fn)(**kw), getattr(jbots, fn)(**kw)
    assert (wl.name, wl.mem_intensity) == (jwl.name, jwl.mem_intensity)
    tbl, jtbl = runtime.ensure_table(wl), jruntime.ensure_table(jwl)
    _table_equal(tbl, jtbl)
    again = table_from_arrays(jtbl.work_pre, jtbl.work_post, jtbl.f_root,
                              jtbl.f_parent, jtbl.num_children,
                              jtbl.num_post)
    _table_equal(again, jtbl)
    if wl.root is not None:
        assert wl.root.count() == jwl.root.count() == tbl.n
        assert wl.root.total_work() == jwl.root.total_work()


@pytest.mark.parametrize("name", sorted(bots.WORKLOADS))
def test_make_medium_equals_jax(name):
    _table_equal(runtime.ensure_table(bots.make(name, "medium")),
                 jruntime.ensure_table(jbots._build(name, "medium")))


# ----------------------------------------------------------------------
# victim plans, steal orders
# ----------------------------------------------------------------------

@pytest.mark.parametrize("topo_name", sorted(TOPOS))
@pytest.mark.parametrize("sched", SCHEDS)
def test_victim_plan_equals_jax(topo_name, sched):
    topo, jtopo = _topos(topo_name)
    for T in (1, 3, 8):
        cores = tuple(context.BINDINGS["paper"].lower(topo, T))
        jcores = tuple(jcontext.BINDINGS["paper"].lower(jtopo, T))
        assert cores == jcores
        vp = policy.compile_victim_plan(policy.get_spec(sched), topo, cores)
        jvp = jpolicy.compile_victim_plan(jpolicy.get_spec(sched), jtopo,
                                          jcores)
        assert vp.groups == jvp.groups
        assert vp.py_groups == jvp.py_groups
        assert vp.static_order == jvp.static_order
        for a, b in zip(vp.flat(), jvp.flat()):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("pol", ["dfwspt", "dfwsrpt", "dfwshier"])
def test_steal_order_matrix_equals_jax(pol):
    for topo_name in TOPOS:
        topo, jtopo = _topos(topo_name)
        cores = list(range(topo.num_cores))[::-1][:8]
        for seed in (0, 3):
            assert np.array_equal(
                stealing.steal_order_matrix(topo, cores, pol, seed),
                jstealing.steal_order_matrix(jtopo, cores, pol, seed))


# ----------------------------------------------------------------------
# bindings, placements, fault plans, serial time
# ----------------------------------------------------------------------

CONTEXTS = [
    dict(binding="paper", placement="first_touch"),
    dict(binding="paper", placement="spill:2"),
    dict(binding="linear", placement="spill:2@0", runtime_data=0,
         migration_rate=0.15),
    dict(binding="scatter", placement="spill:3@1", runtime_data="master"),
    dict(binding="node_fill", placement="interleave"),
    dict(binding="cores:7,3,5", placement="nodes:1,2"),
]


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
@pytest.mark.parametrize("ctx_kw", CONTEXTS,
                         ids=lambda kw: f"{kw['binding']}-{kw['placement']}")
def test_binding_and_placement_equal_jax(topo_name, ctx_kw):
    topo, jtopo = _topos(topo_name)
    explicit = ctx_kw["binding"].startswith("cores:")
    for T in ((None,) if explicit else (1, 4, 6, 8)):
        for bind_seed in (0, 2):
            kw = dict(ctx_kw, bind_seed=bind_seed)
            c = context.ExecContext.compile(topo, SimParams(), T, **kw)
            jc = jcontext.ExecContext.compile(jtopo, jruntime.SimParams(), T,
                                              **kw)
            assert c.thread_cores == jc.thread_cores
            assert c.root_data_nodes == jc.root_data_nodes
            assert c.runtime_data_node == jc.runtime_data_node
            assert (c.label(), c.master_node) == (jc.label(), jc.master_node)


FAULTS = ["straggler:0.5", "straggler:0.5@2,3", "preempt:2", "preempt:3@5",
          "fail:1", "fail:2@30", ("straggler:0.3", "preempt:1@4")]


@pytest.mark.parametrize("spec", FAULTS, ids=str)
def test_fault_plan_equals_jax(spec):
    topo, jtopo = _topos("sunfire")
    cores = tuple(context.BINDINGS["paper"].lower(topo, 8))
    specs, jspecs = faults.get_faults(spec), jfaults.get_faults(spec)
    assert [dataclasses.astuple(s) for s in specs] == \
        [dataclasses.astuple(s) for s in jspecs]
    for seed in range(4):
        p = faults.compile_fault_plan(specs, topo, cores, seed)
        jp = jfaults.compile_fault_plan(jspecs, jtopo, cores, seed)
        for field in ("speed", "win_off", "win_start", "win_end"):
            assert np.array_equal(getattr(p, field), getattr(jp, field))
        assert (p.n_windows, p.is_neutral) == (jp.n_windows, jp.is_neutral)


@pytest.mark.parametrize("name", ["fft", "sort", "strassen", "sparselu"])
def test_serial_time_equals_jax(name):
    fn, kw = BUILDERS[name]
    wl, jwl = getattr(bots, fn)(**kw), getattr(jbots, fn)(**kw)
    for topo_name in TOPOS:
        topo, jtopo = _topos(topo_name)
        m = Machine(topo, device="cpu")
        jm = JMachine(jtopo)
        for core, placement in ((0, "spill:2@0"), (3, "first_touch"),
                                (5, "interleave")):
            got = m.serial_time(wl, core=core, placement=placement)
            assert got == jm.serial_time(jwl, core=core,
                                         placement=placement)
            assert got > 0


# ----------------------------------------------------------------------
# a figure grid and its aggregates
# ----------------------------------------------------------------------

_METRICS = ("makespan", "serial_time", "speedup", "tasks", "steals",
            "failed_probes", "remote_work_fraction", "queue_wait",
            "reclaimed", "reexec", "fault_lost", "steal_hops", "node_tasks",
            "node_remote")


def _grid(machine, wl):
    base = dict(binding="linear", placement="spill:2@0", runtime_data=0,
                migration_rate=0.15)
    numa = dict(binding="paper", placement="spill:2")
    return machine.grid(workloads={"fft": wl},
                        schedulers=("bf", "wf", "dfwsrpt"), threads=(4, 8),
                        contexts={"base": base, "numa": numa}, seeds=3,
                        faults=[None, "straggler:0.5"],
                        serial_reference={"fft": 1000.0})


def test_grid_and_aggregate_equal_jax():
    topo, jtopo = _topos("sunfire")
    wl, jwl = bots.fft(n=1 << 9, cutoff=8), jbots.fft(n=1 << 9, cutoff=8)
    got = _grid(Machine(topo, device="cpu"), wl).run()
    want = _grid(JMachine(jtopo), jwl).run()
    assert [tuple(k) for k in got] == [tuple(k) for k in want]
    assert len(got) == 72
    for (k, r), w in zip(got.items(), want.values()):
        assert r.engine == "plain"
        for m in _METRICS:
            assert getattr(r, m) == getattr(w, m), (k, m)
    stats = _grid(Machine(topo, device="cpu"), wl).run_stats()
    jstats = _grid(JMachine(jtopo), jwl).run_stats()
    assert [tuple(k) for k in stats] == [tuple(k) for k in jstats]
    for s, js in zip(stats.values(), jstats.values()):
        assert s.n == js.n == 3
        for f in ("makespan", "speedup", "steals", "failed_probes",
                  "remote_work_fraction", "queue_wait", "reclaimed",
                  "reexec", "fault_lost"):
            a, b = getattr(s, f), getattr(js, f)
            assert dataclasses.astuple(a) == dataclasses.astuple(b), f
            assert math.isfinite(a.mean)


def test_grid_rejects_what_the_port_lacks(tmp_path):
    """Nothing is left that the port lacks: the durable journal, per-cell
    timeouts and event traces, which raised before they were ported, now
    run on the host and agree with the plain run."""
    topo, _ = _topos("sunfire")
    m = Machine(topo, device="cpu")
    wl = bots.fft(n=1 << 8, cutoff=8)
    grid = m.grid(workloads=[wl], schedulers="wf", threads=4)
    (want,) = run_sweep(grid.plan, device="cpu")
    journal = str(tmp_path / "journal.jsonl")
    assert run_sweep(grid.plan, store=journal, device="cpu") == [want]
    assert run_sweep(grid.plan, timeout=5.0, device="cpu") == [want]
    traced = Machine(topo, SimParams(trace=True), device="cpu")
    r = traced.run(wl, "wf", threads=4)
    assert r == want and r.trace.n_exec == r.tasks


# ----------------------------------------------------------------------
# device dispatch
# ----------------------------------------------------------------------

def _fake_card(monkeypatch, outs, calls, fail=None):
    """A CUDA device without a card: default_device passes "cuda" through,
    the kernel's wrapper returns ``outs`` (or raises ``fail``) and records
    its calls, and the plain version raises if anything reaches it."""
    def run_batch(ctxs, device, timeout=None):
        calls.append((len(ctxs), torch.device(device).type))
        if fail is not None:
            raise fail
        return [dict(o) for o in outs[:len(ctxs)]]

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA device")
    monkeypatch.setattr(repro_torch, "default_device",
                        lambda d=None: torch.device("cuda" if d is None
                                                    else d))
    monkeypatch.setattr(sim_kernel, "run_batch", run_batch)
    monkeypatch.setattr(_engine_py, "run", plain)
    monkeypatch.setattr(_engine_py, "run_batch", plain)
    # the JAX package's engine switches, which the port must not read
    monkeypatch.setenv("REPRO_SIM_ENGINE", "py")
    monkeypatch.setenv("REPRO_SIM_WORKERS", "4")


_engine_py_run = _engine_py.run      # before _fake_card blocks it


def _plain_outs(m, wl, n):
    grid = m.grid(workloads=[wl], schedulers=("wf", "bf"), threads=(2, 4),
                  seeds=n // 4)
    ctxs = [runtime._prepare_ctx(c.to_context(), wl,
                                 policy.get_spec(c.scheduler), c.seed)
            for c in grid.plan]
    return _engine_py.run_batch(ctxs)


def test_cuda_device_never_runs_the_plain_version(monkeypatch):
    topo, _ = _topos("sunfire")
    wl = bots.fft(n=1 << 8, cutoff=8)
    outs = _plain_outs(Machine(topo, device="cpu"), wl, 8)
    calls = []
    _fake_card(monkeypatch, outs, calls)
    m = Machine(topo)                          # the card by default
    assert m.device.type == "cuda"
    res = m.grid(workloads=[wl], schedulers=("wf", "bf"), threads=(2, 4),
                 seeds=2).run(strict=False, workers=8,
                              retry=RetryPolicy(retries=3, backoff=0.0))
    assert calls == [(8, "cuda")]              # one batch, on the card
    assert all(r.engine == "cuda" for r in res.values())
    r = m.run(wl, "wf", threads=2)
    assert calls[-1] == (1, "cuda") and r.engine == "cuda"


def test_kernel_failure_raises_and_never_falls_back(monkeypatch):
    topo, _ = _topos("sunfire")
    wl = bots.fft(n=1 << 8, cutoff=8)
    calls = []
    _fake_card(monkeypatch, [], calls, fail=RuntimeError("nvcc failed"))
    grid = Machine(topo).grid(workloads=[wl], schedulers="wf",
                              threads=(2, 4))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        grid.run(strict=False, retry=RetryPolicy(retries=2, backoff=0.0))
    assert calls == [(2, "cuda")]


def _kernel_outputs(ctxs, outs):
    """The kernel's output buffers for ``ctxs`` holding the result dicts
    ``outs``, laid out as ``kernels.sim.pack`` lays them out."""
    packed = sim_kernel.pack(ctxs)
    n = len(ctxs)
    dout, iout = np.zeros((n, 6)), np.zeros((n, 7), np.int64)
    aggi, aggd = packed["aggi"].copy(), packed["aggd"].copy()
    for i, o in enumerate(outs):
        dout[i] = [o[k] for k in ("makespan", "remote", "total_exec",
                                  "queue_wait", "fault_lost", "last_t")]
        iout[i] = [o[k] for k in ("steals", "failed", "reclaimed", "reexec",
                                  "executed", "steps", "status")]
        h0, nh, t0, r0, nn = packed["aggs"][i]
        aggi[h0:h0 + nh] = o["steal_hops"]
        aggi[t0:t0 + nn] = o["node_tasks"]
        aggd[r0:r0 + nn] = o["node_remote"]
    return packed, dout, iout, aggi, aggd


def test_card_overflow_fails_only_its_cell(monkeypatch):
    """A cell the kernel stops with an overflow code is that cell's
    failure: under strict=False a CellError in its slot while the other
    cells keep their results; under strict=True it raises naming it."""
    topo, _ = _topos("sunfire")
    wl = bots.fft(n=1 << 8, cutoff=8)
    want = Machine(topo, device="cpu").grid(
        workloads=[wl], schedulers=("wf", "bf"), threads=(2, 4)).run()
    calls = []
    _fake_card(monkeypatch, [], calls)

    def run_batch(ctxs, device, timeout=None):
        calls.append((len(ctxs), torch.device(device).type))
        outs = [_engine_py_run(ctx) for ctx in ctxs]
        packed, dout, iout, aggi, aggd = _kernel_outputs(ctxs, outs)
        rc = np.zeros(len(ctxs), np.int64)
        rc[1] = -3
        return sim_kernel.unpack(ctxs, packed, dout, iout, rc, aggi, aggd,
                                 packed["ibuf"][:packed["n_cores"]])
    monkeypatch.setattr(sim_kernel, "run_batch", run_batch)
    grid = Machine(topo).grid(workloads=[wl], schedulers=("wf", "bf"),
                              threads=(2, 4))
    res = grid.plan.run(strict=False)
    assert calls == [(4, "cuda")]
    assert isinstance(res[1], CellError) and res[1].engine == "cuda"
    assert "parked-set overflow" in str(res[1].error)
    for i in (0, 2, 3):
        got, ref = res[i], want[grid.keys[i]]
        assert got.engine == "cuda"
        assert dataclasses.replace(got, engine=ref.engine) == ref
    with pytest.raises(RuntimeError, match=r"cell 1 of 4 .*parked-set"):
        grid.run()


def test_retry_policy_has_no_degrade_ladder():
    names = {f.name for f in dataclasses.fields(RetryPolicy)}
    assert "degrade" not in names
    assert names == {"retries", "backoff", "max_backoff"}


def test_no_card_means_an_error_not_the_host():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    topo, _ = _topos("sunfire")
    with pytest.raises(RuntimeError, match="CUDA"):
        Machine(topo)
    m = Machine(topo, device="cpu")
    ctx = runtime._prepare_ctx(m.context(threads=2), bots.fft(n=64,
                                                              cutoff=8),
                               policy.get_spec("wf"), 0)
    with pytest.raises(Exception):
        sim_kernel.run_batch([ctx], "cuda")


def test_sim_source_alone_builds_without_fma_contraction():
    common = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
    assert _build._NVCC_FLAGS == common
    assert "sim" in _build.SOURCES
    for name in _build.SOURCES:
        cmd = _build.nvcc_command(name, "out.so")
        assert tuple(cmd[1:1 + len(common)]) == common, name
        assert ("--fmad=false" in cmd) == (name == "sim"), name
        assert cmd[-1].endswith(f"csrc/{name}.cu")
    assert _build._target("sim") != _build._target("rmsnorm")


PTXAS_SIM = """\
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__f40d40ef_6_sim_cu_2ad464c916sim_batch_kernelILb0ELb0EEEvlPKlPKdPlPhPdS5_S5_S7_S5_iNS_9TraceColsEl' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__f40d40ef_6_sim_cu_2ad464c916sim_batch_kernelILb0ELb0EEEvlPKlPKdPlPhPdS5_S5_S7_S5_iNS_9TraceColsEl
    80 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 234 registers, used 0 barriers, 80 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__f40d40ef_6_sim_cu_2ad464c916sim_batch_kernelILb1ELb0EEEvlPKlPKdPlPhPdS5_S5_S7_S5_iNS_9TraceColsEl' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__f40d40ef_6_sim_cu_2ad464c916sim_batch_kernelILb1ELb0EEEvlPKlPKdPlPhPdS5_S5_S7_S5_iNS_9TraceColsEl
    88 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 240 registers, used 0 barriers, 88 bytes cumulative stack size
"""


def test_build_reads_back_the_log_of_a_library_built_before(
        tmp_path, monkeypatch):
    """A library built by an earlier process keeps its compiler log beside
    it: build() in a new process fills build_logs from it without nvcc,
    and chip_smoke reads the registers and spills from it; a library
    without its log is built again."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "build_logs", {})

    def no_nvcc():
        raise RuntimeError("nvcc called")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    lib = _build._target("sim")
    lib.write_bytes(b"")
    with pytest.raises(RuntimeError, match="nvcc called"):
        _build.build(["sim"])
    lib.with_suffix(".log").write_text(PTXAS_SIM)
    _build.build(["sim"])
    assert _build.build_logs == {"sim": PTXAS_SIM}
    assert chip_smoke.sim_registers() == {
        "untraced/untimed": (234, 0, 0), "traced/untimed": (240, 8, 12)}


def test_sweep_plan_add_validates_cells():
    topo, _ = _topos("sunfire")
    plan = SweepPlan()
    wl = bots.fft(n=64, cutoff=8)
    with pytest.raises(ValueError, match="unknown scheduler"):
        plan.add(topo, [0, 1], wl, "nope")
    with pytest.raises(ValueError, match="outside topology"):
        plan.add(topo, [0, 99], wl, "wf")
    errors = []
    assert plan.add(topo, [0, 0], wl, "wf", errors=errors) is None
    assert "duplicate cores" in errors[0]
