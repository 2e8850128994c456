"""The port's event traces (``repro_torch.core.sim.trace``) against the JAX
package's:

* the port's ``TraceBuffer``: its capacity plan equals JAX's, it grows,
  columnizes flat rows, and round-trips through pickle and ``.npz``; a
  sidecar either package writes loads through the other's ``load_npz``,
  equal column for column;
* on drawn cells (``derandomize=True``: both contexts of the paper's
  figures, every scheduler, migration, straggler and preempt faults) the
  port's plain version and ``csrc/sim.cu``'s traced instantiation built
  as host C++ (``kernels.sim.build_host``) record the JAX package's py
  and C engines' traces event for event, and the traced metrics equal
  the untraced ones bit for bit;
* every trace agrees with its aggregates (``steal_hops`` is the
  histogram of ``st_dist``, ``node_tasks`` the bincount of ``ex_node``),
  and forced waves give the same traces;
* one paper-scale FFT cell (1 769 471 tasks), the host-built traced
  kernel against the JAX C engine traced (~10 s, mostly the two table
  builds).
"""

from __future__ import annotations

import pickle
import subprocess

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

from repro.core import topology as jtopology
from repro.core.sim import _csim as jcsim
from repro.core.sim import _engine_py as jengine
from repro.core.sim import bots as jbots
from repro.core.sim import context as jcontext
from repro.core.sim import policy as jpolicy
from repro.core.sim import runtime as jruntime
from repro.core.sim import trace as jtrace

torch = pytest.importorskip("torch")

from repro_torch.core import topology  # noqa: E402
from repro_torch.core.sim import (Machine, SimParams, bots,  # noqa: E402
                                  context, policy, runtime, trace)
from repro_torch.core.sim import _engine_py  # noqa: E402
from repro_torch.kernels import sim as sim_kernel  # noqa: E402
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401
from test_torch_sim_engine import (_CONTEXTS, _FAULTS, _TOPOS,  # noqa: E402
                                   SCHEDS, _tree)

COLS = [name for name, _ in trace.ALL_COLS]
_HOST: dict = {}


def _host_lib(tmp_dir):
    if "lib" not in _HOST:
        try:
            _HOST["lib"] = sim_kernel.build_host(tmp_dir)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _HOST["lib"] = None
    return _HOST["lib"]


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sim_trace_host")


def _same_events(got, want, what=""):
    """Column for column, across the two packages' TraceBuffers."""
    for name in COLS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, name)


def _agrees(out, tr):
    """The aggregates a result dict carries, recomputed from its trace."""
    hops = np.bincount(tr.st_dist, minlength=len(out["steal_hops"]))
    assert list(hops) == list(out["steal_hops"])
    nodes = np.bincount(tr.ex_node, minlength=len(out["node_tasks"]))
    assert list(nodes) == list(out["node_tasks"])
    assert tr.n_exec == out["executed"] and tr.n_steal == out["steals"]


# ----------------------------------------------------------------------
# the buffer
# ----------------------------------------------------------------------

def test_schema_and_capacity_plan_equal_jax():
    assert [(n, np.dtype(d)) for n, d in trace.ALL_COLS] == \
        [(n, np.dtype(d)) for n, d in jtrace.ALL_COLS]
    assert trace.EVENT_BYTES == (56, 40, 32)
    for n in (0, 1, 63, 64, 511, 45_055, 1_769_471):
        assert trace.plan_capacity(n) == jtrace.plan_capacity(n)


def _filled(n_exec=300, n_steal=90, n_mig=70, seed=0):
    rng = np.random.RandomState(seed)
    tb = trace.TraceBuffer(n_tasks=16, meta={"scheduler": "wf", "seed": 3})
    for i in range(n_exec):
        s = float(rng.rand() * 100)
        tb.add_exec(i, i % 7, i % 16, i % 8, i % 5, s, s + 1.5)
    for i in range(n_steal):
        tb.add_steal(float(i) / 3, i % 7, (i + 1) % 7, 2 * i, i % 4)
    for i in range(n_mig):
        tb.add_mig(float(i) * 1.25, i % 7, i % 16, (i + 3) % 16)
    return tb


def test_buffer_grows_and_trims():
    tb = _filled()
    assert len(tb.ex_task) >= 300 > 16           # grew past its plan
    tb.finalize()
    assert (tb.n_exec, tb.n_steal, tb.n_mig) == (300, 90, 70)
    assert all(len(getattr(tb, n)) == c for n, c in (
        ("ex_end", 300), ("st_dist", 90), ("mg_to", 70)))
    assert tb.nbytes() == 56 * 300 + 40 * 90 + 32 * 70
    assert repr(tb) == "TraceBuffer(exec=300, steals=90, migrations=70)"


def test_from_flat_columnizes_rows():
    tb = trace.TraceBuffer.from_flat(
        [3, 1, 2, 0, 4, 0.5, 1.25, 7, 0, 1, 1, 0, 1.25, 2.0],
        [1.0, 2, 3, 7, 1], [], meta={"x": 1})
    assert list(tb.ex_task) == [3, 7] and tb.ex_task.dtype == np.int64
    assert list(tb.ex_end) == [1.25, 2.0]
    assert list(tb.st_victim) == [3] and tb.st_time.dtype == np.float64
    assert tb.n_mig == 0 and tb.mg_from.dtype == np.int64
    assert tb.meta == {"x": 1}


def test_pickle_and_npz_round_trips(tmp_path):
    tb = _filled()
    back = pickle.loads(pickle.dumps(tb))
    assert back == tb and back.meta == tb.meta
    tb.save_npz(tmp_path / "t.npz")
    got = trace.TraceBuffer.load_npz(tmp_path / "t.npz")
    assert got == tb and got.meta == tb.meta


def test_sidecars_cross_between_the_packages(tmp_path):
    """A port-written .npz loads through JAX's load_npz, column for
    column, and a JAX-written one through the port's."""
    tb = _filled(seed=4)
    tb.save_npz(tmp_path / "port.npz")
    j = jtrace.TraceBuffer.load_npz(tmp_path / "port.npz")
    _same_events(j, tb)
    assert j.meta == tb.meta
    jt = jtrace.TraceBuffer.from_arrays(
        {n: getattr(tb, n) for n in COLS}, meta={"engine": "c"})
    jt.save_npz(tmp_path / "jax.npz")
    got = trace.TraceBuffer.load_npz(tmp_path / "jax.npz")
    _same_events(got, tb)
    assert got.meta == {"engine": "c"}


# ----------------------------------------------------------------------
# drawn cells: the plain version, the kernel's host build, JAX's engines
# ----------------------------------------------------------------------

def _prepared(pkg_ctx, pkg_rt, pkg_policy, topo, wl, sched, T, ctx_kw,
              faults, seed, traced):
    params = pkg_rt.SimParams(trace=traced)
    ectx = pkg_ctx.ExecContext.compile(topo, params, T, **ctx_kw,
                                       faults=faults)
    return pkg_rt._prepare_ctx(ectx, wl, pkg_policy.get_spec(sched), seed)


def _check_traced(tree_seed, depth, topo_name, sched, T, ctx_i, fault_i,
                  seed, tmp_dir):
    mk, jmk, args = _TOPOS[topo_name]
    topo, jtopo = mk(*args), jmk(*args)
    T = min(T, topo.num_cores)
    faults = _FAULTS[fault_i]
    if "fail:1" in faults and T < 2:
        T = 2
    ctx_kw = _CONTEXTS[ctx_i]
    if topo.num_nodes < 2:
        ctx_kw = dict(ctx_kw, placement="first_touch")
    wl = runtime.Workload("drawn", _tree(runtime.TaskSpec, tree_seed, depth),
                          0.7)
    jwl = jruntime.Workload("drawn", _tree(jruntime.TaskSpec, tree_seed,
                                           depth), 0.7)

    def port(traced):
        return _prepared(context, runtime, policy, topo, wl, sched, T,
                         ctx_kw, faults, seed, traced)

    def jax():
        return _prepared(jcontext, jruntime, jpolicy, jtopo, jwl, sched, T,
                         ctx_kw, faults, seed, True)
    plain_ctx = port(True)
    got = _engine_py.run(plain_ctx)
    tr = got.pop("trace")
    untraced = _engine_py.run(port(False))
    assert "trace" not in untraced and got == untraced
    _agrees(got, tr)
    engines = {"jax py": jengine.run}
    if jcsim.load() is not None:
        engines["jax c"] = jcsim.run
    for name, fn in engines.items():
        jctx = jax()
        want = fn(jctx)
        _same_events(tr, want.pop("trace"), name)
        assert got == want, name
        assert plain_ctx["cores"] == jctx["cores"], name
    lib = _host_lib(tmp_dir)
    if lib is not None:
        host, host_untraced = sim_kernel.run_batch_host(
            [port(True), port(False)], lib)
        _same_events(host.pop("trace"), tr, "kernel host build")
        assert host == got == host_untraced
    return got


_DRAW = dict(tree_seed=st.integers(0, 10_000), depth=st.integers(1, 5),
             topo_name=st.sampled_from(sorted(_TOPOS)),
             sched=st.sampled_from(SCHEDS), T=st.integers(1, 16),
             ctx_i=st.integers(0, len(_CONTEXTS) - 1),
             seed=st.integers(0, 2 ** 31 - 1))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(**_DRAW)
def _traced_fault_free(tmp_dir, tree_seed, depth, topo_name, sched, T,
                       ctx_i, seed):
    _check_traced(tree_seed, depth, topo_name, sched, T, ctx_i, 0, seed,
                  tmp_dir)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(fault_i=st.integers(1, len(_FAULTS) - 1), **_DRAW)
def _traced_with_faults(tmp_dir, tree_seed, depth, topo_name, sched, T,
                        ctx_i, fault_i, seed):
    _check_traced(tree_seed, depth, topo_name, sched, T, ctx_i, fault_i,
                  seed, tmp_dir)


def test_traces_agree_on_drawn_fault_free_cells(tmp_dir):
    _traced_fault_free(tmp_dir)


def test_traces_agree_on_drawn_cells_with_faults(tmp_dir):
    _traced_with_faults(tmp_dir)


@pytest.mark.parametrize("ctx_name", ["base", "numa"])
@pytest.mark.parametrize("sched", SCHEDS)
def test_figure_contexts_trace_every_scheduler(tmp_dir, ctx_name, sched):
    """The paper figures' two contexts (baseline Nanos with migration,
    the NUMA model) under every scheduler, with a straggler and a preempt
    fault: the three traced runs agree with JAX's py engine."""
    kw = {"base": dict(binding="linear", placement="spill:2@0",
                       runtime_data=0, migration_rate=0.15),
          "numa": dict(binding="paper", placement="spill:2")}[ctx_name]
    faults = ("straggler:0.5", "preempt:2@5")
    topo, jtopo = topology.sunfire_x4600(), jtopology.sunfire_x4600()
    wl, jwl = bots.fft(n=1 << 10, cutoff=8), jbots.fft(n=1 << 10, cutoff=8)
    ctx = _prepared(context, runtime, policy, topo, wl, sched, 16, kw,
                    faults, 5, True)
    got = _engine_py.run(ctx)
    jctx = _prepared(jcontext, jruntime, jpolicy, jtopo, jwl, sched, 16, kw,
                     faults, 5, True)
    want = jengine.run(jctx)
    _same_events(got["trace"], want["trace"])
    if ctx_name == "base":
        assert got["trace"].n_mig > 0
    lib = _host_lib(tmp_dir)
    if lib is not None:
        (host,) = sim_kernel.run_batch_host(
            [_prepared(context, runtime, policy, topo, wl, sched, 16, kw,
                       faults, 5, True)], lib)
        _same_events(host["trace"], got["trace"])


def test_traced_results_equal_untraced_through_the_machine():
    topo = topology.sunfire_x4600()
    wl = bots.sparselu(n=8)
    plain = Machine(topo, device="cpu").grid(
        workloads=[wl], schedulers=("bf", "wf"), threads=(4, 16),
        seeds=2, faults=[None, "preempt:2"]).run()
    traced = Machine(topo, SimParams(trace=True), device="cpu").grid(
        workloads=[wl], schedulers=("bf", "wf"), threads=(4, 16),
        seeds=2, faults=[None, "preempt:2"]).run()
    assert traced == plain
    for k, r in traced.items():
        assert plain[k].trace is None
        tr = r.trace
        assert tr.n_exec == r.tasks and tr.n_steal == r.steals
        assert tuple(np.bincount(tr.st_dist, minlength=len(r.steal_hops))) \
            == r.steal_hops
        assert tuple(np.bincount(tr.ex_node, minlength=len(r.node_tasks))) \
            == r.node_tasks
        assert tr.meta == dict(scheduler=k.scheduler, seed=k.seed,
                               engine="plain", threads=k.threads,
                               num_nodes=8, num_cores=16, tasks=r.tasks,
                               makespan=r.makespan)


def test_forced_waves_give_the_same_traces(tmp_dir):
    lib = _host_lib(tmp_dir)
    if lib is None:
        pytest.skip("no C++ compiler to build the kernel source for the host")
    topo = topology.sunfire_x4600()
    wls = [bots.fft(n=1 << 9, cutoff=8), bots.sparselu(n=6)]

    def ctxs():
        out = []
        for i, sched in enumerate(SCHEDS):
            ectx = context.ExecContext.compile(
                topo, SimParams(trace=True), 4 + 4 * (i % 3),
                binding="linear", placement="spill:2@0", runtime_data=0,
                migration_rate=0.2, faults=("preempt:1",) if i % 2 else ())
            out.append(runtime._prepare_ctx(ectx, wls[i % 2],
                                            policy.get_spec(sched), i))
        return out
    one = sim_kernel.run_batch_host(ctxs(), lib)
    packed = sim_kernel.pack(ctxs(), max_wave_bytes=1, traced=True)
    assert len(packed["waves"]) == len(SCHEDS)
    waved = sim_kernel.run_batch_host(ctxs(), lib, max_wave_bytes=1)
    for a, b in zip(one, waved):
        ta, tb = a.pop("trace"), b.pop("trace")
        assert a == b and ta == tb and ta.n_exec > 0


def test_trace_caps_bound_every_family():
    """The columns a traced cell gets (kernels.sim.trace_caps) hold its
    events: exec n, steals n - 1 + W (none under a shared queue),
    migrations n + W (none at rate 0)."""
    topo = topology.sunfire_x4600()
    wl = bots.fft(n=1 << 9, cutoff=8)
    for sched in ("bf", "wf"):
        for mig, faults in ((0.0, ()), (0.3, ("preempt:2@5", "fail:1"))):
            ectx = context.ExecContext.compile(
                topo, SimParams(trace=True), 8, binding="linear",
                placement="spill:2@0", migration_rate=mig, faults=faults)
            ctx = runtime._prepare_ctx(ectx, wl, policy.get_spec(sched), 1)
            ex, stl, mg = sim_kernel.trace_caps(ctx)
            w = ctx["fault_plan"].n_windows if faults else 0
            assert ex == wl.table.n
            assert stl == (0 if sched == "bf" else wl.table.n - 1 + w)
            assert mg == (wl.table.n + w if mig else 0)
            tr = _engine_py.run(ctx)["trace"]
            assert tr.n_exec <= ex and tr.n_steal <= stl and tr.n_mig <= mg


def test_paper_scale_fft_cell_traced(tmp_dir):
    """One paper-scale FFT cell (wf, the NUMA context, 16 threads): the
    kernel's traced loop built for the host against the JAX package's C
    engine traced, event for event and metric for metric."""
    lib = _host_lib(tmp_dir)
    if lib is None or jcsim.load() is None:
        pytest.skip("needs a C and a C++ compiler")
    kw = dict(binding="paper", placement="spill:2")
    wl = bots.make("fft", "paper")
    assert wl.table.n == 1_769_471
    ctx = _prepared(context, runtime, policy, topology.sunfire_x4600(), wl,
                    "wf", 16, kw, (), 0, True)
    (got,) = sim_kernel.run_batch_host([ctx], lib)
    del ctx
    jwl = jbots.make("fft", "paper")
    jctx = _prepared(jcontext, jruntime, jpolicy, jtopology.sunfire_x4600(),
                     jwl, "wf", 16, kw, (), 0, True)
    want = jcsim.run(jctx)
    _same_events(got.pop("trace"), want.pop("trace"))
    assert got == want
    assert want["steals"] > 100_000
