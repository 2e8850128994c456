"""The port's simulator engines on the host, against the JAX package's:

* the plain version (``repro_torch.core.sim._engine_py``) reproduces every
  metric of ``tests/data/sim_golden.json`` (all 25 keys) exactly;
* on small trees, contexts and fault specs drawn by hypothesis
  (``derandomize=True``), the plain version equals the JAX package's
  ``py`` engine and its ``c`` engine (where a C compiler loads it) field
  for field — every metric, aggregate and final core binding — and so
  does the card's kernel ``kernels/csrc/sim.cu`` compiled as host C++
  (:func:`build_host`, where a C++ compiler is found), reached through
  the wrapper's own packing and unpacking;
* the kernel source's replicas of numpy's MT19937 and shuffle and of
  CPython's set, and its hot-state and workspace layouts, in that host
  build; its two placements of a cell's hot state (the shared-memory
  slice, stood in for by a garbage-filled host buffer, and the
  workspace) equal on drawn cells, cells of 64 and 256 threads equal to
  JAX's C engine, 2048-thread cells taking the workspace route by
  themselves, and ``pack`` refusing tables past int32 task ids.

About 40 s in one process."""

from __future__ import annotations

import json
import os
import random
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

torch = pytest.importorskip("torch")

from repro_torch.core import placement, topology  # noqa: E402
from repro_torch.core.sim import (SweepPlan, bots, context, policy,  # noqa: E402
                                  runtime, simulate)
from repro_torch.core.sim import _engine_py  # noqa: E402
from repro_torch.kernels import sim as sim_kernel  # noqa: E402
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                   "sim_golden.json")))
SCHEDS = ("bf", "cilk", "wf", "dfwspt", "dfwsrpt", "dfwshier")


def _golden_cells():
    """(key, topo, cores, workload, scheduler, seed, kwargs) of the 25
    fixture keys, as tests/test_sim_golden.py runs them."""
    topos = {"sunfire": topology.sunfire_x4600(),
             "tpu2x4": topology.tpu_pod_2d(2, 4)}
    wls = {"fft_small": bots.fft(n=1 << 10, cutoff=8),
           "sparselu_small": bots.sparselu(n=8)}
    cells = [(f"{tn}/{wn}/{s}", topo, list(range(8)), wl, s, 7, {})
             for tn, topo in topos.items() for wn, wl in wls.items()
             for s in SCHEDS]
    sf = topos["sunfire"]
    cells.append(("sunfire/fft_small/wf+baseline-numa", sf, list(range(16)),
                  wls["fft_small"], "wf", 3,
                  dict(root_data_nodes=placement.first_touch_spill(sf, 0, 2),
                       runtime_data_node=0, migration_rate=0.15)))
    return cells


def _assert_gold(r, key):
    assert set(GOLD[key]) == {"failed_probes", "makespan", "queue_wait",
                              "remote_work_fraction", "speedup", "steals",
                              "tasks"}
    for m, want in GOLD[key].items():
        assert getattr(r, m) == want, (key, m, getattr(r, m), want)


@pytest.mark.parametrize("key", sorted(GOLD))
def test_plain_version_matches_golden(key):
    (cell,) = [c for c in _golden_cells() if c[0] == key]
    _, topo, cores, wl, sched, seed, kw = cell
    r = simulate(topo, cores, wl, sched, seed=seed, device="cpu", **kw)
    assert r.engine == "plain"
    _assert_gold(r, key)


def test_plain_version_matches_golden_batched():
    cells = _golden_cells()
    plan = SweepPlan()
    for _, topo, cores, wl, sched, seed, kw in cells:
        plan.add(topo, cores, wl, sched, seed=seed, **kw)
    assert len(plan) == len(GOLD) == 25
    for r, cell in zip(plan.run(device="cpu"), cells):
        _assert_gold(r, cell[0])


# ----------------------------------------------------------------------
# drawn cells: the plain version, JAX's py and c engines, the kernel's
# host build
# ----------------------------------------------------------------------

_HOST = {}
# the kernel source built as host C++, and the wrapper's packing and
# unpacking around it (``kernels.sim.pack`` / ``unpack``)
build_host = sim_kernel.build_host
run_batch_host = sim_kernel.run_batch_host


def _host_lib(tmp_dir):
    """The kernel source built as host C++, once a process (None when no
    C++ compiler is found)."""
    if "lib" not in _HOST:
        try:
            _HOST["lib"] = build_host(tmp_dir)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _HOST["lib"] = None
    return _HOST["lib"]


def _tree(spec_cls, seed: int, depth: int):
    """A random task tree (fan-out, post waves, work and memory profile
    from ``seed``), built from ``spec_cls`` (either package's TaskSpec)."""
    rng = np.random.RandomState(seed)
    prof = [(0.8, 0.2), (0.45, 0.55), (0.05, 0.1)]

    def rec(d):
        fr, fp = prof[rng.randint(len(prof))]
        if d == 0 or rng.rand() < 0.15:
            return spec_cls(work_pre=float(rng.randint(5, 200)), f_root=fr,
                            f_parent=fp)
        kids = [rec(d - 1) for _ in range(rng.randint(1, 5))]
        post = [spec_cls(work_pre=float(rng.randint(2, 30)), f_root=fr,
                         f_parent=fp)
                for _ in range(rng.randint(0, 4) if rng.rand() < 0.5 else 0)]
        return spec_cls(work_pre=float(rng.randint(1, 20)),
                        work_post=float(rng.randint(0, 3)), f_root=fr,
                        f_parent=fp, children=kids, post_children=post)
    return rec(depth)


_TOPOS = {
    "sunfire": (topology.sunfire_x4600, jtopology.sunfire_x4600, ()),
    "tpu2x4": (topology.tpu_pod_2d, jtopology.tpu_pod_2d, (2, 4)),
    "uma4": (topology.uma, jtopology.uma, (4,)),
    "pods": (topology.multi_pod, jtopology.multi_pod, (2, 2, 2)),
}
_CONTEXTS = [
    dict(binding="paper", placement="first_touch"),
    dict(binding="paper", placement="spill:2"),
    dict(binding="linear", placement="spill:2@0", runtime_data=0,
         migration_rate=0.15),
    dict(binding="scatter", placement="interleave", runtime_data="master",
         migration_rate=0.3),
]
_FAULTS = [(), ("straggler:0.5",), ("preempt:2@5",), ("fail:1",),
           ("straggler:0.3", "preempt:1@4")]


def _prepared(pkg_ctx, pkg_rt, pkg_policy, topo, wl, sched, T, ctx_kw,
              faults, seed, spec_params):
    ectx = pkg_ctx.ExecContext.compile(topo, spec_params, T, **ctx_kw,
                                       faults=faults)
    return pkg_rt._prepare_ctx(ectx, wl, pkg_policy.get_spec(sched), seed)


def _check_drawn(tree_seed, depth, topo_name, sched, T, ctx_i, fault_i,
                 seed, tmp_dir):
    mk, jmk, args = _TOPOS[topo_name]
    topo, jtopo = mk(*args), jmk(*args)
    T = min(T, topo.num_cores)
    faults = _FAULTS[fault_i]
    if "fail:1" in faults and T < 2:
        T = 2
    ctx_kw = _CONTEXTS[ctx_i]
    if topo.num_nodes < 2:                  # nothing to spill over
        ctx_kw = dict(ctx_kw, placement="first_touch")
    wl = runtime.Workload("drawn", _tree(runtime.TaskSpec, tree_seed, depth),
                          0.7)
    jwl = jruntime.Workload("drawn", _tree(jruntime.TaskSpec, tree_seed,
                                           depth), 0.7)

    def port_ctx():
        return _prepared(context, runtime, policy, topo, wl, sched, T,
                         ctx_kw, faults, seed, runtime.SimParams())

    def jax_ctx():
        return _prepared(jcontext, jruntime, jpolicy, jtopo, jwl, sched, T,
                         ctx_kw, faults, seed, jruntime.SimParams())
    got_ctx = port_ctx()
    got = _engine_py.run(got_ctx)
    outs = {"jax py": (jengine.run, jax_ctx())}
    if jcsim.load() is not None:
        outs["jax c"] = (jcsim.run, jax_ctx())
    for name, (fn, ctx) in outs.items():
        want = fn(ctx)
        want.pop("trace", None)
        assert got == want, (name, got, want)
        assert got_ctx["cores"] == ctx["cores"], name
    lib = _host_lib(tmp_dir)
    if lib is not None:
        host_ctx = port_ctx()
        (host,) = run_batch_host([host_ctx], lib)
        assert host == got, ("kernel host build", host, got)
        assert host_ctx["cores"] == got_ctx["cores"]
    return got


_DRAW = dict(tree_seed=st.integers(0, 10_000), depth=st.integers(1, 5),
             topo_name=st.sampled_from(sorted(_TOPOS)),
             sched=st.sampled_from(SCHEDS), T=st.integers(1, 16),
             seed=st.integers(0, 2 ** 31 - 1))


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sim_host")


@settings(max_examples=40, deadline=None, derandomize=True)
@given(ctx_i=st.integers(0, len(_CONTEXTS) - 1), **_DRAW)
def _fault_free(tmp_dir, tree_seed, depth, topo_name, sched, T, ctx_i,
                seed):
    got = _check_drawn(tree_seed, depth, topo_name, sched, T, ctx_i, 0,
                       seed, tmp_dir)
    assert got["status"] == 0 and got["reexec"] == 0


@settings(max_examples=40, deadline=None, derandomize=True)
@given(ctx_i=st.integers(0, len(_CONTEXTS) - 1),
       fault_i=st.integers(1, len(_FAULTS) - 1), **_DRAW)
def _with_faults(tmp_dir, tree_seed, depth, topo_name, sched, T, ctx_i,
                 fault_i, seed):
    _check_drawn(tree_seed, depth, topo_name, sched, T, ctx_i, fault_i,
                 seed, tmp_dir)


def test_engines_agree_on_drawn_fault_free_cells(tmp_dir):
    _fault_free(tmp_dir)


def test_engines_agree_on_drawn_cells_with_faults(tmp_dir):
    _with_faults(tmp_dir)


def _placements_agree(tree_seed, depth, topo_name, sched, T, ctx_i,
                      fault_i, seed, tmp_dir):
    """One drawn cell through the kernel's host build with its hot state
    in the shared slice layout (a garbage-filled host buffer) and in its
    workspace: the same results and bindings, and the plain version's."""
    lib = _host_lib(tmp_dir)
    if lib is None:
        return
    want = _check_drawn(tree_seed, depth, topo_name, sched, T, ctx_i,
                        fault_i, seed, tmp_dir)
    mk, _, args = _TOPOS[topo_name]
    topo = mk(*args)
    T = min(T, topo.num_cores)
    faults = _FAULTS[fault_i]
    if "fail:1" in faults and T < 2:
        T = 2
    ctx_kw = _CONTEXTS[ctx_i]
    if topo.num_nodes < 2:
        ctx_kw = dict(ctx_kw, placement="first_touch")
    wl = runtime.Workload("drawn", _tree(runtime.TaskSpec, tree_seed, depth),
                          0.7)
    got, cores = [], []
    for limit in (None, 0):
        ctx = _prepared(context, runtime, policy, topo, wl, sched, T, ctx_kw,
                        faults, seed, runtime.SimParams())
        got += run_batch_host([ctx], lib, limit=limit)
        cores.append(list(ctx["cores"]))
    assert got[0] == got[1] == want
    assert cores[0] == cores[1]


@settings(max_examples=25, deadline=None, derandomize=True)
@given(ctx_i=st.integers(0, len(_CONTEXTS) - 1), **_DRAW)
def _placements_fault_free(tmp_dir, tree_seed, depth, topo_name, sched, T,
                           ctx_i, seed):
    _placements_agree(tree_seed, depth, topo_name, sched, T, ctx_i, 0, seed,
                      tmp_dir)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(ctx_i=st.integers(0, len(_CONTEXTS) - 1),
       fault_i=st.integers(1, len(_FAULTS) - 1), **_DRAW)
def _placements_with_faults(tmp_dir, tree_seed, depth, topo_name, sched, T,
                            ctx_i, fault_i, seed):
    _placements_agree(tree_seed, depth, topo_name, sched, T, ctx_i, fault_i,
                      seed, tmp_dir)


def test_kernel_placements_agree_on_drawn_fault_free_cells(tmp_dir):
    _lib_or_skip(tmp_dir)
    _placements_fault_free(tmp_dir)


def test_kernel_placements_agree_on_drawn_cells_with_faults(tmp_dir):
    _lib_or_skip(tmp_dir)
    _placements_with_faults(tmp_dir)


@pytest.mark.parametrize("T", [64, 256])
@pytest.mark.parametrize("sched,faults", [
    ("wf", ()), ("cilk", ("preempt:2@5",)), ("bf", ()),
    ("dfwsrpt", ("straggler:0.3", "fail:1")), ("dfwshier", ())])
def test_kernel_many_threads_match_jax_c_engine(tmp_dir, T, sched, faults):
    """Cells at 64 and 256 threads (sunfire with 32 cores a node, its 8
    nodes, the baseline context with migration) on a small table: the
    kernel's host build, its hot state in the shared layout and in the
    workspace, field for field against JAX's C engine (its py engine where
    no C compiler loads it) and the port's plain version."""
    lib = _lib_or_skip(tmp_dir)
    topo, jtopo = (topology.sunfire_x4600(32, 8),
                   jtopology.sunfire_x4600(32, 8))
    kw = dict(binding="linear", placement="spill:2@0", runtime_data=0,
              migration_rate=0.15)

    def ctx():
        return _prepared(context, runtime, policy, topo,
                         bots.fft(n=1 << 11, cutoff=8), sched, T, kw,
                         faults, 5, runtime.SimParams())
    jctx = _prepared(jcontext, jruntime, jpolicy, jtopo,
                     jbots.fft(n=1 << 11, cutoff=8), sched, T, kw, faults, 5,
                     jruntime.SimParams())
    engine = jcsim.run if jcsim.load() is not None else jengine.run
    want = engine(jctx)
    want.pop("trace", None)
    assert sim_kernel.hot_bytes(T, 8, len(want["steal_hops"])) \
        <= sim_kernel.HOST_SHARED_LIMIT
    for limit in (None, 0):
        c = ctx()
        (got,) = run_batch_host([c], lib, limit=limit)
        assert got == want, (limit, got, want)
        assert c["cores"] == jctx["cores"]
    assert _engine_py.run(ctx()) == want


def test_kernel_cells_past_shared_memory_take_the_workspace_route(tmp_dir):
    """2048 threads on sunfire with 256 cores a node: the cell's hot state
    (about 243 KB) passes the 227 KB a block may have on an H100, so the
    batch runs it on the workspace route, on its own, beside a 16-thread
    cell on the shared one; both equal the plain version."""
    lib = _lib_or_skip(tmp_dir)
    topo = topology.sunfire_x4600(256, 8)
    wl = bots.fft(n=1 << 9, cutoff=8)

    def ctxs():
        return [runtime._prepare_ctx(
            context.ExecContext.compile(topo, runtime.SimParams(), T,
                                        binding="linear"),
            wl, policy.get_spec(sched), 1)
            for T, sched in ((2048, "dfwshier"), (16, "wf"), (2048, "bf"))]
    assert sim_kernel.hot_bytes(2048, 8, 4) > sim_kernel.HOST_SHARED_LIMIT
    got, stats = sim_kernel._drive(ctxs(), sim_kernel._Host(lib, None), None)
    assert [g["route"] for g in stats["groups"]] == ["untraced",
                                                     "untraced_workspace"]
    assert [g["cells"] for g in stats["groups"]] == [1, 2]
    assert got == [_engine_py.run(c) for c in ctxs()]


def test_pack_refuses_tables_past_int32_ids():
    """A table of 2^31 tasks or more cannot be packed (task ids are
    int32): pack raises naming the cell's table before it touches an
    array (a stub table stands in for a huge one)."""
    topo = topology.sunfire_x4600()
    ectx = context.ExecContext.compile(topo, runtime.SimParams(), 4)
    ctx = runtime._prepare_ctx(ectx, bots.fft(n=64, cutoff=8),
                               policy.get_spec("wf"), 1)

    class Huge:
        n = 2 ** 31
    for n in (2 ** 31, 2 ** 40):
        Huge.n = n
        with pytest.raises(ValueError, match=r"task table of cell 1 .* "
                                             r"fewer than 2\^31"):
            sim_kernel.pack([ctx, dict(ctx, table=Huge())])
    assert sim_kernel.pack([ctx])["desc"].shape == (1, len(sim_kernel.DESC))


def test_engines_agree_on_a_stall(tmp_dir):
    """A watchdog budget too small for the run: status 1 and its last
    event time, equal across the engines, become SimStalled."""
    topo = topology.sunfire_x4600()
    wl = bots.fft(n=1 << 9, cutoff=8)
    params = runtime.SimParams(max_steps=50)
    ectx = context.ExecContext.compile(topo, params, 4)
    ctx = runtime._prepare_ctx(ectx, wl, policy.get_spec("wf"), 1)
    out = _engine_py.run(ctx)
    assert out["status"] == 1 and out["steps"] == 51
    jectx = jcontext.ExecContext.compile(jtopology.sunfire_x4600(),
                                         jruntime.SimParams(max_steps=50), 4)
    jctx = jruntime._prepare_ctx(jectx, jbots.fft(n=1 << 9, cutoff=8),
                                 jpolicy.get_spec("wf"), 1)
    assert out == jengine.run(jctx)
    lib = _host_lib(tmp_dir)
    if lib is not None:
        ctx = runtime._prepare_ctx(ectx, wl, policy.get_spec("wf"), 1)
        assert run_batch_host([ctx], lib) == [out]
    with pytest.raises(runtime.SimStalled, match="watchdog"):
        runtime._finish_result(ctx, out, 1.0, "plain")


# ----------------------------------------------------------------------
# the kernel source as host C++
# ----------------------------------------------------------------------

def _lib_or_skip(tmp_dir):
    lib = _host_lib(tmp_dir)
    if lib is None:
        pytest.skip("no C++ compiler to build the kernel source for the host")
    return lib


def test_kernel_host_build_matches_golden(tmp_dir):
    lib = _lib_or_skip(tmp_dir)
    cells = _golden_cells()
    ctxs, serials = [], []
    for _, topo, cores, wl, sched, seed, kw in cells:
        ectx = context.ExecContext.from_raw(
            topo, runtime.SimParams(), cores, kw.get("root_data_nodes"),
            kw.get("runtime_data_node"), kw.get("migration_rate", 0.0))
        ctxs.append(runtime._prepare_ctx(ectx, wl, policy.get_spec(sched),
                                         seed))
        serials.append(runtime.serial_time(topo, wl, cores[0],
                                           ctxs[-1]["root_data_nodes"]))
    outs = run_batch_host(ctxs, lib)
    for cell, ctx, out, serial in zip(cells, ctxs, outs, serials):
        _assert_gold(runtime._finish_result(ctx, out, serial, "cuda"),
                     cell[0])


def test_kernel_workspace_layout_matches_wrapper(tmp_dir):
    """The hot-state and workspace layouts the kernel carves equal the
    wrapper's sizes, for both placements, over thread counts up to 256
    (and one past CPython's 50 000-key resize rule), node counts and hop
    bins; the task records are the sizes the wrapper packs."""
    lib = _lib_or_skip(tmp_dir)
    assert lib.sim_task_record_bytes() == sim_kernel.TASK_RECORD.itemsize \
        == 64
    assert lib.sim_task_state_bytes() == sim_kernel.TASK_STATE_BYTES == 16
    for T in (1, 2, 3, 8, 16, 64, 256, 300, 60_000):
        for nodes, bins in ((1, 1), (8, 4), (64, 7)):
            hot = sim_kernel.hot_bytes(T, nodes, bins)
            assert lib.sim_hot_bytes(T, nodes, bins) == hot, (T, nodes, bins)
            assert hot % 16 == 0
            for n in (1, 511, 45_055, 1_000_000):
                for in_ws in (False, True):
                    got = lib.sim_workspace_bytes(n, T, nodes, bins,
                                                  int(in_ws))
                    want = sim_kernel.workspace_bytes(n, T, nodes, bins,
                                                      in_ws)
                    assert got == want, (n, T, nodes, bins, in_ws)
                    assert want % 16 == 0
                    assert want == 16 * n + (hot if in_ws else 0)
    # the paper's 16 threads on sunfire (8 nodes, 4 hop bins): ~5 KB
    assert sim_kernel.hot_bytes(16, 8, 4) < 5 * 1024


def test_kernel_mt19937_matches_numpy(tmp_dir):
    lib = _lib_or_skip(tmp_dir)
    for seed in (0, 7, 12345, 2 ** 32 - 1):
        out = np.zeros(3000, dtype=np.uint32)
        lib.sim_mt_selftest_host(seed, 3000, out.ctypes.data)
        want = np.random.RandomState(seed).randint(0, 2 ** 32, size=3000,
                                                   dtype=np.uint32)
        assert np.array_equal(out, want)


def test_kernel_shuffle_matches_numpy(tmp_dir):
    lib = _lib_or_skip(tmp_dir)
    for n in (2, 5, 15, 33):
        reps = 300
        rows = np.zeros((reps, n), dtype=np.int64)
        lib.sim_shuffle_selftest_host(3, n, reps, rows.ctypes.data)
        rng = np.random.RandomState(3)
        for r in range(reps):
            g = list(range(n))
            rng.shuffle(g)
            assert list(rows[r]) == g


def test_kernel_set_replica_matches_cpython(tmp_dir):
    lib = _lib_or_skip(tmp_dir)
    rnd = random.Random(123)
    for _ in range(150):
        T = rnd.choice([2, 3, 8, 16, 64, 300])
        ops, ref, s = [], [], set()
        for _ in range(rnd.randrange(5, 300)):
            if s and rnd.random() < 0.45:
                ops.append(-1)
                ref.append(s.pop())
            else:
                v = rnd.randrange(T)
                ops.append(v)
                s.add(v)
        arr = np.array(ops, dtype=np.int64)
        out = np.zeros(max(len(ops), 1), dtype=np.int64)
        ws = np.zeros(lib.sim_set_workspace_bytes(T), np.uint8)
        npop = lib.sim_set_selftest_host(len(ops), arr.ctypes.data, T,
                                         out.ctypes.data, ws.ctypes.data)
        assert npop == len(ref) and list(out[:npop]) == ref


def test_pack_shares_tables_and_splits_waves():
    topo = topology.sunfire_x4600()
    wls = [bots.fft(n=1 << 8, cutoff=8), bots.sparselu(n=5)]
    ctxs = []
    for i in range(6):
        ectx = context.ExecContext.compile(topo, runtime.SimParams(),
                                           2 + i % 3, faults=(
                                               "preempt:1",) if i else ())
        ctxs.append(runtime._prepare_ctx(ectx, wls[i % 2],
                                         policy.get_spec(SCHEDS[i]), i))
    packed = sim_kernel.pack(ctxs)
    d = {name: i for i, name in enumerate(sim_kernel.DESC)}
    desc = packed["desc"]
    # two tables, each uploaded once; cells in launch order longest
    # first (the fft table has the more tasks)
    assert len(set(desc[:, d["tab"]])) == 2
    assert len(packed["tab"]) == sum(w.root.count() for w in wls) + 1
    assert list(desc[:3, d["out"]] % 2) == [0, 0, 0]
    assert sorted(desc[:, d["out"]]) == list(range(6))
    assert packed["waves"] == [(0, 6)]
    sizes = [sim_kernel.workspace_bytes(c["table"].n, c["T"])
             for c in ctxs]
    assert packed["wave_hot"] == [max(sim_kernel.hot_bytes(
        c["T"], c["num_nodes"], c["max_hop"] + 1) for c in ctxs)]
    cap = max(sizes) + 8
    waved = sim_kernel.pack(ctxs, max_wave_bytes=cap)
    assert len(waved["waves"]) > 1
    assert all(b <= cap for b in waved["wave_bytes"])
    for a, b in waved["waves"]:
        assert waved["desc"][a, d["ws"]] == 0


def test_unpack_raises_naming_the_cell():
    """An overflow code puts a RuntimeError naming the cell in its slot
    (``run_context`` raises it, ``run_sweep`` maps it to a CellError);
    the other cells keep their results."""
    topo = topology.sunfire_x4600()
    ectx = context.ExecContext.compile(topo, runtime.SimParams(), 4)
    ctxs = [runtime._prepare_ctx(ectx, bots.fft(n=64, cutoff=8),
                                 policy.get_spec(s), seed)
            for s, seed in (("wf", 1), ("dfwsrpt", 9))]
    packed = sim_kernel.pack(ctxs)
    z = np.zeros
    good, bad = sim_kernel.unpack(
        ctxs, packed, z((2, 6)), z((2, 7), np.int64), np.array([0, -2]),
        packed["aggi"], packed["aggd"], packed["ibuf"])
    assert isinstance(good, dict) and good["status"] == 0
    assert isinstance(bad, RuntimeError)
    with pytest.raises(RuntimeError, match=r"cell 1 of 2 \(dfwsrpt, T=4, "
                                           r"seed=9.*event heap overflow"):
        raise bad
