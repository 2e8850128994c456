"""The port's durable sweeps (``repro_torch.core.sim.store`` and
``run_sweep(store=, timeout=)``), mirroring ``tests/test_durable_sweep.py``
where it applies, and held to the JAX package's store:

* ``cell_key`` and ``workload_fingerprint`` equal JAX's on the same cells,
  so a journal written by either package resumes in the other (both
  directions tested, traces' sidecars included);
* exact round trips, a torn tail, the header, first write wins; an
  interrupted resume gives the same bits and re-simulates only the
  missing cells; a warm store never runs the engine; ``Grid.run(resume=)``
  and ``Machine.run(store=)``; sidecars;
* timeouts: the plain version with a deadline small for one slow cell and
  large for the fast ones; the kernel's host build with a deadline under
  a nanosecond, where every cell comes back a ``CellTimeout``, and with
  ``timeout=0``, which is no deadline there as in ``resolve_timeout``
  (the plain version's too); a timeout retried under
  ``RetryPolicy``; ``resolve_timeout``'s precedence. The JAX package's
  fork pool and ``WorkerDied`` have no counterpart: the port's cells
  check their own deadline.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import warnings

import pytest

from repro.core import topology as jtopology
from repro.core.sim import Machine as JMachine
from repro.core.sim import ResultStore as JResultStore
from repro.core.sim import SimParams as JSimParams
from repro.core.sim import bots as jbots
from repro.core.sim import cell_key as jcell_key
from repro.core.sim import policy as jpolicy
from repro.core.sim import workload_fingerprint as jworkload_fingerprint

torch = pytest.importorskip("torch")

from repro_torch.core import topology  # noqa: E402
from repro_torch.core.sim import (CellError, CellTimeout, Machine,  # noqa: E402
                                  ResultStore, RetryPolicy, SimParams,
                                  SimResult, SweepPlan, bots, cell_key,
                                  policy, resolve_timeout, run_sweep,
                                  runtime, workload_fingerprint)
from repro_torch.core.sim import _engine_py  # noqa: E402
from repro_torch.kernels import sim as sim_kernel  # noqa: E402
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401

TOPO = topology.sunfire_x4600()
JTOPO = jtopology.sunfire_x4600()
_HOST: dict = {}


def _wl(pkg=bots):
    return pkg.fft(n=1 << 10, cutoff=8)


def _grid(machine, wl, seeds=3, **kw):
    return machine.grid(workloads=[wl], schedulers=("wf", "dfwsrpt"),
                        threads=(4, 16), seeds=seeds,
                        faults=[None, "straggler:1.0"], **kw)


def _cpu(params=None):
    return Machine(TOPO, params, device="cpu")


# ----------------------------------------------------------------------
# keys equal to the JAX package's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("faults", [(), ("preempt:2@5",),
                                    ("straggler:0.5", "fail:1")])
@pytest.mark.parametrize("variant", ["base", "numa", "params"])
def test_cell_key_equals_jax(variant, faults):
    kw = {"base": dict(binding="linear", placement="spill:2@0",
                       runtime_data=0, migration_rate=0.15),
          "numa": dict(binding="paper", placement="spill:2"),
          "params": dict(binding="scatter", placement="interleave")}[variant]
    params = dict(steal_time=2.5, max_steps=10 ** 7) \
        if variant == "params" else {}
    m, jm = Machine(TOPO, SimParams(**params), device="cpu"), \
        JMachine(JTOPO, JSimParams(**params))
    wl, jwl = bots.make("strassen", "medium"), \
        jbots.make("strassen", "medium")
    assert workload_fingerprint(wl) == jworkload_fingerprint(jwl)
    ectx = m.context(8, faults=faults, **kw)
    jectx = jm.context(8, faults=faults, **kw)
    assert ectx.fingerprint() == jectx.fingerprint()
    for sched in ("bf", "wf", "dfwshier"):
        for seed, serial in ((0, None), (7, 1234.5)):
            assert cell_key(ectx, wl, policy.get_spec(sched), seed, serial) \
                == jcell_key(jectx, jwl, jpolicy.get_spec(sched), seed,
                             serial)


def test_keys_discriminate_as_jax_does():
    m = _cpu()
    wl = _wl()
    ectx = m.context(16)
    spec = policy.get_spec("wf")
    k = cell_key(ectx, wl, spec, 0, 100.0)
    assert k == cell_key(ectx, wl, spec, 0, 100.0)
    assert k != cell_key(ectx, wl, spec, 1, 100.0)
    assert k != cell_key(ectx, wl, spec, 0, 101.0)
    assert k != cell_key(ectx, wl, policy.get_spec("bf"), 0, 100.0)
    assert k != cell_key(m.context(8), wl, spec, 0, 100.0)
    assert k != cell_key(m.context(16, faults="straggler:1.0"), wl, spec,
                         0, 100.0)
    assert k != cell_key(_cpu(SimParams(steal_time=9.0)).context(16), wl,
                         spec, 0, 100.0)
    # execution knobs that cannot change a result leave the key alone
    for p in (SimParams(workers=4), SimParams(trace=True)):
        assert k == cell_key(_cpu(p).context(16), wl, spec, 0, 100.0)
    renamed = _wl()
    renamed.name = "renamed"
    assert workload_fingerprint(renamed) == workload_fingerprint(wl)


# ----------------------------------------------------------------------
# the journal
# ----------------------------------------------------------------------

def test_store_roundtrip_exact(tmp_path):
    grid = _grid(_cpu(), _wl())
    base = grid.run()
    path = tmp_path / "j.jsonl"
    assert grid.run(store=str(path)) == base
    st = ResultStore(path)
    assert len(st) == len(base)
    replay = grid.run(store=st)
    assert st.hits == len(base)
    for k in base:
        assert replay[k] == base[k]
        assert replay[k].makespan == base[k].makespan
        assert replay[k].speedup == base[k].speedup
        assert replay[k].steal_hops == base[k].steal_hops
        assert replay[k].node_remote == base[k].node_remote
        assert replay[k].engine == "plain"
    st.close()


def test_store_tolerates_torn_tail(tmp_path):
    grid = _grid(_cpu(), _wl())
    base = grid.run()
    path = tmp_path / "j.jsonl"
    grid.run(store=str(path))
    path.write_bytes(path.read_bytes()[:-17])
    with pytest.warns(RuntimeWarning, match="torn final line"):
        st = ResultStore(path)
    assert len(st) == len(base) - 1
    assert grid.run(store=st) == base
    st.close()
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # repaired: loads clean
        st2 = ResultStore(path)
    assert len(st2) == len(base)
    st2.close()


def test_store_header_and_first_write_wins(tmp_path):
    path = tmp_path / "j.jsonl"
    st = ResultStore(path)
    r1 = SimResult(makespan=1.0, serial_time=2.0, speedup=2.0, tasks=3,
                   steals=0, failed_probes=0, remote_work_fraction=0.0,
                   queue_wait=0.0, engine="cuda")
    r2 = dataclasses.replace(r1, makespan=9.0)
    st.put("k1", r1)
    st.put("k1", r2)
    assert st.get("k1") == r1
    st.close()
    lines = path.read_text().splitlines()
    assert json.loads(lines[0]) == {"format": "repro-sim-store",
                                    "version": 1}
    assert len(lines) == 2


def test_interrupted_resume_bit_identical(tmp_path, monkeypatch):
    """A journal cut in half resumes to the uninterrupted run's bits and
    re-simulates only the missing cells."""
    grid = _grid(_cpu(), _wl())
    base = grid.run()
    path = tmp_path / "j.jsonl"
    grid.run(store=str(path))
    lines = path.read_text().splitlines(keepends=True)
    keep = len(lines) // 2
    path.write_text("".join(lines[:keep]))
    calls = []
    orig = runtime.run_cells

    def counting(ctxs, device, timeout=None):
        calls.append(len(ctxs))
        return orig(ctxs, device, timeout)
    monkeypatch.setattr(runtime, "run_cells", counting)
    import repro_torch.core.sim.sweep as sweep_mod
    monkeypatch.setattr(sweep_mod, "run_cells", counting)
    assert grid.run(resume=str(path)) == base
    assert sum(calls) == len(base) - (keep - 1)


def test_warm_store_never_runs_the_engine(tmp_path, monkeypatch):
    grid = _grid(_cpu(), _wl())
    path = tmp_path / "j.jsonl"
    base = grid.run(store=str(path))

    def boom(*a, **kw):
        raise AssertionError("an engine ran on a fully warm store")
    import repro_torch.core.sim.sweep as sweep_mod
    for mod, name in ((runtime, "run_cells"), (sweep_mod, "run_cells"),
                      (runtime, "_prepare_ctx"), (sweep_mod, "_prepare_ctx"),
                      (_engine_py, "run"), (_engine_py, "run_batch"),
                      (sim_kernel, "run_batch")):
        monkeypatch.setattr(mod, name, boom)
    assert grid.run(store=str(path)) == base


def test_grid_resume_and_machine_store(tmp_path):
    m = _cpu()
    wl = _wl()
    with pytest.raises(ValueError, match="either store= or resume="):
        _grid(m, wl).run(store=str(tmp_path / "a"), resume="b")
    g = _grid(m, wl, store=str(tmp_path / "grid.jsonl"))
    base = g.run()
    assert len(ResultStore(tmp_path / "grid.jsonl")) == len(base)
    merged = type(g).concat([_grid(m, wl, seeds=(5,)), g])
    assert merged.store == g.store
    st = ResultStore(tmp_path / "cells.jsonl")
    r1 = m.run(wl, "wf", seed=0, threads=16, store=st)
    assert r1 == m.run(wl, "wf", seed=0, threads=16) and len(st) == 1
    assert m.run(wl, "wf", seed=0, threads=16, store=st) == r1
    assert st.hits == 1
    st.close()


def test_sidecar_traces(tmp_path):
    """A traced grid's events go to <stem>.traces/<key>.npz, the journal
    keeps the result without them, and get_trace gives them back."""
    traced = Machine(TOPO, SimParams(trace=True), device="cpu")
    g = _grid(traced, _wl(), seeds=1, serial_reference=5000.0)
    path = tmp_path / "t.jsonl"
    with ResultStore(path) as st:
        got = g.run(store=st)
        keys = [cell_key(c.to_context(), c.workload,
                         policy.get_spec(c.scheduler), c.seed,
                         c.serial_reference)
                for c in g.plan.configs]
        for key, r in zip(keys, got.values()):
            assert r.trace is not None
            assert st.get(key).trace is None
            assert st.get_trace(key) == r.trace
        assert st.trace_path(keys[0]) == str(
            tmp_path / "t.traces" / f"{keys[0]}.npz")
    replay = g.run(resume=str(path))
    assert replay == got and all(r.trace is None for r in replay.values())


def test_journals_cross_between_the_packages(tmp_path):
    """A journal (and its sidecars) written by the port resumes in the
    JAX package without running a cell, and the reverse."""
    wl, jwl = _wl(), _wl(jbots)
    port_path, jax_path = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    m = Machine(TOPO, SimParams(trace=True), device="cpu")
    jm = JMachine(JTOPO, JSimParams(trace=True))
    base = _grid(m, wl, serial_reference=5000.0).run(store=str(port_path))
    jgrid = _grid(jm, jwl, serial_reference=5000.0)
    jst = JResultStore(port_path)
    jgot = jgrid.run(workers=1, store=jst)
    assert jst.hits == len(base) and len(jst) == len(base)
    for (k, r), (jk, jr) in zip(base.items(), jgot.items()):
        assert tuple(k) == tuple(jk)
        assert dataclasses.astuple(dataclasses.replace(
            r, engine="", trace=None)) == dataclasses.astuple(
            dataclasses.replace(jr, engine="", trace=None))
    for c in jgrid.plan.configs:
        key = jcell_key(c.to_context(), c.workload,
                        jpolicy.get_spec(c.scheduler), c.seed,
                        c.serial_reference)
        jtr = jst.get_trace(key)
        ptr = ResultStore(port_path).get_trace(key)
        for name in ("ex_task", "ex_start", "st_dist", "mg_to"):
            assert (getattr(jtr, name) == getattr(ptr, name)).all()
    jst.close()
    # the reverse: the JAX package journals, the port replays
    jwant = jgrid.run(workers=1, store=str(jax_path))
    st = ResultStore(jax_path)
    got = _grid(m, wl, serial_reference=5000.0).run(store=st)
    assert st.hits == len(jwant)
    assert all(r.engine == "c" or r.engine == "py" for r in got.values())
    assert got == base
    k0 = next(iter(st.keys()))
    assert st.get_trace(k0) is not None
    st.close()


# ----------------------------------------------------------------------
# timeouts
# ----------------------------------------------------------------------

def test_plain_version_times_out_the_slow_cell_only():
    """A deadline far longer than the fast cells and far shorter than the
    slow one: the slow cell is a CellTimeout, the others equal their
    untimed results."""
    m = _cpu()
    fast = m.grid(workloads=[bots.fft(n=1 << 8, cutoff=8)],
                  schedulers=("wf", "bf"), threads=4, seeds=2)
    slow = m.grid(workloads=[bots.fft(n=1 << 14, cutoff=2)],
                  schedulers="wf", threads=16)
    plan = SweepPlan(fast.plan.configs[:2] + slow.plan.configs
                     + fast.plan.configs[2:])
    base = run_sweep(fast.plan, device="cpu")
    got = run_sweep(plan, strict=False, timeout=0.05, device="cpu")
    err = got[2]
    assert isinstance(err, CellError) and isinstance(err.error, CellTimeout)
    assert err.engine == "plain" and err.error.timeout == 0.05
    assert got[:2] + got[3:] == base
    with pytest.raises(CellTimeout, match="0.05s wall-clock"):
        run_sweep(plan, timeout=0.05, device="cpu")


def test_kernel_host_build_deadline_zero_times_out_every_cell(tmp_path):
    if "lib" not in _HOST:
        try:
            _HOST["lib"] = sim_kernel.build_host(tmp_path)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            pytest.skip("no C++ compiler to build the kernel source")
    lib = _HOST["lib"]
    m = _cpu()
    wl = _wl()
    ctxs = [runtime._prepare_ctx(m.context(4), wl, policy.get_spec(s), i)
            for i, s in enumerate(("bf", "wf", "dfwspt"))]
    traced = [runtime._prepare_ctx(
        Machine(TOPO, SimParams(trace=True), device="cpu").context(4), wl,
        policy.get_spec("wf"), 0)]
    # under 1 ns: a 0 ns deadline, passed at every cell's first check
    outs = sim_kernel.run_batch_host(ctxs + traced, lib, timeout=1e-12)
    assert all(isinstance(o, CellTimeout) and o.engine == "cuda"
               for o in outs)

    def fresh():
        return [runtime._prepare_ctx(m.context(4), wl, policy.get_spec(s), i)
                for i, s in enumerate(("bf", "wf", "dfwspt"))]
    plain = [_engine_py.run(c) for c in fresh()]
    for timeout in (60.0, 0.0, -1.0):   # 0 and below: no deadline
        assert sim_kernel.run_batch_host(fresh(), lib,
                                         timeout=timeout) == plain
        assert _engine_py.run_batch(fresh(), timeout=timeout) == plain


def test_timeout_is_transient_under_retry(monkeypatch):
    m = _cpu()
    grid = m.grid(workloads=[_wl()], schedulers=("wf", "bf"), threads=4)
    base = grid.run()
    calls = []
    orig = _engine_py.run_batch

    def flaky(ctxs, timeout=None):
        calls.append(len(ctxs))
        out = orig(ctxs, timeout)
        if len(calls) == 1:
            out[0] = CellTimeout(timeout, "plain")
        return out
    monkeypatch.setattr(_engine_py, "run_batch", flaky)
    got = grid.run(timeout=30.0, retry=RetryPolicy(retries=1, backoff=0.0))
    assert got == base and calls == [2, 1]
    calls.clear()
    res = grid.plan.run(strict=False, timeout=30.0, device="cpu")
    assert isinstance(res[0], CellError)
    assert isinstance(res[0].error, CellTimeout) and res[1] == base[
        grid.keys[1]]


def test_timeout_env_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_SIM_TIMEOUT", raising=False)
    assert resolve_timeout() is None
    assert resolve_timeout(5) == 5.0
    assert resolve_timeout(0) is None
    assert resolve_timeout(-1) is None
    monkeypatch.setenv("REPRO_SIM_TIMEOUT", "2.5")
    assert resolve_timeout() == 2.5
    assert resolve_timeout(9) == 9.0
    monkeypatch.setenv("REPRO_SIM_TIMEOUT", "0")
    assert resolve_timeout() is None
    monkeypatch.setenv("REPRO_SIM_TIMEOUT", "nope")
    with pytest.raises(ValueError, match="REPRO_SIM_TIMEOUT"):
        resolve_timeout()


def test_timed_out_cell_is_never_journaled(tmp_path):
    m = _cpu()
    slow = m.grid(workloads=[bots.fft(n=1 << 14, cutoff=2)],
                  schedulers="wf", threads=16)
    path = tmp_path / "j.jsonl"
    res = slow.run(strict=False, store=str(path), timeout=0.02)
    assert isinstance(next(iter(res.values())), CellError)
    assert len(ResultStore(path)) == 0


def test_analysis_layer_reads_the_ports_journal(tmp_path):
    """The analysis layer (``analysis/loader.py``, ``analysis/stats.py``,
    written against the JAX package) reads a port-written journal and its
    sidecars: the same records, traces and statistics as from the port's
    live results."""
    from analysis import loader, stats
    m = Machine(TOPO, SimParams(trace=True), device="cpu")
    g = _grid(m, _wl(), seeds=1, serial_reference=5000.0)
    path = tmp_path / "forensics.jsonl"
    live = g.run(store=str(path))
    recs = loader.from_store(str(path))
    assert len(recs) == len(live)
    by_key = {cell_key(c.to_context(), c.workload,
                       policy.get_spec(c.scheduler), c.seed,
                       c.serial_reference): r
              for c, r in zip(g.plan.configs, live.values())}
    for rec in recs:
        r = by_key[rec.key]
        assert rec.trace.meta["engine"] == "plain"
        for name in ("ex_task", "ex_end", "st_dist", "mg_to"):
            assert (getattr(rec.trace, name) == getattr(r.trace,
                                                        name)).all()
        max_hop = len(r.steal_hops) - 1
        assert list(stats.steal_hist(rec, max_hop)) == list(r.steal_hops)
        assert stats.summary(rec) == stats.summary(
            loader.from_result(r, rec.label))
    side = loader.from_npz(ResultStore(path).trace_path(recs[0].key))
    assert list(side.trace.ex_task) == list(recs[0].trace.ex_task)
