"""The port's fault-tolerance runtime (``repro_torch.runtime``) against the
JAX package's ``repro.runtime`` on the same inputs, as
``tests/test_substrate.py`` holds the JAX one: ``plan_elastic_remesh``
field for field (``multi_pod(2, 4, 4)`` at mesh (4, 8), model axis 8,
over the failure sets of ``test_remesh_plan_properties``; and
``tpu_pod_2d(2, 2)`` at (2, 2), model axis 2), the ``Supervisor``'s
events string for string with the same stub callbacks (the schedule of
``test_supervisor_restores_after_failure``, the one ``chip_smoke.py``'s
``[elastic]`` phase drives on the card, and the JAX example's), the
straggler's eviction with a remesh, and ``HeartbeatMonitor.missing``
once an evicted host stops beating. Pure Python and numpy, a few
seconds."""

from __future__ import annotations

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import topology as jtopology
from repro.runtime import HeartbeatMonitor as JHeartbeatMonitor
from repro.runtime import Supervisor as JSupervisor
from repro.runtime import plan_elastic_remesh as jplan

torch = pytest.importorskip("torch")

from repro_torch.core import topology  # noqa: E402
from repro_torch.examples import elastic_failover  # noqa: E402
from repro_torch.runtime import (HeartbeatMonitor, RemeshPlan,  # noqa: E402
                                 Supervisor, plan_elastic_remesh)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401

MULTI_POD_CASES = [(seed, n) for seed in range(4) for n in range(1, 21)]
POD_2X2_FAILURES = [list(c) for k in (1, 2)
                    for c in itertools.combinations(range(4), k)]


def _fields(plan) -> tuple:
    return (plan.surviving, plan.mesh_shape, plan.dropped,
            plan.data_parallel_scale)


@pytest.mark.parametrize("seed,n_fail", MULTI_POD_CASES,
                         ids=[f"seed{s}-fail{n}" for s, n in MULTI_POD_CASES])
def test_remesh_plan_multi_pod_matches_jax(seed, n_fail):
    """The failure sets of test_substrate.py's test_remesh_plan_properties
    (seeds 0-3, 1-20 failures)."""
    rng = np.random.RandomState(seed)
    failed = rng.choice(32, size=min(n_fail, 20), replace=False).tolist()
    got = plan_elastic_remesh(topology.multi_pod(2, 4, 4), failed, (4, 8), 8)
    want = jplan(jtopology.multi_pod(2, 4, 4), failed, (4, 8), 8)
    assert isinstance(got, RemeshPlan)
    assert _fields(got) == _fields(want)
    assert all(type(x) is int for x in got.surviving + got.dropped)
    assert set(got.surviving).isdisjoint(failed)
    assert len(got.surviving) == got.mesh_shape[0] * 8


@pytest.mark.parametrize("failed", POD_2X2_FAILURES,
                         ids=["-".join(map(str, f)) for f in POD_2X2_FAILURES])
def test_remesh_plan_pod_2x2_matches_jax(failed):
    got = plan_elastic_remesh(topology.tpu_pod_2d(2, 2), failed, (2, 2), 2)
    want = jplan(jtopology.tpu_pod_2d(2, 2), failed, (2, 2), 2)
    assert _fields(got) == _fields(want)
    assert got.mesh_shape == (1, 2)


def _schedule_run(supervisor_cls, topo_mod, *, num_hosts, checkpoint_every,
                  steps, failure, topo, mesh_shape, model_axis_size,
                  straggler=None, straggler_from=0, slowdown=3.0):
    """A Supervisor run with stub callbacks: unit step times (the
    straggler's ``slowdown`` from ``straggler_from``); restore returns the
    last saved step. Returns what the callbacks saw, the events and the
    monitor."""
    out = dict(executed=[], saved=[], plans=[])

    def run_step(s):
        out["executed"].append(s)
        return [slowdown if h == straggler and s >= straggler_from else 1.0
                for h in range(num_hosts)]

    def save(s):
        out["saved"].append(s)

    def restore():
        return out["saved"][-1] if out["saved"] else 0

    def remesh(plan):
        out["plans"].append(_fields(plan))
    make, args = topo
    sup = supervisor_cls(
        num_hosts=num_hosts, checkpoint_every=checkpoint_every,
        run_step=run_step, save=save, restore=restore, remesh=remesh,
        topo=getattr(topo_mod, make)(*args), mesh_shape=mesh_shape,
        model_axis_size=model_axis_size)
    out["final"] = sup.run(0, steps, inject_failure=failure)
    out["events"] = sup.events
    out["monitor"] = sup.monitor
    out["evicted"] = sorted(sup.evicted)
    return out


E = chip_smoke.ELASTIC
SCHEDULES = {
    # tests/test_substrate.py's test_supervisor_restores_after_failure
    "substrate": dict(num_hosts=1, checkpoint_every=5, steps=20,
                      failure={12: [1]}, topo=("tpu_pod_2d", (2, 2)),
                      mesh_shape=(2, 2), model_axis_size=2),
    # chip_smoke.py's [elastic]
    "elastic": dict(num_hosts=E["num_hosts"],
                    checkpoint_every=E["checkpoint_every"],
                    steps=chip_smoke.TRAIN_STEPS, failure=E["failure"],
                    topo=("multi_pod", E["topology"]),
                    mesh_shape=E["mesh_shape"],
                    model_axis_size=E["model_axis_size"],
                    straggler=E["straggler"],
                    straggler_from=E["straggler_from"],
                    slowdown=E["slowdown"]),
    # examples/elastic_failover.py (and the port's example)
    "example": dict(num_hosts=elastic_failover.NUM_HOSTS,
                    checkpoint_every=elastic_failover.CHECKPOINT_EVERY,
                    steps=elastic_failover.STEPS,
                    failure=elastic_failover.FAILURE,
                    topo=("multi_pod", elastic_failover.TOPOLOGY),
                    mesh_shape=elastic_failover.MESH_SHAPE,
                    model_axis_size=elastic_failover.MODEL_AXIS,
                    straggler=elastic_failover.STRAGGLER,
                    straggler_from=elastic_failover.STRAGGLER_FROM,
                    slowdown=elastic_failover.SLOWDOWN),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_supervisor_events_match_jax(name):
    got = _schedule_run(Supervisor, topology, **SCHEDULES[name])
    want = _schedule_run(JSupervisor, jtopology, **SCHEDULES[name])
    assert got["events"] == want["events"]
    for k in ("executed", "saved", "plans", "final", "evicted"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["monitor"].ewma, want["monitor"].ewma)
    np.testing.assert_array_equal(got["monitor"].beats,
                                  want["monitor"].beats)
    assert got["final"] == SCHEDULES[name]["steps"]
    kinds = [e for _, e in got["events"]]
    assert any(k.startswith("failure") for k in kinds)
    assert "restored" in kinds


def test_supervisor_replays_from_the_last_checkpoint():
    """test_supervisor_restores_after_failure's schedule: a failure fires
    once, the restore rewinds to the checkpoint at 10, steps 10 and 11
    run twice, and a checkpoint follows each multiple of 5."""
    got = _schedule_run(Supervisor, topology, **SCHEDULES["substrate"])
    assert got["executed"] == list(range(12)) + list(range(10, 20))
    assert got["saved"] == [5, 10, 15, 20]
    assert got["events"][:4] == [(5, "checkpoint"), (10, "checkpoint"),
                                 (12, "failure hosts=[1]"),
                                 (12, "remesh (1, 2) dropped=2")]
    assert got["events"][4] == (10, "restored")


def test_elastic_phase_stub_run_is_the_schedule():
    """chip_smoke.py's own stub run (check (a) of [elastic] on the card)
    equals JAX's Supervisor on the schedule: the failure's remesh, the
    straggler's eviction with its remesh, the checkpoints."""
    got = chip_smoke.elastic_stub_run(Supervisor, topology)
    js = chip_smoke.elastic_stub_run(JSupervisor, jtopology)
    want = _schedule_run(JSupervisor, jtopology, **SCHEDULES["elastic"])
    for k in ("events", "executed", "saved", "plans", "final"):
        assert got[k] == js[k] == want[k], k
    kinds = [e for _, e in got["events"]]
    assert any(k.startswith("stragglers=") for k in kinds)
    assert any("evicted=" in k for k in kinds)
    assert [p[1] for p in got["plans"]] == [(2, 8), (2, 8)]


@pytest.mark.parametrize("slow", [0, 5, 6])
def test_elastic_stub_run_on_measured_times(slow):
    """Check (a) of [elastic] on the card feeds the stub run the measured
    step times: one step three times slower moves the straggler's flagging
    (step 8 for a slow first step or replay, step 5 for a slow step 5),
    JAX's Supervisor moves it the same, and the event kinds and executed
    steps stay the unit-time run's."""
    times = [0.66] * 12
    times[slow] = 2.0
    got = chip_smoke.elastic_stub_run(Supervisor, topology, times=times)
    js = chip_smoke.elastic_stub_run(JSupervisor, jtopology, times=times)
    unit = chip_smoke.elastic_stub_run(Supervisor, topology)
    assert got["events"] == js["events"]
    flagged = [s for s, e in got["events"] if e.startswith("stragglers=")]
    assert flagged == [{0: 8, 5: 5, 6: 8}[slow]]
    assert sorted(e for _, e in got["events"]) == sorted(
        e for _, e in unit["events"])
    assert got["executed"] == unit["executed"]
    assert got["plans"] == unit["plans"] and got["final"] == unit["final"]


def test_evicted_straggler_stops_beating_and_goes_missing():
    """The example's schedule: host 3 is flagged, evicted with a remesh,
    and its beats stop, so the monitor reports it missing, as JAX's."""
    got = _schedule_run(Supervisor, topology, **SCHEDULES["example"])
    want = _schedule_run(JSupervisor, jtopology, **SCHEDULES["example"])
    assert got["evicted"] == [3]
    events = dict((e, s) for s, e in got["events"])
    assert events["stragglers=[3]"] == events[
        "remesh (2, 8) evicted=[3]"]
    assert got["monitor"].missing() == want["monitor"].missing() == [3]
    assert got["monitor"].stragglers() == want["monitor"].stragglers()


def test_straggler_flagging_and_recovery_matches_jax():
    """test_substrate.py's test_straggler_flagging_and_recovery, both
    monitors beat for beat."""
    jm = JHeartbeatMonitor(4, patience=2, threshold=1.5)
    tm = HeartbeatMonitor(4, patience=2, threshold=1.5)
    seen = []
    for beat in range(18):
        for h in range(4):
            t = 4.0 if h == 3 and beat < 4 else 1.0
            jm.beat(h, t)
            tm.beat(h, t)
        assert tm.stragglers() == jm.stragglers()
        np.testing.assert_array_equal(tm.ewma, jm.ewma)
        seen.append(tm.stragglers())
    assert [3] in seen and seen[-1] == []
