"""Fault tolerance and elasticity runtime (port of
``repro/runtime/ft.py``): pure Python and numpy on the port's own
``core/topology.py`` and ``core/placement.py``.

  * **Heartbeats and straggler detection**: per-host step-time EWMA;
    hosts slower than ``threshold`` times the fleet median for
    ``patience`` consecutive beats are flagged, hosts that stop beating
    are reported missing. Mitigation in a lockstep (SPMD) program is
    eviction and an elastic remesh: one slow rank cannot be balanced
    around inside a collective.
  * **Elastic remesh** (:func:`plan_elastic_remesh`): on failure, keep the
    model axis, shrink the data axis to the largest power of two the
    survivors fill, and order the survivors with the paper's priority
    walk on the surviving topology (priorities explicitly support "some
    cores have already been allocated/lost", Tahan 2014 §IV).
  * **Supervisor**: checkpoint every k steps, restore and continue after
    a failure, evict persistent stragglers. The caller supplies the
    callbacks (a step, a save, a restore, a remesh), so the same loop
    drives a training run on the card and the simulated schedules of the
    tests; its ``events`` are the JAX package's, string for string.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import placement
from repro_torch.core import topology as topo_mod

__all__ = ["HeartbeatMonitor", "RemeshPlan", "plan_elastic_remesh",
           "Supervisor"]


class HeartbeatMonitor:
    """Step-time EWMA per host; robust straggler flagging."""

    def __init__(self, num_hosts: int, alpha: float = 0.2,
                 threshold: float = 1.5, patience: int = 3):
        self.num_hosts = num_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ewma = np.zeros(num_hosts)
        self.strikes = np.zeros(num_hosts, np.int64)
        self.beats = np.zeros(num_hosts, np.int64)

    def beat(self, host: int, step_time: float):
        if self.beats[host] == 0:
            self.ewma[host] = step_time
        else:
            self.ewma[host] = (self.alpha * step_time
                               + (1 - self.alpha) * self.ewma[host])
        self.beats[host] += 1
        med = float(np.median(self.ewma[self.beats > 0]))
        if med > 0 and self.ewma[host] > self.threshold * med:
            self.strikes[host] += 1
        else:
            self.strikes[host] = 0

    def stragglers(self) -> list[int]:
        return [h for h in range(self.num_hosts)
                if self.strikes[h] >= self.patience]

    def missing(self, timeout_beats: int = 2) -> list[int]:
        """Hosts that stopped reporting (crash detection)."""
        if self.beats.max(initial=0) == 0:
            return []
        return [h for h in range(self.num_hosts)
                if self.beats[h] < self.beats.max() - timeout_beats]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    surviving: tuple[int, ...]       # physical device ids kept, in logical order
    mesh_shape: tuple[int, ...]
    dropped: tuple[int, ...]
    data_parallel_scale: float       # new global-batch scale vs old


def plan_elastic_remesh(topo: topo_mod.Topology,
                        failed: Sequence[int],
                        mesh_shape: tuple[int, ...],
                        model_axis_size: int) -> RemeshPlan:
    """Shrink-and-relayout after device failures.

    Keeps the model axis intact (weights shard over it — its size is a
    property of the checkpoint layout) and shrinks the data axis to the
    largest power of two that fits the survivors; then orders survivors
    with the paper's priority walk restricted to the surviving topology,
    so the rebuilt rings stay low-hop even around the hole.
    """
    n = topo.num_cores
    failed_set = set(int(f) for f in failed)
    survivors = [d for d in range(n) if d not in failed_set]
    old_data = int(np.prod(mesh_shape)) // model_axis_size
    new_data = 1
    while new_data * 2 * model_axis_size <= len(survivors) and \
            new_data * 2 <= old_data:
        new_data *= 2
    keep = new_data * model_axis_size
    sub = topo.restrict(survivors)
    # two-stage paper walk: compact blob of `keep` survivors, then a
    # ring-aware order within it so the rebuilt mesh's model rings stay
    # minimal-hop around the failure holes
    blob = placement.device_order_priority(sub, (len(survivors),))[:keep]
    sub2 = sub.restrict([int(b) for b in blob])
    inner = placement.device_order_priority(
        sub2, (keep // model_axis_size, model_axis_size))
    order = [int(blob[i]) for i in inner]
    chosen = tuple(int(survivors[i]) for i in order)
    extra_dropped = tuple(sorted(set(survivors)
                                 - set(chosen))) + tuple(sorted(failed_set))
    return RemeshPlan(
        surviving=chosen,
        mesh_shape=(new_data, model_axis_size),
        dropped=extra_dropped,
        data_parallel_scale=new_data / old_data,
    )


class Supervisor:
    """Checkpoint/restart + straggler-eviction training supervisor.

    The caller supplies callbacks, so the same supervisor runs the real
    loop and the simulated tests:
      run_step(step)  -> step time per host: list[float]
      save(step)      -> persist the state after ``step`` steps
      restore()       -> the step of the latest checkpoint, its state
                         loaded (0 when there is none)
      remesh(plan)    -> rebuild the mesh and placements after a failure

    A failure fires once; a restore rewinds ``step``; a checkpoint is
    taken when ``step % checkpoint_every == 0`` after the step's
    increment; an evicted straggler's beats are no longer counted.
    """

    def __init__(self, num_hosts: int, checkpoint_every: int,
                 run_step: Callable[[int], Sequence[float]],
                 save: Callable[[int], None],
                 restore: Callable[[], int],
                 remesh: Callable[[RemeshPlan], None] | None = None,
                 topo: topo_mod.Topology | None = None,
                 mesh_shape: tuple[int, ...] | None = None,
                 model_axis_size: int = 1,
                 monitor: HeartbeatMonitor | None = None):
        self.monitor = monitor or HeartbeatMonitor(num_hosts)
        self.checkpoint_every = checkpoint_every
        self.run_step = run_step
        self.save = save
        self.restore = restore
        self.remesh = remesh
        self.topo = topo
        self.mesh_shape = mesh_shape
        self.model_axis_size = model_axis_size
        self.events: list[tuple[int, str]] = []
        self.evicted: set[int] = set()

    def run(self, start_step: int, num_steps: int,
            inject_failure: dict[int, list[int]] | None = None) -> int:
        """Run steps [start, start+num); returns the final step.

        inject_failure: {step: [host_ids]} — test hook that marks hosts
        failed *before* that step executes.
        """
        step = start_step
        end = start_step + num_steps
        pending_failures = dict(inject_failure or {})
        while step < end:
            # a failure fires once: the dead hosts are removed by the
            # remesh, so the replayed steps after restore don't re-fail
            failed = pending_failures.pop(step, [])
            if failed:
                self.events.append((step, f"failure hosts={failed}"))
                # roll back to last checkpoint, shrink, continue
                if self.remesh is not None and self.topo is not None:
                    plan = plan_elastic_remesh(
                        self.topo, failed, self.mesh_shape,
                        self.model_axis_size)
                    self.remesh(plan)
                    self.events.append(
                        (step, f"remesh {plan.mesh_shape} "
                               f"dropped={len(plan.dropped)}"))
                step = self.restore()
                self.events.append((step, "restored"))
                continue
            times = self.run_step(step)
            for h, t in enumerate(times):
                if h not in self.evicted:
                    self.monitor.beat(h, t)
            slow = [h for h in self.monitor.stragglers()
                    if h not in self.evicted]
            if slow:
                self.events.append((step, f"stragglers={slow}"))
                # eviction policy: treat persistent stragglers as failures
                if self.remesh is not None and self.topo is not None:
                    plan = plan_elastic_remesh(
                        self.topo, slow, self.mesh_shape,
                        self.model_axis_size)
                    self.remesh(plan)
                    self.events.append(
                        (step, f"remesh {plan.mesh_shape} evicted={slow}"))
                self.evicted.update(slow)
            step += 1
            if step % self.checkpoint_every == 0:
                self.save(step)
                self.events.append((step, "checkpoint"))
        return step
