"""Fault-tolerance runtime (port of ``repro/runtime/ft.py``): the
heartbeat monitor the training launcher beats once a step. Per-host
step-time EWMA with straggler flagging; hosts slower than ``threshold``
times the fleet median for ``patience`` consecutive beats are flagged,
and hosts that stop beating are reported missing. ``Supervisor`` and
``plan_elastic_remesh`` join with the fault-tolerance slice."""

from __future__ import annotations

import numpy as np

__all__ = ["HeartbeatMonitor"]


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
