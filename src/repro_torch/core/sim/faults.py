"""Declarative fault models: perturbed-execution simulation (own copy of
``repro/core/sim/faults.py``).

Every paper figure assumes perfectly healthy cores; real multi-socket
machines have stragglers, preempted threads, and failed cores — and it
is exactly under such perturbation that load-balancing strategies
separate (Wang et al. 2025). This module makes faults a *declarative
policy* like schedulers (``policy.py``) and bindings/placements
(``context.py``):

  * :class:`FaultSpec` — one fault model:
      ``"straggler:S"``      one bound core (drawn from the fault RNG)
                             executes all work ``(1+S)×`` slower;
      ``"straggler:S@a,b"``  explicit core ids instead of a draw;
      ``"preempt:N"``        per thread, ``Poisson(N)`` offline windows
                             with starts ~ ``U[0, span)`` and durations
                             ~ ``Exp(duration)`` — the thread goes
                             offline for the window, its in-hand task is
                             reclaimed (re-queued, stealable) and it
                             resumes at the window end;
      ``"preempt:N@D"``      mean window duration ``D``;
      ``"fail:K"``           ``K`` distinct threads (drawn) fail
                             *permanently* at times ~ ``U[0, span)``;
                             their queued tasks are reclaimed and
                             re-stolen, aborted work re-executes
                             elsewhere — deterministic re-execution;
      ``"fail:K@T"``         the drawn threads all fail at fixed time T.

  * :class:`FaultPlan` — the compiled form both engines consume through
    one lowered representation, exactly as victim plans do: a per-core
    ``speed`` multiplier vector plus per-thread sorted, merged
    ``(start, end)`` offline windows in flat CSR arrays
    (``win_off``/``win_start``/``win_end``; a permanent failure is a
    window ending at ``+inf``).

All randomness is consumed at *compile* time from a dedicated fault RNG
stream seeded from ``(FAULT_STREAM, seed)`` — the engines' own
``RandomState(seed)`` task-execution draw order is untouched, which is
how every fault-free configuration stays bit-exact against the golden
fixtures. Plans are cached on the topology per (specs, binding, seed)
like victim plans, so sweeps share them across cells.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..topology import Topology, lazy_cache

__all__ = [
    "FaultSpec", "FaultPlan", "FAULTS",
    "register_fault", "get_fault", "get_faults", "compile_fault_plan",
    "FAULT_KINDS",
]

FAULT_KINDS = ("straggler", "preempt", "fail")

# Stream-id prefix for the dedicated fault RNG: RandomState([FAULT_STREAM,
# seed]) never collides with the engines' RandomState(seed) draw sequence.
FAULT_STREAM = 0xFA17


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault model (see module docstring).

    Fields by kind:
      straggler: ``severity`` S (cost multiplier ``1+S``), ``cores``
        (explicit core ids, or None → one core drawn from the bound set).
      preempt:   ``count`` (expected windows per thread, Poisson),
        ``duration`` (mean offline interval, exponential), ``span``
        (window-start horizon, uniform).
      fail:      ``count`` (threads failed, drawn without replacement),
        ``at`` (fixed failure time, or None → drawn ~ U[0, span)).
    """
    name: str
    kind: str = "straggler"
    severity: float = 0.5
    cores: Optional[tuple] = None
    count: float = 1.0
    duration: float = 20.0
    span: float = 200.0
    at: Optional[float] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind={self.kind!r}: expected one of {FAULT_KINDS}")
        if self.severity < 0.0:
            raise ValueError(f"fault {self.name!r}: severity "
                             f"{self.severity} < 0")
        if self.count < 0:
            raise ValueError(f"fault {self.name!r}: count {self.count} < 0")
        if self.duration <= 0.0:
            raise ValueError(f"fault {self.name!r}: duration "
                             f"{self.duration} <= 0")
        if self.span <= 0.0:
            raise ValueError(f"fault {self.name!r}: span {self.span} <= 0")
        if self.at is not None and self.at < 0.0:
            raise ValueError(f"fault {self.name!r}: at {self.at} < 0")
        if self.cores is not None:
            if self.kind != "straggler":
                raise ValueError(f"fault kind={self.kind!r} takes no "
                                 "explicit core list")
            if not self.cores:
                raise ValueError("explicit straggler needs a non-empty "
                                 "core tuple")
            object.__setattr__(self, "cores",
                               tuple(int(c) for c in self.cores))
        if self.kind == "fail" and self.count != int(self.count):
            raise ValueError(f"fault {self.name!r}: fail count must be "
                             f"an integer, got {self.count}")

    def validate(self, topo: Topology, num_threads: int) -> None:
        """Eager per-context validation (bad cells fail at compile time,
        naming the spec, not mid-batch inside an engine)."""
        if self.kind == "straggler" and self.cores is not None:
            bad = [c for c in self.cores if not 0 <= c < topo.num_cores]
            if bad:
                raise ValueError(f"fault {self.name!r}: cores {bad} outside "
                                 f"topology ({topo.num_cores} cores)")
        if self.kind == "fail":
            if int(self.count) >= num_threads:
                raise ValueError(
                    f"fault {self.name!r}: failing {int(self.count)} of "
                    f"{num_threads} threads would leave no survivor")


class FaultPlan:
    """Compiled fault plan — the flat arrays both engines consume.

    ``speed[c]``: execution-cost multiplier of topology core ``c``
    (1.0 = healthy; migration can land a thread on a straggler core).
    Thread ``th``'s offline windows occupy
    ``win_start/win_end[win_off[th]:win_off[th+1]]`` — sorted by start,
    non-overlapping (merged at compile), ``end = inf`` for a permanent
    failure.
    """

    __slots__ = ("speed", "win_off", "win_start", "win_end", "n_windows")

    def __init__(self, speed, win_off, win_start, win_end):
        self.speed = np.ascontiguousarray(speed, dtype=np.float64)
        self.win_off = np.ascontiguousarray(win_off, dtype=np.int64)
        self.win_start = np.ascontiguousarray(win_start, dtype=np.float64)
        self.win_end = np.ascontiguousarray(win_end, dtype=np.float64)
        self.n_windows = int(self.win_start.shape[0])

    @property
    def is_neutral(self) -> bool:
        """True when the plan perturbs nothing (all speeds 1, no
        windows) — the engines' fault hook still runs, bit-exactly."""
        return self.n_windows == 0 and bool((self.speed == 1.0).all())


# ----------------------------------------------------------------------
# Registry + string forms
# ----------------------------------------------------------------------

FAULTS: dict = {}


def register_fault(spec: FaultSpec, *, replace: bool = False) -> FaultSpec:
    """Register ``spec`` under ``spec.name``; returns it for chaining."""
    if not replace and spec.name in FAULTS:
        raise ValueError(f"fault {spec.name!r} already registered "
                         "(pass replace=True to override)")
    FAULTS[spec.name] = spec
    return spec


def _num(text: str, what: str) -> float:
    try:
        return float(text)
    except ValueError:
        raise ValueError(f"malformed fault {what} {text!r}") from None


def get_fault(fault) -> FaultSpec:
    """Resolve one fault: a spec, a registered name, or a parametrized
    string (``straggler:S[@a,b]``, ``preempt:N[@D]``, ``fail:K[@T]``)."""
    if isinstance(fault, FaultSpec):
        return fault
    if not isinstance(fault, str):
        raise TypeError(f"cannot interpret {fault!r} as a fault spec")
    spec = FAULTS.get(fault)
    if spec is not None:
        return spec
    kind, sep, body = fault.partition(":")
    if not sep or kind not in FAULT_KINDS:
        raise ValueError(
            f"unknown fault {fault!r}; registered: {sorted(FAULTS)} (or "
            "'straggler:S[@a,b]', 'preempt:N[@D]', 'fail:K[@T]')")
    head, asep, tail = body.partition("@")
    if kind == "straggler":
        severity = _num(head, "severity")
        cores = None
        if asep:
            try:
                cores = tuple(int(p) for p in tail.split(",") if p != "")
            except ValueError:
                raise ValueError(
                    f"malformed fault core list {tail!r}") from None
        return FaultSpec(fault, kind="straggler", severity=severity,
                         cores=cores)
    if kind == "preempt":
        kw = dict(count=_num(head, "rate"))
        if asep:
            kw["duration"] = _num(tail, "duration")
        return FaultSpec(fault, kind="preempt", **kw)
    # kind == "fail"
    kw = dict(count=_num(head, "count"))
    if asep:
        kw["at"] = _num(tail, "time")
    return FaultSpec(fault, kind="fail", **kw)


def get_faults(faults) -> tuple:
    """Normalize a fault description into a tuple of :class:`FaultSpec`.

    Accepts ``None`` / ``()`` (no faults), one spec or string, or a
    sequence of them (composed in order into one plan).
    """
    if faults is None:
        return ()
    if isinstance(faults, (FaultSpec, str)):
        return (get_fault(faults),)
    if isinstance(faults, (list, tuple)):
        return tuple(get_fault(f) for f in faults)
    raise TypeError(f"cannot interpret {faults!r} as faults")


# ----------------------------------------------------------------------
# Compilation
# ----------------------------------------------------------------------

def _merge_windows(wins: list) -> list:
    """Sort by start and merge overlapping/touching intervals; anything
    at or after a permanent failure's start is absorbed by it."""
    if not wins:
        return []
    wins = sorted(wins)
    out = [list(wins[0])]
    for s, e in wins[1:]:
        if s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def compile_fault_plan(specs: Sequence[FaultSpec], topo: Topology,
                       thread_cores: Sequence[int], seed: int) -> FaultPlan:
    """Compile (and cache) ``specs`` into one :class:`FaultPlan`.

    All stochastic draws (straggler core choice, window starts/durations,
    failure times/threads) happen here, from the dedicated
    ``RandomState([FAULT_STREAM, seed])`` stream — never inside an
    engine. The cache lives on the (frozen, immutable) topology, keyed
    by (specs, binding, seed): a robustness sweep reuses one plan across
    every (workload, scheduler) cell that shares a context and seed.
    """
    specs = tuple(specs)
    cores = tuple(int(c) for c in thread_cores)
    cache = lazy_cache(topo, "_fault_plan_cache")
    key = (specs, cores, seed)
    plan = cache.get(key)
    if plan is not None:
        return plan

    T = len(cores)
    for spec in specs:
        spec.validate(topo, T)
    rng = np.random.RandomState([FAULT_STREAM, seed & 0xFFFFFFFF])
    speed = np.ones(topo.num_cores, dtype=np.float64)
    wins: list[list] = [[] for _ in range(T)]
    inf = float("inf")
    for spec in specs:
        if spec.kind == "straggler":
            if spec.cores is not None:
                targets = spec.cores
            else:
                targets = (cores[int(rng.randint(T))],)
            for c in targets:
                speed[c] *= 1.0 + spec.severity
        elif spec.kind == "preempt":
            for th in range(T):
                n = int(rng.poisson(spec.count))
                if n == 0:
                    continue
                starts = rng.uniform(0.0, spec.span, n)
                durs = rng.exponential(spec.duration, n)
                for s, d in zip(starts.tolist(), durs.tolist()):
                    wins[th].append((s, s + d))
        else:  # fail
            k = int(spec.count)
            if k == 0:
                continue
            victims = rng.permutation(T)[:k]
            if spec.at is not None:
                times = [float(spec.at)] * k
            else:
                times = rng.uniform(0.0, spec.span, k).tolist()
            for th, at in zip(victims.tolist(), times):
                wins[th].append((float(at), inf))

    win_off = [0]
    win_start: list[float] = []
    win_end: list[float] = []
    dead = 0
    for th in range(T):
        merged = _merge_windows(wins[th])
        if merged and merged[-1][1] == inf:
            dead += 1
        for s, e in merged:
            win_start.append(s)
            win_end.append(e)
        win_off.append(len(win_start))
    if T and dead == T:
        raise ValueError(
            f"fault plan {tuple(s.name for s in specs)} fails all {T} "
            "threads permanently — no survivor could finish the workload")
    plan = FaultPlan(speed, win_off, win_start, win_end)
    cache[key] = plan
    return plan
