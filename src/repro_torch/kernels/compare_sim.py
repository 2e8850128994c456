"""Time the simulator's kernel against another checkout's, in turns, on
one card, and show where an event's cycles go.

    python3 -m repro_torch.kernels.compare_sim [--parent OTHER/src]
        [--cases grid held forensics paper] [--shapes 0 1 2 4 8 32]
        [--rounds 2] [--workspace] [--profile] [--min-blocks 4 5 6]

``OTHER/src`` is the ``src`` directory of another checkout of this repo
(unpack a commit with ``git archive`` under ``_archive/``, which is
gitignored); its ``repro_torch`` is loaded under an alias and its own
``kernels/sim.py`` packs, launches and unpacks with its own build of its
own ``csrc/sim.cu``. The cells are ``chip_smoke.py``'s (at the root of
this checkout), prepared once by this tree's ``core/sim``:

  * ``grid`` — the ``[sim]`` figure grid (``sim_grid``: fft and sort at
    2^15 with cutoff 4, strassen medium on sunfire_x4600, 5328 cells);
  * ``held`` — its 8 held cells (``SIM_HELD``);
  * ``forensics`` — the ``[sim_durable]`` forensics grid (162 cells),
    untraced and traced;
  * ``paper`` — the paper-scale FFT (1 769 471 tasks) under wf and
    dfwspt in both contexts at 16 threads (4 cells), untraced and traced.

Each case runs in turns, ``other, this, this, other``, for ``--rounds``
rounds; the grid also runs this tree at each of ``--shapes`` (cells a
warp; 0 is the batch's own choice, ``kernels/sim.py``
``CELLS_PER_WARP = None``), in order and then in reverse, and with
``--workspace`` with every cell's hot state in its workspace
(``SHARED_CELL_MAX = 0``). Every run's results (and traces) must equal
the case's first run bit for bit, whichever tree ran it. Prints the
card's name and power limit first, each tree's registers and spills
from its ptxas log, one line per case and tree or shape (the best
kernel time by CUDA events and every run's, events/s, the launch shape
and resident cells), and a JSON line of the best times.

``--profile`` builds each tree's ``sim.cu`` once more with
``-DSIM_PROFILE`` (a library of its own; the main path's build has no
counting code) and runs each untraced case once: every cell sums
``clock64()`` cycles by part of its loop (heap pop and push; acquire:
local pop, steal sweep and its shuffle's bookkeeping, shared FIFO; RNG
draws and twists; execute; spawn with its set pops; the completion
walk; the cell's set-up; the rest: the fault checks and the loop), and
the tool prints cycles an event by part over the case's cells. The other
tree's source must carry the same counting (``sim_profile_read``);
where it does not, its split is left out. ``--min-blocks`` times this
tree's grid and paper cells once more for each ``-DSIM_MIN_BLOCKS`` (the
blocks an SM should hold, which caps a thread's registers), printing each
build's registers and spills. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import sim as this_sim

PARTS = ("heap", "acquire", "rng", "execute", "spawn", "walk", "setup",
         "rest")


def _chip_smoke():
    path = Path(__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_other(src: Path):
    """The other tree's ``repro_torch.kernels.sim`` under an alias."""
    root = Path(src).resolve() / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", root / "__init__.py",
        submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["other_repro_torch"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("other_repro_torch.kernels.sim")


@contextlib.contextmanager
def _variant(mod, flags):
    """``mod``'s ``sim.cu`` built and loaded with ``flags`` added while
    inside (its own library, by the flags' hash); the main build after."""
    b = mod._build
    old = b._SOURCE_FLAGS.get("sim", ())
    log = b.build_logs.get("sim")

    def drop():
        b._libs.pop("sim", None)
        for key in [k for k in b._functions if k[0] == "sim"]:
            del b._functions[key]
    drop()
    b._SOURCE_FLAGS["sim"] = old + tuple(flags)
    try:
        yield b
    finally:
        b._SOURCE_FLAGS["sim"] = old
        drop()
        if log is not None:
            b.build_logs["sim"] = log


def _same_trace(a, b) -> bool:
    """Two cells' traces (or their absence) equal column for column; the
    other tree's ``TraceBuffer`` is a class of its own, so ``==`` between
    the two would compare identities."""
    from ..core.sim.trace import ALL_COLS
    if a is None or b is None:
        return a is None and b is None
    a.finalize()
    b.finalize()
    return all(np.array_equal(getattr(a, n), getattr(b, n))
               for n, _ in ALL_COLS)


class Case:
    """Prepared contexts of one case, their cores restored before each
    run (migration writes them)."""

    def __init__(self, name, configs):
        from ..core.sim import policy, runtime
        self.name = name
        self.ctxs = [runtime._prepare_ctx(c.to_context(), c.workload,
                                          policy.get_spec(c.scheduler),
                                          c.seed) for c in configs]
        self.cores = [list(c["cores"]) for c in self.ctxs]
        self.want = None

    def fresh(self):
        for c, cores in zip(self.ctxs, self.cores):
            c["cores"] = list(cores)
        return self.ctxs

    def check(self, what, got) -> None:
        """Raise unless ``got`` equals the case's first run bit for bit."""
        for i, r in enumerate(got):
            if isinstance(r, Exception):
                raise AssertionError(f"{self.name} cell {i} ({what}): {r!r}")
        got = [dict(r) for r in got]
        if self.want is None:
            self.want = got
            return
        for i, (a, b) in enumerate(zip(got, self.want)):
            ta, tb = a.pop("trace", None), b.get("trace")
            b = {k: v for k, v in b.items() if k != "trace"}
            if a != b or not _same_trace(ta, tb):
                raise AssertionError(f"{self.name} cell {i} ({what}) differs "
                                     f"from the first run")


def _cases(smoke, names) -> dict:
    from ..core import topology
    from ..core.sim import GridKey, Machine, SimParams, bots
    topo = topology.sunfire_x4600()
    card = Machine(topo, device="cuda")
    plain = Machine(topo, device="cpu")
    traced = Machine(topo, SimParams(trace=True), device="cuda")
    wls = smoke.sim_workloads()
    out = {}
    if "grid" in names or "held" in names:
        grid = smoke.sim_grid(card, wls)
        if "grid" in names:
            out["grid"] = Case("grid", grid.plan.configs)
        if "held" in names:
            index = {k: i for i, k in enumerate(grid.keys)}
            out["held"] = Case("held", [
                grid.plan.configs[index[GridKey(*h)]] for h in smoke.SIM_HELD])
    if "forensics" in names:
        for name in smoke.DURABLE_SMALL:
            wls[name] = bots.make(name, "medium")
        serial = {name: plain.serial_time(
            wl, placement=f"spill:{smoke.DURABLE_SPILL[name]}@0")
            for name, wl in wls.items()}
        out["forensics"] = Case("forensics", smoke.durable_grid(
            card, wls, serial).plan.configs)
        out["forensics-traced"] = Case("forensics-traced", smoke.durable_grid(
            traced, wls, serial).plan.configs)
    if "paper" in names:
        wl = bots.make("fft", "paper")
        serial = {smoke.PAPER_HELD[0]: 1.0}
        for label, m in (("paper", card), ("paper-traced", traced)):
            out[label] = Case(label, m.grid(
                workloads={smoke.PAPER_HELD[0]: wl},
                schedulers=smoke.PAPER_SCHEDS, threads=16,
                contexts=smoke.sim_variants(2), seeds=(0,),
                serial_reference=serial).plan.configs)
    return out


def _run(mod, case: Case, what: str) -> float:
    got = mod.run_batch(case.fresh(), "cuda")
    case.check(what, got)
    return mod.last_run["kernel_ms"]


def _profile(mod, case: Case) -> "dict | None":
    """Cycles an event by part over the case's cells, from ``mod``'s
    profiled build (None where its source has no counting)."""
    with _variant(mod, ("-DSIM_PROFILE",)) as b:
        got = mod.run_batch(case.fresh(), "cuda")
        case.check("profiled", got)
        lib = b._library("sim")
        if not hasattr(lib, "sim_profile_read"):
            return None
        read = lib.sim_profile_read
        read.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        read.restype = ctypes.c_int
        n = len(case.ctxs)
        cyc = np.zeros((n, len(PARTS)), np.uint64)
        if read(cyc.ctypes.data, n):
            raise RuntimeError("sim_profile_read failed")
        events = sum(r["steps"] for r in got)
        tot = cyc.sum(axis=0).astype(np.float64)
        return dict(events=events, cycles_per_event={
            p: float(tot[i] / events) for i, p in enumerate(PARTS)},
            total_per_event=float(tot.sum() / events),
            kernel_ms=mod.last_run["kernel_ms"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="the src directory of the checkout to compare with")
    ap.add_argument("--cases", nargs="+", default=["grid", "held",
                                                   "forensics", "paper"],
                    choices=["grid", "held", "forensics", "paper"])
    ap.add_argument("--shapes", type=int, nargs="+", default=[0, 1, 2, 4])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--workspace", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--min-blocks", type=int, nargs="*", default=[],
                    help="also time this tree's grid and paper cells built "
                         "with each -DSIM_MIN_BLOCKS (the main route's "
                         "__launch_bounds__)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_sim: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from ..core.sim import compile_cache
    os.environ.setdefault(compile_cache.ENV_VAR,
                          tempfile.mkdtemp(prefix="compare_sim_cache_"))
    compile_cache.reset_cache()
    trees = {"this": this_sim}
    if args.parent is not None:
        trees["other"] = _load_other(args.parent)
    for name, mod in trees.items():
        mod._build.build(["sim"])
        regs = this_sim.ptxas_registers(mod._build.build_logs["sim"])
        print(f"{name}: ptxas " + "; ".join(
            f"{k} {r} registers, spill stores {st} B, loads {ld} B"
            for k, (r, st, ld) in sorted(regs.items())), flush=True)
    smoke = _chip_smoke()
    cases = _cases(smoke, set(args.cases))
    order = ["other", "this", "this", "other"] if "other" in trees \
        else ["this"]
    times: dict = {}
    keep = (this_sim.CELLS_PER_WARP, this_sim.SHARED_CELL_MAX)
    try:
        for _ in range(args.rounds):
            for case in cases.values():
                for who in order:
                    times.setdefault((case.name, who), []).append(
                        _run(trees[who], case, who))
                    if who == "this":
                        times[(case.name, "shape")] = (
                            this_sim.last_run["cells_per_warp"],
                            this_sim.last_run["resident_cells"],
                            this_sim.last_run["hot_bytes"])
                if case.name != "grid":
                    continue
                shapes = list(args.shapes) + list(reversed(args.shapes))
                for s in shapes:
                    this_sim.CELLS_PER_WARP = s or None
                    times.setdefault(("grid", f"shape {s}"), []).append(
                        _run(this_sim, case, f"{s} cells a warp"))
                this_sim.CELLS_PER_WARP = keep[0]
                if args.workspace:
                    this_sim.SHARED_CELL_MAX = 0
                    times.setdefault(("grid", "workspace"), []).append(
                        _run(this_sim, case, "hot state in the workspace"))
                    this_sim.SHARED_CELL_MAX = keep[1]
                    if this_sim.last_run["groups"][0]["route"] != \
                            "untraced_workspace":
                        raise AssertionError("the workspace run took "
                                             f"{this_sim.last_run['groups']}")
    finally:
        this_sim.CELLS_PER_WARP, this_sim.SHARED_CELL_MAX = keep
    best = {}
    for (name, who), ts in times.items():
        if who == "shape":
            continue
        events = sum(r["steps"] for r in cases[name].want)
        best[f"{name} {who}"] = min(ts)
        extra = ""
        if who == "this":
            cpw, res, hot = times[(name, "shape")]
            extra = (f"; {cpw} cell(s) a warp, {res} resident, "
                     f"{hot} B of hot state a cell")
        print(f"{name} ({len(cases[name].ctxs)} cells, {events} events) "
              f"{who}: kernel {min(ts):.1f} ms (runs "
              + ", ".join(f"{t:.1f}" for t in ts)
              + f"), {events / min(ts) * 1e3:.3e} events/s{extra}; the same "
              "bits", flush=True)
    for name in cases:
        if (name, "other") in times:
            ratio = min(times[(name, "other")]) / min(times[(name, "this")])
            print(f"{name}: other / this = {ratio:.2f}", flush=True)
    for nb in args.min_blocks:
        with _variant(this_sim, (f"-DSIM_MIN_BLOCKS={nb}",)) as b:
            b.build(["sim"])
            regs = this_sim.ptxas_registers(b.build_logs["sim"])
            print(f"min blocks {nb}: ptxas " + "; ".join(
                f"{k} {r} registers, spill stores {st} B, loads {ld} B"
                for k, (r, st, ld) in sorted(regs.items())), flush=True)
            for name, case in cases.items():
                if name not in ("grid", "paper"):
                    continue
                ts = [_run(this_sim, case, f"min blocks {nb}")
                      for _ in range(2)]
                best[f"{name} min blocks {nb}"] = min(ts)
                print(f"{name} min blocks {nb}: kernel {min(ts):.1f} ms (runs "
                      + ", ".join(f"{t:.1f}" for t in ts) + f"), "
                      f"{this_sim.last_run['cells_per_warp']} cell(s) a "
                      f"warp, {this_sim.last_run['resident_cells']} "
                      "resident; the same bits", flush=True)
    prof = {}
    if args.profile:
        for who, mod in trees.items():
            for name, case in cases.items():
                if name.endswith("traced"):
                    continue
                got = _profile(mod, case)
                prof[f"{name} {who}"] = got
                if got is None:
                    print(f"profile {name} {who}: no counting in its source",
                          flush=True)
                    continue
                c, tot = got["cycles_per_event"], got["total_per_event"]
                print(f"profile {name} {who}: {tot:.0f} cycles an event: "
                      + ", ".join(f"{p} {c[p]:.0f} ({100 * c[p] / tot:.1f} %)"
                                  for p in PARTS)
                      + f"; profiled kernel {got['kernel_ms']:.1f} ms",
                      flush=True)
    print(json.dumps({"card": card, "best_ms": best, "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
