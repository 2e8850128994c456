"""Time the simulator's kernel on ``chip_smoke.py``'s ``[sim]`` figure
grid at each launch shape, the number of cells that share a warp
(``kernels/sim.py`` ``CELLS_PER_WARP`` fixes it on the main path).

    python3 -m repro_torch.kernels.compare_sim [--shapes 1 2 4 8 32] [--rounds 2]

The grid is the one ``chip_smoke.py`` (at the root of this checkout)
builds with ``sim_grid``: fft and sort at 2^15 with cutoff 4 and
strassen medium on sunfire_x4600, 5328 cells. It runs once at each
shape in turns, the shapes in order and then in reverse, for
``--rounds`` rounds; every run's results must equal the first run's bit
for bit. Prints the card's name and power limit first, one line per
shape (the best kernel time by CUDA events and the others, cells/s,
events/s), and a JSON line of the best time of each. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from . import sim


def _chip_smoke():
    path = Path(__file__).resolve().parents[3] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", type=int, nargs="+", default=[1, 2, 4, 8, 32])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_sim: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from ..core import topology
    from ..core.sim import Machine
    smoke = _chip_smoke()
    grid = smoke.sim_grid(Machine(topology.sunfire_x4600(), device="cuda"),
                          smoke.sim_workloads())
    order = list(args.shapes) + list(reversed(args.shapes))
    times: dict = {s: [] for s in args.shapes}
    first, steps, keep = None, 0, sim.CELLS_PER_WARP
    try:
        for _ in range(args.rounds):
            for shape in order:
                sim.CELLS_PER_WARP = shape
                res = grid.run()
                times[shape].append(sim.last_run["kernel_ms"])
                steps = sim.last_run["steps"]
                if first is None:
                    first = res
                for k, r in res.items():
                    smoke.sim_same(f"grid cell {k} at {shape} cells a warp",
                                   r, first[k])
    finally:
        sim.CELLS_PER_WARP = keep
    best = {s: min(t) for s, t in times.items()}
    for s in args.shapes:
        print(f"{s:>2} cells a warp: kernel {best[s]:.1f} ms (runs "
              + ", ".join(f"{t:.1f}" for t in times[s])
              + f"), {len(grid) / best[s] * 1e3:.0f} cells/s, "
              f"{steps / best[s] * 1e3:.3e} events/s; the same bits",
              flush=True)
    print(json.dumps({"card": card, "cells": len(grid), "events": steps,
                      "grid_ms_by_cells_a_warp": best,
                      "main_path": keep,
                      "fastest": min(best, key=best.get)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
