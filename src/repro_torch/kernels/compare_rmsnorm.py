"""Time this checkout's ``rmsnorm`` against another checkout's on one card,
in turns, with each route of this checkout and the memory's practical
ceiling beside them.

    python3 -m repro_torch.kernels.compare_rmsnorm [--other OTHER/src]

``OTHER/src`` is the ``src`` directory of another checkout of this repo
(for example a parent commit unpacked with ``git archive``); each tree's
kernel is built from its own ``csrc/`` into its own build directory.
At ``chip_smoke.py``'s rmsnorm cases, in bf16 and f32, each tree's
kernel is held against this checkout's plain version and timed from a
CUDA graph of at least 16 calls cycling over argument sets that exceed
the L2, in the order other, this, this, other. Each tree's kernel is
launched through its own wrapper's launch function (``_launch``), not
through the custom op ``repro_torch::rmsnorm``: a process holds one
registration of an op name, the last tree's, so the op would run the
same kernel for both trees. Then, where a shape takes
both the ``"bulk"`` and the ``"vector"`` route (aligned rows of at most
512 bytes), each is launched directly and timed the same way; then
``torch.nn.functional.rms_norm``, and ``x.copy_`` into a fresh tensor of
x's shape: the bytes the kernel must move (x read once, the output
written once) moved by PyTorch's own copy kernel, the practical ceiling
of a kernel bound by them. Prints the card's name and power limit first,
one line per case, and a JSON line of the best time of each. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from . import rmsnorm as this_rms

# (rows, D, x's offset in elements): chip_smoke.py's RMS_CASES
CASES = [(8192, 1024, 0), (8192, 1280, 0), (8192, 2048, 0), (8192, 4096, 0),
         (8192, 5120, 0), (8192, 8192, 0), (327680, 128, 0), (4, 5120, 0),
         (31, 96, 0), (33, 50, 0), (8192, 1024, 1)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}    # chip_smoke.RMS_TOL
EPS = 1e-5
L2_BYTES = 50e6


def _load_other(src: Path):
    """The other tree's ``repro_torch.kernels.rmsnorm`` under an alias."""
    root = src / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        "other_kernels", root / "__init__.py",
        submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["other_kernels"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("other_kernels.rmsnorm")


def _graph_ms(fn, sets, reps: int = 3, calls: int = 16) -> float:
    sets = [sets[i % len(sets)] for i in range(max(calls, len(sets)))]
    for a in sets:                          # warm-up outside the capture
        fn(*a)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for a in sets:
            fn(*a)
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / len(sets))
    return best


def _check(what, got, want, tol: float) -> float:
    diff = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all() or \
            (diff - tol - tol * want.float().abs()).max().item() > 0:
        raise AssertionError(f"{what}: max |err| {diff.max().item():.3e} "
                             f"beyond {tol} abs + rel")
    return diff.max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="src directory of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_rmsnorm: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"this": this_rms}
    order = ("this",)
    if args.other is not None:
        trees["other"] = _load_other(args.other.resolve())
        order = ("other", "this", "this", "other")
    gen = torch.Generator(device="cuda").manual_seed(0)
    best: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).removeprefix("torch.")
        for N, D, off in CASES:
            size = torch.tensor([], dtype=dtype).element_size()
            n = max(2, min(16, math.ceil(2 * L2_BYTES / (N * D * size))))
            sets = [(torch.randn((N * D + off,), generator=gen,
                                 device="cuda").to(dtype)[off:].view(N, D),
                     torch.randn((D,), generator=gen, device="cuda")
                     .to(dtype)) for _ in range(n)]
            x, w = sets[0]
            want = this_rms.rmsnorm_plain(x, w, EPS)
            case = f"({N},{D}) offset {off} {dt}"
            times = {}
            for name in order:
                launch = trees[name]._launch
                _check(f"{name} {case}", launch(x, w, EPS), want,
                       TOL[dtype])
                ms = _graph_ms(lambda a, b: launch(a, b, EPS), sets)
                times[name] = min(times.get(name, math.inf), ms)
            if this_rms.route(x, w) == "vector":
                for kind in ("bulk", "vector"):
                    _check(f"{kind} {case}",
                           this_rms._launch(x, w, EPS, kind), want,
                           TOL[dtype])
                    times[kind] = _graph_ms(
                        lambda a, b, k=kind: this_rms._launch(a, b, EPS, k),
                        sets)
            times["F.rms_norm"] = _graph_ms(
                lambda a, b: F.rms_norm(a, (D,), b, EPS), sets)
            times["copy"] = _graph_ms(
                lambda a, b: torch.empty((N, D), dtype=dtype,
                                         device="cuda").copy_(a), sets)
            bound = (2 * N * D + D) * size / 3.35e12 * 1e3
            print(f"{case}: route {this_rms.route(x, w)}; "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items())
                  + f"; bound {bound:.4f} ms (bytes at 3.35 TB/s)",
                  flush=True)
            best.update({f"{case} | {k}": v for k, v in times.items()})
            del sets, x, w, want
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "best_ms": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
