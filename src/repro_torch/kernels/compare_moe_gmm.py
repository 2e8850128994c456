"""Time this checkout's ``moe_gmm`` kernels against another checkout's on
one card, in turns.

    python3 -m repro_torch.kernels.compare_moe_gmm --other OTHER/src

``OTHER/src`` is the ``src`` directory of another checkout of this repo
(for example a parent commit unpacked with ``git archive``). Each tree's
``moe_gmm`` is built from its own ``csrc/`` into its own build directory.
At the serving and training shapes in bf16, both kernels are held against
this checkout's plain version, then timed in the order other, this, this,
other: the forward from a CUDA graph over argument sets that exceed the
L2, the backward (dx and dw) by CUDA events around 5 calls after a
warm-up. Prints the card's name and power limit first, one line per shape
and tree, and a JSON line of the best time of each. Needs a CUDA card.
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

from . import moe_gmm as this_gmm

# (label, Z = groups x experts, C, D, F, expert period): chip_smoke.py's
# serving and training shapes
SHAPES = [
    ("prefill gate/up", 32, 80, 1024, 512, 32),
    ("prefill down", 32, 80, 512, 1024, 32),
    ("train gate/up", 64, 1280, 1024, 512, 32),
    ("train down", 64, 1280, 512, 1024, 32),
]
BWD = {"train gate/up", "train down"}
TOL = 3e-2                                 # bf16, tests/test_kernels.py
L2_BYTES = 50e6


def _load_other(src: Path):
    """The other tree's ``repro_torch.kernels.moe_gmm`` under an alias."""
    root = src / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        "other_kernels", root / "__init__.py",
        submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["other_kernels"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("other_kernels.moe_gmm")


def _graph_ms(fn, sets, reps: int = 3) -> float:
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


def _event_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _check(what, got, want) -> float:
    diff = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all() or \
            (diff - TOL - TOL * want.float().abs()).max().item() > 0:
        raise AssertionError(f"{what}: max |err| {diff.max().item():.3e} "
                             f"beyond {TOL} abs + rel")
    return diff.max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="src directory of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_moe_gmm: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"other": _load_other(args.other.resolve()), "this": this_gmm}
    gen = torch.Generator(device="cuda").manual_seed(0)
    best: dict = {}
    for label, Z, C, D, F, P in SHAPES:
        nbytes = (Z * C * D + P * D * F) * 2
        sets = [(torch.randn((Z, C, D), generator=gen, device="cuda")
                 .bfloat16(),
                 (torch.randn((P, D, F), generator=gen, device="cuda")
                  / math.sqrt(D)).bfloat16())
                for _ in range(max(2, min(16, math.ceil(2 * L2_BYTES
                                                         / nbytes))))]
        x, w = sets[0]
        gy = torch.randn((Z, C, F), generator=gen, device="cuda").bfloat16()
        want = this_gmm.moe_gmm_plain(x, w, P)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        dwant = torch.autograd.grad(this_gmm.moe_gmm_plain(xr, wr, P),
                                    (xr, wr), gy)
        flops = 2.0 * Z * C * D * F
        for turn, name in enumerate(("other", "this", "this", "other")):
            gmm = trees[name]
            err = _check(f"{name} {label} forward", gmm.moe_gmm(x, w, P),
                         want)
            ms = _graph_ms(lambda a, b: gmm.moe_gmm(a, b, P), sets)
            line = (f"{label:16s} {name:5s} turn {turn}: forward {ms:.4f} "
                    f"ms {flops / ms / 1e9:.1f} TFLOP/s (max|err| "
                    f"{err:.3e})")
            best[(label, name, "fwd")] = min(
                best.get((label, name, "fwd"), math.inf), ms)
            if label in BWD:
                dx, dw = gmm.moe_gmm_bwd(x, w, gy, P)
                err = max(_check(f"{name} {label} dx", dx, dwant[0]),
                          _check(f"{name} {label} dw", dw, dwant[1]))
                bms = _event_ms(lambda: gmm.moe_gmm_bwd(x, w, gy, P))
                line += (f"; backward {bms:.4f} ms {2 * flops / bms / 1e9:.1f}"
                         f" TFLOP/s (max|err| {err:.3e})")
                best[(label, name, "bwd")] = min(
                    best.get((label, name, "bwd"), math.inf), bms)
            print(line, flush=True)
        del sets, x, w, gy, want, xr, wr, dwant
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "best_ms": {
        " | ".join(k): v for k, v in best.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
