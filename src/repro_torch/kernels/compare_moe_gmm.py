"""Time this checkout's ``moe_gmm`` kernels against another checkout's on
one card, in turns.

    python3 -m repro_torch.kernels.compare_moe_gmm --other OTHER/src

``OTHER/src`` is the ``src`` directory of another checkout of this repo
(for example a parent commit unpacked with ``git archive``). Each tree's
``moe_gmm`` is built from its own ``csrc/`` into its own build directory.
At the serving (prefill and decode) and training shapes in bf16, and the
training gate/up in f32, both kernels are held against this checkout's
plain version (f32: against the plain arithmetic in float64), then timed
in the order other, this, this, other: the forward from a CUDA graph of
at least 16 calls cycling over argument sets that exceed the L2 (so the
graph's own launch, some microseconds, is spread over 16 calls and not
over the two or three sets a decode shape needs), the backward (dx and
dw) by CUDA events around 5 calls after a warm-up; then the library call
(``torch.bmm``, or ``torch.matmul`` over the groups) the same way as the
forward, and for the backward its two products (``torch.matmul`` for dx,
and for dw summed over the groups) the same way as the backward, with
TF32 off. The training shapes run also with D and F off a multiple of 8
(1020 and 510: the edge route's loads). Prints the card's name and power limit first, one line per shape
and tree, and a JSON line of the best time of each. Needs a CUDA card.
Each tree's forward is launched through its own wrapper's ``_launch``,
not through the custom op ``repro_torch::moe_gmm``: a process holds one
registration of an op name, the last tree's, so the op would run the
same kernel for both trees (the backward, ``moe_gmm_bwd``, launches
directly).
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

# (label, Z = groups x experts, C, D, F, expert period, dtype):
# chip_smoke.py's serving and training shapes
SHAPES = [
    ("prefill gate/up", 32, 80, 1024, 512, 32, torch.bfloat16),
    ("prefill down", 32, 80, 512, 1024, 32, torch.bfloat16),
    ("decode gate/up", 32, 8, 1024, 512, 32, torch.bfloat16),
    ("decode down", 32, 8, 512, 1024, 32, torch.bfloat16),
    ("train gate/up", 64, 1280, 1024, 512, 32, torch.bfloat16),
    ("train down", 64, 1280, 512, 1024, 32, torch.bfloat16),
    ("train gate/up", 64, 1280, 1024, 512, 32, torch.float32),
    ("train gate/up odd", 64, 1280, 1020, 510, 32, torch.bfloat16),
    ("train down odd", 64, 1280, 510, 1020, 32, torch.bfloat16),
]
BWD = {"train gate/up", "train down", "train gate/up odd", "train down odd"}
# tests/test_kernels.py's tolerances (atol = rtol)
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
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


def _check(what, got, want, tol: float) -> float:
    diff = (got.double() - want.double()).abs()
    if not torch.isfinite(got.float()).all() or \
            (diff - tol - tol * want.double().abs()).max().item() > 0:
        raise AssertionError(f"{what}: max |err| {diff.max().item():.3e} "
                             f"beyond {tol} abs + rel")
    return diff.max().item()


def _reference(x, w, P, gy):
    """The output and (dx, dw): the plain version and its autograd for
    bf16 inputs; for f32 inputs its arithmetic in float64 (an f32 sum at
    the training dw's depth is itself off the exact one by more than
    1e-4)."""
    if x.dtype == torch.float32:
        x, w, gy = x.double(), w.double(), gy.double()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    if x.dtype == torch.float64:
        Z, C, D = x.shape
        out = torch.matmul(xr.view(Z // P, P, C, D), wr).view(Z, C, -1)
    else:
        out = this_gmm.moe_gmm_plain(xr, wr, P)
    grads = torch.autograd.grad(out, (xr, wr), gy)
    return out.detach(), grads


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
    for label, Z, C, D, F, P, dtype in SHAPES:
        size = torch.tensor([], dtype=dtype).element_size()
        nbytes = (Z * C * D + P * D * F) * size
        sets = [(torch.randn((Z, C, D), generator=gen, device="cuda")
                 .to(dtype),
                 (torch.randn((P, D, F), generator=gen, device="cuda")
                  / math.sqrt(D)).to(dtype))
                for _ in range(max(2, min(16, math.ceil(2 * L2_BYTES
                                                         / nbytes))))]
        x, w = sets[0]
        gy = torch.randn((Z, C, F), generator=gen, device="cuda").to(dtype)
        want, dwant = _reference(x, w, P, gy)
        tol, dt = TOL[dtype], str(dtype).removeprefix("torch.")
        flops = 2.0 * Z * C * D * F
        for turn, name in enumerate(("other", "this", "this", "other")):
            gmm = trees[name]
            err = _check(f"{name} {label} {dt} forward",
                         gmm._launch(x, w, P), want, tol)
            ms = _graph_ms(lambda a, b: gmm._launch(a, b, P), sets)
            line = (f"{label:16s} {dt:8s} {name:5s} turn {turn}: forward "
                    f"{ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s (max|err| "
                    f"{err:.3e})")
            key = (label, dt, name)
            best[key + ("fwd",)] = min(best.get(key + ("fwd",), math.inf), ms)
            if label in BWD:
                dx, dw = gmm.moe_gmm_bwd(x, w, gy, P)
                err = max(_check(f"{name} {label} {dt} dx", dx, dwant[0],
                                 tol),
                          _check(f"{name} {label} {dt} dw", dw, dwant[1],
                                 tol))
                del dx, dw
                bms = _event_ms(lambda: gmm.moe_gmm_bwd(x, w, gy, P))
                line += (f"; backward {bms:.4f} ms {2 * flops / bms / 1e9:.1f}"
                         f" TFLOP/s (max|err| {err:.3e})")
                best[key + ("bwd",)] = min(best.get(key + ("bwd",), math.inf),
                                           bms)
            print(line, flush=True)
        if P == Z:
            lib = torch.bmm
        else:
            def lib(a, b, G=Z // P):
                return torch.matmul(a.view(G, P, C, D), b)
        torch.backends.cuda.matmul.allow_tf32 = False
        ms = _graph_ms(lib, sets)
        line = f"{label:16s} {dt:8s} library forward {ms:.4f} ms"
        best[(label, dt, "library", "fwd")] = ms
        if label in BWD:
            G = Z // P
            bms = _event_ms(lambda: (
                torch.matmul(gy.view(G, P, C, F), w.transpose(1, 2)),
                torch.matmul(x.view(G, P, C, D).transpose(2, 3),
                             gy.view(G, P, C, F)).sum(0)))
            line += f"; backward {bms:.4f} ms"
            best[(label, dt, "library", "bwd")] = bms
        print(line, flush=True)
        del sets, x, w, gy, want, dwant
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "best_ms": {
        " | ".join(k): v for k, v in best.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
