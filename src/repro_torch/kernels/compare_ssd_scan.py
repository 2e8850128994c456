"""Time this checkout's ``ssd_scan`` kernels against another checkout's on
one card, in turns.

    python3 -m repro_torch.kernels.compare_ssd_scan --other OTHER/src

``OTHER/src`` is the ``src`` directory of another checkout of this repo
(for example a parent commit unpacked with ``git archive``). Each tree's
``ssd_scan`` is built from its own ``csrc/`` into its own build directory
and called through its own low-level entry points with the states kept
for the backward, as the training path calls it. At the training shape
of mamba2-1.3b (batch 2 x 4096, 64 heads of 64, one group, state 128,
chunk 128), in bf16 and in f32, and at that shape with its widths off
a multiple of 16 in bf16 (P 56, N 120: TMA's bounds pad them; P 50, N
100: the edge loads), both trees are held against this checkout's plain
version, then timed in the order other, this, this, other: the forward
from a CUDA graph over argument sets that exceed the L2, the backward by
CUDA events around 5 calls after a warm-up; then this tree's forward and
backward once more under torch.profiler, device time by kernel. Prints
the card's name and power limit first, one line per tree and turn, the
kernels' times, and a JSON line of the best time of each. Needs a CUDA
card.
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

from . import ssd_scan as this_ssd

# (label, (B, S, H, P, G, N, chunk), dtypes): chip_smoke.py's training
# shape, and the same with P and N off a multiple of 16
CASES = [
    ("train", (2, 4096, 64, 64, 1, 128, 128),
     (torch.bfloat16, torch.float32)),
    ("train P 56 N 120", (2, 4096, 64, 56, 1, 120, 128), (torch.bfloat16,)),
    ("train P 50 N 100", (2, 4096, 64, 50, 1, 100, 128), (torch.bfloat16,)),
]
# tests/test_kernels.py's SSD tolerances (rtol, atol; gradients atol x
# their largest element)
TOL = {torch.bfloat16: (3e-2, 3e-2), torch.float32: (2e-3, 2e-4)}
L2_BYTES = 50e6


def _load_other(src: Path):
    """The other tree's ``repro_torch.kernels.ssd_scan`` under an alias."""
    root = src / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        "other_kernels", root / "__init__.py",
        submodule_search_locations=[str(root)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["other_kernels"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("other_kernels.ssd_scan")


def _entry_points(mod, chunk: int):
    """(forward, backward) of a tree: trees before the tensor-core route
    take the kernel's chunk rows where later ones take the chunk."""
    rows = chunk if hasattr(mod, "route") else mod.kernel_chunk(chunk)

    def fwd(x, a, b, c):
        return mod.ssd_scan_fwd(x, a, b, c, rows, True)

    def bwd(x, a, b, c, saved, gy, gh):
        return mod.ssd_scan_bwd(x, a, b, c, saved, gy, gh, rows)
    return fwd, bwd


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


def _by_kernel(fn, reps: int = 5) -> dict:
    """Device ms of one call of ``fn`` by kernel name, from torch.profiler
    over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + e.device_time / reps / 1e3
    return out


def _check(what, got, want, tol, scale: float = 1.0) -> float:
    rtol, atol = tol
    diff = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all() or \
            (diff - atol * scale - rtol * want.float().abs()).max().item() > 0:
        raise AssertionError(f"{what}: max |err| {diff.max().item():.3e} "
                             f"beyond rtol {rtol} atol {atol * scale:.3e}")
    return diff.max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="src directory of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_ssd_scan: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"other": _load_other(args.other.resolve()), "this": this_ssd}
    gen = torch.Generator(device="cuda").manual_seed(0)
    best: dict = {}
    for label, (B, S, H, P, G, N, chunk), dtype in (
            (lbl, shape, dt) for lbl, shape, dts in CASES for dt in dts):
        decay = torch.exp(torch.linspace(0.0, math.log(16.0), H,
                                         device="cuda"))

        def draw():
            x = (torch.randn((B, S, H, P), generator=gen, device="cuda")
                 * 0.5).to(dtype)
            a = -F.softplus(torch.randn((B, S, H), generator=gen,
                                        device="cuda")) * decay
            b, c = ((torch.randn((B, S, G, N), generator=gen, device="cuda")
                     * 0.5).to(dtype) for _ in range(2))
            return x, a, b, c
        size = torch.tensor([], dtype=dtype).element_size()
        nbytes = (2 * B * S * H * P + 2 * B * S * G * N) * size
        sets = [draw() for _ in range(max(2, math.ceil(2 * L2_BYTES
                                                        / nbytes)))]
        x, a, b, c = sets[0]
        gy = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dtype)
        gh = torch.randn((B, H, N, P), generator=gen, device="cuda")
        rs = [t.float().requires_grad_() for t in (x, a, b, c)]
        ry, rh = this_ssd.ssd_scan_plain(*rs, chunk=chunk)
        want = torch.autograd.grad((ry, rh), rs, (gy.float(), gh))
        ry, rh = ry.detach(), rh.detach()
        del rs
        tol, dt = TOL[dtype], str(dtype).removeprefix("torch.")
        for turn, name in enumerate(("other", "this", "this", "other")):
            fwd, bwd = _entry_points(trees[name], chunk)
            y, hT, saved = fwd(x, a, b, c)
            err = max(_check(f"{name} y", y, ry, tol),
                      _check(f"{name} state", hT, rh, tol))
            grads = bwd(x, a, b, c, saved, gy, gh)
            berr = max(_check(f"{name} d{n}", u, v, tol, v.abs().max().item())
                       for n, u, v in zip("xabc", grads, want))
            del y, hT, grads
            fms = _graph_ms(fwd, sets)
            bms = _event_ms(lambda: bwd(x, a, b, c, saved, gy, gh))
            del saved
            torch.cuda.empty_cache()
            print(f"{label} {dt:8s} {name:5s} turn {turn}: forward "
                  f"{fms:.4f} ms (max|err| {err:.3e}); backward {bms:.4f} ms "
                  f"(max|err| {berr:.3e})", flush=True)
            for k, v in (("fwd", fms), ("bwd", bms)):
                key = (label, dt, name, k)
                best[key] = min(best.get(key, math.inf), v)
        fwd, bwd = _entry_points(this_ssd, chunk)
        saved = fwd(x, a, b, c)[2]
        for k, fn in (("forward", lambda: fwd(x, a, b, c)),
                      ("backward", lambda: bwd(x, a, b, c, saved, gy, gh))):
            print(f"{label} {dt:8s} this  {k} by kernel: " + ", ".join(
                f"{n} {v:.4f} ms" for n, v in _by_kernel(fn).items()),
                flush=True)
        del sets, x, a, b, c, gy, gh, ry, rh, want, saved
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "best_ms": {
        " | ".join(k): v for k, v in best.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
