#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and this checkout; it
imports nothing of JAX or of the JAX package. It

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds every kernel of the path from ``csrc/``;
2. holds each kernel against its plain PyTorch version on the card, at
   the serving path's shapes plus ragged and grouped cases, in bf16 and
   f32, and times kernel, plain version and library call (each captured
   in a CUDA graph over inputs that rotate past the 50 MB L2);
3. serves full-width granite-moe-1b-a400m in bf16 (random weights from a
   seed) at batch 4, prompt 64, gen 32 with ``moe_impl="kernel"``, counts
   the kernel launches of that run, then checks the result: the same
   prefill with ``moe_impl="einsum"`` (routing, each MoE block, last
   logits) and the reduced float32 config on the card against the host,
   and profiles a decode step;
4. prints the ``kernels`` JSON line and, last, the device JSON line.

Any failure raises and exits non-zero before the last line is printed.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,      # dense bf16 tensor cores
              torch.float32: 67e12}        # f32 outside the tensor cores
# tests/test_kernels.py's moe_gmm tolerances (atol = rtol)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
L2_BYTES = 50e6

# (label, Z = groups x experts, C, D, F, expert period)
GMM_CASES = [
    ("prefill gate/up", 32, 80, 1024, 512, 32),
    ("prefill down", 32, 80, 512, 1024, 32),
    ("decode gate/up", 32, 8, 1024, 512, 32),
    ("decode down", 32, 8, 512, 1024, 32),
    ("ragged", 2, 100, 48, 72, 2),
    ("ragged odd widths", 3, 33, 50, 70, 3),
    ("grouped G=2", 64, 80, 1024, 512, 32),
]
REPORT_CASE = ("decode gate/up", torch.bfloat16)   # 48 of 72 calls a step

ARCH = "granite-moe-1b-a400m"
BATCH, PROMPT, GEN, SEED = 4, 64, 32, 0
# Last-token logits, kernel vs einsum route, bf16 at full width, as the
# relative L2 norm of the difference. Where the two routes sum an expert
# product in another order (cuBLAS picks its own), they round 1 ulp apart
# in a few elements (each MoE block is held below at the bf16 kernel
# tolerance); a 1-ulp change flips near-tied top-k choices and capacity
# slots in later layers, and those flips grow through 24 layers. A wrong
# kernel gives a relative L2 near 1 or above.
LOGIT_REL_L2_TOL = 0.15


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def graph_ms(fn, arg_sets, reps: int = 3) -> float:
    """Device time of one call: ``fn`` over every argument set, captured
    once in a CUDA graph (no host gaps), replayed; the least of ``reps``
    timed replays over the number of calls."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for a in arg_sets:                  # warm-up outside the capture
            fn(*a)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for a in arg_sets:
            fn(*a)
    g.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / len(arg_sets))
    return best


def bound(Z, C, D, F, P, dtype):
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (Z * C * D + P * D * F + Z * C * F) * size
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * Z * C * D * F / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(gmm) -> dict:
    log("[kernels] moe_gmm vs its plain version on the card "
        "(tolerance: |k - p| <= tol + tol*|p|, tol f32 1e-4, bf16 3e-2)")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, Z, C, D, F, P in GMM_CASES:
            size = torch.tensor([], dtype=dtype).element_size()
            set_bytes = (Z * C * D + P * D * F) * size
            nsets = max(2, min(16, math.ceil(2 * L2_BYTES / set_bytes)))
            sets = [(torch.randn((Z, C, D), generator=g, device="cuda")
                     .to(dtype),
                     (torch.randn((P, D, F), generator=g, device="cuda")
                      / math.sqrt(D)).to(dtype)) for _ in range(nsets)]
            x, w = sets[0]
            got = gmm.moe_gmm(x, w, P)
            want = gmm.moe_gmm_plain(x, w, P)
            torch.cuda.synchronize()
            if got.shape != (Z, C, F) or not torch.isfinite(got).all():
                raise AssertionError(f"moe_gmm {label} {dtype}: bad output")
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            tol = TOL[dtype]
            excess = (diff - tol - tol * want.float().abs()).max().item()
            if excess > 0:
                raise AssertionError(
                    f"moe_gmm {label} {dtype}: max |err| {err:.3e} beyond "
                    f"tolerance {tol}")
            kern_ms = graph_ms(lambda a, b: gmm.moe_gmm(a, b, P), sets)
            plain_ms = graph_ms(lambda a, b: gmm.moe_gmm_plain(a, b, P), sets)
            if P == Z:
                lib = torch.bmm
            else:
                def lib(a, b, G=Z // P):
                    return torch.matmul(a.view(G, P, C, D), b)
            lib_ms = graph_ms(lib, sets)
            bound_ms, bound_by = bound(Z, C, D, F, P, dtype)
            dt = str(dtype).removeprefix("torch.")
            log(f"[kernels] {label:17s} {dt:8s} x({Z},{C},{D}) "
                f"w({P},{D},{F}): max|err| {err:.3e} (tol {tol}) "
                f"kernel_ms {kern_ms:.4f} plain_ms {plain_ms:.4f} "
                f"library_ms {lib_ms:.4f} bound_ms {bound_ms:.4f} "
                f"({bound_by}-bound)")
            results[(label, dtype)] = dict(
                shape=f"x({Z},{C},{D}) w({P},{D},{F}) {dt}",
                max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
            del sets, x, w, got, want
    return results


def decode_breakdown(model_lib, params, cfg, prompts, steps: int = 3):
    """Where a decode step's time goes: torch.profiler over ``steps``
    steps after the prefill and two warm steps; device kernels by name,
    the device's busy share of the wall time (which the profiler itself
    lengthens), and kernel launches per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    logits, caches = model_lib.prefill(params, cfg, prompts,
                                       max_len=PROMPT + steps + 2)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    for _ in range(2):
        logits, caches = model_lib.decode_step(params, cfg, caches, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, caches = model_lib.decode_step(params, cfg, caches, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        log("[profile] the profiler saw no device kernels: device busy share "
            "not measured")
        return
    busy, end = 0.0, -math.inf
    for s, t in sorted(spans):              # union of kernel intervals
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    busy_ms = busy / 1e3 / steps
    gmm_ms = sum(v for k, v in by_name.items() if "moe_gmm" in k) / 1e3 \
        / steps
    log(f"[profile] decode step under torch.profiler: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({100*busy_ms/wall_ms:.1f}%), "
        f"{len(spans)/steps:.0f} kernels/step, moe_gmm {gmm_ms:.3f} ms/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    for name, us in top:
        log(f"[profile]   {us/1e3/steps:8.3f} ms/step  {name[:90]}")


def serve_phase(gmm) -> int:
    from repro_torch import configs
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import model as model_lib

    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(ARCH), moe_impl="kernel")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.moe_num_experts} experts top-{cfg.moe_top_k}, "
        f"{nparams/1e9:.3f} B params in {cfg.dtype}, "
        f"init {time.perf_counter()-t0:.1f} s")
    prompts = make_prompts(cfg, BATCH, PROMPT, SEED)
    generate(cfg, params, prompts[:, :8], 2, dev)      # warm-up (cuBLAS)

    gmm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tokens, st = generate(cfg, params, prompts, GEN, dev)
    launches = gmm.launches
    expected = cfg.num_layers * 3 * GEN
    per_tok = st["decode_s"] / (GEN - 1)
    log(f"[serve] batch={BATCH} prompt={PROMPT} gen={GEN} "
        f"moe_impl=kernel: moe_gmm launches {launches} (expected "
        f"{cfg.num_layers} layers x 3 x {GEN} forwards = {expected})")
    log(f"[serve] prefill {st['prefill_s']*1e3:.3f} ms "
        f"({BATCH*PROMPT/st['prefill_s']:.1f} tok/s)")
    log(f"[serve] decode {per_tok*1e3:.3f} ms/token "
        f"({BATCH/per_tok:.1f} tok/s)")
    log(f"[serve] peak memory {torch.cuda.max_memory_allocated()/2**30:.3f} "
        "GiB")
    if launches != expected:
        raise AssertionError(f"moe_gmm launched {launches} times, expected "
                             f"{expected}")
    if tokens.shape != (BATCH, GEN) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {tokens.shape}")
    if st["length"] != PROMPT + GEN - 1:
        raise AssertionError(f"cache length {st['length']}")
    log(f"[serve] row 0 tokens: {tokens[0].tolist()}")
    decode_breakdown(model_lib, params, cfg, prompts.to(dev))

    # the same prefill through the einsum route: routing and logits; each
    # MoE block's input is captured so its routing can be recomputed
    captured, logits = {}, {}
    for impl in ("kernel", "einsum"):
        cfg_i = dataclasses.replace(cfg, moe_impl=impl)
        handles = [blk.ffn.register_forward_pre_hook(
            lambda mod, args, key=(impl, i): captured.__setitem__(
                key, args[0])) for i, blk in enumerate(params.blocks)]
        try:
            logits[impl], _ = model_lib.prefill(
                params, cfg_i, prompts.to(dev), max_len=PROMPT + GEN)
        finally:
            for h in handles:
                h.remove()
    same_layers, layer_err = 0, 0.0
    cfg_e = dataclasses.replace(cfg, moe_impl="einsum")
    with torch.no_grad():
        for i, blk in enumerate(params.blocks):
            hk, he = captured[("kernel", i)], captured[("einsum", i)]
            rk = blk.ffn.route_groups(hk.reshape(1, -1, cfg.d_model), cfg)
            re_ = blk.ffn.route_groups(he.reshape(1, -1, cfg.d_model), cfg)
            same = torch.equal(rk[0], re_[0]) and torch.equal(rk[1], re_[1])
            if i == 0 and not same:
                raise AssertionError("layer 0 routing differs between the "
                                     "kernel and einsum routes")
            same_layers += int(same)
            # in situ: this layer's MoE input from the kernel run through
            # both routes (same routing), elementwise within bf16 tolerance
            yk, _ = blk.ffn(hk, cfg)
            ye, _ = blk.ffn(hk, cfg_e)
            d = (yk.float() - ye.float()).abs()
            tol = TOL[torch.bfloat16]
            if (d - tol - tol * ye.float().abs()).max().item() > 0:
                raise AssertionError(f"layer {i}: MoE output of the kernel "
                                     "route disagrees with the einsum route")
            layer_err = max(layer_err, d.max().item())
    lk, le = logits["kernel"][:, 0], logits["einsum"][:, 0]
    if not (torch.isfinite(lk).all() and torch.isfinite(le).all()):
        raise AssertionError("non-finite logits")
    err = (lk - le).abs().max().item()
    rel = err / le.abs().max().item()
    rel_l2 = ((lk - le).norm() / le.norm()).item()
    agree = (lk.argmax(-1) == le.argmax(-1)).float().mean().item()
    log(f"[serve] MoE blocks on the same input, kernel vs einsum route: "
        f"max|diff| {layer_err:.4e} over {cfg.num_layers} layers (tol "
        f"{TOL[torch.bfloat16]} abs + rel)")
    log(f"[serve] prefill kernel vs einsum route end to end: layer-0 "
        f"routing identical; identical routing (expert and slot) in "
        f"{same_layers}/{cfg.num_layers} layers; last-token logits "
        f"max|diff| {err:.4e}, relative to max|logit| {rel:.4e}; relative "
        f"L2 {rel_l2:.4e} (tol {LOGIT_REL_L2_TOL}); argmax agreement "
        f"{agree:.2f}")
    if rel_l2 > LOGIT_REL_L2_TOL:
        raise AssertionError("kernel and einsum logits disagree")
    return launches


def reduced_phase() -> None:
    """Reduced float32 granite-moe: kernel route on the card against the
    plain route on the host, same weights, same prompts."""
    from repro_torch import configs
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import model as model_lib

    cfg = configs.get(ARCH).reduced()
    host = model_lib.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 "cpu")
    card = copy.deepcopy(host).to("cuda")
    prompts = make_prompts(cfg, 2, 16, SEED)
    cfg_k = dataclasses.replace(cfg, moe_impl="kernel")
    lk, _ = model_lib.prefill(card, cfg_k, prompts.cuda(), max_len=24)
    lh, _ = model_lib.prefill(host, cfg, prompts, max_len=24)
    err = (lk.cpu() - lh).abs().max().item()
    tk, _ = generate(cfg_k, card, prompts, 8, "cuda")
    th, _ = generate(cfg, host, prompts, 8, "cpu")
    log(f"[reduced] {cfg.name} f32: card kernel route vs host einsum "
        f"route: prefill logits max|diff| {err:.3e} (tol 1e-3); greedy "
        f"tokens identical: {torch.equal(tk, th)}")
    if err > 1e-3 or not torch.equal(tk, th):
        raise AssertionError("reduced model: card and host disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_gmm as gmm

    log(card_line())
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {', '.join(_build.SOURCES)} for sm_90a in "
        f"{time.perf_counter()-t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line.strip()}")

    results = kernel_phase(gmm)
    launches = serve_phase(gmm)
    reduced_phase()

    rep = results[REPORT_CASE]
    log(json.dumps({"kernels": [dict(
        name="moe_gmm", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:43",
        launches=launches, **rep)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
