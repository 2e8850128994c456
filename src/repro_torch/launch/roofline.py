"""Roofline of the port's dry run on the NVIDIA H100: three floors per
cell, in seconds a step (port of ``benchmarks/roofline.py``).

Sources:

* the dry run's records (``artifacts/dryrun_torch/<cell>.json``,
  ``launch/dryrun.py``). Their FLOPs are counted op by op while the step
  runs once on placeholder ranks, each op as often as it runs (the
  JAX package's XLA counts a loop body once, so its roofline prices
  closed forms instead): here they are the step's own, by the dtype of
  each op. Their collectives give the share of wire bytes whose group
  spans an 8-card host;
* closed forms from the configs (:func:`analytic_terms`, the JAX
  package's, against the port's configs and parameter counts): the HBM
  bytes a step moves (the dry run counts none), the collective bytes an
  ideal schedule sends, the model FLOPs (6 or 2 × active parameters ×
  tokens) and a closed-form FLOP count beside the record's.

The H100's rates, from NVIDIA's data sheet (SXM part, dense, at its 700 W
limit), not measured here:

    compute_s    = Σ_dtype flops(dtype) / peak(dtype)   989e12 bf16,
                                                         67e12 f32
    memory_s     = hbm_bytes / 3.35e12
    collective_s = intra-host bytes / 450e9 + cross-host bytes / 50e9

NVLink moves 450 GB/s each way per card between the 8 cards of a host;
between hosts a card has one 400 Gb/s NDR link, 50 GB/s: both are
spec-sheet figures, not measured. The floor of a cell is the largest of
the three: accounting at spec-sheet rates, not a measurement.

    PYTHONPATH=src python -m repro_torch.launch.roofline
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import math
import os

from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.launch.dryrun import ARTIFACTS, FACTORED_OPT

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NET_BW", "OUT",
           "analytic_terms", "cell_roofline", "analyze", "markdown_table",
           "main"]

# NVIDIA H100 SXM data sheet (dense, 700 W): spec-sheet, not measured
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
NVLINK_BW = 450e9       # per card, each way, within an 8-card host
NET_BW = 50e9           # per card between hosts: one 400 Gb/s NDR link

OUT = os.path.normpath(os.path.join(ARTIFACTS, "..", "roofline_torch.json"))


# ----------------------------------------------------------------------
# closed forms per cell
# ----------------------------------------------------------------------

def _mesh_dims(mesh) -> dict:
    """"single" (16, 16), "multi" (2, 16, 16) or a mesh shape: devices,
    the data-parallel ways (pod × data), the model axis and the pods."""
    shape = tuple({"single": (16, 16), "multi": (2, 16, 16)}[mesh]
                  if isinstance(mesh, str) else mesh)
    devices, tp = math.prod(shape), shape[-1]
    return dict(devices=devices, dp=devices // tp, tp=tp,
                pods=shape[0] if len(shape) == 3 else 1)


@functools.lru_cache(maxsize=64)
def _counts(cfg) -> tuple[int, int]:
    """(parameters, active parameters) of a config, on the meta device."""
    from repro_torch.models import model as model_lib
    return model_lib.param_count(cfg), model_lib.active_param_count(cfg)


def analytic_terms(arch: str, shape_name: str, mesh, micro: int,
                   cfg_overrides: dict | None = None,
                   grad_bytes: float = 4.0,
                   shape: ShapeSpec | None = None) -> dict:
    """Closed-form FLOPs, HBM bytes and collective bytes per device per
    step (the JAX package's ``analytic_terms``). ``mesh``: "single",
    "multi" or a mesh shape, down to one card (1, 1); ``shape`` in place
    of ``SHAPES[shape_name]`` (a card's cut batch). ``coll_bytes`` is
    every collective byte; ``cross_bytes`` the share that must cross
    pods (the pod axis's gradient sync), a floor on what crosses hosts."""
    cfg = configs.get(arch)
    overridden = set()
    if cfg_overrides:
        ov = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg_overrides.items() if hasattr(cfg, k)}
        overridden = set(ov)
        cfg = dataclasses.replace(cfg, **ov)
    shape = shape or configs.SHAPES[shape_name]
    m = _mesh_dims(mesh)
    dev, dp, tp, pods = m["devices"], m["dp"], m["tp"], m["pods"]

    N_total, N_active = _counts(cfg)
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    tokens = B * S if kind != "decode" else B

    L_attn = cfg.repeats * sum(1 for k, _ in cfg.pattern if k == "attn")
    L_cross = cfg.repeats * sum(1 for k, _ in cfg.pattern if k == "cross")
    L_mamba = cfg.repeats * sum(1 for k, _ in cfg.pattern if k == "mamba")
    d_attn = cfg.num_heads * cfg.head_dim

    # ---- FLOPs ------------------------------------------------------
    if kind == "train":
        remat = 1.5 if len(cfg.pattern) > 1 else 4.0 / 3.0  # nested remat
        flops = 6.0 * N_active * tokens * remat
        # causal attention: fwd 2·S²·d (qk+pv halved by causality), ×3
        # for the backward and the recompute
        flops += 3.0 * 2.0 * B * S * S * d_attn * L_attn
        flops += 3.0 * 4.0 * B * S * cfg.num_media_tokens * d_attn * L_cross
    elif kind == "prefill":
        flops = 2.0 * N_active * tokens
        flops += 2.0 * B * S * S * d_attn * L_attn
        flops += 4.0 * B * S * cfg.num_media_tokens * d_attn * L_cross
    else:  # decode: one token against an S-long cache / SSM state
        flops = 2.0 * N_active * B
        flops += 4.0 * B * S * d_attn * L_attn
        if L_mamba:
            d_inner = cfg.ssm_expand * cfg.d_model
            H = d_inner // cfg.ssm_head_dim
            flops += 4.0 * B * H * cfg.ssm_state * cfg.ssm_head_dim * L_mamba
    flops_dev = flops / dev

    # ---- HBM bytes --------------------------------------------------
    pb = 2.0 * N_total  # bf16 param bytes (global)
    factored = arch in FACTORED_OPT
    if kind == "train":
        # weights: fwd + remat + bwd reads; grads f32 RW; m RW; v RW
        w_traffic = 3 * pb
        g_traffic = 2 * 4.0 * N_total
        m_bytes = 2.0 * N_total if factored else 4.0 * N_total
        v_bytes = 0.1 * N_total if factored else 4.0 * N_total
        o_traffic = 2 * (m_bytes + v_bytes) + 2 * pb  # states RW, params RW
        act = 16.0 * tokens * cfg.d_model * 2.0       # streamed activations
        bytes_dev = (w_traffic + g_traffic + o_traffic + act) / dev
    elif kind == "prefill":
        act = 8.0 * tokens * cfg.d_model * 2.0
        kv = 2.0 * tokens * cfg.num_kv_heads * cfg.kv_repeat \
            * cfg.head_dim * 2.0 * L_attn
        bytes_dev = (pb + act + kv) / dev
    else:
        # decode reads all (active) weights once + the whole KV cache
        kv = 2.0 * B * S * cfg.num_kv_heads * cfg.head_dim * 2.0 * L_attn
        kv *= _kv_rep(cfg, tp, overridden)
        ssm = 0.0
        if L_mamba:
            d_inner = cfg.ssm_expand * cfg.d_model
            H = d_inner // cfg.ssm_head_dim
            ssm = 4.0 * B * H * cfg.ssm_state * cfg.ssm_head_dim * L_mamba
        bytes_dev = (2.0 * N_active * _moe_read_frac(cfg) + kv + ssm) / dev

    # ---- collective bytes -------------------------------------------
    total = cross = 0.0
    D = cfg.d_model
    if kind == "train":
        # ZeRO-3 regather per microbatch (fwd + bwd) over the data axis
        gather = 2.0 * micro * (pb / tp) * (dp - 1) / dp
        # grad sync: reduce-scatter + all-gather of grads over DP
        gsync = 2.0 * grad_bytes * N_total / tp * (dp - 1) / dp
        # Megatron-style TP all-reduces: 2 fwd + 2 bwd (+1 remat) a layer
        tp_ar = 5.0 * 2.0 * (tokens / dp) * D * 2.0 \
            * cfg.num_layers * (tp - 1) / tp
        if cfg.sharding_profile == "ep_only":
            tp_ar = 0.0   # no tensor parallelism: dense weights FSDP-only
            # but FSDP now spans dp·tp devices → regathers cost more
            gather = 2.0 * micro * pb * (dp * tp - 1) / (dp * tp)
        elif cfg.sharding_profile == "ep_replicated":
            # dense replicated (no gathers, AR grads over all devices);
            # experts sharded (model × data): regathered per microbatch
            dense = _dense_params(cfg)
            n_exp = 2.0 * (N_total - dense)
            tp_ar = 0.0
            gather = 2.0 * micro * (n_exp / tp) * (dp - 1) / dp
            gsync = 2.0 * grad_bytes * (dense + (N_total - dense) / tp) \
                * (dp - 1) / dp
        # MoE all-to-all: dispatch + combine, fwd+bwd (tokens·D each way),
        # over the model axis that holds the experts (none on one card)
        a2a = 0.0
        if cfg.moe_num_experts and tp > 1:
            L_moe = cfg.repeats * sum(1 for _, f in cfg.pattern
                                      if f == "moe")
            a2a = 4.0 * (tokens / dp) * D * 2.0 * L_moe
        total = gather + gsync + tp_ar + a2a
        if pods > 1:
            # the pod axis is pure DP: the cross-pod share of grad sync
            cross = grad_bytes * N_total / tp / pods
    elif kind == "prefill":
        tp_ar = 2.0 * 2.0 * (tokens / dp) * D * 2.0 * cfg.num_layers \
            * (tp - 1) / tp
        if cfg.sharding_profile == "ep_only":
            tp_ar = 0.0
        a2a = 0.0
        if cfg.moe_num_experts and tp > 1:
            L_moe = cfg.repeats * sum(1 for _, f in cfg.pattern
                                      if f == "moe")
            a2a = 2.0 * (tokens / dp) * D * 2.0 * L_moe
        total = tp_ar + a2a
    else:
        rows_dev = B / min(dp, B)
        total = 2.0 * 2.0 * rows_dev * D * 2.0 * cfg.num_layers \
            * (tp - 1) / tp
    return dict(flops_dev=flops_dev, bytes_dev=bytes_dev,
                coll_bytes=total, cross_bytes=cross,
                model_flops_dev=(6.0 if kind == "train" else 2.0)
                * N_active * tokens / dev)


def _dense_params(cfg) -> float:
    nt, na = _counts(cfg)
    # expert params = total - active-adjusted share; dense ≈ the rest
    exp_total = (nt - na) / (1 - cfg.moe_top_k / max(cfg.moe_num_experts, 1)) \
        if cfg.moe_num_experts else 0.0
    return max(nt - exp_total, 0.0)


def _kv_rep(cfg, tp, overridden=()) -> float:
    """Effective stored-head replication. The launcher (adapt_config)
    infers it per mesh; an explicit override pins it."""
    if "kv_repeat" in overridden or cfg.kv_repeat > 1:
        return float(cfg.kv_repeat)
    kv = cfg.num_kv_heads
    if cfg.num_heads > 1 and kv < tp and tp % kv == 0 \
            and cfg.num_heads % (kv * (tp // kv)) == 0:
        return tp / kv
    return 1.0


def _moe_read_frac(cfg) -> float:
    """Decode batches re-read most experts: with B tokens over E experts,
    expected touched experts ≈ E·(1-(1-k/E)^B) → weight reads exceed the
    per-token active fraction. Approximate with full expert reads when
    B ≥ E (the decode_32k cells)."""
    if not cfg.moe_num_experts:
        return 1.0
    nt, na = _counts(cfg)
    return nt / na  # active→total correction (B=128 ≥ E for our cells)


# ----------------------------------------------------------------------
# a record's floors
# ----------------------------------------------------------------------

def cell_roofline(rec: dict) -> dict | None:
    """The three floors of one dry-run record (None unless it is "ok"):
    compute from the record's FLOPs by dtype, memory from the closed
    form's bytes, collectives from the closed form's bytes split between
    NVLink and the network by the record's cross-host share of wire
    bytes (at least the closed form's cross-pod share)."""
    if rec.get("status") != "ok":
        return None
    gb = 2.0 if rec.get("grad_acc_dtype") == "bfloat16" else 4.0
    shape = ShapeSpec(rec["shape"], rec["seq_len"], rec["global_batch"],
                      rec["kind"])
    a = analytic_terms(rec["arch"], rec["shape"], rec["mesh_shape"],
                       rec.get("microbatches", 1),
                       cfg_overrides=rec.get("cfg_overrides"),
                       grad_bytes=gb, shape=shape)

    colls = rec.get("collectives") or {}
    wire = sum(v["wire_bytes"] for v in colls.values())
    x_wire = sum(v.get("cross_host_wire_bytes", 0) for v in colls.values())
    total = a["coll_bytes"]
    cross = max(a["cross_bytes"], total * x_wire / wire if wire else 0.0)

    by_dtype = rec["cost"].get("flops_by_dtype") or {
        "bfloat16": rec["cost"]["flops_per_device"]}
    compute_s = sum(n / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
                    for dt, n in by_dtype.items())
    terms = dict(compute_s=compute_s, memory_s=a["bytes_dev"] / HBM_BW,
                 collective_s=(total - cross) / NVLINK_BW + cross / NET_BW)
    floor_s = max(terms.values())
    flops = rec["cost"]["flops_per_device"]
    return dict(
        cell=f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"
             + (f"|{rec['variant']}" if rec.get("variant") else ""),
        kind=rec["kind"], mesh_shape=rec["mesh_shape"],
        **terms,
        floor_s=floor_s,
        dominant=max(terms, key=terms.get),
        flops_per_device=flops,
        analytic_flops_per_device=a["flops_dev"],
        analytic_compute_s=a["flops_dev"] / PEAK_FLOPS["bfloat16"],
        model_flops_per_device=a["model_flops_dev"],
        useful_flops_ratio=a["model_flops_dev"] / flops if flops else 0.0,
        roofline_fraction=(a["model_flops_dev"] / PEAK_FLOPS["bfloat16"])
        / floor_s if floor_s else 0.0,
        collective_bytes=total, cross_host_bytes=cross,
        peak_gib=rec["memory"]["peak_bytes"] / 2**30,
    )


def analyze(art: str | None = None, out: str | None = OUT,
            cells=None) -> list[dict]:
    """``cell_roofline`` of every record in ``art`` (the dry run's
    directory by default), or of those whose (arch, shape, mesh) is in
    ``cells``; the rows are written to ``out`` (None: not written)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(art or ARTIFACTS, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if cells is not None and (rec.get("arch"), rec.get("shape"),
                                  rec.get("mesh")) not in cells:
            continue
        r = cell_roofline(rec)
        if r:
            rows.append(r)
    if out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| cell | kind | compute s | memory s | collective s | floor s "
           "| dominant | model/counted FLOPs | roofline frac | peak GiB |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    return hdr + "\n".join(
        f"| {r['cell']} | {r['kind']} | {r['compute_s']:.4f} | "
        f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
        f"{r['floor_s']:.4f} | {r['dominant'].removesuffix('_s')} | "
        f"{r['useful_flops_ratio']:.3f} | {r['roofline_fraction']:.3f} | "
        f"{r['peak_gib']:.2f} |" for r in rows)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default=None,
                    help="directory of dry-run records (default: the dry "
                         "run's own)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    print(markdown_table(analyze(args.artifacts, args.out)))


if __name__ == "__main__":
    main()
