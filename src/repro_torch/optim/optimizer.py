"""Optimizer substrate (port of ``repro/optim/optimizer.py``): AdamW with a
cosine schedule, gradient accumulation, int8 gradient compression with
error feedback.

Plain functions on dicts of tensors (``dict(model.named_parameters())``),
not ``torch.optim.AdamW``, so the arithmetic is the JAX package's: clip
first, the schedule and bias corrections at ``count + 1``, decoupled
weight decay on leaves of rank >= 2 only, update math in f32 cast back to
each parameter's dtype. Where JAX returns new parameters,
``adamw_update`` writes them into the given tensors in place under
``torch.no_grad()`` (one copy of the weights on the card instead of two);
the values are the same. Scalars of the schedule are computed in float32,
as JAX computes them, and then applied as Python floats that hold those
f32 values.

Ranks are those of the JAX tree. JAX stacks each pattern slot's
per-layer weights on a leading ``repeats`` axis, so a per-layer leaf
(``blocks.<layer>.<path>`` here) has rank one more than the port's
tensor: its vectors (norm weights, biases, Mamba2's ``A_log``...) are
decayed and, under ``factored``, factored across the slot's layers, with
``vr`` of shape (R,) and ``vc`` of shape (D,) kept under the key
``slot<si>.<path>``. ``adamw_init(..., period=len(cfg.pattern))`` records
that layout in the state (``stacked``: slot key -> the R layer names in
repeat order); names outside ``blocks.`` are top-level leaves, as in
JAX.

Parameters may be DTensors (``launch/shardings.py``). A gradient can
come back with other placements than its parameter (``Partial`` where
the parameter is ``Shard``): every gradient is redistributed to its
parameter's placements before it is accumulated or applied, and each new
value to its target's before it is written in place. The global norm is
then a reduction over all shards.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "stacked_layout", "slot_of", "factored_slots",
           "global_norm", "clip_by_global_norm", "accumulate_gradients",
           "compress_int8", "decompress_int8", "CompressionState",
           "compressed_gradients"]

Tensors = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # Adafactor-style factored second moment (row/col stats) and the
    # dtype of the first moment, for models whose state would not fit
    factored: bool = False
    m_dtype: str = "float32"


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements when both are DTensors
    that differ in them; otherwise ``x``."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and isinstance(ref, DTensor) \
            and tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: AdamWConfig, step) -> float:
    """Learning rate at ``step``: linear warm-up, cosine decay to
    ``lr_min_ratio``; computed in float32 as the JAX package does."""
    step = _f32(step)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * cos
    return float(cfg.lr_peak * warm * frac)


def stacked_layout(names, period: int) -> dict[str, list[str]]:
    """The JAX tree's stacking of per-layer names, the one place that
    states it: ``slot<si>.<path>`` -> the names
    ``blocks.<r * period + si>.<path>`` for r = 0, 1, ... (names outside
    ``blocks.`` are top-level leaves and left out)."""
    found: dict[str, dict[int, str]] = {}
    for name in names:
        parts = name.split(".")
        if parts[0] != "blocks":
            continue
        layer = int(parts[1])
        key = ".".join([f"slot{layer % period}"] + parts[2:])
        found.setdefault(key, {})[layer // period] = name
    out = {}
    for key, by_r in found.items():
        if sorted(by_r) != list(range(len(by_r))):
            raise ValueError(f"{key}: repeats {sorted(by_r)} are not "
                             "0, 1, ...")
        out[key] = [by_r[r] for r in range(len(by_r))]
    return out


def slot_of(key: str) -> tuple[int, tuple[str, ...]]:
    """(slot index, path in the slot) of a :func:`stacked_layout` key."""
    slot, *path = key.split(".")
    return int(slot.removeprefix("slot")), tuple(path)


def factored_slots(state: dict) -> dict[str, list[str]]:
    """The slots whose per-layer vectors share one factored second moment
    (``state["v"][slot key]``, JAX rank 2): slot key -> layer names."""
    return {k: names for k, names in state["stacked"].items()
            if k in state["v"]}


def adamw_init(params: Tensors, cfg: AdamWConfig | None = None, *,
               period: int | None = None) -> dict:
    """AdamW state for ``params``. ``period`` (the config's pattern length)
    is required when per-layer names (``blocks.``) are present: it gives
    each its slot in the JAX tree."""
    cfg = cfg or AdamWConfig()
    m_dt = getattr(torch, cfg.m_dtype)
    if period is None:
        if any(k.startswith("blocks.") for k in params):
            raise ValueError("per-layer parameters need the pattern period "
                             "(adamw_init(..., period=len(cfg.pattern)))")
        stacked = {}
    else:
        stacked = stacked_layout(params, period)

    def zeros(shape, like):
        """f32 zeros of ``shape`` on ``like``'s device (replicated on its
        mesh when ``like`` is a DTensor: factored statistics)."""
        from torch.distributed.tensor import DTensor, Replicate
        if isinstance(like, DTensor):
            mesh = like.device_mesh
            return DTensor.from_local(
                torch.zeros(shape, dtype=torch.float32,
                            device=like.to_local().device),
                mesh, [Replicate()] * mesh.ndim, run_check=False)
        return torch.zeros(shape, dtype=torch.float32, device=like.device)

    def v_init(p, jax_rank):
        if cfg.factored and jax_rank >= 2:
            return dict(vr=zeros(p.shape[:-1], p),
                        vc=zeros(p.shape[:-2] + p.shape[-1:], p))
        return torch.zeros_like(p, dtype=torch.float32)

    state = dict(
        m={k: torch.zeros_like(p, dtype=m_dt) for k, p in params.items()},
        v={}, count=0, stacked=stacked)
    grouped = {k: names for k, names in stacked.items()
               if cfg.factored and params[names[0]].dim() == 1}
    in_group = {n for names in grouped.values() for n in names}
    per_layer = {n for names in stacked.values() for n in names}
    for k, p in params.items():
        if k not in in_group:
            state["v"][k] = v_init(p, p.dim() + (k in per_layer))
    for key, names in grouped.items():
        p = params[names[0]]
        state["v"][key] = dict(vr=zeros((len(names),), p),
                               vc=zeros(p.shape, p))
    return state


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in grads.items()}, g


def _factored_vh(v: dict, gf: torch.Tensor, cfg: AdamWConfig, b2c: float):
    """Update the row and column statistics in place; returns v-hat."""
    g2 = gf * gf + 1e-30
    for key, dim in (("vr", -1), ("vc", -2)):
        v[key].copy_(placed_like(
            cfg.b2 * v[key] + (1 - cfg.b2) * g2.mean(dim), v[key]))
    vr, vc = v["vr"], v["vc"]
    return (vr[..., :, None] * vc[..., None, :]
            / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30)) / b2c


@torch.no_grad()
def adamw_update(grads: Tensors, state: dict, params: Tensors,
                 cfg: AdamWConfig):
    """One AdamW step: ``params`` and ``state``'s moments are updated in
    place. Returns (params, new_state, metrics)."""
    grads = {k: placed_like(g, params[k]) for k, g in grads.items()}
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state["count"] + 1
    lr = cosine_schedule(cfg, count)
    b1c = float(1 - _f32(cfg.b1) ** _f32(count))
    b2c = float(1 - _f32(cfg.b2) ** _f32(count))
    per_layer = {n for names in state["stacked"].values() for n in names}

    def apply(name, gf, vh):
        p, m = params[name], state["m"][name]
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        step = (m_new / b1c) / (torch.sqrt(vh) + cfg.eps)
        pf = p.float()
        if p.dim() + (name in per_layer) >= 2:   # decay where JAX's rank >= 2
            step = step + cfg.weight_decay * pf
        p.copy_(placed_like((pf - lr * step).to(p.dtype), p))
        m.copy_(placed_like(m_new.to(m.dtype), m))

    grouped = factored_slots(state)
    for key, names in grouped.items():         # vectors across the slot
        gf = torch.stack([grads[n].float() for n in names])
        vh = _factored_vh(state["v"][key], gf, cfg, b2c)
        for r, name in enumerate(names):
            apply(name, gf[r], vh[r])
    in_group = {n for names in grouped.values() for n in names}
    for name in params:
        if name in in_group:
            continue
        gf = grads[name].float()
        v = state["v"][name]
        if isinstance(v, dict):
            vh = _factored_vh(v, gf, cfg, b2c)
        else:
            v.copy_(placed_like(cfg.b2 * v + (1 - cfg.b2) * gf * gf, v))
            vh = v / b2c
        apply(name, gf, vh)
    return params, dict(state, count=count), dict(lr=lr, grad_norm=gnorm)


def accumulate_gradients(loss_fn: Callable, params: Tensors, batch: dict,
                         num_microbatches: int, acc_dtype=None):
    """Mean loss and gradients over ``num_microbatches`` slices of the
    batch's leading axis. ``loss_fn(microbatch) -> (loss, metrics)``
    reads ``params``. One microbatch gives gradients in each parameter's
    dtype; with more, each microbatch's gradients are cast into a buffer
    of ``acc_dtype`` (a dtype or its name; default float32) and summed
    there, and the f32 sum is divided by their number at the end, as the
    JAX package does (a bf16 buffer halves the second gradient-sized
    buffer). Returns (loss, grads, metrics of the last slice).
    """
    names = list(params)
    tensors = [params[k] for k in names]

    def grads_of(mb):
        loss, metrics = loss_fn(mb)
        gs = torch.autograd.grad(loss, tensors, allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(t) if g is None else placed_like(g, t)
            for k, t, g in zip(names, tensors, gs)}, \
            {k: v.detach() for k, v in metrics.items()}

    if num_microbatches <= 1:
        return grads_of(batch)
    acc_dt = getattr(torch, acc_dtype) if isinstance(acc_dtype, str) \
        else (acc_dtype or torch.float32)
    acc = {k: torch.zeros_like(t, dtype=acc_dt) for k, t in params.items()}
    for i in range(num_microbatches):
        def part(x):
            mb = x.shape[0] // num_microbatches
            return x[i * mb:(i + 1) * mb]
        loss, grads, metrics = grads_of({k: part(x) for k, x in
                                         batch.items()})
        loss_sum = loss.float() if i == 0 else loss_sum + loss.float()
        for k, g in grads.items():
            acc[k] += g.to(acc_dt)
        del grads
    n = float(num_microbatches)
    return loss_sum / n, {k: g.float() / n for k, g in acc.items()}, \
        metrics


# ----------------------------------------------------------------------
# int8 gradient compression with error feedback
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CompressionState:
    """Per-leaf error-feedback residuals (dict like the params)."""
    residual: Tensors


def compress_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x)).float()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compressed_gradients(grads: Tensors, comp: CompressionState | None):
    """Quantize grads to int8 with error feedback (the wire format of a
    cross-pod reduction, simulated in place). Returns
    (dequantized_grads, new_comp_state)."""
    if comp is None:
        comp = CompressionState(residual={
            k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()})
    deq, resid = {}, {}
    for k, g in grads.items():
        gf = g.float() + comp.residual[k]
        q, s = compress_int8(gf)
        d = decompress_int8(q, s)
        deq[k], resid[k] = d.to(g.dtype), gf - d
    return deq, CompressionState(resid)
