"""Optimizer substrate (port of ``repro/optim/optimizer.py``): AdamW with a
cosine schedule, gradient accumulation, int8 gradient compression with
error feedback.

Plain functions on dicts of tensors (``dict(model.named_parameters())``),
not ``torch.optim.AdamW``, so the arithmetic is the JAX package's: clip
first, the schedule and bias corrections at ``count + 1``, decoupled
weight decay on matrices only, update math in f32 cast back to each
parameter's dtype. Where JAX returns new parameters, ``adamw_update``
writes them into the given tensors in place under ``torch.no_grad()``
(one copy of the weights on the card instead of two); the values are the
same. Scalars of the schedule are computed in float32, as JAX computes
them, and then applied as Python floats that hold those f32 values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
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


def adamw_init(params: Tensors, cfg: AdamWConfig | None = None) -> dict:
    cfg = cfg or AdamWConfig()
    m_dt = getattr(torch, cfg.m_dtype)

    def v_init(p):
        if cfg.factored and p.dim() >= 2:
            return dict(vr=torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device),
                        vc=torch.zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=torch.float32, device=p.device))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return dict(
        m={k: torch.zeros(p.shape, dtype=m_dt, device=p.device)
           for k, p in params.items()},
        v={k: v_init(p) for k, p in params.items()},
        count=0,
    )


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in grads.items()}, g


@torch.no_grad()
def adamw_update(grads: Tensors, state: dict, params: Tensors,
                 cfg: AdamWConfig):
    """One AdamW step: ``params`` and ``state``'s moments are updated in
    place. Returns (params, new_state, metrics)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    count = state["count"] + 1
    lr = cosine_schedule(cfg, count)
    b1c = float(1 - _f32(cfg.b1) ** _f32(count))
    b2c = float(1 - _f32(cfg.b2) ** _f32(count))
    for name, p in params.items():
        gf = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        if isinstance(v, dict):
            g2 = gf * gf + 1e-30
            v["vr"].copy_(cfg.b2 * v["vr"] + (1 - cfg.b2) * g2.mean(-1))
            v["vc"].copy_(cfg.b2 * v["vc"] + (1 - cfg.b2) * g2.mean(-2))
            vr, vc = v["vr"], v["vc"]
            vh = (vr[..., :, None] * vc[..., None, :]
                  / torch.clamp(vr.mean(-1)[..., None, None], min=1e-30)
                  ) / b2c
        else:
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * gf * gf)
            vh = v / b2c
        step = (m_new / b1c) / (torch.sqrt(vh) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:              # decoupled decay on matrices only
            step = step + cfg.weight_decay * pf
        p.copy_((pf - lr * step).to(p.dtype))
        m.copy_(m_new.to(m.dtype))
    return params, dict(m=state["m"], v=state["v"], count=count), \
        dict(lr=lr, grad_norm=gnorm)


def accumulate_gradients(loss_fn: Callable, params: Tensors, batch: dict,
                         num_microbatches: int):
    """Mean loss and gradients over ``num_microbatches`` slices of the
    batch's leading axis. ``loss_fn(microbatch) -> (loss, metrics)``
    reads ``params``. One microbatch gives gradients in each parameter's
    dtype; more are summed in f32 and divided by their number, as the
    JAX package does. Returns (loss, grads, metrics of the last slice).
    """
    names = list(params)
    tensors = [params[k] for k in names]

    def grads_of(mb):
        loss, metrics = loss_fn(mb)
        gs = torch.autograd.grad(loss, tensors, allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(t) if g is None else g
                               for k, t, g in zip(names, tensors, gs)}, \
            {k: v.detach() for k, v in metrics.items()}

    if num_microbatches <= 1:
        return grads_of(batch)
    loss_sum = torch.zeros((), dtype=torch.float32)
    acc = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
           for k, t in params.items()}
    for i in range(num_microbatches):
        def part(x):
            mb = x.shape[0] // num_microbatches
            return x[i * mb:(i + 1) * mb]
        loss, grads, metrics = grads_of({k: part(x) for k, x in
                                         batch.items()})
        loss_sum = loss_sum.to(loss.device) + loss.float()
        for k, g in grads.items():
            acc[k] += g.float()
        del grads
    n = float(num_microbatches)
    return loss_sum / n, {k: g / n for k, g in acc.items()}, metrics


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
