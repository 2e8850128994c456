"""Locality-aware MoE routing — DFWSPT/DFWSRPT overflow stealing.

Port of ``repro/core/routing.py``. Experts are task queues with bounded
capacity; tokens that overflow an expert are re-routed ("stolen") to the
next expert in a steal order that lists the other experts nearest first,
as the paper's schedulers let an idle thread steal from the nearest
victim. Expert and slot ids equal the JAX reference's exactly:

  * top-k keeps the lower expert index first among equal probabilities
    (``jax.lax.top_k``'s order), through a stable descending sort;
  * capacity is filled greedily in (k-slot, token) order by an exclusive
    int32 cumsum, with the slots already used carried across attempts;
  * a dropped (token, k) pair carries expert = slot = -1, whose one-hot
    row is zero (see :func:`one_hot`).

The steal table comes from the caller: ``expert_steal_table`` builds it
from a topology (the training launcher's), and ``ring_steal_table`` is the
order the MoE layer falls back to when none is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .topology import Topology

__all__ = ["RoutingConfig", "route", "dispatch_combine_weights",
           "expert_steal_table", "ring_steal_table", "one_hot"]


@dataclasses.dataclass(frozen=True)
class RoutingConfig:
    num_experts: int
    top_k: int
    capacity: int            # per-expert token slots (per routed batch)
    steal_attempts: int = 2  # 0 = vanilla GShard-style drop-on-overflow
    policy: str = "dfwspt"   # or 'dfwsrpt'


def expert_steal_table(topo: Topology,
                       expert_device: np.ndarray,
                       policy: str = "dfwspt",
                       seed: int = 0) -> np.ndarray:
    """(E, E-1) steal order: row e = other experts by hop distance from
    the device owning e (the paper's priority list, expert-granular).
    Ties go to the lower expert id (DFWSPT) or to a permutation drawn
    from ``seed`` (DFWSRPT), as in the JAX package.

    expert_device: (E,) device (== core in the topology) owning each
    expert.
    """
    expert_device = np.asarray(expert_device, np.int64)
    E = expert_device.shape[0]
    dist = topo.core_distance_matrix()
    rng = np.random.RandomState(seed)
    rows = []
    for e in range(E):
        others = [x for x in range(E) if x != e]
        d = dist[expert_device[e], expert_device[others]]
        if policy == "dfwspt":
            key = np.lexsort((np.asarray(others), d))
        elif policy == "dfwsrpt":
            key = np.lexsort((rng.permutation(E - 1), d))
        else:
            raise ValueError(f"unknown policy {policy!r}")
        rows.append([others[i] for i in key])
    return np.asarray(rows, np.int64)


def ring_steal_table(num_experts: int) -> np.ndarray:
    """(E, E-1) ring order: expert e steals from e+1, e+2, ... (mod E)."""
    e = np.arange(num_experts)
    return (e[:, None] + np.arange(1, num_experts)[None, :]) % num_experts


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row.

    Built by comparison: ``F.one_hot`` refuses -1 and, on CUDA, checks its
    indices on the host, which would stall the stream on every call.
    """
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(dtype)


def _fill_positions(choice: torch.Tensor, active: torch.Tensor,
                    used: torch.Tensor, num_experts: int, capacity: int):
    """Greedy in-order capacity fill for one routing attempt, for each
    routed group along the leading dims.

    choice: (..., T) expert id per token; active: (..., T) tokens still
    waiting. used: (..., E) slots already taken. Returns (placed,
    position, new_used).
    """
    choice_l = choice.long()
    onehot = one_hot(choice, num_experts, torch.int32)
    onehot = onehot * active[..., None].to(torch.int32)
    onehot_t = onehot.transpose(-1, -2).contiguous()
    pos_in_expert = torch.cumsum(onehot_t, dim=-1, dtype=torch.int32) \
        - onehot_t
    pos = pos_in_expert.gather(-2, choice_l[..., None, :])[..., 0, :] \
        + used.gather(-1, choice_l)
    placed = active & (pos < capacity)
    new_used = used + torch.minimum(onehot.sum(dim=-2, dtype=torch.int32),
                                    capacity - used)
    return placed, pos, new_used


def route(gate_logits: torch.Tensor, cfg: RoutingConfig,
          steal_table: np.ndarray | torch.Tensor | None = None) -> dict:
    """Top-k routing with locality-aware overflow stealing.

    Args:
      gate_logits: (T, E) router scores for a routed group, or (..., T, E)
        for many groups at once, each routed on its own.
      steal_table: (E, E-1) steal order, nearest victim first. Required
        when ``cfg.steal_attempts > 0``.

    Returns dict with (each with the leading group dims):
      expert:   (T, K) int32 — final expert of each (token, slot); -1 drop.
      slot:     (T, K) int32 — capacity slot within that expert; -1 drop.
      weight:   (T, K) f32   — combine weights (renormalised gate probs).
      aux_loss: scalar load-balancing auxiliary (Switch-style).
      drop_fraction: scalar — fraction of (token, slot) pairs dropped.
    """
    *lead, T, E = gate_logits.shape
    if E != cfg.num_experts:
        raise ValueError(f"gate width {E} != num_experts {cfg.num_experts}")
    dev = gate_logits.device
    probs = torch.softmax(gate_logits.float(), dim=-1)
    # stable descending sort: lower index first among ties, as lax.top_k
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = sorted_p[..., :cfg.top_k], order[..., :cfg.top_k]

    # Switch-Transformer auxiliary load-balance loss.
    density = one_hot(top_e[..., 0], E, torch.float32).mean(dim=-2)
    router_prob = probs.mean(dim=-2)
    aux_loss = E * torch.sum(density * router_prob, dim=-1)

    table = None
    if cfg.steal_attempts > 0:
        if steal_table is None:
            raise ValueError("steal_attempts > 0 requires a steal_table")
        table = torch.as_tensor(steal_table, dtype=torch.long,
                                device=dev)             # (E, E-1)

    # Flatten (token, k-slot) pairs; earlier k-slots get priority, matching
    # the paper's depth-first "own queue first" preference.
    n = cfg.top_k * T
    choice = top_e.transpose(-1, -2).reshape(*lead, n)    # (..., K*T)
    flat_active = torch.ones((*lead, n), dtype=torch.bool, device=dev)
    flat_expert = torch.full((*lead, n), -1, dtype=torch.int32, device=dev)
    flat_slot = torch.full((*lead, n), -1, dtype=torch.int32, device=dev)
    used = torch.zeros((*lead, E), dtype=torch.int32, device=dev)

    for attempt in range(cfg.steal_attempts + 1):
        placed, pos, used = _fill_positions(choice, flat_active, used,
                                            E, cfg.capacity)
        flat_expert = torch.where(placed, choice.to(torch.int32),
                                  flat_expert)
        flat_slot = torch.where(placed, pos.to(torch.int32), flat_slot)
        flat_active = flat_active & ~placed
        if attempt < cfg.steal_attempts:
            # overflow tokens walk the victim list of their *current*
            # expert: nearest device first (DFWSPT/DFWSRPT).
            choice = table[choice, attempt]
    expert = flat_expert.reshape(*lead, cfg.top_k, T).transpose(-1, -2)
    slot = flat_slot.reshape(*lead, cfg.top_k, T).transpose(-1, -2)
    keep = expert >= 0                                    # (..., T, K)
    w = top_p * keep
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return dict(expert=expert, slot=slot, weight=w, aux_loss=aux_loss,
                drop_fraction=1.0 - keep.float().mean(dim=(-2, -1)))


def dispatch_combine_weights(routing: dict, num_experts: int, capacity: int):
    """Dense GShard-style tensors from a routing result.

    Returns:
      dispatch: (T, E, C) bool — token t occupies slot c of expert e.
      combine:  (T, E, C) f32  — dispatch · weight.
    """
    expert, slot, w = routing["expert"], routing["slot"], routing["weight"]
    e_oh = one_hot(expert, num_experts, torch.float32)    # (T,K,E)
    c_oh = one_hot(slot, capacity, torch.float32)         # (T,K,C)
    combine = torch.einsum("tke,tkc,tk->tec", e_oh, c_oh, w)
    dispatch = torch.einsum("tke,tkc->tec", e_oh, c_oh) > 0
    return dispatch, combine
