"""Weights to and from the JAX package: ``from_jax(params_np, cfg)`` and
its inverse ``to_jax(model, cfg)``.

The input is the JAX parameter tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``): ``embed``, ``final_norm``,
optional ``lm_head``, and ``blocks``, a list over pattern slots whose
leaves carry a leading ``repeats`` axis. Those are unstacked into the
port's per-layer modules, layer ``r * len(pattern) + si`` taking index
``r`` of slot ``si``. bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` refuses; they are moved as ``uint16`` and
viewed as ``torch.bfloat16``, bit for bit. Each leaf keeps its own dtype
(a bf16 Mamba2 model holds float32 ``A_log``, ``dt_bias`` and ``D_skip``,
as the JAX tree does); a leaf whose shape or dtype differs from the
port's parameter raises.

``jax.random`` cannot be replayed in torch, so this is how a test gives
both packages the same weights; ``to_jax`` gives the port's weights (or
gradients) back in the JAX tree's layout, so a test compares them leaf by
leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.models.model import Model

__all__ = ["from_jax", "to_jax", "to_tensor", "to_numpy"]


def to_tensor(arr) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor, bit for bit."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # arrays viewed from JAX buffers
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array, bit for bit; bf16 comes out as its
    ``uint16`` bits (numpy has no bf16 of its own)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def from_jax(params_np: dict, cfg, device=None) -> Model:
    """The port's :class:`Model` holding the JAX tree's weights."""
    dev = default_device(device)
    model = Model(cfg, device=dev)
    params = dict(model.named_parameters())
    assigned = set()

    def put(name, arr):
        if name not in params:
            raise KeyError(f"JAX leaf {name!r} has no counterpart in the "
                           "port's model")
        p, t = params[name], to_tensor(arr)
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: JAX leaf {tuple(t.shape)} {t.dtype} "
                             f"vs port {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(t)
        assigned.add(name)

    for key in ("embed", "final_norm", "lm_head"):
        if key in params_np:
            put(key, params_np[key])
    period = len(cfg.pattern)
    if len(params_np["blocks"]) != period:
        raise ValueError(f"{len(params_np['blocks'])} slots in the JAX tree, "
                         f"pattern has {period}")
    for si, slot in enumerate(params_np["blocks"]):
        for path, leaf in _leaves(slot):
            if leaf.shape[0] != cfg.repeats:
                raise ValueError(f"{path}: leading axis {leaf.shape[0]} != "
                                 f"repeats {cfg.repeats}")
            for r in range(cfg.repeats):
                put(".".join(("blocks", str(r * period + si)) + path),
                    leaf[r])
    missing = sorted(set(params) - assigned)
    if missing:
        raise ValueError(f"port parameters not in the JAX tree: {missing}")
    return model


def to_jax(params, cfg) -> dict:
    """The JAX parameter tree (numpy leaves) of a :class:`Model`, or of a
    dict of tensors under its parameter names (gradients, for example):
    per-layer weights stacked on a leading ``repeats`` axis per pattern
    slot. bf16 leaves come out as their ``uint16`` bits (:func:`to_numpy`)."""
    named = dict(params.named_parameters()) if isinstance(params, Model) \
        else dict(params)
    period = len(cfg.pattern)
    out: dict = {"blocks": [{} for _ in range(period)]}
    per_slot: dict = {}
    for name, t in named.items():
        arr = to_numpy(t)
        parts = name.split(".")
        if parts[0] != "blocks":
            out[name] = arr
            continue
        layer = int(parts[1])
        per_slot.setdefault((layer % period, tuple(parts[2:])), {})[
            layer // period] = arr
    for (si, path), by_repeat in per_slot.items():
        if sorted(by_repeat) != list(range(cfg.repeats)):
            raise ValueError(f"slot {si} {'.'.join(path)}: repeats "
                             f"{sorted(by_repeat)} of {cfg.repeats}")
        node = out["blocks"][si]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([by_repeat[r]
                                   for r in range(cfg.repeats)])
    return out
