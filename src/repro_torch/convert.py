"""Weights from the JAX package: ``from_jax(params_np, cfg)``.

The input is the JAX parameter tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``): ``embed``, ``final_norm``,
optional ``lm_head``, and ``blocks``, a list over pattern slots whose
leaves carry a leading ``repeats`` axis. Those are unstacked into the
port's per-layer modules, layer ``r * len(pattern) + si`` taking index
``r`` of slot ``si``. bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` refuses; they are moved as ``uint16`` and
viewed as ``torch.bfloat16``, bit for bit.

``jax.random`` cannot be replayed in torch, so this is how a test gives
both packages the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.models.model import Model

__all__ = ["from_jax", "to_tensor"]


def to_tensor(arr) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor, bit for bit."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # arrays viewed from JAX buffers
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
