"""Sharding rules engine (port of ``repro/launch/shardings.py``).

Assigns a spec to every parameter, optimizer-state, cache and batch
tensor from its *role* (inferred from its name and shape), with
divisibility checks and graceful fallback (drop the axis, replicate that
dim), so every (arch × shape × mesh) cell runs.

Specs, their fitting to a mesh and their DTensor placements live in
``core/sharding.py`` (the layers read them too) and are re-exported
here; :func:`distribute` places a tensor by a spec.

Strategy (2-D "data" × "model" per pod, +"pod" across pods):
  * batch dims          → ("pod","data")  [DP]
  * TP matrix dims      → "model" (attention heads / MLP hidden / vocab)
  * FSDP: the non-TP matrix dim of every weight → "data"  [ZeRO-3; DTensor
    gathers it at each use]
  * MoE expert dim      → "model" [EP]
  * KV caches           → batch on ("pod","data"), stored heads on
    "model" (kv_repeat pre-replicates heads when TP > kv heads)
  * optimizer state     → like its parameter (m, v); factored ``vr/vc``
    replicated

The port holds every layer as its own module (``blocks.<layer>.<path>``),
where JAX stacks each pattern slot's layers on a leading ``repeats``
axis: a per-layer tensor gets JAX's spec with that leading ``None``
removed, fitted to the per-layer shape.
"""

from __future__ import annotations

import torch

from repro_torch.core.sharding import (batch_axes, fit_spec, local_shape,
                                       mesh_shape, placements)

__all__ = ["mesh_shape", "batch_axes", "fit_spec", "role_spec",
           "param_specs", "batch_specs", "cache_specs", "opt_state_specs",
           "local_shape", "placements", "distribute", "distribute_model",
           "distribute_tree"]


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def role_spec(path_keys: list[str], shape: tuple[int, ...],
              profile: str = "2d") -> tuple:
    """Desired (pre-fallback) spec by role, for the per-layer shape.

    profile '2d'            — TP on "model" + FSDP on "data" (default).
    profile 'ep_only'       — experts on "model", everything else
      FSDP-only: for small-d_model MoE archs where 16-way TP shards are
      slivers and the TP all-reduces dominate the step.
    profile 'ep_replicated' — weight-stationary dense: replicate
      everything except the experts, for MoE archs whose dense tower is
      tiny (no TP all-reduces, no ZeRO regathers).
    """
    name = path_keys[-1] if path_keys else ""
    joined = "/".join(path_keys)

    if profile == "ep_only":
        if len(shape) == 3 and name in ("wg", "wu", "wd"):
            return ("model", "data", None) if name != "wd" \
                else ("model", None, "data")
        if name == "embed":
            return (("data", "model"), None)
        if name == "lm_head":
            return (None, ("data", "model"))
        if len(shape) >= 2:
            return (("data", "model"),)   # pure FSDP over both axes
        return ()

    if profile == "ep_replicated":
        if len(shape) == 3 and name in ("wg", "wu", "wd"):
            return ("model", "data", None) if name != "wd" \
                else ("model", None, "data")
        return ()

    if profile != "2d":
        raise ValueError(f"unknown sharding profile {profile!r}")
    if name in ("embed",):                       # (V, D)
        return ("model", "data")
    if name == "lm_head":                        # (D, V)
        return ("data", "model")
    if name in ("wq", "wk", "wv"):               # (D, heads·Dh)
        return ("data", "model")
    if name == "wo":                             # (heads·Dh, D)
        return ("model", "data")
    if name in ("wg", "wu"):
        if len(shape) == 3:                      # MoE experts (E, D, F)
            return ("model", "data", None)
        return ("data", "model")                 # dense (D, F)
    if name == "wd":
        if len(shape) == 3:                      # (E, F, D)
            return ("model", None, "data")
        return ("model", "data")                 # dense (F, D)
    if name == "router":                         # (D, E) — small
        return ()
    if name == "in_proj":                        # mamba (D, big)
        return ("data", "model")
    if name == "out_proj":                       # mamba (d_inner, D)
        return ("model", "data")
    if name == "conv_w":                         # (K, conv_dim)
        return (None, "model")
    if name == "conv_b":
        return ("model",)
    if name in ("bq", "bk", "bv"):               # attention biases
        return ("model",)
    if "shared" in joined and name in ("wg", "wu"):
        return ("data", "model")
    # norms, gates, A_log, dt_bias, D_skip, q_norm/k_norm ... replicate
    return ()


def _shapes(tensors) -> dict[str, tuple[int, ...]]:
    if isinstance(tensors, torch.nn.Module):
        tensors = dict(tensors.named_parameters())
    return {k: tuple(v.shape) for k, v in tensors.items()}


def param_specs(mesh, params, profile: str = "2d") -> dict[str, tuple]:
    """Spec of every parameter (a module or a dict of name → tensor)."""
    return {name: fit_spec(mesh, shape,
                           role_spec(name.split("."), shape, profile))
            for name, shape in _shapes(params).items()}


# ----------------------------------------------------------------------
# batches / caches / optimizer state
# ----------------------------------------------------------------------

def batch_specs(mesh, batch: dict) -> dict[str, tuple]:
    """Every batch leaf split along its leading (batch) dim."""
    ba = batch_axes(mesh)
    return {k: fit_spec(mesh, tuple(v.shape), (ba,))
            for k, v in batch.items()}


def _cache_spec(mesh, name: str, shape: tuple[int, ...]) -> tuple:
    ba = batch_axes(mesh)
    model_size = mesh_shape(mesh).get("model", 1)
    if name in ("k", "v") and len(shape) == 4:
        # (B, S, H_stored, Dh): prefer head sharding; if the stored heads
        # don't divide the TP axis, shard the sequence instead
        # (flash-decoding style)
        if shape[2] % model_size == 0:
            spec = (ba, None, "model", None)
        else:
            spec = (ba, "model", None, None)
    elif name == "conv":                         # (B, K-1, conv_dim)
        spec = (ba, None, "model")
    elif name == "ssm":                          # (B, H, N, P)
        spec = (ba, "model", None, None)
    else:
        spec = (ba,)
    return fit_spec(mesh, shape, spec)


def cache_specs(mesh, caches: dict) -> dict:
    """Specs of decode caches (``stack.init_caches``' layout: a per-layer
    list of dicts, None for a layer without one, and the ``length``
    counter, which is a Python int and gets no spec)."""
    return dict(length=None, layers=[
        None if c is None else {k: _cache_spec(mesh, k, tuple(v.shape))
                                for k, v in c.items()}
        for c in caches["layers"]])


def opt_state_specs(mesh, opt_state: dict, p_specs: dict) -> dict:
    """m is param-shaped → the param specs. v likewise, except factored
    (vr/vc dict) leaves, which are small → replicated."""
    v = {k: dict(vr=(), vc=()) if isinstance(x, dict) else p_specs[k]
         for k, x in opt_state["v"].items()}
    return dict(m={k: p_specs[k] for k in opt_state["m"]}, v=v)


# ----------------------------------------------------------------------
# tensors placed on a DeviceMesh
# ----------------------------------------------------------------------

def distribute(t: torch.Tensor, mesh, spec: tuple):
    """``t`` (the full tensor, the same on every rank) as a DTensor placed
    by ``spec``: each rank keeps its own shard, no collective runs."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=None)


def distribute_model(model: torch.nn.Module, mesh, specs: dict):
    """Replace every parameter of ``model`` in place by its DTensor placed
    by ``specs`` (from :func:`param_specs`). Returns the model."""
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        mod = model.get_submodule(".".join(path))
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(p.detach(), mesh, specs[name]),
            requires_grad=p.requires_grad)
    return model


def distribute_tree(tree, mesh, specs):
    """A nested dict/list of tensors placed leaf by leaf by the matching
    tree of specs (a None spec leaves its leaf as it is)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, specs[k])
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, mesh, s) for v, s in zip(tree, specs)]
    if isinstance(tree, torch.Tensor) and specs is not None:
        return distribute(tree, mesh, specs)
    return tree
