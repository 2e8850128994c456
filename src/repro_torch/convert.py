"""Weights and optimizer state to and from the JAX package:
``from_jax(params_np, cfg)`` and its inverse ``to_jax(model, cfg)``;
``opt_from_jax(state_np, cfg)`` and ``opt_to_jax(state, cfg)`` for the
AdamW state (``m``, ``v`` factored or not, ``count``).

The input is the JAX parameter tree with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``): ``embed`` (none for an arch that
takes frontend embeddings), ``final_norm``, optional ``lm_head``, and
``blocks``, a list over pattern slots (1 for a dense model, 5 for the
vision model, 8 for jamba) whose leaves carry a leading ``repeats`` axis. Those are unstacked into the
port's per-layer modules as ``optim.stacked_layout`` maps them, layer
``r * len(pattern) + si`` taking index ``r`` of slot ``si``. bf16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` refuses; they are moved as ``uint16`` and
viewed as ``torch.bfloat16``, bit for bit. Each leaf keeps its own dtype
(a bf16 Mamba2 model holds float32 ``A_log``, ``dt_bias`` and ``D_skip``,
as the JAX tree does); a leaf whose shape or dtype differs from the
port's parameter raises.

``jax.random`` cannot be replayed in torch, so this is how a test gives
both packages the same weights; ``to_jax`` gives the port's weights (or
gradients) back in the JAX tree's layout, so a test compares them leaf by
leaf, and a checkpoint holds the same tree whichever package wrote it.

A model placed on a mesh (``launch/shardings.distribute_model``) has
DTensor parameters. ``to_jax`` and ``opt_to_jax`` with ``numpy=False``
keep each rank's part: a stacked leaf becomes a DTensor whose local
block is the stack of the layers' local blocks, copied to the host, its
``Shard`` dims shifted by one for the ``repeats`` axis; a top-level leaf
keeps its placements. Both are built by ``DTensor.from_local`` on the
host twin of the mesh, with no collective, so a checkpoint writes each
rank's blocks (``checkpoint.save``). A DTensor on a one-device mesh
comes out a plain host tensor, as a plain tensor does. The way back is
``from_jax`` of a restored (whole) tree, then ``distribute_model`` with
the target mesh's specs; :func:`specs_to_jax` and :func:`opt_specs_to_jax`
give ``launch/shardings``' specs in the JAX tree's layout, for
``CheckpointManager.restore_latest(mesh, specs)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.models.model import Model
from repro_torch.optim import factored_slots, slot_of, stacked_layout

__all__ = ["from_jax", "to_jax", "opt_from_jax", "opt_to_jax", "to_tensor",
           "to_numpy", "specs_to_jax", "opt_specs_to_jax"]


def to_tensor(arr) -> torch.Tensor:
    """A numpy array (bf16 included) as a CPU tensor, bit for bit; a
    tensor is returned as it is."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:        # arrays viewed from JAX buffers
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array, bit for bit; bf16 comes out as its
    ``uint16`` bits (numpy has no bf16 of its own). A DTensor must lie
    on a one-device mesh."""
    t = _local(t).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _sharded(t):
    """``t`` if it is a DTensor over more than one device, else None."""
    return t if _is_dtensor(t) and t.device_mesh.size() > 1 else None


def _local(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor, or the whole of a DTensor on a one-device mesh."""
    if not _is_dtensor(t):
        return t
    if _sharded(t) is not None:
        raise ValueError(f"a DTensor over {t.device_mesh.size()} devices "
                         "has no whole local tensor: take numpy=False")
    return t.detach().to_local()


def _host_twin(mesh):
    """``mesh``'s twin on the CPU: the same rank grid and axis names with
    device type "cpu" and no process groups of its own."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names,
                      _init_backend=False)


def _host_mesh(mesh):
    """``mesh`` itself on the CPU, else its host twin, so that
    ``DTensor.from_local`` leaves a host block on the host."""
    return mesh if mesh.device_type == "cpu" else _host_twin(mesh)


def _from_local(local: torch.Tensor, like, placements, shape):
    """A DTensor of the host block ``local`` on ``like``'s mesh, or on
    that mesh's host twin when it is not a CPU mesh."""
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, _host_mesh(like.device_mesh),
                              placements, shape=torch.Size(shape),
                              stride=stride)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of its own: later updates of ``t`` leave it alone. A
    DTensor over several devices keeps its placements, each rank's block
    copied (:func:`_from_local`)."""
    if _sharded(t) is None:
        return _local(t).detach().to("cpu", copy=True)
    local = t.detach().to_local().to("cpu", copy=True)
    return _from_local(local, t, t.placements, tuple(t.shape))


def _host_stack(leaves) -> torch.Tensor:
    """The per-layer tensors stacked into one CPU tensor of its own, each
    copied once. Per-layer DTensors over several devices (one mesh, one
    placement) stack their local blocks: a DTensor with a leading
    ``repeats`` axis, each ``Shard(d)`` now ``Shard(d + 1)``."""
    from torch.distributed.tensor import Replicate, Shard
    first = _sharded(leaves[0])
    blocks = [_local(x) for x in leaves] if first is None else \
        [x.detach().to_local() for x in leaves]
    out = torch.empty((len(leaves),) + tuple(blocks[0].shape),
                      dtype=blocks[0].dtype, device="cpu")
    for r, x in enumerate(blocks):
        out[r].copy_(x.detach())
    if first is None:
        return out
    for x in leaves:
        if x.device_mesh != first.device_mesh \
                or x.placements != first.placements:
            raise ValueError("a slot's layers lie on different meshes or "
                             "placements")
    placements = []
    for pl in first.placements:
        if type(pl) is Shard:
            placements.append(Shard(pl.dim + 1))
        elif isinstance(pl, Replicate):
            placements.append(pl)
        else:
            raise ValueError(f"cannot stack a leaf placed {pl}")
    return _from_local(out, first, placements,
                       (len(leaves),) + tuple(first.shape))


def _is_factored(node) -> bool:
    return isinstance(node, dict) and set(node) == {"vr", "vc"}


def _leaves(tree, prefix=()):
    """(path, leaf) of a nested dict, keys sorted; a factored second
    moment ``{vr, vc}`` is one leaf."""
    if isinstance(tree, dict) and not _is_factored(tree):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _put(node: dict, path, value) -> None:
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _unstack(tree: dict, cfg, layout: dict) -> dict:
    """The JAX tree's leaves under the port's names: top-level keys as
    they are, each slot's leaves split along the ``repeats`` axis into the
    layer names that ``layout`` (:func:`optim.stacked_layout` of the
    port's parameter names) gives the slot's path. A factored ``{vr, vc}``
    of a slot's vectors (``vr`` of shape (R,)) stays whole under its slot
    key, as the optimizer keys it."""
    by_slot = {slot_of(k): (k, names) for k, names in layout.items()}
    out = {k: v for k, v in tree.items() if k != "blocks"}
    if len(tree["blocks"]) != len(cfg.pattern):
        raise ValueError(f"{len(tree['blocks'])} slots in the JAX tree, "
                         f"pattern has {len(cfg.pattern)}")
    for si, slot in enumerate(tree["blocks"]):
        for path, leaf in _leaves(slot):
            if (si, path) not in by_slot:
                raise KeyError(f"JAX leaf blocks[{si}]/{'/'.join(path)} has "
                               "no counterpart in the port's model")
            key, names = by_slot[si, path]
            lead = leaf["vr"] if _is_factored(leaf) else leaf
            if lead.shape[0] != len(names):
                raise ValueError(f"{key}: leading axis {lead.shape[0]} != "
                                 f"repeats {len(names)}")
            if _is_factored(leaf) and len(lead.shape) == 1:
                out[key] = leaf
                continue
            for r, name in enumerate(names):
                out[name] = {k: v[r] for k, v in leaf.items()} \
                    if _is_factored(leaf) else leaf[r]
    return out


def from_jax(params_np: dict, cfg, device=None) -> Model:
    """The port's :class:`Model` holding the JAX tree's weights."""
    dev = default_device(device)
    model = Model(cfg, device=dev)
    params = dict(model.named_parameters())
    named = _unstack(params_np, cfg,
                     stacked_layout(params, len(cfg.pattern)))
    for name, arr in named.items():
        if name not in params:
            raise KeyError(f"JAX leaf {name!r} has no counterpart in the "
                           "port's model")
        p, t = params[name], to_tensor(arr)
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{name}: JAX leaf {tuple(t.shape)} {t.dtype} "
                             f"vs port {tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(t)
    missing = sorted(set(params) - set(named))
    if missing:
        raise ValueError(f"port parameters not in the JAX tree: {missing}")
    return model


def _np_stack(leaves) -> np.ndarray:
    return np.stack([to_numpy(x) for x in leaves])


def _spec_stack(specs) -> tuple:
    """The spec of a stacked leaf: the layers' spec behind a replicated
    ``repeats`` axis."""
    if any(x != specs[0] for x in specs):
        raise ValueError(f"a slot's layers have different specs: {specs}")
    return (None,) + tuple(specs[0])


def _tree(named: dict, cfg, numpy: bool = False, leaf_fn=None,
          stack=None) -> dict:
    """Per-layer leaves (tensors, or factored ``{vr, vc}`` dicts of them)
    stacked on a leading ``repeats`` axis per pattern slot, as
    :func:`optim.stacked_layout` groups them; numpy arrays
    (:func:`to_numpy`) or CPU tensors of their own, or what ``leaf_fn``
    and ``stack`` make of a top-level leaf and of a slot's layers."""
    leaf_fn = leaf_fn or (to_numpy if numpy else _host)
    stack = stack or (_np_stack if numpy else _host_stack)
    layout = stacked_layout(named, len(cfg.pattern))
    out: dict = {"blocks": [{} for _ in cfg.pattern]}
    per_layer = {n for names in layout.values() for n in names}
    for name, t in named.items():
        if name not in per_layer:
            out[name] = {k: leaf_fn(v) for k, v in t.items()} \
                if isinstance(t, dict) else leaf_fn(t)
    for key, names in layout.items():
        if len(names) != cfg.repeats:
            raise ValueError(f"{key}: {len(names)} layers of "
                             f"{cfg.repeats} repeats")
        leaves = [named[n] for n in names]
        if isinstance(leaves[0], dict):
            value = {k: stack([x[k] for x in leaves]) for k in leaves[0]}
        else:
            value = stack(leaves)
        si, path = slot_of(key)
        _put(out["blocks"][si], path, value)
    return out


def to_jax(params, cfg, numpy: bool = True) -> dict:
    """The JAX parameter tree of a :class:`Model`, or of a dict of tensors
    under its parameter names (gradients, for example): per-layer weights
    stacked on a leading ``repeats`` axis per pattern slot. Leaves are
    numpy arrays, bf16 as its ``uint16`` bits (:func:`to_numpy`; a
    top-level leaf of a CPU model shares its memory), or with
    ``numpy=False`` CPU tensors of their own, bf16 kept: a snapshot that
    later updates of the model leave alone."""
    named = dict(params.named_parameters()) if isinstance(params, Model) \
        else dict(params)
    return _tree(named, cfg, numpy)


def opt_to_jax(state: dict, cfg, numpy: bool = True) -> dict:
    """The JAX AdamW state (``m``, ``v``, ``count``) of the port's
    optimizer state, factored or not: ``m`` and ``v`` in the parameter
    tree's layout, a factored leaf as ``{vr, vc}``, the slot-wide
    ``vr``/``vc`` of per-layer vectors under their slot, ``count`` an
    int32 scalar. Leaves as in :func:`to_jax`."""
    leaf_fn = to_numpy if numpy else _host
    slots = factored_slots(state)
    vtree = _tree({k: t for k, t in state["v"].items() if k not in slots},
                  cfg, numpy)
    for key in slots:
        si, path = slot_of(key)
        _put(vtree["blocks"][si], path,
             {k: leaf_fn(x) for k, x in state["v"][key].items()})
    count = np.asarray(state["count"], np.int32)
    return dict(m=_tree(state["m"], cfg, numpy), v=vtree,
                count=count if numpy else torch.from_numpy(count))


def specs_to_jax(p_specs: dict, cfg) -> dict:
    """``launch/shardings.param_specs``' specs (by the port's parameter
    names) as a tree of the JAX parameter tree's layout: a stacked leaf's
    spec leads with a replicated ``repeats`` axis."""
    return _tree(p_specs, cfg, leaf_fn=tuple, stack=_spec_stack)


def opt_specs_to_jax(o_specs: dict, cfg) -> dict:
    """``launch/shardings.opt_state_specs``' specs in the layout of
    :func:`opt_to_jax`'s tree (``count`` None: left on the host)."""
    slots = {k for k, x in o_specs["v"].items()
             if isinstance(x, dict) and k.startswith("slot")}
    vtree = _tree({k: x for k, x in o_specs["v"].items() if k not in slots},
                  cfg, leaf_fn=tuple, stack=_spec_stack)
    for key in slots:
        si, path = slot_of(key)
        _put(vtree["blocks"][si], path,
             {k: tuple(x) for k, x in o_specs["v"][key].items()})
    return dict(m=specs_to_jax(o_specs["m"], cfg), v=vtree, count=None)


def opt_from_jax(state_np: dict, cfg, device=None) -> dict:
    """The port's optimizer state of a JAX AdamW state (numpy leaves, bf16
    as ``ml_dtypes`` arrays, or tensors), the inverse of
    :func:`opt_to_jax`."""
    dev = default_device(device)
    layout = stacked_layout(dict(Model(cfg, device="meta")
                                 .named_parameters()), len(cfg.pattern))

    def put(x):
        return to_tensor(x).to(dev, copy=True)
    m = {k: put(x) for k, x in _unstack(state_np["m"], cfg, layout).items()}
    v = {k: {p: put(y) for p, y in x.items()} if _is_factored(x) else put(x)
         for k, x in _unstack(state_np["v"], cfg, layout).items()}
    return dict(m=m, v=v, count=int(np.asarray(state_np["count"])),
                stacked=layout)
