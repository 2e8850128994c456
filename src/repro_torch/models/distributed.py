"""Layers on DTensors: the helpers ``models/layers.py`` calls where the
JAX package constrains a sharding or GSPMD settles one. Each takes a
plain tensor through unchanged (the one-device path's bits do not move).

  * :func:`constrain` redistributes an activation to a config-carried
    spec (JAX's ``with_sharding_constraint``);
  * :func:`batch_split` holds the residual stream to the batch split and
    :func:`gathered` gathers a weight over the batch axes at its use
    (FSDP);
  * :func:`local_call` runs a function (a kernel, the router) on each
    rank's local shards through ``local_map``;
  * :func:`split_last` / :func:`merge_last` view (..., n·d) as
    (..., n, d) and back where a dim's shards do not fall on whole rows;
  * :func:`write_seq` writes a cache slice on each rank's local shard;
  * :func:`token_log_likelihood` is a vocabulary-parallel cross-entropy.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.sharding import (MODEL_AXIS, axis_size, batch_axes,
                                       fit_spec, mesh_shape, placements)

__all__ = ["constrain", "batch_split", "gathered", "entry", "entry_size",
           "local_call", "shard_index", "split_last", "merge_last",
           "write_seq", "token_log_likelihood"]


def constrain(x, spec):
    """Redistribute a DTensor activation to the placements of a
    config-carried spec (a tuple of axis names per dim, fitted again to
    ``x``'s shape); a plain tensor, or a None spec, is returned as it is."""
    if spec is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(
        mesh, fit_spec(mesh, tuple(x.shape), spec)))


def batch_split(h):
    """A DTensor activation split along its batch over the mesh's batch
    axes and whole along the rest: the data-parallel layout the JAX
    package's GSPMD settles on for the residual stream (between layers)
    and the Mamba2 mixer's input projection. DTensor propagates
    placements forward only; without this, partial sums of the
    tensor-parallel products leave them split in ways each later product
    (and its gradient) has to search a redistribution for. A plain tensor
    is returned as it is."""
    if not isinstance(h, DTensor):
        return h
    return constrain(h, (batch_axes(h.device_mesh),))


def gathered(w):
    """A DTensor weight gathered whole over the mesh's batch axes, its
    split over the other axes kept: FSDP's gather at the use site (the
    JAX package's GSPMD inserts it there; DTensor's own choice for a
    product whose contraction dim is split would move the activations
    instead). Its gradient comes back split by the inverse reduce-scatter.
    A plain tensor is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    names = list(mesh.mesh_dim_names)
    batch = {names.index(a) for a in batch_axes(mesh)}
    pl = [Replicate() if m in batch else p
          for m, p in enumerate(w.placements)]
    return w if pl == list(w.placements) else w.redistribute(mesh, pl)


def entry(spec, dim):
    """The mesh axes (None, a name or a tuple) that ``spec`` gives ``dim``."""
    spec = tuple(spec or ())
    return spec[dim] if dim < len(spec) else None


def entry_size(mesh, axes) -> int:
    """The number of shards of a dim split over ``axes`` (a spec entry)."""
    return axis_size(mesh_shape(mesh), axes)


def local_call(fn, args: tuple, specs: tuple, out_specs, partial=None):
    """``fn`` on each rank's local shards of its DTensor arguments, each
    first redistributed to its spec (None for a non-tensor or plain
    argument), and its outputs as DTensors placed by ``out_specs`` (one
    spec, or a list of them), partial sums over the mesh axes ``partial``
    names (an axis name or a tuple of them). A replicated argument used
    beside one that is split over a mesh axis gets a partial gradient over
    that axis: each rank's local call sees a different slice of the
    other's data. With no DTensor argument this is ``fn(*args)``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    in_pl = [tuple(placements(mesh, s)) if isinstance(a, DTensor)
             else None for a, s in zip(args, specs)]
    split = {m for pl in in_pl if pl for m, p in enumerate(pl)
             if isinstance(p, Shard)}
    grad_pl = [None if pl is None else tuple(
        Partial() if m in split and isinstance(p, Replicate) else p
        for m, p in enumerate(pl)) for pl in in_pl]
    many = isinstance(out_specs, list)
    summed = [] if partial is None else [
        list(mesh.mesh_dim_names).index(a)
        for a in (partial if isinstance(partial, tuple) else (partial,))]
    outs = [tuple(Partial() if m in summed else p for m, p in
                  enumerate(placements(mesh, s)))
            for s in (out_specs if many else [out_specs])]
    # local_map reads a tuple as one placement list per output
    return local_map(fn, out_placements=tuple(outs) if many
                     else list(outs[0]),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def shard_index(mesh, axes) -> int:
    """This rank's shard of a dim split over ``axes`` (a spec entry)."""
    idx = 0
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        idx = idx * mesh.size(list(mesh.mesh_dim_names).index(a)) \
            + mesh.get_local_rank(a)
    return idx


def split_last(x, n: int, d: int):
    """``x`` (..., n·d) viewed as (..., n, d). A DTensor split along its
    last dim over more shards than ``n`` divides into is gathered along it
    first (DTensor cannot view such a split as whole rows of d)."""
    if isinstance(x, DTensor):
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        shards = math.prod(x.device_mesh.size(m)
                           for m, p in enumerate(x.placements)
                           if isinstance(p, Shard) and p.dim == last)
        if n % shards:
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == last
                else p for p in x.placements])
    return x.reshape(*x.shape[:-1], n, d)


class _Merge(torch.autograd.Function):
    """(..., n, d) → (..., n·d) for a DTensor, whose gradient is split
    back by :func:`split_last` (DTensor's own view backward cannot split
    a dim sharded over more shards than n)."""

    @staticmethod
    def forward(ctx, x):
        ctx.n, ctx.d = x.shape[-2:]
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return split_last(g, ctx.n, ctx.d)


def merge_last(x):
    """``x`` (..., n, d) viewed as (..., n·d)."""
    if isinstance(x, DTensor):
        return _Merge.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def write_seq(buf, new, start: int):
    """``buf[:, start:start + S] = new`` in place (S = new's length); a
    DTensor cache is written on each rank's local shard, which may hold a
    slice of the sequence (a cache sharded on its sequence dim)."""
    if not isinstance(buf, DTensor):
        buf[:, start:start + new.shape[1]] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in buf.placements]
    local_new = new.redistribute(mesh, pl).to_local()
    local_buf = buf.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    lo = max(start, offset[1])
    hi = min(start + new.shape[1], offset[1] + shape[1])
    if lo < hi:
        local_buf[:, lo - offset[1]:hi - offset[1]] = \
            local_new[:, lo - start:hi - start]


class _SumOver(torch.autograd.Function):
    """An all-reduce sum over one mesh axis, inside a local call whose
    output is replicated over that axis: each rank's input reaches the
    one logical output once, so its gradient is the output's."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def token_log_likelihood(logits, labels):
    """Per token: the label's log-probability and the logsumexp of the
    logits (B, S, V) f32. On DTensors split along the vocabulary the two
    are reduced over the vocabulary's axis from each rank's slice (a
    vocabulary-parallel cross-entropy): DTensor's own log_softmax would
    gather the (B, S, V) logits and their gradient whole on every rank."""
    def plain(x, labels):
        logp = torch.log_softmax(x, dim=-1)
        return (logp.gather(-1, labels[..., None])[..., 0],
                torch.logsumexp(x, dim=-1))
    if not isinstance(logits, DTensor):
        return plain(logits, labels)
    mesh = logits.device_mesh
    names = list(mesh.mesh_dim_names)
    spec = fit_spec(mesh, tuple(logits.shape),
                        (batch_axes(mesh), None, MODEL_AXIS))
    b, v = entry(spec, 0), entry(spec, 2)
    if v is None:
        return local_call(plain, (logits, labels), ((b,), (b,)),
                           [(b,), (b,)])
    group = mesh.get_group(names.index(v))
    first = shard_index(mesh, v) * (logits.shape[-1] // entry_size(mesh, v))

    def local(x, labels):
        from torch.distributed import _functional_collectives as funcol
        Vl = x.shape[-1]
        m = funcol.wait_tensor(funcol.all_reduce(
            x.detach().amax(-1), "max", group))
        lse = m + torch.log(_SumOver.apply(
            torch.exp(x - m[..., None]).sum(-1), group))
        idx = labels - first
        inside = (idx >= 0) & (idx < Vl)
        xl = x.gather(-1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
        xl = _SumOver.apply(torch.where(inside, xl, 0.0), group)
        return xl - lse, lse
    return local_call(local, (logits, labels), ((b, None, v), (b,)),
                       [(b,), (b,)])
