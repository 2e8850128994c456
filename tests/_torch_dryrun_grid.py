"""The dry-run grid check shared by ``tests/test_torch_dryrun_grid_{0,1}.py``
(mesh (16,16)) and ``tests/test_torch_dryrun_multi_{0,1}.py``
((2,16,16)), each half of the archs.

Each (arch × shape) cell of the grid runs through the port's
``run_cell`` on the reduced config at the grid's shapes, on placeholder
ranks. It must come out ``ok``, or ``skipped`` with the reason the JAX
package gives, and its per-rank argument bytes must equal the sum of the
local shard sizes of JAX's own specs for the same leaves (parameters,
AdamW ``m`` and ``v``, batch, caches; JAX's step counter and cache length
are scalars the port keeps as Python ints), computed here from shapes.
The port's prefill step takes its empty caches as arguments, where JAX's
makes them inside the step: those are counted from JAX's cache specs.

Two sizing choices keep the grid inside the test budget, neither of
which touches what is checked: training cells run 2 microbatches (the
loop is the same for any count; ``num_microbatches`` is held to JAX's
separately), and a Mamba2 layer's scan runs as the ``ssd_scan`` op in
training and with chunks of 1024 in prefill (the reduced config's chunk
of 16 is 2048 Python-loop steps a layer at 32k tokens).
"""

from __future__ import annotations

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import shardings as jshd
from repro.models import model as jmodel
from repro.models import stack as jstack
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init

from repro_torch import configs
from repro_torch.launch import dryrun

MICRO = 2


class DuckMesh:
    """Duck-typed JAX mesh (tests/test_system.py:97)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def overrides(cfg, kind: str):
    if not cfg.ssm_state:
        return None
    if kind == "train":
        return {"ssm_impl": "kernel"}
    if kind == "prefill":
        return {"ssm_chunk": 1024}
    return None


def _local_bytes(sds, spec, sizes) -> int:
    entries = list(tuple(spec)) + [None] * (len(sds.shape) - len(spec))
    n = 1
    for dim, e in zip(sds.shape, entries):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * jnp.dtype(sds.dtype).itemsize


def _tree_bytes(tree, specs, sizes) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(_local_bytes(x, s, sizes) for x, s in zip(leaves, spec_leaves)
               if x.shape != ())          # scalars: count / cache length


def jax_argument_bytes(arch: str, shape: str, sizes: dict,
                       kv_repeat: int) -> int:
    """Per-rank argument bytes of a cell from the JAX package's specs
    (``NamedSharding`` replaced by the bare spec, see the caller)."""
    cfg = dataclasses.replace(jconfigs.get(arch).reduced(),
                              kv_repeat=kv_repeat)
    spec = jconfigs.SHAPES[shape]
    mesh = DuckMesh(sizes)
    params = jmodel.abstract_params(cfg)
    p_specs = jshd.param_specs(mesh, params, cfg.sharding_profile)
    total = _tree_bytes(params, p_specs, sizes)
    B, S = spec.global_batch, spec.seq_len
    if spec.kind in ("train", "prefill"):
        batch = {"labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
        if cfg.embeds_input:
            batch["embeds"] = jax.ShapeDtypeStruct((B, S, cfg.d_model),
                                                   cfg.param_dtype)
        else:
            batch["tokens"] = jax.ShapeDtypeStruct((B, S), jnp.int32)
        if cfg.num_media_tokens:
            batch["media"] = jax.ShapeDtypeStruct(
                (B, cfg.num_media_tokens, cfg.d_model), cfg.param_dtype)
    else:
        batch = {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32)}
    total += _tree_bytes(batch, jshd.batch_shardings(mesh, batch), sizes)
    if spec.kind == "train":
        factored = arch in dryrun.FACTORED_OPT
        opt = jax.eval_shape(lambda p: jadamw_init(p, JAdamWConfig(
            factored=factored,
            m_dtype="bfloat16" if factored else "float32")), params)
        o_specs = jshd.opt_state_shardings(mesh, opt, p_specs)
        total += _tree_bytes(opt, o_specs, sizes)
    elif not cfg.is_encoder:
        caches = jax.eval_shape(lambda: jstack.init_caches(
            cfg, B, S, cfg.param_dtype))
        if spec.kind == "prefill":
            # the port's prefill step takes its empty caches as arguments
            # (JAX's makes them inside the step); a cross layer's media
            # projections are made by prefill, not passed in
            caches["slots"] = [None if kind == "cross" else c for c, (kind, _)
                               in zip(caches["slots"], cfg.pattern)]
        total += _tree_bytes(caches, jshd.cache_shardings(mesh, caches),
                             sizes)
    return total


def check_cell(arch: str, shape: str, mesh_kind: str, out_dir) -> dict:
    cfg = configs.get(arch).reduced()
    spec = configs.SHAPES[shape]
    rec = dryrun.run_cell(arch, shape, mesh_kind, skip_existing=False,
                          verbose=False, cfg=cfg,
                          micro_override=MICRO if spec.kind == "train"
                          else None,
                          cfg_overrides=overrides(cfg, spec.kind),
                          out_dir=str(out_dir))
    assert os.path.exists(os.path.join(
        str(out_dir), dryrun.cell_id(arch, shape, mesh_kind) + ".json"))
    if shape not in cfg.shapes():
        jreason = jconfigs.get(arch).skipped_shapes()[shape]
        assert rec["status"] == "skipped"
        assert jreason.startswith(rec["reason"]), (rec["reason"], jreason)
        return rec
    assert rec["status"] == "ok"
    sizes = ({"pod": 2, "data": 16, "model": 16} if mesh_kind == "multi"
             else {"data": 16, "model": 16})
    kv = dryrun.adapt_config(cfg, spec, sizes, micro=MICRO).kv_repeat
    assert rec["memory"]["argument_bytes"] == \
        jax_argument_bytes(arch, shape, sizes, kv)
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["num_devices"] == math.prod(sizes.values())
    assert rec["microbatches"] == (MICRO if spec.kind == "train" else 1)
    if spec.kind == "train":
        # every training step synchronises its gradients somehow
        assert any(k in rec["collectives"]
                   for k in ("all-reduce", "reduce-scatter")), rec
    if mesh_kind == "multi" and spec.kind == "train":
        assert sum(c["cross_pod_bytes"] for c in
                   rec["collectives"].values()) > 0
    return rec


def grid(part: int):
    """Half ``part`` (0 or 1) of the grid's archs × shapes: the two meshes'
    grids run as four test files, so that ``--dist loadfile`` spreads
    them over four workers."""
    archs = sorted(configs.ARCHS)[part::2]
    return [(a, s) for a in archs for s in configs.SHAPES]

