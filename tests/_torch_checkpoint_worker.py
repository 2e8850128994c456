"""The runs of ``tests/test_torch_checkpoint_sharded.py``.

Run as a script, it is one rank of a gloo world on the CPU, or the JAX
writer:

    python tests/_torch_checkpoint_worker.py save RANK 4 PORT DIR
    python tests/_torch_checkpoint_worker.py resume RANK 2 PORT DIR
    python tests/_torch_checkpoint_worker.py jax DIR

``save`` (4 ranks, the (2, 2) ("data", "model") mesh, profile "2d"):
reduced qwen2.5-3b (f32) trains 2 steps of the dry run's train step,
then ``save_sync`` writes its weights and AdamW state (``convert.to_jax``
/ ``opt_to_jax`` with ``numpy=False``, DTensor leaves) to DIR/sync, and
the same blocks on the mesh's host twin (a "cpu" ``DeviceMesh`` without
process groups, what a CUDA mesh's snapshot lies on) to DIR/twin;
rank 0 writes every leaf gathered whole to DIR/gathered.npz. Then
``save_async`` writes the same state to DIR/async while step 3 runs its
collectives, and ``wait()``. Last, it restores the 4-device checkpoint
that the JAX writer left in DIR/jax onto the mesh (``restore_latest``
with the specs in the JAX layout, and ``from_jax`` +
``distribute_model``) and checks each rank's blocks against the whole.

``resume`` (2 ranks, the mesh (1, 2) whose rank grid is
``plan_elastic_remesh(tpu_pod_2d(2, 2), [2, 3], (2, 2), 2)``'s order):
restores DIR/sync, places it on that mesh and runs steps 3 and 4; rank 0
writes the losses and the weights gathered whole to DIR/resumed.npz.

``jax``: JAX on 4 host devices saves reduced qwen2.5-3b in bf16 and its
AdamW state (after one update), placed by the JAX package's role rules
on a (2, 2) mesh, to DIR/jax at step 1, and each leaf whole to
DIR/jax_whole.npz (bf16 as its 16-bit words).

Imported, :func:`reference` runs the 4 steps on plain tensors in one
process.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import (AdamWConfig, accumulate_gradients,  # noqa: E402
                               adamw_init)
from repro_torch.runtime import plan_elastic_remesh  # noqa: E402

ARCH = "qwen2.5-3b"
MESH, RESUME_FAILED = (2, 2), [2, 3]
TRAIN = dict(batch=8, seq=128, micro=2)
SAVE_AT, STEPS = 2, 4
OPT = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)


def _grid():
    """The (2, 2) mesh's rank grid and axes, for the unsharded runs."""
    return types.SimpleNamespace(mesh=torch.arange(4).reshape(MESH),
                                 mesh_dim_names=("data", "model"))


def config(mesh):
    spec = ShapeSpec("train", TRAIN["seq"], TRAIN["batch"], "train")
    return dryrun.adapt_config(configs.get(ARCH).reduced(), spec,
                               mesh or _grid(), micro=TRAIN["micro"])


def batches():
    cfg = configs.get(ARCH).reduced()
    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
        global_batch=TRAIN["batch"], seed=1))
    return [{k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
            for s in range(STEPS)]


def fresh(cfg):
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    return params, adamw_init(dict(params.named_parameters()), OPT,
                              period=len(cfg.pattern))


def place(params, state, mesh, cfg):
    """``params`` and ``state`` (plain) placed on ``mesh`` by the role
    rules; the state's moments by ``opt_state_specs``."""
    p_specs = shd.param_specs(mesh, params, cfg.sharding_profile)
    shd.distribute_model(params, mesh, p_specs)
    o_specs = shd.opt_state_specs(mesh, state, p_specs)
    state.update(shd.distribute_tree({"m": state["m"], "v": state["v"]},
                                     mesh, o_specs))
    return params, state


def run(params, state, cfg, mesh, start, stop):
    step = dryrun.make_train_step(cfg, OPT, TRAIN["micro"], None, mesh)
    losses = []
    for b in batches()[start:stop]:
        if mesh is not None:
            b = shd.distribute_tree(b, mesh, shd.batch_specs(mesh, b))
        params, state, loss, _ = step(params, state, b)
        losses.append(float(_whole(loss)))
    return params, state, losses


def _whole(t) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def snapshot(params, state, cfg) -> dict:
    return {"params": convert.to_jax(params, cfg, numpy=False),
            "opt": convert.opt_to_jax(state, cfg, numpy=False)}


def on_twin(tree, twin):
    """``tree``'s DTensor leaves rebuilt on ``twin`` from their local
    blocks."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: on_twin(v, twin) for k, v in tree.items()}
    if isinstance(tree, list):
        return [on_twin(v, twin) for v in tree]
    if isinstance(tree, DTensor):
        return DTensor.from_local(tree.to_local(), twin, tree.placements,
                                  shape=tree.shape, stride=tree.stride())
    return tree


def whole(tree) -> dict:
    """{checkpoint key: numpy array} of a tree, DTensors gathered (a
    collective on every rank)."""
    return {k: _whole(v).detach().numpy() for k, v in _flatten(tree).items()}


def reference() -> dict:
    """Steps 1-4 on plain tensors in one process: losses, the first
    step's gradients and the weights after step 4, by checkpoint key."""
    cfg = config(None)
    params, state = fresh(cfg)
    named = dict(params.named_parameters())
    _, grads, _ = accumulate_gradients(
        lambda b: model_lib.train_loss(params, cfg, b), named, batches()[0],
        TRAIN["micro"])
    params, state, losses = run(params, state, cfg, None, 0, STEPS)
    return dict(losses=np.array(losses), grads=whole(
        {"params": convert.to_jax(grads, cfg, numpy=False)}),
        final=whole({"params": convert.to_jax(params, cfg, numpy=False)}))


def _check_placed(tree, placed, what: str) -> int:
    """Every DTensor leaf of ``placed`` holds, on this rank, the slice of
    ``tree``'s whole leaf that its placement gives it; returns the
    number of leaves checked."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    want, got = _flatten(tree), _flatten(placed)
    assert want.keys() == got.keys(), what
    n = 0
    for k, leaf in got.items():
        if not isinstance(leaf, DTensor):
            assert torch.equal(leaf, want[k]), (what, k)
            continue
        shape, off = compute_local_shape_and_global_offset(
            leaf.shape, leaf.device_mesh, leaf.placements)
        sl = tuple(slice(o, o + s) for o, s in zip(off, shape))
        local = leaf.to_local()
        if local.dtype == torch.bfloat16:
            local, ref = local.view(torch.int16), \
                want[k][sl].view(torch.int16)
        else:
            ref = want[k][sl]
        assert torch.equal(local, ref), (what, k)
        n += 1
    return n


def save_world(rank: int, d: str) -> None:
    from repro_torch.checkpoint import restore
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device_type="cpu", shape=MESH)
    cfg = config(mesh)
    params, state = place(*fresh(cfg), mesh, cfg)
    params, state, _ = run(params, state, cfg, mesh, 0, SAVE_AT)
    snap = snapshot(params, state, cfg)
    CheckpointManager(os.path.join(d, "sync")).save_sync(SAVE_AT, snap)
    # the same blocks on the mesh's host twin (what a CUDA mesh's
    # snapshot lies on): the same checkpoint
    CheckpointManager(os.path.join(d, "twin")).save_sync(
        SAVE_AT, on_twin(snap, convert._host_twin(mesh)))
    gathered = whole(snap)
    if rank == 0:
        np.savez(os.path.join(d, "gathered.npz"), **gathered)
    mgr = CheckpointManager(os.path.join(d, "async"))
    mgr.save_async(SAVE_AT, snapshot(params, state, cfg))
    params, state, _ = run(params, state, cfg, mesh, SAVE_AT, SAVE_AT + 1)
    mgr.wait()

    # the JAX package's 4-device checkpoint onto this mesh
    jdir = os.path.join(d, "jax")
    jcfg = dataclasses.replace(cfg, dtype="bfloat16")
    like, like_state = fresh(jcfg)
    p_specs = shd.param_specs(mesh, like, jcfg.sharding_profile)
    specs = {"params": convert.specs_to_jax(p_specs, jcfg),
             "opt": convert.opt_specs_to_jax(
                 shd.opt_state_specs(mesh, like_state, p_specs), jcfg)}
    step, placed = CheckpointManager(jdir).restore_latest(mesh, specs)
    tree = restore(jdir, step)
    n = _check_placed(tree, placed, "restore_latest onto the mesh")
    model = convert.from_jax(tree["params"], jcfg, "cpu")
    shd.distribute_model(model, mesh, p_specs)
    n += _check_placed({"params": tree["params"]},
                       {"params": convert.to_jax(model, jcfg, numpy=False)},
                       "from_jax + distribute_model")
    with open(os.path.join(d, f"placed_{rank}.txt"), "w") as f:
        f.write(str(n))


def resume_world(rank: int, d: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    plan = plan_elastic_remesh(topology.tpu_pod_2d(2, 2), RESUME_FAILED,
                               MESH, 2)
    new_rank = {dev: r for r, dev in enumerate(sorted(plan.surviving))}
    grid = torch.tensor([new_rank[dev] for dev in plan.surviving]
                        ).reshape(plan.mesh_shape)
    mesh = DeviceMesh("cpu", grid, mesh_dim_names=("data", "model"))
    cfg = config(mesh)
    step, tree = CheckpointManager(os.path.join(d, "sync")).restore_latest()
    assert step == SAVE_AT, step
    params = convert.from_jax(tree["params"], cfg, "cpu")
    state = convert.opt_from_jax(tree["opt"], cfg, "cpu")
    params, state = place(params, state, mesh, cfg)
    params, state, losses = run(params, state, cfg, mesh, SAVE_AT, STEPS)
    final = whole({"params": convert.to_jax(params, cfg, numpy=False)})
    if rank == 0:
        np.savez(os.path.join(d, "resumed.npz"), losses=np.array(losses),
                 grid=grid.numpy(), **final)


def jax_writer(d: str) -> None:
    """Run with XLA_FLAGS=--xla_force_host_platform_device_count=4."""
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jckpt
    from repro import configs as jconfigs
    from repro import optim as joptim
    from repro.launch import shardings as jshd
    from repro.models import model as jmodel

    assert len(jax.devices()) == 4, jax.devices()
    cfg = dataclasses.replace(jconfigs.get(ARCH).reduced(), dtype="bfloat16")
    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(3))
    opt_cfg = joptim.AdamWConfig(lr_peak=1e-2, warmup_steps=1,
                                 total_steps=10)
    state = joptim.adamw_init(params, opt_cfg)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype)
                         * jnp.arange(p.size, dtype=p.dtype).reshape(
                             p.shape) / p.size, params)
    params, state, _ = joptim.adamw_update(grads, state, params, opt_cfg)
    ps = jshd.param_shardings(mesh, params, "2d")
    tree = {"params": jax.device_put(params, ps),
            "opt": jax.device_put(state, jshd.opt_state_shardings(
                mesh, state, ps))}
    sharded = [k for k, v in jckpt.checkpoint._flatten(tree).items()
               if len(v.sharding.device_set) > 1]
    assert sharded, "nothing sharded"
    jckpt.save(os.path.join(d, "jax"), 1, tree)
    out = {}
    for k, v in jckpt.checkpoint._flatten(tree).items():
        a = np.asarray(v)
        out[k] = a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    np.savez(os.path.join(d, "jax_whole.npz"), **out)


def main(argv) -> None:
    mode = argv[0]
    if mode == "jax":
        jax_writer(argv[1])
        return
    import torch.distributed as dist
    rank, world, port, d = int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        (save_world if mode == "save" else resume_world)(rank, d)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
