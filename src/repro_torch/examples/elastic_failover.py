"""Fault-tolerance walk-through (port of ``examples/elastic_failover.py``):
train, lose modelled chips mid-run, shrink the mesh with the paper's
priority re-placement, restore the last checkpoint, continue; a host
that turns into a straggler is evicted.

    PYTHONPATH=src python -m repro_torch.examples.elastic_failover \
        [--device cpu]

The model trains for real (reduced qwen2.5-3b on one device); the 32
chips of ``multi_pod(2, 4, 4)`` behind the (4, 8) mesh, their failure
and the hosts' step times are modelled. The decision code (straggler
detection, remesh planning, checkpoint and restore) is the production
path: ``runtime.Supervisor`` with checkpoints of the JAX package's
layout in a temporary directory. The schedule is the JAX example's: 40
steps, a checkpoint every 10, chips 5 and 6 fail before step 17, host 3
runs 3x slower from step 25.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch import configs, convert, default_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import topology
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.launch import train as train_mod
from repro_torch.models import model as model_lib
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import Supervisor

ARCH = "qwen2.5-3b"
STEPS, CHECKPOINT_EVERY = 40, 10
NUM_HOSTS, TOPOLOGY, MESH_SHAPE, MODEL_AXIS = 4, (2, 4, 4), (4, 8), 8
FAILURE = {17: [5, 6]}
STRAGGLER, STRAGGLER_FROM, SLOWDOWN = 3, 25, 3.0


def host_times(step: int) -> list[float]:
    """The hosts' modelled step times: 1 each, the straggler's 3 from
    ``STRAGGLER_FROM`` on."""
    return [SLOWDOWN if h == STRAGGLER and step >= STRAGGLER_FROM else 1.0
            for h in range(NUM_HOSTS)]


def main(argv=None):
    """Returns (the Supervisor's events, the loss of every executed step,
    replays included)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the CUDA device")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    cfg = configs.get(ARCH).reduced()
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=5, total_steps=60)
    pipe = TokenPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                        seq_len=32, global_batch=8))
    step_fn = train_mod.build_train_step(cfg, opt_cfg, 1, None)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = {"params": params, "losses": [], "mesh": MESH_SHAPE,
             "opt": adamw_init(dict(params.named_parameters()), opt_cfg,
                               period=len(cfg.pattern))}

    with tempfile.TemporaryDirectory(prefix="elastic_failover_") as d:
        mgr = CheckpointManager(d, keep_last=2)

        def run_step(s):
            batch = train_mod.to_device(pipe.batch_at(s), dev)
            state["params"], state["opt"], _, loss, _ = step_fn(
                state["params"], state["opt"], None, batch)
            state["losses"].append(float(loss))
            return host_times(s)

        def save(s):
            mgr.save_sync(s, {
                "params": convert.to_jax(state["params"], cfg, numpy=False),
                "opt": convert.opt_to_jax(state["opt"], cfg, numpy=False)})

        def restore():
            step, tree = mgr.restore_latest()
            if step is None:
                return 0
            state["params"] = convert.from_jax(tree["params"], cfg, dev)
            state["opt"] = convert.opt_from_jax(tree["opt"], cfg, dev)
            return step

        def remesh(plan):
            state["mesh"] = plan.mesh_shape
            print(f"[elastic] new mesh {plan.mesh_shape}, "
                  f"{len(plan.surviving)} devices, "
                  f"DP scale x{plan.data_parallel_scale:.2f}")

        sup = Supervisor(num_hosts=NUM_HOSTS,
                         checkpoint_every=CHECKPOINT_EVERY,
                         run_step=run_step, save=save, restore=restore,
                         remesh=remesh,
                         topo=topology.multi_pod(*TOPOLOGY),
                         mesh_shape=MESH_SHAPE, model_axis_size=MODEL_AXIS)
        final = sup.run(0, STEPS, inject_failure=FAILURE)
    losses = state["losses"]
    print(f"[elastic] finished at step {final}")
    print("[elastic] events:")
    for s, e in sup.events:
        print(f"   step {s:3d}: {e}")
    print(f"[elastic] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} executed steps (incl. replays)")
    return sup.events, losses


if __name__ == "__main__":
    main()
