"""Training launcher (port of ``repro/launch/train.py``): AdamW over the
stateless token pipeline, with gradient accumulation, optional int8
gradient compression, the paper's topology-aware MoE steal table,
checkpoint-every-k with async writes and exact resume, and the heartbeat
monitor.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2.5-3b --steps 10 --global-batch 2 --seq-len 4096 \
        --attn-impl kernel
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-1b-a400m --steps 10 --global-batch 2 \
        --seq-len 4096 --attn-impl kernel --moe-impl kernel
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch mamba2-1.3b --steps 10 --global-batch 2 --seq-len 4096 \
        --ssm-impl kernel
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch hubert-xlarge --steps 10 --global-batch 2 --seq-len 4096 \
        --attn-impl kernel
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 30 --global-batch 4 --seq-len 32 \
        --checkpoint-dir /tmp/ckpt

Runs on the CUDA device unless ``--device cpu`` is given. Remat is off
with ``--reduced`` and "full" otherwise, as in the JAX launcher. Weights
come from a seeded ``torch.Generator`` on the device; the batches from
the stateless pipeline (``pipeline_for_arch``: frame embeddings for an
encoder such as hubert, patch embeddings for a VLM), the same arrays as
the JAX launcher's (the model casts the embeddings to its dtype). With
``--checkpoint-dir`` the run resumes from the directory's latest step
(weights and AdamW state, in the JAX package's on-disk layout, so either
package's checkpoint serves), saves every ``--checkpoint-every`` steps in
the background and once more at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs, convert, default_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import topology as topo_mod
from repro_torch.core.routing import expert_steal_table
from repro_torch.configs import ShapeSpec
from repro_torch.data import Prefetcher, pipeline_for_arch
from repro_torch.models import model as model_lib
from repro_torch.optim import (AdamWConfig, accumulate_gradients, adamw_init,
                               adamw_update, compressed_gradients)
from repro_torch.runtime import HeartbeatMonitor


def steal_table_for(cfg, device) -> torch.Tensor | None:
    """The MoE steal table from the modelled topology (``train.py:76-83``
    of the JAX launcher): experts spread over max(devices, E) chips of a
    1 x n torus, nearest first. The devices are those of the chosen
    device's platform, as ``len(jax.devices())`` counts them: the cards
    under ``cuda``, 1 under ``cpu``. None for a dense config."""
    if not cfg.moe_num_experts:
        return None
    n_cards = torch.cuda.device_count() \
        if torch.device(device).type == "cuda" else 1
    n_dev = max(n_cards or 1, cfg.moe_num_experts)
    topo = topo_mod.tpu_pod_2d(1, n_dev) if n_dev > 1 \
        else topo_mod.uma(cfg.moe_num_experts)
    owners = np.arange(cfg.moe_num_experts) % topo.num_cores
    table = expert_steal_table(topo, owners, cfg.moe_steal_policy)
    return torch.as_tensor(table, device=device)


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build_train_step(cfg, opt_cfg, n_micro, steal_table, compress=False):
    """step_fn(params, opt_state, comp_state, batch) -> (params, opt_state,
    comp_state, loss, grad_norm); ``params`` (a Model) is updated in
    place."""
    def step_fn(params, opt_state, comp_state, batch):
        named = dict(params.named_parameters())
        loss, grads, _ = accumulate_gradients(
            lambda b: model_lib.train_loss(params, cfg, b,
                                           steal_table=steal_table),
            named, batch, n_micro)
        if compress:
            grads, comp_state = compressed_gradients(grads, comp_state)
        _, opt_state, om = adamw_update(grads, opt_state, named, opt_cfg)
        return params, opt_state, comp_state, loss, om["grad_norm"]
    return step_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true",
                    help="same-family small config (host-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 + error feedback (cross-pod wire format)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--attn-impl", choices=("ref", "kernel"), default=None,
                    help="attention route (default: the config's)")
    ap.add_argument("--moe-impl", choices=("einsum", "kernel"), default=None,
                    help="expert FFN route (default: the config's)")
    ap.add_argument("--ssm-impl", choices=("ref", "kernel"), default=None,
                    help="Mamba2 scan route (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the CUDA device")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat="none" if args.reduced else "full")
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    if args.ssm_impl:
        cfg = dataclasses.replace(cfg, ssm_impl=args.ssm_impl)

    dev = default_device(args.device)
    steal = steal_table_for(cfg, dev)
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=args.warmup,
                          total_steps=args.steps)
    pipe = pipeline_for_arch(
        cfg, ShapeSpec("cli", args.seq_len, args.global_batch, "train"),
        seed=args.seed)

    start_step, mgr, tree = 0, None, None
    if args.checkpoint_dir:
        mgr = CheckpointManager(args.checkpoint_dir, keep_last=3)
        start_step, tree = mgr.restore_latest()
    if tree is not None:
        params = convert.from_jax(tree["params"], cfg, dev)
        opt_state = convert.opt_from_jax(tree["opt"], cfg, dev)
        del tree
        print(f"[train] resumed from step {start_step}")
    else:
        start_step = 0
        params = model_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
        opt_state = adamw_init(dict(params.named_parameters()), opt_cfg,
                               period=len(cfg.pattern))

    def snapshot():
        return {"params": convert.to_jax(params, cfg, numpy=False),
                "opt": convert.opt_to_jax(opt_state, cfg, numpy=False)}

    step_fn = build_train_step(cfg, opt_cfg, args.microbatches, steal,
                               args.compress_grads)
    comp_state = None
    monitor = HeartbeatMonitor(num_hosts=1)
    it = Prefetcher(pipe.iter_from(start_step))
    t_start = time.time()
    tokens_done = 0
    loss = float("nan")
    try:
        for step in range(start_step, args.steps):
            batch = to_device(next(it), dev)
            t0 = time.time()
            params, opt_state, comp_state, loss, gnorm = step_fn(
                params, opt_state, comp_state, batch)
            loss = float(loss)                  # waits for the device
            dt = time.time() - t0
            monitor.beat(0, dt)
            tokens_done += args.global_batch * args.seq_len
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(gnorm):7.3f} {dt*1e3:7.1f} ms/step "
                      f"{tokens_done/(time.time()-t_start):9.0f} tok/s")
            if mgr and (step + 1) % args.checkpoint_every == 0:
                mgr.save_async(step + 1, snapshot())
        if mgr:
            mgr.save_sync(args.steps, snapshot())
    finally:
        it.close()
        if mgr:
            mgr.wait()
    print(f"[train] done: final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
