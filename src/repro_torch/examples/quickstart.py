"""Quickstart: the paper's technique end to end (the port of
``examples/quickstart.py``).

1. Model the machine (hop-distance topology) as a `Machine`.
2. Compute the paper's core priorities; the `"paper"` binding compiles
   them into a thread→core map.
3. Run the NANOS simulator on a BOTS workload: baseline Nanos vs the
   paper's NUMA-aware execution context — two declarative contexts. On
   the card every simulation is a launch of the simulator's kernel.
4. Sweep a whole figure grid with one `Machine.grid` call: one launch,
   one thread of the card per cell.
5. Route MoE tokens on 16 experts of a 4 x 4 torus with three hot
   experts: without stealing the overflow is dropped; with nearest-first
   stealing (the steal table from the topology's hop distances) it goes
   to the nearest expert with room.
6. Train a reduced qwen2.5 for 30 steps through the training launcher.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
        [--sim-only]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core import priority, topology
from repro_torch.core.routing import RoutingConfig, expert_steal_table, route
from repro_torch.core.sim import Machine, bots
from repro_torch.launch import train

EXPERTS, TOKENS, HOT, BOOST = 16, 256, 3, 3.0


def moe_logits(seed: int = 0) -> np.ndarray:
    """(256, 16) router logits, N(0, 1) from ``seed``, the first three
    experts boosted by 3 (hot experts)."""
    logits = np.random.default_rng(seed).standard_normal(
        (TOKENS, EXPERTS)).astype(np.float32)
    logits[:, :HOT] += BOOST
    return logits


def simulate_steps(dev: torch.device) -> dict:
    """Steps 1-4 on ``dev``; prints what the JAX quickstart prints and
    returns dict(baseline, numa, grid) speedups."""
    # -- 1. the paper's machine ---------------------------------------
    topo = topology.sunfire_x4600()
    m = Machine(topo, device=dev)
    print(f"machine: {topo.name}: {topo.num_cores} cores / "
          f"{topo.num_nodes} NUMA nodes, ≤{topo.max_distance()} hops")

    # -- 2. priorities (Figs 2–4) + thread binding --------------------
    pr = priority.priorities(topo)
    ctx = m.context(threads=16, binding="paper", placement="spill:2")
    print(f"core priorities: min={pr.total.min():.1f} "
          f"max={pr.total.max():.1f}")
    print(f"master core: {ctx.master_core} (node {ctx.master_node}) — "
          f"the topology centroid; root arrays spill over nodes "
          f"{ctx.root_data_nodes}")

    # -- 3. simulator: baseline Nanos vs the paper --------------------
    # baseline Nanos (threads in OS enumeration order and unbound,
    # runtime + root data first-touched on node 0) vs the paper's
    # (priority binding, local runtime data, spill from the master's
    # node); one shared serial reference
    wl = bots.fft(n=1 << 14, cutoff=4)
    serial = m.serial_time(wl, placement="spill:2@0")
    base = m.run(wl, "wf", seed=0, serial_reference=serial,
                 threads=16, binding="linear", placement="spill:2@0",
                 runtime_data=0, migration_rate=0.15)
    numa = m.run(wl, "dfwspt", seed=0, serial_reference=serial,
                 context=ctx)
    print(f"FFT@16: baseline wf {base.speedup:.2f}x → "
          f"NUMA-aware DFWSPT {numa.speedup:.2f}x "
          f"({(numa.speedup/base.speedup-1)*100:+.1f}%)")

    # -- 4. a whole paper figure as one declarative grid --------------
    grid = m.grid(workloads=[wl], schedulers=("wf", "dfwspt", "dfwsrpt"),
                  threads=(4, 16), placements=("spill:2",),
                  serial_reference=serial)
    res = grid.run()    # one batched engine call, {GridKey: SimResult}
    row = " ".join(f"{k.scheduler}@{k.threads}={r.speedup:.2f}x"
                   for k, r in res.items())
    print(f"grid ({len(res)} cells, 1 batched call): {row}")
    return dict(baseline=base.speedup, numa=numa.speedup,
                grid={(k.scheduler, k.threads): r.speedup
                      for k, r in res.items()})


def main(argv=None):
    """Returns dict(sim, drop_vanilla, drop_stealing, loss); with
    ``--sim-only`` dict(sim) alone."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the CUDA device")
    ap.add_argument("--sim-only", action="store_true",
                    help="steps 1-4 only (skip MoE routing + training)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

    sim = simulate_steps(dev)
    if args.sim_only:
        print("(--sim-only: skipping MoE routing + training steps)")
        return dict(sim=sim)

    # -- 5. the SPMD adaptation: locality-aware MoE overflow ----------
    pod = topology.tpu_pod_2d(4, 4)
    table = expert_steal_table(pod, np.arange(EXPERTS), "dfwspt")
    logits = torch.from_numpy(moe_logits()).to(dev)
    vanilla = route(logits, RoutingConfig(EXPERTS, 1, EXPERTS,
                                          steal_attempts=0))
    local = route(logits, RoutingConfig(EXPERTS, 1, EXPERTS,
                                        steal_attempts=3), table)
    drop_v = float(vanilla["drop_fraction"])
    drop_s = float(local["drop_fraction"])
    print(f"MoE overflow: drop {drop_v:.1%} -> {drop_s:.1%} with "
          "nearest-first stealing")

    # -- 6. the production loop at toy scale --------------------------
    print("\ntraining a reduced qwen2.5 for 30 steps:")
    loss = train.main(["--arch", "qwen2.5-3b", "--reduced", "--steps", "30",
                       "--global-batch", "4", "--seq-len", "64",
                       "--lr", "2e-3", "--warmup", "5", "--log-every", "10",
                       "--device", str(dev)])
    return dict(sim=sim, drop_vanilla=drop_v, drop_stealing=drop_s,
                loss=loss)


if __name__ == "__main__":
    main()
