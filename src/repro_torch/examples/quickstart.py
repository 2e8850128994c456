"""Quickstart, the LM half (steps 5 and 6 of ``examples/quickstart.py``):
the SPMD adaptation of the paper's DFWSPT stealing, then a short
training run through the production loop.

Steps 1-4 of the JAX quickstart (the paper's machine, its priorities,
the NANOS simulator and a figure grid) run the simulator in
``repro.core.sim``: C and numpy on the host with no accelerator path,
which the port does not carry. Run them with ``examples/quickstart.py``.

5. Route MoE tokens on 16 experts of a 4 x 4 torus with three hot
   experts: without stealing the overflow is dropped; with nearest-first
   stealing (the steal table from the topology's hop distances) it goes
   to the nearest expert with room.
6. Train a reduced qwen2.5 for 30 steps through the training launcher.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import default_device
from repro_torch.core import topology
from repro_torch.core.routing import RoutingConfig, expert_steal_table, route
from repro_torch.launch import train

EXPERTS, TOKENS, HOT, BOOST = 16, 256, 3, 3.0


def moe_logits(seed: int = 0) -> np.ndarray:
    """(256, 16) router logits, N(0, 1) from ``seed``, the first three
    experts boosted by 3 (hot experts)."""
    logits = np.random.default_rng(seed).standard_normal(
        (TOKENS, EXPERTS)).astype(np.float32)
    logits[:, :HOT] += BOOST
    return logits


def main(argv=None):
    """Returns dict(drop_vanilla, drop_stealing, loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the CUDA device")
    args = ap.parse_args(argv)
    dev = default_device(args.device)

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
    return dict(drop_vanilla=drop_v, drop_stealing=drop_s, loss=loss)


if __name__ == "__main__":
    main()
