"""End-to-end example (port of ``examples/train_lm.py``): train a ~100M
dense LM with checkpointing and exact resume, in two phases through the
training launcher (``repro_torch.launch.train.main``): phase 1 trains
half the steps and checkpoints, phase 2 is a restart that resumes from
that checkpoint and runs to the end.

The config is a scaled stablelm-family model (~100M params: 12 layers,
d 768, 12 heads, FF 2048, 32k vocabulary, float32); the default schedule
is the JAX example's short one, ``--steps 300`` the full run.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \
        [--steps 300] [--device cpu] [--checkpoint-dir DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models import model


def lm_100m():
    return dataclasses.replace(
        configs.get("stablelm-1.6b"), name="stablelm-100m", num_layers=12,
        d_model=768, num_heads=12, num_kv_heads=12, head_dim=64, d_ff=2048,
        vocab_size=32768, dtype="float32", remat="none")


def main(argv=None):
    """Returns phase 2's final loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the CUDA device")
    args = ap.parse_args(argv)

    cfg = lm_100m()
    print(f"[example] {cfg.name}: {model.param_count(cfg)/1e6:.1f}M params")
    configs.ARCHS[cfg.name] = cfg     # so that the launcher can name it

    common = ["--arch", cfg.name, "--global-batch", str(args.global_batch),
              "--seq-len", str(args.seq_len), "--lr", "3e-4",
              "--warmup", "20", "--checkpoint-dir", args.checkpoint_dir,
              "--checkpoint-every", "10", "--log-every", "10"]
    if args.device:
        common += ["--device", args.device]
    half = args.steps // 2
    print(f"[example] phase 1: steps 0..{half}, checkpointing")
    train.main(common + ["--steps", str(half)])
    print(f"[example] phase 2: auto-resume to {args.steps} "
          f"(simulated restart)")
    loss = train.main(common + ["--steps", str(args.steps)])
    print(f"[example] final loss {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()
