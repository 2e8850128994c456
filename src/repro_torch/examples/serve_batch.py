"""Batched serving across architectures (port of
``examples/serve_batch.py``): prefill and greedy decode of reduced
qwen2.5-3b (attention cache), mamba2-1.3b (SSM state) and
jamba-1.5-large (both), through the serving launcher
(``repro_torch.launch.serve.main``).

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import serve

ARCHS = ("qwen2.5-3b", "mamba2-1.3b", "jamba-1.5-large-398b")


def main(argv=None):
    """Returns {arch: generated tokens (B, gen)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the CUDA device")
    args = ap.parse_args(argv)
    out = {}
    for arch in ARCHS:
        print(f"\n=== {arch} (reduced config) ===")
        out[arch] = serve.main(
            ["--arch", arch, "--reduced", "--batch", "4", "--prompt-len",
             "64", "--gen", "16"]
            + (["--device", args.device] if args.device else []))
    return out


if __name__ == "__main__":
    main()
