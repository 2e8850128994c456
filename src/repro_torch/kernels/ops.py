"""Public kernel entry points of the port (mirror of
``repro/kernels/ops.py``).

Each op is a hand-written Hopper kernel behind a wrapper that takes the
plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors, and each is differentiable: ``flash_attention``, ``moe_gmm`` and
``ssd_scan`` through kernel backwards, ``rmsnorm`` through its plain
version's autograd (as the JAX package's backward is the oracle's VJP).
Unlike the JAX ops, no shape is sent to the oracle: ragged edges are
masked in the kernels.
"""

from __future__ import annotations

from .flash_attention import flash_attention, flash_attention_split
from .moe_gmm import moe_gmm
from .rmsnorm import rmsnorm
from .ssd_scan import ssd_scan

__all__ = ["flash_attention", "flash_attention_split", "moe_gmm", "rmsnorm",
           "ssd_scan"]
