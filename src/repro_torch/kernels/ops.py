"""Public kernel entry points of the port (mirror of
``repro/kernels/ops.py``).

Each op is a hand-written Hopper kernel behind a wrapper that takes the
plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors, and each is differentiable: ``flash_attention`` and ``moe_gmm``
through kernel backwards, ``rmsnorm`` through its plain version's
autograd (as the JAX package's backward is the oracle's VJP). Unlike the
JAX ops, no shape is sent to the oracle: ragged edges are masked in the
kernels.

Still to port (see ROADMAP.md): ``ssd_scan`` with Mamba2.
"""

from __future__ import annotations

from .flash_attention import flash_attention
from .moe_gmm import moe_gmm
from .rmsnorm import rmsnorm

__all__ = ["flash_attention", "moe_gmm", "rmsnorm"]
