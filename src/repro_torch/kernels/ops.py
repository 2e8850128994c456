"""Public kernel entry points of the port.

Each op is a hand-written Hopper kernel behind a wrapper that takes the
plain PyTorch version for CPU tensors and launches the kernel for CUDA
tensors. Serving has no backward, so no op carries an autograd rule yet.

Ported: ``moe_gmm``. Still to port (see ROADMAP.md): ``flash_attention``
and ``rmsnorm`` with the training slice, ``ssd_scan`` with Mamba2.
"""

from __future__ import annotations

from .moe_gmm import moe_gmm

__all__ = ["moe_gmm"]
