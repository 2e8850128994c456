"""PyTorch/CUDA port of the ``repro`` LM stack for NVIDIA Hopper (sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs``, ``kernels``, ``core.routing``, ``models``,
``launch``) and imports nothing of it. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper takes its plain PyTorch version.

float32 on the card means float32: TF32 is switched off for matmuls and
cuDNN when this package is imported, so the float32 paths hold the same
tolerances as the JAX reference. bf16 matmuls sum in float32 throughout:
cuBLAS's reduced-precision (bf16) split-K reductions are switched off too,
so the library route sums as the hand-written kernels do.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["default_device"]


def default_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it returns ``cuda`` and raises when no CUDA
    device is present (there is no silent fallback to the host). The CPU
    is used only when the caller asks for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for but CUDA is not "
                           "available")
    return dev
