"""RMSNorm: the wrapper of the Hopper kernel ``csrc/rmsnorm.cu``.

Normalises the last axis of x (..., D) by its f32 root mean square and
scales by w (D,), cast back to x's dtype. It replaces the Pallas TPU
kernel ``repro/kernels/rmsnorm.py:rmsnorm_kernel_call``; any row count and
width run (the JAX op sends rows that do not tile to the oracle).

A CPU tensor takes the plain version (:func:`rmsnorm_plain`) under
autograd. A CUDA tensor launches the kernel or raises, through the custom
op ``torch.ops.repro_torch.rmsnorm`` (a meta tensor takes the op too,
which there only allocates its output; its FLOP formula counts 4
operations an element). Its backward is the plain version's autograd on
the saved inputs, as the JAX package's is the oracle's VJP
(``repro/kernels/ops.py:40-55``); no layer calls this kernel
(``use_kernel`` is never set), so no path needs more. ``launches`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_plain", "launches"]

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P]


def _check(x, w):
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"x must be (..., D) and w (D,); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x and w must share a dtype among "
                        f"{list(_DTYPE_CODES)}; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """The plain PyTorch version: the oracle ``rmsnorm_ref``."""
    _check(x, w)
    return rmsnorm_ref(x, w, eps)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    global launches
    x2 = x.contiguous().reshape(-1, x.shape[-1])
    w = w.contiguous()
    out = torch.empty_like(x2)
    launch = _build.kernel_function("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    with _build.on_device(x.device):
        launch(x2.data_ptr(), w.data_ptr(), out.data_ptr(), x2.shape[0],
               x2.shape[1], float(eps), _DTYPE_CODES[x.dtype],
               torch.cuda.current_stream().cuda_stream)
    launches += 1
    return out.reshape(x.shape)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=(),
                         device_types="cuda")
def _op(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return _launch(x, w, eps)


@_op.register_fake
def _(x, w, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _setup_context(ctx, inputs, output):
    x, w, eps = inputs
    ctx.save_for_backward(x, w)
    ctx.eps = eps


def _backward(ctx, g):
    x, w = ctx.saved_tensors
    with torch.enable_grad():
        xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
        out = rmsnorm_ref(xx, ww, ctx.eps)
        dx, dw = torch.autograd.grad(out, (xx, ww), g)
    return dx, dw, None


_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula(torch.ops.repro_torch.rmsnorm)
def _flops(x_shape, w_shape, *args, **kwargs):
    return 4 * math.prod(x_shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm over the last axis; any leading shape."""
    _check(x, w)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")
    if x.numel() == 0:
        raise ValueError("rmsnorm of an empty tensor")
    return _op(x, w, float(eps))
