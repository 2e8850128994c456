"""RMSNorm: the wrapper of the Hopper kernel ``csrc/rmsnorm.cu``.

Normalises the last axis of x (..., D) by its f32 root mean square and
scales by w (D,), cast back to x's dtype. It replaces the Pallas TPU
kernel ``repro/kernels/rmsnorm.py:rmsnorm_kernel_call``; any row count and
width run (the JAX op sends rows that do not tile to the oracle). Three
routes (:func:`route`, chosen here before launch from the dtype, the
width and the alignment, and passed to the CUDA source, which refuses a
route that does not take the rows), the first two for rows of whole
16-byte vectors with 16-byte aligned x and w:

  * ``"bulk"``: rows of more than 512 bytes up to 32 KB (D 1024 to 8192,
    the widths the architectures normalise a model's width at):
    persistent blocks read each row once through a ring of 1-D bulk async
    copies into shared memory;
  * ``"vector"``: rows of at most 512 bytes (the q/k-norm's D 128): a few
    lanes a row, one 16-byte load a lane;
  * ``"plain"``: every other width or alignment: one warp a row, element
    by element.

A CPU tensor takes the plain version (:func:`rmsnorm_plain`) under
autograd. A CUDA tensor launches the kernel or raises, through the custom
op ``torch.ops.repro_torch.rmsnorm`` (a meta tensor takes the op too,
which there only allocates its output; its FLOP formula counts 4
operations an element). Its backward is the plain version's autograd on
the saved inputs, as the JAX package's is the oracle's VJP
(``repro/kernels/ops.py:40-55``); no layer calls this kernel
(``use_kernel`` is never set), so no path needs more. ``launches`` counts
kernel launches, ``route_launches`` the same by route, and nothing else.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_plain", "route", "launches",
           "route_launches"]

launches = 0
route_launches = {"bulk": 0, "vector": 0, "plain": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P]
_ROUTE_CODES = {"bulk": 0, "vector": 1, "plain": 2}
MAX_ROW_BYTES = 32 * 1024           # the "bulk" route's widest row
VECTOR_ROW_BYTES = 512              # the "vector" route's widest row


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


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel a CUDA call takes: for rows of a multiple of 16 bytes
    up to 32 KB with x and w 16-byte aligned as the kernel reads them (a
    tensor that is not contiguous is copied, which aligns it; the output
    is a fresh allocation), ``"vector"`` up to 512-byte rows and
    ``"bulk"`` above; else ``"plain"``. A meta tensor counts as aligned
    where its offset into its storage is, as every block of the CUDA
    allocator is."""
    def aligned(t):
        if not t.is_contiguous():
            return True
        if t.device.type == "cuda":
            return t.data_ptr() % 16 == 0
        return t.storage_offset() * t.element_size() % 16 == 0
    row_bytes = x.shape[-1] * x.element_size()
    if (row_bytes % 16 or row_bytes > MAX_ROW_BYTES or not aligned(x)
            or not aligned(w)):
        return "plain"
    return "vector" if row_bytes <= VECTOR_ROW_BYTES else "bulk"


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float,
            kind: str | None = None) -> torch.Tensor:
    """One counted launch of route ``kind`` (default: :func:`route`'s
    choice) on CUDA tensors; ``compare_rmsnorm`` names the route to time
    the routes against one another."""
    global launches
    x2 = x.contiguous().reshape(-1, x.shape[-1])
    w = w.contiguous()
    kind = route(x2, w) if kind is None else kind
    out = torch.empty_like(x2)
    launch = _build.kernel_function("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    with _build.on_device(x.device):
        launch(x2.data_ptr(), w.data_ptr(), out.data_ptr(), x2.shape[0],
               x2.shape[1], float(eps), _DTYPE_CODES[x.dtype],
               _ROUTE_CODES[kind], torch.cuda.current_stream().cuda_stream)
    launches += 1
    route_launches[kind] += 1
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
