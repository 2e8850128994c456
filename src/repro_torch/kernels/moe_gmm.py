"""Grouped expert GEMM: the wrapper of the Hopper kernel ``csrc/moe_gmm.cu``.

Computes ``out[z] = x[z] @ w[z mod P]`` for x (Z, C, D) and w (P, D, F)
with P = ``expert_period`` (default Z): Z runs over groups × experts and
every group reads the same P expert weights, which are never copied per
group. It replaces the Pallas TPU kernel
``repro/kernels/moe_gmm.py:moe_gmm_kernel_call``; see the CUDA source for
the design and what bounds it.

A CPU tensor takes the plain version (:func:`moe_gmm_plain`) under
autograd. A CUDA tensor launches the kernel on the current stream or
raises: there is no fallback. On CUDA the gradient is a
``torch.autograd.Function`` whose backward is two more launches of the
same kernel (the JAX package takes the VJP of the oracle, i.e. the same
two grouped GEMMs):

  * dx = moe_gmm(g, w^T) with the same period, w^T (P, F, D) contiguous;
  * dw[e] = sum over groups of x[g, e]^T g[g, e]: one call with Z = P on
    x^T laid out (P, D, groups*C) and g laid out (P, groups*C, F).

The transposed copies cost memory traffic that a kernel reading
transposed operands would not (later work). ``launches`` counts forward
kernel launches and ``bwd_launches`` backward ones, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import moe_gmm_ref

__all__ = ["moe_gmm", "moe_gmm_plain", "moe_gmm_bwd", "launches",
           "bwd_launches"]

launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_MAX_Z = 65535            # gridDim.z


def _check(x: torch.Tensor, w: torch.Tensor, expert_period: int | None):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be (Z, C, D) and w (P, D, F); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    Z, C, D = x.shape
    period = Z if expert_period is None else expert_period
    if w.shape[0] != period or w.shape[1] != D:
        raise ValueError(f"w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)} with expert_period {period}")
    if period <= 0 or Z % period:
        raise ValueError(f"Z={Z} is not a multiple of expert_period "
                         f"{period}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x and w must share a dtype among "
                        f"{list(_DTYPE_CODES)}; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    return period


def moe_gmm_plain(x: torch.Tensor, w: torch.Tensor,
                  expert_period: int | None = None) -> torch.Tensor:
    """The plain PyTorch version: f32 einsum, cast to x's dtype."""
    period = _check(x, w, expert_period)
    Z, C, D = x.shape
    if period == Z:
        return moe_gmm_ref(x, w)
    out = torch.einsum("gecd,edf->gecf",
                       x.reshape(Z // period, period, C, D).float(),
                       w.float())
    return out.to(x.dtype).reshape(Z, C, -1)


def _launch(x: torch.Tensor, w: torch.Tensor, period: int) -> torch.Tensor:
    """One kernel launch on contiguous CUDA tensors (uncounted)."""
    Z, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((Z, C, F), dtype=x.dtype, device=x.device)
    launch = _build.kernel_function("moe_gmm", "moe_gmm_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), Z, C, D, F,
               period, _DTYPE_CODES[x.dtype], stream)
    return out


def moe_gmm_bwd(x, w, g, period, need_dx=True, need_dw=True):
    """The gradients (dx, dw) of ``moe_gmm(x, w, period)`` for the output
    gradient g, by two launches of the kernel on contiguous CUDA tensors
    (None for a gradient not asked for)."""
    global bwd_launches
    Z, C, D = x.shape
    F = w.shape[2]
    dx = dw = None
    if need_dx:
        dx = _launch(g, w.transpose(1, 2).contiguous(), period)
        bwd_launches += 1
    if need_dw:
        G = Z // period
        xt = x.reshape(G, period, C, D).permute(1, 3, 0, 2)
        gt = g.reshape(G, period, C, F).permute(1, 0, 2, 3)
        dw = _launch(xt.reshape(period, D, G * C).contiguous(),
                     gt.reshape(period, G * C, F).contiguous(), period)
        bwd_launches += 1
    return dx, dw


class _MoeGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, period):
        global launches
        ctx.save_for_backward(x, w)
        ctx.period = period
        out = _launch(x, w, period)
        launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = moe_gmm_bwd(x, w, g.contiguous(), ctx.period,
                             *ctx.needs_input_grad[:2])
        return dx, dw, None


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            expert_period: int | None = None) -> torch.Tensor:
    """Per-expert GEMM: (Z, C, D) @ (P, D, F)[z mod P] → (Z, C, F)."""
    period = _check(x, w, expert_period)
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, expert_period)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm needs contiguous x and w")
    if x.shape[0] > _MAX_Z:
        raise ValueError(f"Z={x.shape[0]} exceeds the kernel's grid limit "
                         f"{_MAX_Z}")
    return _MoeGmm.apply(x, w, period)
