"""Grouped expert GEMM: the wrapper of the Hopper kernel ``csrc/moe_gmm.cu``.

Computes ``out[z] = x[z] @ w[z mod P]`` for x (Z, C, D) and w (P, D, F)
with P = ``expert_period`` (default Z): Z runs over groups × experts and
every group reads the same P expert weights, which are never copied per
group. It replaces the Pallas TPU kernel
``src/repro/kernels/moe_gmm.py:43`` ``moe_gmm_kernel_call``.

What bounds it: at the training shapes (x (64, 1280, 1024) @ w (32, 1024,
512) and (64, 1280, 512) @ (32, 512, 1024), bf16) a call is 85.9 GFLOP,
0.087 ms of tensor-core work against 0.085 ms of memory traffic: on the
ridge, so it needs full wgmma issue and no redundant bytes. At prefill
(C 80) it is memory-bound by the 33.5 MB of expert weights. The CUDA
source has the design. The kernels a call takes (:func:`route`, chosen
before launch from the dtype, the widths and the pointers' alignment):

  * ``"wgmma"``: bf16 with D and F multiples of 8, 16-byte aligned
    pointers and C > 32 (and every such backward): persistent
    warp-specialised blocks run wgmma products fed by a TMA ring;
  * ``"wgmma_decode"``: the same bf16 widths at C <= 32 (decode): the
    expert weights stream through wgmma as its 64-row operand with the
    tokens (every group's, stacked) as its N, a TMA ring of weight
    stages per block, each expert's weights read once a call;
  * ``"tf32x3"``: f32: wgmma on TF32 operands split into big and small
    halves (3xTF32), which holds f32's 1e-4 (16-byte loads where D and F
    are multiples of 4 and the pointers aligned, else element by element);
  * ``"wgmma_edge"``: bf16 of any other widths or alignment (rows that
    are not whole 16-byte multiples, which TMA cannot take, or unaligned
    pointers), forward and backward at any C: the ``"wgmma"`` kernels'
    products on 128 x 128 tiles, the producer warpgroup loading B and
    each consumer warpgroup its own half of A, two threads a row, as the
    16-byte granules that cover it, shifted into the swizzled panels in
    registers, zero past the edge; the tiles stored from registers with
    masks.

A CPU tensor takes the plain version (:func:`moe_gmm_plain`) under
autograd. A CUDA tensor launches a kernel on the current stream or
raises: there is no fallback. It goes through the custom op
``torch.ops.repro_torch.moe_gmm``, whose autograd formula is the ops
``moe_gmm_dx`` and ``moe_gmm_dw``, two more launches (the JAX package
takes the VJP of the oracle, i.e. the same two grouped GEMMs). A meta
tensor (the dry run's) takes the same ops, which there only allocate
their outputs; each op has a FLOP formula (2·Z·C·D·F) for
``FlopCounterMode``. The backward is two kernels of the forward's route
(``"wgmma"`` for bf16 at any C, or ``"wgmma_edge"``; ``"tf32x3"`` for
f32) that read x, w and g as stored, with no copy: dx[z] = g[z] @
w[e]^T, and dw[e] = the sum over groups of x[z]^T @ g[z], summed in
registers in a fixed order (the bits repeat from run to run).

``launches`` counts forward kernel launches, ``bwd_launches`` backward
ones and ``route_launches`` both by route, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import moe_gmm_ref

__all__ = ["moe_gmm", "moe_gmm_plain", "moe_gmm_bwd", "route", "launches",
           "bwd_launches", "route_launches"]

launches = 0
bwd_launches = 0
route_launches = {"wgmma": 0, "wgmma_decode": 0, "tf32x3": 0,
                  "wgmma_edge": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# pointers a, b, out; Z C D F period dtype edge; the stream
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


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


def route(dtype: torch.dtype, C: int, D: int, F: int, aligned: bool,
          backward: bool = False) -> str:
    """The kernels a CUDA call takes, from the dtype, the widths and
    whether every pointer it reads or writes is 16-byte aligned (as
    ``csrc/moe_gmm.cu`` takes them): ``"tf32x3"`` (f32), ``"wgmma"``
    (bf16, D and F multiples of 8, aligned, C > 32 or a backward),
    ``"wgmma_decode"`` (the same at C <= 32) or ``"wgmma_edge"`` (bf16
    otherwise)."""
    if dtype == torch.float32:
        return "tf32x3"
    if D % 8 == 0 and F % 8 == 0 and aligned:
        return "wgmma" if backward or C > 32 else "wgmma_decode"
    return "wgmma_edge"


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _run(symbol, kind, a, b, out, Z, C, D, F, period):
    """One launch of a C entry point into ``out`` on the route ``kind``
    (counted by route only)."""
    route_launches[kind] += 1
    launch = _build.kernel_function("moe_gmm", symbol, _ARGTYPES)
    with _build.on_device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), Z, C, D, F,
               period, _DTYPE_CODES[a.dtype], int(kind == "wgmma_edge"),
               stream)
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, period: int) -> torch.Tensor:
    """One forward launch on contiguous CUDA tensors (counted by route
    only)."""
    Z, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((Z, C, F), dtype=x.dtype, device=x.device)
    kind = route(x.dtype, C, D, F, _aligned(x, w, out))
    return _run("moe_gmm_launch", kind, x, w, out, Z, C, D, F, period)


def moe_gmm_bwd(x, w, g, period, need_dx=True, need_dw=True):
    """The gradients (dx, dw) of ``moe_gmm(x, w, period)`` for the output
    gradient g, by two kernel launches on contiguous CUDA tensors that
    read x, w and g as stored (None for a gradient not asked for)."""
    global bwd_launches
    Z, C, D = x.shape
    F = w.shape[2]
    kind = route(x.dtype, C, D, F, _aligned(x, w, g), backward=True)
    dx = dw = None
    if need_dx:
        dx = _run("moe_gmm_dx_launch", kind, g, w, torch.empty_like(x), Z,
                  C, D, F, period)
        bwd_launches += 1
    if need_dw:
        dw = _run("moe_gmm_dw_launch", kind, x, g, torch.empty_like(w), Z,
                  C, D, F, period)
        bwd_launches += 1
    return dx, dw


# ----------------------------------------------------------------------
# the custom ops: CUDA launches, meta/fake allocation, autograd, FLOPs
# ----------------------------------------------------------------------

@torch.library.custom_op("repro_torch::moe_gmm", mutates_args=(),
                         device_types="cuda")
def _op(x: torch.Tensor, w: torch.Tensor, period: int) -> torch.Tensor:
    global launches
    out = _launch(x, w, period)
    launches += 1
    return out


@_op.register_fake
def _(x, w, period):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@torch.library.custom_op("repro_torch::moe_gmm_dx", mutates_args=(),
                         device_types="cuda")
def _dx_op(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
           period: int) -> torch.Tensor:
    return moe_gmm_bwd(x, w, g, period, need_dw=False)[0]


@_dx_op.register_fake
def _(x, w, g, period):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::moe_gmm_dw", mutates_args=(),
                         device_types="cuda")
def _dw_op(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
           period: int) -> torch.Tensor:
    return moe_gmm_bwd(x, w, g, period, need_dx=False)[1]


@_dw_op.register_fake
def _(x, w, g, period):
    return torch.empty_like(w)


def _setup_context(ctx, inputs, output):
    x, w, period = inputs
    ctx.save_for_backward(x, w)
    ctx.period = period


def _backward(ctx, g):
    x, w = ctx.saved_tensors
    g = g.contiguous()
    need_dx, need_dw = ctx.needs_input_grad[:2]
    dx = _dx_op(x, w, g, ctx.period) if need_dx else None
    dw = _dw_op(x, w, g, ctx.period) if need_dw else None
    return dx, dw, None


_op.register_autograd(_backward, setup_context=_setup_context)


def _flops(x_shape, w_shape):
    Z, C, D = x_shape
    return 2 * Z * C * D * w_shape[2]


@register_flop_formula([torch.ops.repro_torch.moe_gmm,
                        torch.ops.repro_torch.moe_gmm_dx,
                        torch.ops.repro_torch.moe_gmm_dw])
def _gmm_flops(x, w, *args, **kwargs):
    return _flops(x, w)


def moe_gmm(x: torch.Tensor, w: torch.Tensor,
            expert_period: int | None = None) -> torch.Tensor:
    """Per-expert GEMM: (Z, C, D) @ (P, D, F)[z mod P] → (Z, C, F)."""
    period = _check(x, w, expert_period)
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, expert_period)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gmm runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm needs contiguous x and w")
    return _op(x, w, period)
