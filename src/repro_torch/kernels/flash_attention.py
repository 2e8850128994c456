"""Flash attention: the wrapper of the Hopper kernels
``csrc/flash_attention.cu`` (forward and backward).

GQA attention in the JAX package's BSHD layout, q (B, Sq, Hq, D) over
k/v (B, Skv, Hkv, D), causal or bidirectional, with an optional sliding
window, on absolute positions shifted by ``kv_offset``. It replaces the
Pallas TPU kernel ``repro/kernels/flash_attention.py:
flash_attention_kernel_call``; see the CUDA source for the design and
what bounds it. The wrapper picks its own tiles: there are no
``block_q``/``block_k`` arguments, and any Sq, Skv run (ragged edges are
masked in the kernel). Head dims above 128 raise.

A CPU tensor takes the plain version (:func:`flash_attention_plain`,
the oracle ``attention_ref``) under autograd. A CUDA tensor launches the
kernels or raises: it goes through the custom ops
``torch.ops.repro_torch.flash_attention_fwd`` (out, lse) and
``flash_attention_bwd`` (dq, dk, dv and the delta workspace), whose
autograd formula is the backward op, three kernel launches (the delta
pre-pass, dK/dV, dQ). A meta tensor (the dry run's) takes the same ops,
which there only allocate what the CUDA path allocates; each op has a
FLOP formula for ``FlopCounterMode`` (the unmasked score pairs × head
dim: 4 per pair forward, 10 backward). A row that sees no key gives 0
(and zero gradients) on the card, as the TPU kernel does, where the
oracle gives NaN. ``fwd_launches`` and ``bwd_launches`` count kernel
launches, ``route_launches`` both by route (:func:`route`), and nothing
else.

Routes (:func:`route`), by dtype: ``"wgmma"``, bf16 (tiles by TMA where
rows are whole 16-byte chunks and the pointers aligned, else element by
element); ``"tf32x3"``, f32: wgmma on TF32 operands split into big and
small halves (3xTF32), which holds f32's tolerances (16-byte loads where
rows are whole 16-byte chunks and the pointers aligned, else element by
element).

:func:`flash_attention_split` runs one key block of an attention split
along its keys (a sequence-sharded K/V): the forward kernel on the block
at its own ``kv_offset`` (negative for a block past the first), a
caller's merge of the blocks' (out, lse), and a backward of three
launches on the block with the merged out and lse, which gives that
block's dK and dV exactly and its share of dQ.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import attention_lse_ref, attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_split",
           "flash_attention_fwd", "flash_attention_bwd", "score_pairs",
           "route", "fwd_launches", "bwd_launches", "route_launches"]

fwd_launches = 0
bwd_launches = 0
route_launches = {"wgmma": 0, "tf32x3": 0}
MAX_HEAD_DIM = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I] * 9 + [_F, _I, _P]     # B Sq Skv Hq Hkv D causal window off,
#                                      scale, dtype, stream
_FWD_ARGTYPES = [_P] * 5 + _SHAPE
_BWD_ARGTYPES = [_P] * 10 + _SHAPE


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, Hq, D) and k, v (B, Skv, Hkv, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must share a dtype among "
                        f"{list(_DTYPE_CODES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")


def flash_attention_plain(q, k, v, causal: bool = True,
                          scale: float | None = None,
                          window: int | None = None,
                          kv_offset: int = 0) -> torch.Tensor:
    """The plain PyTorch version: the oracle ``attention_ref``."""
    _check(q, k, v)
    return attention_ref(q, k, v, causal=causal, scale=scale, window=window,
                         kv_offset=kv_offset)


def route(dtype: torch.dtype) -> str:
    """The kernels a CUDA call of this dtype takes, as
    ``csrc/flash_attention.cu`` chooses them: ``"wgmma"`` (bf16) or
    ``"tf32x3"`` (f32)."""
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _shape_args(q, k, causal, scale, window, kv_offset):
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    return [B, Sq, Skv, Hq, Hkv, D, int(causal),
            0 if window is None else int(window), int(kv_offset),
            float(scale), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream]


def flash_attention_fwd(q, k, v, causal, scale, window, kv_offset):
    """The forward kernel on contiguous CUDA tensors: (out, lse) with
    lse (B, Hq, Sq) f32, the per-row log-sum-exp the backward reads."""
    global fwd_launches
    B, Sq, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    launch = _build.kernel_function("flash_attention", "flash_attention_fwd",
                                    _FWD_ARGTYPES)
    with _build.on_device(q.device):
        launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(),
               *_shape_args(q, k, causal, scale, window, kv_offset))
    fwd_launches += 1
    route_launches[route(q.dtype)] += 1
    return out, lse


def _bwd_outputs(q, k, v, lse):
    """What the backward allocates: dq, dk, dv and the delta workspace
    (the per-row sum of dout · out, f32, shaped like lse)."""
    return (*(torch.empty_like(t) for t in (q, k, v)),
            torch.empty_like(lse))


def flash_attention_bwd(q, k, v, out, lse, dout, causal, scale, window,
                        kv_offset):
    """The backward kernels on contiguous CUDA tensors: (dq, dk, dv)."""
    return _bwd(q, k, v, out, lse, dout, causal, scale, window,
                kv_offset)[:3]


def _bwd(q, k, v, out, lse, dout, causal, scale, window, kv_offset):
    global bwd_launches
    dq, dk, dv, delta = _bwd_outputs(q, k, v, lse)
    launch = _build.kernel_function("flash_attention", "flash_attention_bwd",
                                    _BWD_ARGTYPES)
    with _build.on_device(q.device):
        launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               *_shape_args(q, k, causal, scale, window, kv_offset))
    bwd_launches += 3              # delta pre-pass, dK/dV, dQ
    route_launches[route(q.dtype)] += 3
    return dq, dk, dv, delta


# ----------------------------------------------------------------------
# the custom ops: CUDA launches, meta/fake allocation, autograd, FLOPs
# ----------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            scale: float, window: Optional[int], kv_offset: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal, scale, window, kv_offset)


@_fwd_op.register_fake
def _(q, k, v, causal, scale, window, kv_offset):
    B, Sq, Hq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, Hq, Sq),
                                            dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
            causal: bool, scale: float, window: Optional[int],
            kv_offset: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    return _bwd(q, k, v, out, lse, dout, causal, scale, window, kv_offset)


@_bwd_op.register_fake
def _(q, k, v, out, lse, dout, causal, scale, window, kv_offset):
    return _bwd_outputs(q, k, v, lse)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, scale, window, kv_offset = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.args = (causal, scale, window, kv_offset)


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv, _ = _bwd_op(q, k, v, out, lse, dout.contiguous(), *ctx.args)
    return dq, dk, dv, None, None, None, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def score_pairs(Sq: int, Skv: int, causal: bool, window: int | None,
                kv_offset: int) -> int:
    """The (query, key) pairs the mask leaves: key position j sees query
    position i + kv_offset when j <= it (causal) and j > it - window."""
    pos = np.arange(Sq, dtype=np.int64) + kv_offset
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, pos - window + 1) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def _flops(q_shape, k_shape, causal, window, kv_offset, per_pair):
    B, Sq, Hq, D = q_shape
    return per_pair * B * Hq * D * score_pairs(Sq, k_shape[1], causal,
                                               window, kv_offset)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q, k, v, causal, scale, window, kv_offset, *args, **kwargs):
    return _flops(q, k, causal, window, kv_offset, 4)   # QK^T, PV


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q, k, v, out, lse, dout, causal, scale, window, kv_offset,
               *args, **kwargs):
    # QK^T again, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q
    return _flops(q, k, causal, window, kv_offset, 10)


def _kernel_scale(q, scale, window) -> float:
    """The softmax scale for the kernels, after the checks of what they
    refuse."""
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    D = q.shape[3]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}: the kernel's "
                         "tiles hold at most 128")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return float(D ** -0.5 if scale is None else scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """GQA attention, BSHD layout; differentiable on both devices."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, kv_offset=kv_offset)
    scale = _kernel_scale(q, scale, window)
    return _fwd_op(q.contiguous(), k.contiguous(), v.contiguous(), causal,
                   scale, window, int(kv_offset))[0]


class _Split(torch.autograd.Function):
    """One key block: the forward kernel, the merge, and the backward
    kernels on the block with the merged out and lse. Their delta
    pre-pass then reads rowsum(dout · out) of the whole attention, and
    P = exp(S - lse) is the whole softmax restricted to the block: dK and
    dV are the block's own, dQ this block's share of the sum."""

    @staticmethod
    def forward(ctx, q, k, v, merge, causal, scale, window, kv_offset):
        args = (causal, scale, window, kv_offset)
        out, lse = merge(*_fwd_op(q, k, v, *args))
        out = out.contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv, _ = _bwd_op(q, k, v, out, lse, dout.contiguous(),
                                *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          merge, causal: bool = True,
                          scale: float | None = None,
                          window: int | None = None,
                          kv_offset: int = 0) -> torch.Tensor:
    """The attention of q over all key blocks, from this block's k/v:
    ``merge(out, lse)`` merges the blocks' partial results (its
    ``(out, lse)`` merged; ``merge_blocks`` of ``models/distributed.py``
    with reductions across the blocks) and ``kv_offset`` is q[0]'s position less this block's
    first key's. Differentiable on both devices: a CPU tensor takes
    ``attention_lse_ref`` and the merge under autograd."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return merge(*attention_lse_ref(q, k, v, causal=causal, scale=scale,
                                        window=window,
                                        kv_offset=kv_offset))[0]
    scale = _kernel_scale(q, scale, window)
    return _Split.apply(q.contiguous(), k.contiguous(), v.contiguous(), merge,
                        causal, scale, window, int(kv_offset))
