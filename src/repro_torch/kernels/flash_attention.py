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
kernels or raises; its gradient is a ``torch.autograd.Function`` whose
backward is three kernel launches (the delta pre-pass, dK/dV, dQ). A row
that sees no key gives 0 (and zero gradients) on the card, as the TPU
kernel does, where the oracle gives NaN. ``fwd_launches`` and
``bwd_launches`` count kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_fwd",
           "flash_attention_bwd", "fwd_launches", "bwd_launches"]

fwd_launches = 0
bwd_launches = 0
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
    with torch.cuda.device(q.device):
        launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(),
               *_shape_args(q, k, causal, scale, window, kv_offset))
    fwd_launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, causal, scale, window,
                        kv_offset):
    """The backward kernels on contiguous CUDA tensors: (dq, dk, dv)."""
    global bwd_launches
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty_like(lse)
    launch = _build.kernel_function("flash_attention", "flash_attention_bwd",
                                    _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               *_shape_args(q, k, causal, scale, window, kv_offset))
    bwd_launches += 3              # delta pre-pass, dK/dV, dQ
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, kv_offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal, scale, window,
                                       kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, window, kv_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """GQA attention, BSHD layout; differentiable on both devices."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    D = q.shape[3]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}: the kernel's "
                         "tiles hold at most 128")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = D ** -0.5 if scale is None else scale
    return _Flash.apply(q, k, v, causal, scale, window, kv_offset)
