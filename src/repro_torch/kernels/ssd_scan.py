"""Mamba2 SSD scan: the wrapper of the Hopper kernels ``csrc/ssd_scan.cu``
(forward and backward).

The chunked state-space-dual scan of the JAX package's layouts: x
(B, S, H, P), a (B, S, H) f32, b and c (B, S, G, N), returning y like x
and the final state (B, H, N, P) f32, with a zero initial state. It
replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py:
ssd_scan_kernel_call``; see the CUDA source for the design and what
bounds it. Any S runs (a partial last chunk is masked in the kernel; the
JAX op sends S % chunk != 0 to the oracle). The kernel takes the chunk in
rows of ``min(chunk, 64)``: the same scan, since the dual form is exact
for any chunk length. State widths N above 128 and head dims P above 64
raise.

A CPU tensor takes the plain version (:func:`ssd_scan_plain`, the oracle
``ssd_chunked_ref``) under autograd. A CUDA tensor launches the kernels or
raises; its gradient is a ``torch.autograd.Function`` whose backward is
two kernel launches (the carried state gradient, chunk by chunk in
reverse; then every chunk's dx, da, db, dc). ``fwd_launches`` and
``bwd_launches`` count kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_chunked_ref

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_scan_fwd", "ssd_scan_bwd",
           "kernel_chunk", "fwd_launches", "bwd_launches"]

fwd_launches = 0
bwd_launches = 0
MAX_STATE = 128
MAX_HEAD_DIM = 64
MAX_CHUNK = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SHAPE = [_I] * 8 + [_P]            # B S H G N P L, dtype, stream
_FWD_ARGTYPES = [_P] * 7 + _SHAPE
_BWD_ARGTYPES = [_P] * 12 + _SHAPE


def _check(x, a, b, c):
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"x must be (B, S, H, P), a (B, S, H) and b, c "
                         f"(B, S, G, N); got {tuple(x.shape)}, "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    B, S, H, _ = x.shape
    if tuple(a.shape) != (B, S, H) or tuple(b.shape[:2]) != (B, S):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"match x {tuple(x.shape)}")
    G = b.shape[2]
    if H % G:
        raise ValueError(f"H={H} not a multiple of G={G}")
    if not (x.device == a.device == b.device == c.device):
        raise ValueError("x, a, b, c lie on different devices")


def kernel_chunk(chunk: int) -> int:
    """The rows of one chunk in the kernel for a requested ``chunk``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return min(chunk, MAX_CHUNK)


def ssd_scan_plain(x, a, b, c, chunk: int = 128):
    """The plain PyTorch version: the oracle ``ssd_chunked_ref`` (the
    sequential ``ssd_ref`` when S % chunk != 0), returning (y, state)."""
    _check(x, a, b, c)
    return ssd_chunked_ref(x, a, b, c, chunk=min(chunk, x.shape[1]),
                           return_state=True)


def _shape_args(x, b, L):
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    return [B, S, H, G, N, P, L, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream]


def ssd_scan_fwd(x, a, b, c, L: int, keep_states: bool):
    """The forward kernel on contiguous CUDA tensors: (y, final state,
    states) with states (B, H, nc, N, P) f32, the state at each chunk's
    start, which the backward reads (None unless ``keep_states``)."""
    global fwd_launches
    B, S, H, P = x.shape
    N = b.shape[3]
    nc = -(-S // L)
    y = torch.empty_like(x)
    hT = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32,
                         device=x.device) if keep_states else None
    launch = _build.kernel_function("ssd_scan", "ssd_scan_fwd",
                                    _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        launch(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
               y.data_ptr(), hT.data_ptr(),
               None if states is None else states.data_ptr(),
               *_shape_args(x, b, L))
    fwd_launches += 1
    return y, hT, states


def ssd_scan_bwd(x, a, b, c, states, dy, dhT, L: int):
    """The backward kernels on contiguous CUDA tensors: (dx, da, db, dc).
    ``dhT`` (the final state's gradient) may be None (zero)."""
    global bwd_launches
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), \
        torch.empty_like(c)
    da = torch.empty_like(a)
    dstates = torch.empty_like(states)
    launch = _build.kernel_function("ssd_scan", "ssd_scan_bwd",
                                    _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        launch(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
               states.data_ptr(), dy.data_ptr(),
               None if dhT is None else dhT.data_ptr(), dstates.data_ptr(),
               dx.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
               *_shape_args(x, b, L))
    bwd_launches += 2              # carried state gradient, chunks
    return dx, da, db, dc


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, c, L):
        x, a, b, c = (t.contiguous() for t in (x, a, b, c))
        y, hT, states = ssd_scan_fwd(x, a, b, c, L,
                                     any(ctx.needs_input_grad[:4]))
        ctx.save_for_backward(x, a, b, c, states)
        ctx.L = L
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, a, b, c, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else \
            dy.to(x.dtype).contiguous()
        if dhT is not None:
            dhT = dhT.float().contiguous()
        dx, da, db, dc = ssd_scan_bwd(x, a, b, c, states, dy, dhT, ctx.L)
        return dx, da, db, dc, None


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128):
    """Mamba2 SSD over a sequence. Returns (y, final_state);
    differentiable on both devices."""
    _check(x, a, b, c)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, b, c, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype \
            or c.dtype != x.dtype or a.dtype != torch.float32:
        raise TypeError(f"x, b, c must share a dtype among "
                        f"{list(_DTYPE_CODES)} and a must be float32; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}, {a.dtype}")
    N, P = b.shape[3], x.shape[3]
    if N > MAX_STATE or P > MAX_HEAD_DIM:
        raise ValueError(f"state width {N} > {MAX_STATE} or head dim {P} > "
                         f"{MAX_HEAD_DIM}: the kernel's tiles hold at most "
                         f"{MAX_STATE} x {MAX_HEAD_DIM}")
    if x.numel() == 0 or b.numel() == 0:
        raise ValueError("ssd_scan of an empty tensor")
    return _Ssd.apply(x, a, b, c, kernel_chunk(chunk))
