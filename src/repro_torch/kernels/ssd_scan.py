"""Mamba2 SSD scan: the wrapper of the Hopper kernels ``csrc/ssd_scan.cu``
(forward and backward).

The chunked state-space-dual scan of the JAX package's layouts: x
(B, S, H, P), a (B, S, H) f32, b and c (B, S, G, N), returning y like x
and the final state (B, H, N, P) f32, with a zero initial state. It
replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py:75
ssd_scan_kernel_call``; the CUDA source has the design and what bounds
it. Any S runs (a partial chunk is masked in the kernels; the JAX op sends
S % chunk != 0 to the oracle). The dual form is exact for any chunk
length, so the kernels may take the chunk in fewer rows than asked. State
widths N above 128 and head dims P above 64 raise.

Three routes (:func:`route`, a function of the dtype, the widths and the
alignment, chosen before launch):

* ``"tc"``: bf16 with N and P multiples of 16 and 16-byte aligned tensors
  (every shape of the training path): tensor-core (wgmma) kernels fed by
  TMA, chunks of ``min(chunk, 128)`` rows. The forward is two launches
  (C B^T of every chunk and group, shared by the group's heads; then the
  walk over the chunks), the backward three (the carried state gradient
  in reverse; dx and da of every chunk and head; dB and dC of every chunk
  and group, summed over its heads). The saved tensors are the state at
  every chunk's start and C B^T; two backward runs give the same bits.
* ``"tf32x3"``: every f32 call (the reduced checks, ``[jamba]``, any f32
  Mamba2 model), at any width: wgmma on TF32 operands split into big and
  small halves (3xTF32), chunks of ``min(chunk, 64)`` rows, the same
  launches as ``"tc"``. It saves the state at every chunk's start and
  the final one, C B^T and B C^T, and y (its backward takes da from
  dy . y and x . dx); two backward runs give the same bits.
* ``"fma"``: bf16 of other widths or unaligned tensors (on no path): the
  first design's CUDA-core f32 FMA kernels, in chunks of
  ``min(chunk, 64)`` rows; one forward launch and two backward launches.

A CPU tensor takes the plain version (:func:`ssd_scan_plain`, the oracle
``ssd_chunked_ref``) under autograd. A CUDA tensor launches the kernels or
raises: it goes through the custom op ``torch.ops.repro_torch.ssd_scan_fwd``
(y, the final state, and the saved chunk states and C B^T, empty where
the route keeps none), whose autograd formula is the op
``ssd_scan_bwd`` (the four input gradients and its ``dstates``
workspace; it also reads y on the ``"tf32x3"`` route). A meta tensor
(the dry run's) takes the same ops, which there only allocate what the
CUDA path allocates; each op has a FLOP
formula (:func:`ssd_flops`) for ``FlopCounterMode``. ``fwd_launches``
and ``bwd_launches`` count kernel launches, ``route_launches`` both by
route, and nothing else (:data:`LAUNCHES` per call and route).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .ref import ssd_chunked_ref

__all__ = ["ssd_scan", "ssd_scan_plain", "ssd_scan_fwd", "ssd_scan_bwd",
           "kernel_chunk", "kernel_rows", "route", "ssd_flops", "LAUNCHES",
           "fwd_launches", "bwd_launches", "route_launches"]

fwd_launches = 0
bwd_launches = 0
MAX_STATE = 128
MAX_HEAD_DIM = 64
MAX_CHUNK = 128                     # the tensor-core route's tile rows
FMA_CHUNK = 64                      # the FMA route's
TF32_CHUNK = 64                     # the 3xTF32 route's
TF32_STATE = 64 * 128               # a 3xTF32 state: h^T padded, floats
# kernel launches of one forward and one backward call, by route
LAUNCHES = {"tc": (2, 3), "tf32x3": (2, 3), "fma": (1, 2)}
route_launches = {kind: 0 for kind in LAUNCHES}

_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SHAPE = [_I] * 7 + [_P]            # B S H G N P L, stream
# the C entry points by route: forward and backward, and their arguments
_ENTRY = {"tc": (("ssd_scan_tc_fwd", [_P] * 8 + _SHAPE),
                 ("ssd_scan_tc_bwd", [_P] * 13 + _SHAPE)),
          "tf32x3": (("ssd_scan_tf32_fwd", [_P] * 8 + _SHAPE),
                     ("ssd_scan_tf32_bwd", [_P] * 14 + _SHAPE)),
          "fma": (("ssd_scan_fwd", [_P] * 7 + _SHAPE),
                  ("ssd_scan_bwd", [_P] * 12 + _SHAPE))}


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
    """The rows of one chunk in the tensor-core kernels for a requested
    ``chunk``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return min(chunk, MAX_CHUNK)


def route(x, b) -> str:
    """The kernels a CUDA call takes: ``"tf32x3"`` for f32 (any width),
    ``"tc"`` for bf16 with N and P multiples of 16 and 16-byte aligned
    tensors, else ``"fma"``. A meta tensor counts as aligned where its
    offset into its storage is, as every block of the CUDA allocator
    is."""
    def aligned(t):
        if t.device.type == "cuda":
            return t.data_ptr() % 16 == 0
        return t.storage_offset() * t.element_size() % 16 == 0
    if x.dtype == torch.float32:
        return "tf32x3"
    N, P = b.shape[3], x.shape[3]
    return "tc" if (N % 16 == 0 and P % 16 == 0 and aligned(x)
                    and aligned(b)) else "fma"


def kernel_rows(chunk: int, kind: str) -> int:
    """The rows of one chunk in the kernels of route ``kind``."""
    L = kernel_chunk(chunk)
    return {"tc": L, "tf32x3": min(L, TF32_CHUNK),
            "fma": min(L, FMA_CHUNK)}[kind]


def ssd_scan_plain(x, a, b, c, chunk: int = 128):
    """The plain PyTorch version: the oracle ``ssd_chunked_ref`` (the
    sequential ``ssd_ref`` when S % chunk != 0), returning (y, state)."""
    _check(x, a, b, c)
    return ssd_chunked_ref(x, a, b, c, chunk=min(chunk, x.shape[1]),
                           return_state=True)


def _shape_args(x, b, L):
    """B S H G N P L, the stream."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    return [B, S, H, G, N, P, L,
            torch.cuda.current_stream(x.device).cuda_stream]


def _fwd_outputs(x, b, chunk: int, keep: bool):
    """What the forward allocates: y, the final state, the chunk states
    (0 rows unless ``keep``) and C B^T of every chunk and group (with B
    C^T on the 3xTF32 route; 0 rows on the FMA route)."""
    kind = route(x, b)
    L = kernel_rows(chunk, kind)
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc = -(-S // L)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    hT = torch.empty((B, H, N, P), **f32)
    # the tensor-core kernels keep each state as a zero-padded tile in
    # their fragment order: 128 x 64 (h) on "tc", 64 x 128 (h^T) on
    # "tf32x3", whose states end with the final one
    Bk = B if keep else 0
    if kind == "tc":
        states = torch.empty((Bk, H, nc, MAX_STATE * MAX_HEAD_DIM), **f32)
        cb = torch.empty((B, nc, G, MAX_CHUNK, MAX_CHUNK), **f32)
    elif kind == "tf32x3":
        states = torch.empty((Bk, H, nc + 1, TF32_STATE), **f32)
        cb = torch.empty((B, nc, G, 2, TF32_CHUNK, TF32_CHUNK), **f32)
    else:
        states = torch.empty((Bk, H, nc, N, P), **f32)
        cb = torch.empty((0, nc, G, MAX_CHUNK, MAX_CHUNK), **f32)
    return y, hT, states, cb


def ssd_scan_fwd(x, a, b, c, chunk: int, keep: bool):
    """The forward kernels on contiguous CUDA tensors, at the rows of
    ``kernel_rows(chunk, route(x, b))``: (y, final state, saved), saved
    being what the backward reads (None unless ``keep``): the state at
    each chunk's start, f32, C B^T of every chunk and group on the
    tensor-core routes (with B C^T on "tf32x3"), and y on "tf32x3". The
    FMA route keeps the states as (B, H, nc, N, P); the tensor-core
    routes keep them, and C B^T, in their kernels' own fragment order (see
    the CUDA source)."""
    y, hT, states, cb = _fwd(x, a, b, c, chunk, keep)
    if not keep:
        return y, hT, None
    return y, hT, (states, cb if cb.numel() else None,
                   y if route(x, b) == "tf32x3" else None)


def _fwd(x, a, b, c, chunk: int, keep: bool):
    """The launches of :func:`ssd_scan_fwd`, returning everything
    :func:`_fwd_outputs` allocated."""
    global fwd_launches
    kind = route(x, b)
    L = kernel_rows(chunk, kind)
    y, hT, states, cb = _fwd_outputs(x, b, chunk, keep)
    ptrs = [t.data_ptr() for t in (x, a, b, c, y, hT)]
    ptrs.append(states.data_ptr() if keep else None)
    if kind != "fma":
        ptrs.append(cb.data_ptr())
    launch = _build.kernel_function("ssd_scan", *_ENTRY[kind][0])
    with _build.on_device(x.device):
        launch(*ptrs, *_shape_args(x, b, L))
    fwd_launches += LAUNCHES[kind][0]
    route_launches[kind] += LAUNCHES[kind][0]
    return y, hT, states, cb


def ssd_scan_bwd(x, a, b, c, saved, dy, dhT, chunk: int):
    """The backward kernels on contiguous CUDA tensors: (dx, da, db, dc).
    ``saved`` comes from :func:`ssd_scan_fwd` on the same inputs; ``dhT``
    (the final state's gradient) may be None (zero)."""
    return _bwd(x, a, b, c, *saved, dy, dhT, chunk)[:4]


def _bwd_outputs(x, a, b, c, states):
    """What the backward allocates: dx, da, db, dc and the ``dstates``
    workspace, as large as the saved states."""
    return (torch.empty_like(x), torch.empty_like(a), torch.empty_like(b),
            torch.empty_like(c), torch.empty_like(states))


def _bwd(x, a, b, c, states, cb, y, dy, dhT, chunk):
    global bwd_launches
    kind = route(x, b)
    L = kernel_rows(chunk, kind)
    dx, da, db, dc, dstates = _bwd_outputs(x, a, b, c, states)
    ptrs = [t.data_ptr() for t in (x, a, b, c)]
    if kind == "tf32x3":
        ptrs.append(y.data_ptr())
    ptrs.append(states.data_ptr())
    if kind != "fma":
        ptrs.append(cb.data_ptr())
    ptrs += [dy.data_ptr(), None if dhT is None else dhT.data_ptr()]
    ptrs += [t.data_ptr() for t in (dstates, dx, da, db, dc)]
    launch = _build.kernel_function("ssd_scan", *_ENTRY[kind][1])
    with _build.on_device(x.device):
        launch(*ptrs, *_shape_args(x, b, L))
    bwd_launches += LAUNCHES[kind][1]
    route_launches[kind] += LAUNCHES[kind][1]
    return dx, da, db, dc, dstates


# ----------------------------------------------------------------------
# the custom ops: CUDA launches, meta/fake allocation, autograd, FLOPs
# ----------------------------------------------------------------------

@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, chunk: int, keep: bool
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    return _fwd(x, a, b, c, chunk, keep)


@_fwd_op.register_fake
def _(x, a, b, c, chunk, keep):
    return _fwd_outputs(x, b, chunk, keep)


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, states: torch.Tensor, cb: torch.Tensor,
            dy: torch.Tensor, dhT: Optional[torch.Tensor], chunk: int,
            y: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    return _bwd(x, a, b, c, states, cb if cb.numel() else None, y, dy, dhT,
                chunk)


@_bwd_op.register_fake
def _(x, a, b, c, states, cb, dy, dhT, chunk, y=None):
    return _bwd_outputs(x, a, b, c, states)


def _setup_context(ctx, inputs, output):
    x, a, b, c, chunk, keep = inputs
    y, _, states, cb = output
    ctx.mark_non_differentiable(states, cb)
    ctx.set_materialize_grads(False)
    # the 3xTF32 backward reads y (da from dy . y)
    ctx.save_for_backward(x, a, b, c, states, cb,
                          y if route(x, b) == "tf32x3" else None)
    ctx.chunk = chunk


def _backward(ctx, dy, dhT, _dstates, _dcb):
    x, a, b, c, states, cb, y = ctx.saved_tensors
    dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
    if dhT is not None:
        dhT = dhT.float().contiguous()
    dx, da, db, dc, _ = _bwd_op(x, a, b, c, states, cb, dy, dhT, ctx.chunk,
                                y)
    return dx, da, db, dc, None, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def ssd_flops(B, S, H, P, G, N, L) -> tuple[int, int]:
    """Operations of one forward and one backward at the kernels' chunk
    rows L: the dual form's causal triangle (C B^T and its products once
    per head) and the state terms once per chunk."""
    nc, tri = -(-S // L), L * (L + 1) // 2
    per = B * H * nc
    return (per * (2 * tri * (N + P) + 4 * L * N * P),
            per * (2 * tri * (2 * P + 2 * N) + 8 * L * N * P))


def _op_flops(x, b, chunk, backward: bool, x_dtype, aligned=True):
    B, S, H, P = x
    G, N = b[2], b[3]
    if x_dtype == torch.float32:
        kind = "tf32x3"
    else:
        kind = "tc" if N % 16 == 0 and P % 16 == 0 and aligned else "fma"
    return ssd_flops(B, S, H, P, G, N, kernel_rows(chunk, kind))[backward]


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd, get_raw=True)
def _fwd_flops(x, a, b, c, chunk, keep, *args, **kwargs):
    return _op_flops(x.shape, b.shape, chunk, False, x.dtype)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd, get_raw=True)
def _bwd_flops(x, a, b, c, states, cb, dy, dhT, chunk, *args, **kwargs):
    return _op_flops(x.shape, b.shape, chunk, True, x.dtype)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 128):
    """Mamba2 SSD over a sequence. Returns (y, final_state);
    differentiable on both devices."""
    _check(x, a, b, c)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a, b, c, chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype \
            or c.dtype != x.dtype or a.dtype != torch.float32:
        raise TypeError(f"x, b, c must share a dtype among "
                        f"{list(_DTYPES)} and a must be float32; got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}, {a.dtype}")
    N, P = b.shape[3], x.shape[3]
    if N > MAX_STATE or P > MAX_HEAD_DIM:
        raise ValueError(f"state width {N} > {MAX_STATE} or head dim {P} > "
                         f"{MAX_HEAD_DIM}: the kernel's tiles hold at most "
                         f"{MAX_STATE} x {MAX_HEAD_DIM}")
    if x.numel() == 0 or b.numel() == 0:
        raise ValueError("ssd_scan of an empty tensor")
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, a, b, c))
    y, hT, _, _ = _fwd_op(*(t.contiguous() for t in (x, a, b, c)),
                          kernel_chunk(chunk), keep)
    return y, hT
