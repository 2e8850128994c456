"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

These are the semantics of record: each hand-written kernel is held
against them, and a wrapper given CPU tensors runs them. Layouts are the
JAX package's:

  attention  — BSHD: q (B, S, Hq, D), k/v (B, S, Hkv, D), GQA via repeat.
  moe_gmm    — x (E, C, D), w (E, D, F).
  rmsnorm    — x (..., D), w (D,).

The Mamba2 ``ssd_*`` oracles join with the Mamba2 slice.
"""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref", "attention_ref", "attention_chunked_ref",
           "moe_gmm_ref"]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: float | None = None,
                  window: int | None = None,
                  kv_offset: int = 0) -> torch.Tensor:
    """Multi-head attention with GQA, causal/bidirectional, sliding window.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    kv_offset: absolute position of q[0] minus that of k[0] (decode: the
    query sits at position ``kv_offset`` within the cache).
    """
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    kr = k.repeat_interleave(group, dim=2)
    vr = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + kv_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
    return out.to(q.dtype)


def attention_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: float | None = None,
                          window: int | None = None,
                          kv_offset: int = 0,
                          chunk: int = 1024) -> torch.Tensor:
    """Memory-bounded attention: a loop over query chunks.

    Same semantics as :func:`attention_ref`, but the (Sq × Skv) score
    matrix never materialises beyond one (chunk × Skv) f32 slab.
    """
    S = q.shape[1]
    if S % chunk:
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             window=window, kv_offset=kv_offset)
    return torch.cat([
        attention_ref(q[:, i:i + chunk], k, v, causal=causal, scale=scale,
                      window=window, kv_offset=kv_offset + i)
        for i in range(0, S, chunk)], dim=1)


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped expert GEMM: x (E, C, D) @ w (E, D, F) -> (E, C, F)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
