"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

These are the semantics of record: each hand-written kernel is held
against them, and a wrapper given CPU tensors runs them. Layouts are the
JAX package's:

  attention  — BSHD: q (B, S, Hq, D), k/v (B, S, Hkv, D), GQA via repeat.
  moe_gmm    — x (E, C, D), w (E, D, F).
  rmsnorm    — x (..., D), w (D,).
  ssd        — x (B, S, H, P), a (B, S, H), b/c (B, S, G, N), state
               (B, H, N, P) f32.

Beside them, the arithmetic of the f32 kernels' tensor-core products,
3xTF32 (:func:`matmul_3xtf32`), emulated on any device.
"""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref", "attention_ref", "attention_chunked_ref",
           "attention_lse_ref", "attention_chunked_lse_ref",
           "moe_gmm_ref", "ssd_ref", "ssd_chunked_ref", "tf32_round",
           "tf32_split", "matmul_3xtf32"]


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


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      scale: float | None = None,
                      window: int | None = None,
                      kv_offset: int = 0):
    """:func:`attention_ref` that also returns each row's log-sum-exp,
    (out, lse) with lse (B, Hq, Sq) f32: the partial result of one key
    block of an attention split along its keys (``merge_blocks`` in
    ``models/distributed.py`` merges the blocks). A row that sees no key gives the flash kernel's
    convention, out 0 and lse -inf, and zero gradients (attention_ref
    gives NaN there)."""
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
    # the row max is a shift the result does not depend on: held out of
    # the graph, and 0 for a row with no key (no -inf - -inf)
    m = s.detach().amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    seen = l > 0
    l = torch.where(seen, l, torch.ones_like(l))
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, vr.float())
    lse = torch.where(seen, m + torch.log(l), float("-inf"))[..., 0]
    return out.to(q.dtype), lse


def attention_chunked_lse_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              scale: float | None = None,
                              window: int | None = None,
                              kv_offset: int = 0, chunk: int = 1024):
    """:func:`attention_lse_ref` as a loop over query chunks, as
    :func:`attention_chunked_ref` bounds the score slab."""
    S = q.shape[1]
    if S % chunk:
        return attention_lse_ref(q, k, v, causal=causal, scale=scale,
                                 window=window, kv_offset=kv_offset)
    parts = [attention_lse_ref(q[:, i:i + chunk], k, v, causal=causal,
                               scale=scale, window=window,
                               kv_offset=kv_offset + i)
             for i in range(0, S, chunk)]
    return (torch.cat([o for o, _ in parts], dim=1),
            torch.cat([l for _, l in parts], dim=-1))


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped expert GEMM: x (E, C, D) @ w (E, D, F) -> (E, C, F)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, h0: torch.Tensor | None = None,
            return_state: bool = False):
    """Mamba2 SSD (state-space dual) semantics via the sequential scan.

    x: (B, S, H, P) inputs (already multiplied by dt).
    a: (B, S, H) per-head log decay (a = -exp(A_log)·dt, <= 0).
    b, c: (B, S, G, N) input/output projections, G groups (H % G == 0).
    h0: optional initial state (B, H, N, P).

    h_t = exp(a_t)·h_{t-1} + B_t ⊗ x_t ;  y_t = C_t · h_t
    """
    B, S, H, P = x.shape
    _, _, G, N = b.shape
    if H % G:
        raise ValueError(f"H={H} not a multiple of G={G}")
    rep = H // G
    bb = b.repeat_interleave(rep, dim=2).float()          # (B,S,H,N)
    cc = c.repeat_interleave(rep, dim=2).float()
    xf, af = x.float(), a.float()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(S):
        h = torch.exp(af[:, t])[..., None, None] * h \
            + bb[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cc[:, t], h))
    y = (torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
         ).to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_chunked_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, h0: torch.Tensor | None = None,
                    chunk: int = 128, return_state: bool = False):
    """Chunked (dual-form) SSD: the semantics of :func:`ssd_ref`, as dense
    intra-chunk products and a loop over the S/chunk chunk states (the
    mirror of the kernel's math, and the training/prefill path of the
    Mamba2 layers' plain route). S % chunk != 0 takes :func:`ssd_ref`."""
    B, S, H, P = x.shape
    _, _, G, N = b.shape
    if S == 0 or S % chunk:
        return ssd_ref(x, a, b, c, h0=h0, return_state=return_state)
    rep = H // G
    L = chunk
    nc = S // L
    bb = b.repeat_interleave(rep, dim=2).float()
    cc = c.repeat_interleave(rep, dim=2).float()
    xf, af = x.float(), a.float()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    ys = []
    for i in range(nc):
        sl = slice(i * L, (i + 1) * L)
        xc, ac, bc, cx = xf[:, sl], af[:, sl], bb[:, sl], cc[:, sl]
        acum = torch.cumsum(ac, dim=1)                  # inclusive (B,L,H)
        a_tot = acum[:, -1]                             # (B,H)
        y_inter = torch.exp(acum)[..., None] * torch.einsum(
            "blhn,bhnp->blhp", cx, h)
        logdecay = acum[:, :, None, :] - acum[:, None, :, :]   # (B,L,L,H)
        # mask BEFORE exp: the upper triangle holds positive values whose
        # exp overflows; inf·0 in the backward would produce NaN grads.
        decay = torch.exp(logdecay.masked_fill(~tri[None, :, :, None],
                                               float("-inf")))
        scores = torch.einsum("blhn,bmhn->blmh", cx, bc) * decay
        ys.append(y_inter + torch.einsum("blmh,bmhp->blhp", scores, xc))
        w = torch.exp(a_tot[:, None] - acum)[..., None] * bc  # (B,L,H,N)
        h = torch.exp(a_tot)[..., None, None] * h + torch.einsum(
            "blhn,blhp->bhnp", w, xc)
    y = torch.cat(ys, dim=1).to(x.dtype)
    if return_state:
        return y, h
    return y


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x as float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 10
    mantissa bits, to nearest with ties away from zero, by integer
    operations on the bits (adding half of the 13 dropped bits' unit to
    the magnitude carries into the kept ones); inf and NaN pass as they
    are."""
    x = x.float().contiguous()
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small): big = tf32(x), small = tf32(x - big), the halves the
    f32 kernels feed their tensor cores."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 as the f32 kernels' tensor cores compute it:
    a_small b_big + a_big b_small + a_big b_big, each a product of TF32
    values (exact in float32), summed in float32; a_small b_small, about
    2^-22 of the product, is left out."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big
