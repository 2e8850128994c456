"""Model building blocks (port of ``repro/models/layers.py``): norms, RoPE,
GQA attention with a KV cache, gated cross attention onto media, the
SwiGLU MLP, MoE with locality-aware routing and an optional shared
expert, the Mamba2 (SSD) mixer with its conv and SSM state.

Conventions, as in the JAX package:
  * activations (B, S, D); attention BSHD; weights stored (d_in, d_out)
    and applied as ``x @ w``, experts (E, D, F);
  * every mixer returns ``(y, new_cache)`` where the cache is ``None``
    for stateless training, so one code path serves train / prefill /
    decode;
  * f32 for softmax/normaliser math, params/activations in cfg dtype.

Each attention layer and MoE block is an ``nn.Module`` that owns its
weights; its ``forward`` takes the config, so one set of weights can run
either ``moe_impl``. Differences from the JAX package:
  * the KV cache is written in place at ``length`` (JAX returns a new
    buffer through ``dynamic_update_slice``); a write past the cache's
    end raises, where JAX clamps the start.

``attn_impl="kernel"`` sends attention without a cache (training) through
the ``flash_attention`` kernel, as the JAX package does; cached attention
(prefill, decode) takes the plain version on both routes. Likewise
``ssm_impl="kernel"`` sends the Mamba2 scan without a cache through the
``ssd_scan`` kernel; prefill with a carried state and single-step decode
take the plain ``ssd_chunked_ref`` / ``ssd_ref`` on both routes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.routing import RoutingConfig, one_hot, ring_steal_table, \
    route
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def new_param(shape, device, dtype, fill=None) -> nn.Parameter:
    t = torch.empty(shape, device=device, dtype=dtype)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


def normal_(p: torch.Tensor, scale: float, generator: torch.Generator):
    """Fill ``p`` with N(0, 1)·scale drawn in f32, then cast (JAX's init)."""
    with torch.no_grad():
        z = torch.randn(p.shape, generator=generator, device=p.device,
                        dtype=torch.float32)
        p.copy_(z.mul_(scale))      # in place: no second f32 temporary


# ----------------------------------------------------------------------
# norms / rope
# ----------------------------------------------------------------------

def rmsnorm(x, w, eps=1e-6, use_kernel=False):
    """RMSNorm; ``use_kernel`` sends it through the rmsnorm kernel. No
    layer sets it, as in the JAX package."""
    if use_kernel:
        return kops.rmsnorm(x, w, eps)
    return kref.rmsnorm_ref(x, w, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, D); positions: (B, S). Rotates pairs (d, d + D/2)."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention (self, GQA, optional qk-norm / bias)
# ----------------------------------------------------------------------

class Attention(nn.Module):
    """Self attention with GQA, RoPE, optional QKV bias and qk-norm."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = new_param((D, H * Dh), device, dtype)
        self.wk = new_param((D, Hkv * Dh), device, dtype)
        self.wv = new_param((D, Hkv * Dh), device, dtype)
        self.wo = new_param((H * Dh, D), device, dtype)
        if cfg.qkv_bias:
            self.bq = new_param((H * Dh,), device, dtype, 0.0)
            self.bk = new_param((Hkv * Dh,), device, dtype, 0.0)
            self.bv = new_param((Hkv * Dh,), device, dtype, 0.0)
        if cfg.qk_norm:
            self.q_norm = new_param((Dh,), device, dtype, 1.0)
            self.k_norm = new_param((Dh,), device, dtype, 1.0)

    def init_weights(self, generator: torch.Generator):
        for w in (self.wq, self.wk, self.wv, self.wo):
            normal_(w, 1.0 / math.sqrt(w.shape[0]), generator)

    def forward(self, x, cfg, *, positions, cache=None, causal=True):
        """cache: None | dict(k, v, length: int).

        Training: full-sequence q over its own k/v. Prefill/decode: k/v
        are written into the cache at ``length`` and q attends over the
        whole cache with a causal mask on absolute positions (the cache
        tail beyond ``length + S`` is masked out).
        """
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(B, S, H, Dh)
        k = k.reshape(B, S, Hkv, Dh)
        v = v.reshape(B, S, Hkv, Dh)
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cfg.kv_repeat > 1:
            k = k.repeat_interleave(cfg.kv_repeat, dim=2)
            v = v.repeat_interleave(cfg.kv_repeat, dim=2)

        new_cache = None
        if cache is None:
            kk, vv, kv_off = k, v, 0
        else:
            length = cache["length"]
            kk, vv = cache["k"], cache["v"]
            if length + S > kk.shape[1]:
                raise ValueError(f"cache of {kk.shape[1]} positions cannot "
                                 f"take {S} more at {length}")
            kk[:, length:length + S] = k                  # in place
            vv[:, length:length + S] = v
            new_cache = dict(k=kk, v=vv, length=length + S)
            kv_off = length

        causal = causal or cache is not None
        if cfg.attn_impl == "kernel" and cache is None:
            out = kops.flash_attention(q, kk, vv, causal=causal,
                                       window=cfg.attn_window)
        elif S >= cfg.attn_chunk_threshold:
            # long prefill/training: bound the score slab to (chunk × Skv)
            out = kref.attention_chunked_ref(
                q, kk, vv, causal=causal, window=cfg.attn_window,
                kv_offset=kv_off, chunk=cfg.attn_chunk)
        else:
            out = kref.attention_ref(q, kk, vv, causal=causal,
                                     window=cfg.attn_window,
                                     kv_offset=kv_off)
        return out.reshape(B, S, H * Dh) @ self.wo, new_cache


class CrossAttention(nn.Module):
    """Gated cross attention onto media embeddings (B, M, D), as
    ``init_cross_attention``/``cross_attention`` of the JAX package
    (llama-3.2-vision): q and k are RMS-normed per head, the attention is
    bidirectional through ``attention_ref`` (no kernel, as in JAX), and
    the output is scaled by ``tanh(gate)``, computed in f32. The gate
    starts at zero, so a fresh layer adds nothing."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = new_param((D, H * Dh), device, dtype)
        self.wk = new_param((D, Hkv * Dh), device, dtype)
        self.wv = new_param((D, Hkv * Dh), device, dtype)
        self.wo = new_param((H * Dh, D), device, dtype)
        self.q_norm = new_param((Dh,), device, dtype, 1.0)
        self.k_norm = new_param((Dh,), device, dtype, 1.0)
        self.gate = new_param((1,), device, dtype, 0.0)

    def init_weights(self, generator: torch.Generator):
        for w in (self.wq, self.wk, self.wv, self.wo):
            normal_(w, 1.0 / math.sqrt(w.shape[0]), generator)

    def forward(self, x, cfg, *, media=None, cache=None):
        """cache: None (train, prefill: k/v are projected from ``media``)
        | dict(k, v) of projected media (decode reuses them). Returns
        (y, dict(k, v))."""
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = rmsnorm((x @ self.wq).reshape(B, S, H, Dh), self.q_norm,
                    cfg.norm_eps)
        if cache is None:
            if media is None:
                raise ValueError("a cross-attention layer needs media")
            M = media.shape[1]
            k = (media @ self.wk).reshape(B, M, Hkv, Dh)
            v = (media @ self.wv).reshape(B, M, Hkv, Dh)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
            if cfg.kv_repeat > 1:
                k = k.repeat_interleave(cfg.kv_repeat, dim=2)
                v = v.repeat_interleave(cfg.kv_repeat, dim=2)
        else:
            k, v = cache["k"], cache["v"]
        out = kref.attention_ref(q, k, v, causal=False)
        out = out.reshape(B, S, H * Dh) @ self.wo
        return torch.tanh(self.gate.float()).to(out.dtype) * out, \
            dict(k=k, v=v)


def attn_cache_init(cfg, batch, max_len, dtype, device):
    stored = cfg.num_kv_heads * cfg.kv_repeat
    shape = (batch, max_len, stored, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                length=0)


# ----------------------------------------------------------------------
# MLP / MoE
# ----------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU MLP ``(silu(x @ wg) * (x @ wu)) @ wd`` (``init_mlp``/``mlp``
    of the JAX package); plain matmuls, as JAX computes them."""

    def __init__(self, cfg, *, device, dtype, d_ff=None):
        super().__init__()
        D, Fd = cfg.d_model, d_ff or cfg.d_ff
        self.wg = new_param((D, Fd), device, dtype)
        self.wu = new_param((D, Fd), device, dtype)
        self.wd = new_param((Fd, D), device, dtype)

    def init_weights(self, generator: torch.Generator):
        for w in (self.wg, self.wu, self.wd):
            normal_(w, 1.0 / math.sqrt(w.shape[0]), generator)

    def forward(self, x):
        return (F.silu(x @ self.wg) * (x @ self.wu)) @ self.wd


def moe_capacity(cfg, group: int) -> int:
    """Per-expert slots for a routed group of ``group`` tokens."""
    cap = int(np.ceil(group * cfg.moe_top_k * cfg.capacity_factor
                      / cfg.moe_num_experts))
    return max(cap, cfg.moe_top_k)


class MoE(nn.Module):
    """Mixture of experts over (B, S, D) with locality-aware overflow.

    Tokens are routed in groups of ``cfg.moe_group`` (GShard-style); the
    router's overflow re-routing walks the steal table (the paper's
    scheduler, see core/routing.py), or the ring order when none is
    given. ``moe_impl="kernel"`` runs the expert FFN through the
    ``moe_gmm`` kernel, three launches per call; ``"einsum"`` through
    ``torch.einsum``. With ``moe_shared_expert`` an :class:`MLP` of width
    ``d_ff`` sees every token and is added to the routed output.
    """

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D, E = cfg.d_model, cfg.moe_num_experts
        Fe = cfg.moe_d_ff or cfg.d_ff
        self.router = new_param((D, E), device, torch.float32)
        self.wg = new_param((E, D, Fe), device, dtype)
        self.wu = new_param((E, D, Fe), device, dtype)
        self.wd = new_param((E, Fe, D), device, dtype)
        if cfg.moe_shared_expert:
            self.shared = MLP(cfg, device=device, dtype=dtype, d_ff=cfg.d_ff)
        self.register_buffer(
            "ring_table", torch.as_tensor(ring_steal_table(E), device=device),
            persistent=False)

    def init_weights(self, generator: torch.Generator):
        normal_(self.router, 1.0 / math.sqrt(self.router.shape[0]), generator)
        for w in (self.wg, self.wu, self.wd):
            normal_(w, 1.0 / math.sqrt(w.shape[1]), generator)
        if hasattr(self, "shared"):
            self.shared.init_weights(generator)

    def route_groups(self, xg, cfg, steal_table=None):
        """Route each group of xg (g, G, D). Returns expert, slot, weight
        (g, G, K) and the per-group aux losses (g,)."""
        rcfg = RoutingConfig(num_experts=cfg.moe_num_experts,
                             top_k=cfg.moe_top_k,
                             capacity=moe_capacity(cfg, xg.shape[1]),
                             steal_attempts=cfg.moe_steal_attempts,
                             policy=cfg.moe_steal_policy)
        table = self.ring_table if steal_table is None else steal_table
        rs = [route(xg1.float() @ self.router, rcfg, table) for xg1 in xg]
        return (torch.stack([r["expert"] for r in rs]),
                torch.stack([r["slot"] for r in rs]),
                torch.stack([r["weight"] for r in rs]),
                torch.stack([r["aux_loss"] for r in rs]))

    def forward(self, x, cfg, steal_table=None):
        """Returns (y, aux_loss)."""
        B, S, D = x.shape
        E = cfg.moe_num_experts
        T = B * S
        G = min(cfg.moe_group, T)
        ngroups = T // G
        xg = x.reshape(ngroups, G, D)
        capacity = moe_capacity(cfg, G)
        expert, slot, weight, aux = self.route_groups(xg, cfg, steal_table)
        e_oh = one_hot(expert, E, xg.dtype)                   # (g,s,K,E)
        c_oh = one_hot(slot, capacity, xg.dtype)              # (g,s,K,C)
        combine = torch.einsum("gske,gskc,gsk->gsec", e_oh, c_oh,
                               weight.to(xg.dtype))
        dispatch = torch.einsum("gske,gskc->gsec", e_oh, c_oh)
        xin = torch.einsum("gsec,gsd->gecd", dispatch, xg)   # (g,E,C,D)
        if cfg.moe_impl == "kernel":
            flat = xin.reshape(ngroups * E, capacity, D).contiguous()
            h = F.silu(kops.moe_gmm(flat, self.wg, E)) \
                * kops.moe_gmm(flat, self.wu, E)
            eout = kops.moe_gmm(h, self.wd, E).reshape(ngroups, E,
                                                       capacity, D)
        elif cfg.moe_impl == "einsum":
            h = torch.einsum("gecd,edf->gecf", xin, self.wg)
            u = torch.einsum("gecd,edf->gecf", xin, self.wu)
            h = F.silu(h) * u
            eout = torch.einsum("gecf,efd->gecd", h, self.wd)
        else:
            raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
        y = torch.einsum("gsec,gecd->gsd", combine, eout).reshape(B, S, D)
        if hasattr(self, "shared"):
            y = y + self.shared(x)
        return y, aux.mean()


# ----------------------------------------------------------------------
# Mamba2 (SSD) mixer
# ----------------------------------------------------------------------

def mamba_split(cfg):
    """(d_inner, G, N, H) of a config's Mamba2 mixer."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, cfg.ssm_groups, cfg.ssm_state, \
        d_inner // cfg.ssm_head_dim


def causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv1d as the JAX package's sum over K shifted
    slices (no cuDNN, which would run it in TF32), plus the bias, then
    silu. xbc: (B, S, C); w: (K, C); conv_state: (B, K-1, C) previous
    inputs for decode. Returns (out, new_state)."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state
    full = torch.cat([pad, xbc], dim=1)                  # (B, S+K-1, C)
    S = xbc.shape[1]
    out = sum(full[:, i:i + S] * w[i] for i in range(K)) + b
    new_state = full[:, full.shape[1] - (K - 1):] if K > 1 else pad
    return F.silu(out), new_state


class Mamba(nn.Module):
    """Mamba2 block (``layers.py:324-412`` of the JAX package).

    ``A_log``, ``dt_bias`` and ``D_skip`` are float32 whatever the model's
    dtype, as the JAX package creates them; the other weights take it.
    """

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        D = cfg.d_model
        d_inner, G, N, H = mamba_split(cfg)
        conv_dim = d_inner + 2 * G * N
        self.in_proj = new_param((D, 2 * d_inner + 2 * G * N + H), device,
                                 dtype)
        self.conv_w = new_param((cfg.ssm_conv, conv_dim), device, dtype)
        self.conv_b = new_param((conv_dim,), device, dtype, 0.0)
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=torch.float32, device=device)))
        self.dt_bias = new_param((H,), device, torch.float32, 0.0)
        self.D_skip = new_param((H,), device, torch.float32, 1.0)
        self.out_norm = new_param((d_inner,), device, dtype, 1.0)
        self.out_proj = new_param((d_inner, D), device, dtype)

    def init_weights(self, generator: torch.Generator):
        normal_(self.in_proj, 1.0 / math.sqrt(self.in_proj.shape[0]),
                generator)
        normal_(self.conv_w, 0.1, generator)
        normal_(self.out_proj, 1.0 / math.sqrt(self.out_proj.shape[0]),
                generator)

    def forward(self, x, cfg, cache=None):
        """cache: None (training) | dict(conv, ssm) for prefill (S > 1,
        chunked scan from the carried state) and decode (S == 1, one
        recurrence step). Returns (y, new_cache)."""
        B, S, _ = x.shape
        d_inner, G, N, H = mamba_split(cfg)
        P = cfg.ssm_head_dim
        proj = x @ self.in_proj
        z, xbc, dtp = torch.split(proj, [d_inner, d_inner + 2 * G * N, H],
                                  dim=-1)
        conv_state = cache["conv"] if cache is not None else None
        xbc, new_conv = causal_conv(xbc, self.conv_w, self.conv_b,
                                    conv_state)
        xs, bmat, cmat = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
        xs = xs.reshape(B, S, H, P)
        bmat = bmat.reshape(B, S, G, N)
        cmat = cmat.reshape(B, S, G, N)
        dt = F.softplus(dtp.float() + self.dt_bias)              # (B,S,H)
        a = -torch.exp(self.A_log)[None, None, :] * dt
        x_dt = xs * dt[..., None].to(xs.dtype)

        if cache is None:
            if cfg.ssm_impl == "kernel":
                y, _ = kops.ssd_scan(x_dt, a, bmat, cmat,
                                     chunk=cfg.ssm_chunk)
            elif cfg.ssm_impl == "ref":
                y = kref.ssd_chunked_ref(x_dt, a, bmat, cmat,
                                         chunk=cfg.ssm_chunk)
            else:
                raise ValueError(f"unknown ssm_impl {cfg.ssm_impl!r}")
            new_cache = None
        elif S > 1:
            y, hT = kref.ssd_chunked_ref(x_dt, a, bmat, cmat,
                                         h0=cache["ssm"],
                                         chunk=cfg.ssm_chunk,
                                         return_state=True)
            new_cache = dict(conv=new_conv, ssm=hT)
        else:
            y, hT = kref.ssd_ref(x_dt, a, bmat, cmat, h0=cache["ssm"],
                                 return_state=True)
            new_cache = dict(conv=new_conv, ssm=hT)
        y = y + xs * self.D_skip[None, None, :, None].to(xs.dtype)
        y = y.reshape(B, S, d_inner)
        y = rmsnorm(y * F.silu(z), self.out_norm, cfg.norm_eps)
        return y @ self.out_proj, new_cache


def mamba_cache_init(cfg, batch, dtype, device):
    d_inner, G, N, H = mamba_split(cfg)
    conv_dim = d_inner + 2 * G * N
    return dict(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, H, N, cfg.ssm_head_dim),
                        dtype=torch.float32, device=device))
