"""Model building blocks (port of ``repro/models/layers.py``): norms, RoPE,
GQA attention with a KV cache, MoE with locality-aware routing.

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
    end raises, where JAX clamps the start;
  * the MLP, cross-attention and Mamba2 layers join with later slices
    and raise ``NotImplementedError`` until then.

``attn_impl="kernel"`` sends attention without a cache (training) through
the ``flash_attention`` kernel, as the JAX package does; cached attention
(prefill, decode) takes the plain version on both routes.
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
        p.copy_(z * scale)


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


def attn_cache_init(cfg, batch, max_len, dtype, device):
    stored = cfg.num_kv_heads * cfg.kv_repeat
    shape = (batch, max_len, stored, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                length=0)


# ----------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------

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
    ``torch.einsum``.
    """

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        if cfg.moe_shared_expert:
            raise NotImplementedError("the shared-expert MLP joins with the "
                                      "MLP slice")
        D, E = cfg.d_model, cfg.moe_num_experts
        Fe = cfg.moe_d_ff or cfg.d_ff
        self.router = new_param((D, E), device, torch.float32)
        self.wg = new_param((E, D, Fe), device, dtype)
        self.wu = new_param((E, D, Fe), device, dtype)
        self.wd = new_param((E, Fe, D), device, dtype)
        self.register_buffer(
            "ring_table", torch.as_tensor(ring_steal_table(E), device=device),
            persistent=False)

    def init_weights(self, generator: torch.Generator):
        normal_(self.router, 1.0 / math.sqrt(self.router.shape[0]), generator)
        for w in (self.wg, self.wu, self.wd):
            normal_(w, 1.0 / math.sqrt(w.shape[1]), generator)

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
        y = torch.einsum("gsec,gecd->gsd", combine, eout)
        return y.reshape(B, S, D), aux.mean()
