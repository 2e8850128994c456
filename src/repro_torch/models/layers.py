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

Distribution: with weights and batch held as DTensors (``launch/
shardings.py``), every layer runs on them as written and DTensor
propagates the placements. :func:`~repro_torch.models.distributed.constrain`
redistributes an activation to the config's spec at the sites where the
JAX package constrains its sharding (q, k/v, the MoE groups, dispatched
tokens, hidden and expert outputs, the Mamba2 input). The kernels and the
MoE router run on each rank's local shards through ``local_call``
(``models/distributed.py``): local heads for flash and ``ssd_scan``,
local experts and groups for ``moe_gmm``, local groups for the router. A
plain tensor takes none of this.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.core.routing import (RoutingConfig, one_hot,
                                      ring_steal_table, route)
from repro_torch.core.sharding import batch_axes, fit_spec
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.distributed import (batch_split, constrain, entry,
                                            entry_size, gathered, local_call,
                                            merge_last, shard_index,
                                            split_last, write_seq)


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
        q, k, v = (x @ gathered(w) for w in (self.wq, self.wk, self.wv))
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = split_last(q, H, Dh)
        k = split_last(k, Hkv, Dh)
        v = split_last(v, Hkv, Dh)
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cfg.kv_repeat > 1:
            k = k.repeat_interleave(cfg.kv_repeat, dim=2)
            v = v.repeat_interleave(cfg.kv_repeat, dim=2)
        q = constrain(q, cfg.attn_q_spec)

        new_cache = None
        if cache is None:
            kk, vv, kv_off = k, v, 0
            kk = constrain(kk, cfg.attn_kv_spec)
            vv = constrain(vv, cfg.attn_kv_spec)
        else:
            length = cache["length"]
            kk, vv = cache["k"], cache["v"]
            if length + S > kk.shape[1]:
                raise ValueError(f"cache of {kk.shape[1]} positions cannot "
                                 f"take {S} more at {length}")
            write_seq(kk, k, length)                         # in place
            write_seq(vv, v, length)
            new_cache = dict(k=kk, v=vv, length=length + S)
            kk = constrain(kk, cfg.attn_kv_spec)
            vv = constrain(vv, cfg.attn_kv_spec)
            kv_off = length

        causal = causal or cache is not None
        kernel = cfg.attn_impl == "kernel" and cache is None

        def core(q, kk, vv):
            if kernel:
                return kops.flash_attention(q, kk, vv, causal=causal,
                                            window=cfg.attn_window)
            if S >= cfg.attn_chunk_threshold:
                # long prefill/training: bound the score slab to
                # (chunk × Skv)
                return kref.attention_chunked_ref(
                    q, kk, vv, causal=causal, window=cfg.attn_window,
                    kv_offset=kv_off, chunk=cfg.attn_chunk)
            return kref.attention_ref(q, kk, vv, causal=causal,
                                      window=cfg.attn_window,
                                      kv_offset=kv_off)
        return _attend(core, q, kk, vv, cfg) @ gathered(self.wo), new_cache


def _attend(core, q, k, v, cfg):
    """``core(q, k, v)`` (the flash kernel or the plain attention), its
    heads merged: (B, S, H·Dh). On DTensors it runs on local heads: batch
    split as ``attn_q_spec`` says, heads too where the q and kv heads both
    divide the axis, every key position on each rank (a cache split along
    its sequence is gathered); the merged output is split along H·Dh as
    the heads were, so its gradient comes back in whole heads."""
    def merged(q, k, v):
        out = core(q, k, v)
        return out.reshape(*out.shape[:2], -1)
    if not isinstance(q, DTensor):
        return merged(q, k, v)
    mesh = q.device_mesh
    qs = fit_spec(mesh, tuple(q.shape),
                      cfg.attn_q_spec or (batch_axes(mesh),))
    b, h = entry(qs, 0), entry(qs, 2)
    if h is not None and k.shape[2] % entry_size(mesh, h):
        h = None
    spec = (b, None, h, None)
    return local_call(merged, (q, k, v), (spec,) * 3, (b, None, h))


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
        q = rmsnorm(split_last(x @ gathered(self.wq), H, Dh), self.q_norm,
                    cfg.norm_eps)
        q = constrain(q, cfg.attn_q_spec)
        if cache is None:
            if media is None:
                raise ValueError("a cross-attention layer needs media")
            k = split_last(media @ gathered(self.wk), Hkv, Dh)
            v = split_last(media @ gathered(self.wv), Hkv, Dh)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
            if cfg.kv_repeat > 1:
                k = k.repeat_interleave(cfg.kv_repeat, dim=2)
                v = v.repeat_interleave(cfg.kv_repeat, dim=2)
        else:
            k, v = cache["k"], cache["v"]
        out = _attend(lambda q, k, v: kref.attention_ref(q, k, v,
                                                         causal=False),
                      q, k, v, cfg) @ gathered(self.wo)
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
        return (F.silu(x @ gathered(self.wg)) * (x @ gathered(self.wu))) \
            @ gathered(self.wd)


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

        def local(xg, router):
            r = route(xg.float() @ router, rcfg, table)   # each group its own
            return r["expert"], r["slot"], r["weight"], r["aux_loss"]
        if not isinstance(xg, DTensor):
            return local(xg, self.router)
        mesh = xg.device_mesh
        g = entry(fit_spec(mesh, tuple(xg.shape),
                                      cfg.moe_group_spec or ()), 0)
        return local_call(local, (xg, self.router), ((g,), ()),
                           [(g,)] * 4)

    def forward(self, x, cfg, steal_table=None):
        """Returns (y, aux_loss). On DTensors the block after routing runs
        on local groups and experts (groups split as ``moe_xin_spec`` says
        and experts too where E divides its axis): each rank dispatches its
        groups' tokens to its own experts and the combined output is a
        partial sum over the expert axis, which DTensor reduces."""
        B, S, D = x.shape
        E = cfg.moe_num_experts
        T = B * S
        G = min(cfg.moe_group, T)
        ngroups = T // G
        xg = constrain(x.reshape(ngroups, G, D), cfg.moe_group_spec)
        capacity = moe_capacity(cfg, G)
        expert, slot, weight, aux = self.route_groups(xg, cfg, steal_table)

        def block(xg, expert, slot, weight, wg, wu, wd, first=0):
            """Experts [first, first + len(wg)) on the groups of xg."""
            El = wg.shape[0]
            local = expert - first if first else expert
            e_oh = one_hot(local, El, xg.dtype)                 # (g,s,K,E)
            c_oh = one_hot(slot, capacity, xg.dtype)            # (g,s,K,C)
            combine = torch.einsum("gske,gskc,gsk->gsec", e_oh, c_oh,
                                   weight.to(xg.dtype))
            dispatch = torch.einsum("gske,gskc->gsec", e_oh, c_oh)
            xin = torch.einsum("gsec,gsd->gecd", dispatch, xg)  # (g,E,C,D)
            xin = constrain(xin, cfg.moe_xin_spec)
            if cfg.moe_impl == "kernel":
                g = xin.shape[0]
                flat = xin.reshape(g * El, capacity, D).contiguous()
                h = F.silu(kops.moe_gmm(flat, wg, El)) \
                    * kops.moe_gmm(flat, wu, El)
                eout = kops.moe_gmm(h, wd, El).reshape(g, El, capacity, D)
            elif cfg.moe_impl == "einsum":
                h = torch.einsum("gecd,edf->gecf", xin, wg)
                u = torch.einsum("gecd,edf->gecf", xin, wu)
                h = F.silu(h) * u
                h = constrain(h, cfg.moe_h_spec)
                eout = torch.einsum("gecf,efd->gecd", h, wd)
            else:
                raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
            eout = constrain(eout, cfg.moe_xin_spec)
            return torch.einsum("gsec,gecd->gsd", combine, eout)

        ws = (self.wg, self.wu, self.wd)
        if not isinstance(xg, DTensor):
            y = block(xg, expert, slot, weight, *ws)
        else:
            mesh = xg.device_mesh
            xs = fit_spec(mesh, (ngroups, E, capacity, D),
                              cfg.moe_xin_spec or (batch_axes(mesh),))
            g, e = entry(xs, 0), entry(xs, 1)
            first = 0 if e is None else \
                shard_index(mesh, e) * (E // entry_size(mesh, e))
            y = local_call(functools.partial(block, first=first),
                            (xg, expert, slot, weight, *ws),
                            ((g,),) * 4 + ((e,),) * 3, (g,), partial=e)
        y = y.reshape(B, S, D)
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
        proj = batch_split(x @ gathered(self.in_proj))
        z, xbc, dtp = torch.split(proj, [d_inner, d_inner + 2 * G * N, H],
                                  dim=-1)
        conv_state = cache["conv"] if cache is not None else None
        xbc, new_conv = causal_conv(xbc, self.conv_w, self.conv_b,
                                    conv_state)
        xs, bmat, cmat = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
        xs = split_last(xs, H, P)
        bmat = split_last(bmat, G, N)
        cmat = split_last(cmat, G, N)
        dt = F.softplus(dtp.float() + self.dt_bias)              # (B,S,H)
        a = -torch.exp(self.A_log)[None, None, :] * dt
        x_dt = xs * dt[..., None].to(xs.dtype)
        x_dt = constrain(x_dt, cfg.ssm_act_spec)

        if cache is None:
            if cfg.ssm_impl == "kernel":
                y = _ssd(lambda *t: kops.ssd_scan(
                    *t, chunk=cfg.ssm_chunk)[0], cfg, x_dt, a, bmat, cmat)
            elif cfg.ssm_impl == "ref":
                y = _ssd(lambda *t: kref.ssd_chunked_ref(
                    *t, chunk=cfg.ssm_chunk), cfg, x_dt, a, bmat, cmat)
            else:
                raise ValueError(f"unknown ssm_impl {cfg.ssm_impl!r}")
            new_cache = None
        elif S > 1:
            y, hT = _ssd(lambda *t: kref.ssd_chunked_ref(
                *t[:4], h0=t[4], chunk=cfg.ssm_chunk, return_state=True),
                cfg, x_dt, a, bmat, cmat, cache["ssm"])
            new_cache = dict(conv=new_conv, ssm=hT)
        else:
            y, hT = _ssd(lambda *t: kref.ssd_ref(
                *t[:4], h0=t[4], return_state=True),
                cfg, x_dt, a, bmat, cmat, cache["ssm"])
            new_cache = dict(conv=new_conv, ssm=hT)
        y = y + xs * self.D_skip[None, None, :, None].to(xs.dtype)
        y = merge_last(y)                                  # (B, S, d_inner)
        y = rmsnorm(y * F.silu(z), self.out_norm, cfg.norm_eps)
        return y @ gathered(self.out_proj), new_cache


def _ssd(core, cfg, x, a, b, c, h0=None):
    """``core(x, a, b, c[, h0])`` (the ``ssd_scan`` kernel or the plain
    scan; y, or y and the final state with an initial state ``h0``) on
    local heads: batch and heads split as ``ssm_act_spec`` says; B and C
    split by group alongside, or whole when there is one group (every
    local head reads it)."""
    args = (x, a, b, c) if h0 is None else (x, a, b, c, h0)
    if not isinstance(x, DTensor):
        return core(*args)
    mesh = x.device_mesh
    xs = fit_spec(mesh, tuple(x.shape),
                      cfg.ssm_act_spec or (batch_axes(mesh),))
    bt, h = entry(xs, 0), entry(xs, 2)
    G = b.shape[2]
    g = h if h is not None and G % entry_size(mesh, h) == 0 else None
    if h is not None and g is None and G != 1:
        h = None
    spec = (bt, None, h, None)
    bspec = (bt, None, g, None)
    specs = (spec, (bt, None, h), bspec, bspec)
    if h0 is None:
        return local_call(core, args, specs, spec)
    state = (bt, h, None, None)
    return local_call(core, args, specs + (state,), [spec, state])


def mamba_cache_init(cfg, batch, dtype, device):
    d_inner, G, N, H = mamba_split(cfg)
    conv_dim = d_inner + 2 * G * N
    return dict(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, H, N, cfg.ssm_head_dim),
                        dtype=torch.float32, device=device))
