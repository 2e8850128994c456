"""The layer stack (port of ``repro/models/stack.py``).

The JAX package stacks each pattern slot's weights on a leading
``repeats`` axis and runs the stack under ``jax.lax.scan``. Here every
layer is its own :class:`Layer` module, held in an ``nn.ModuleList`` in
execution order (layer ``r * len(pattern) + si`` is slot ``si`` of repeat
``r``), and the stack is a Python loop. Caches are a per-layer list that
shares one ``length`` counter, so train, prefill and decode share one
code path: KV for self attention, conv and SSM state for Mamba2, the
projected media for cross attention (prefill projects them, decode
reuses them; training keeps none). Sharding constraints and
``serialize_slot_gathers`` have no counterpart.

Remat: in ``mode="train"`` with ``cfg.remat != "none"`` each pattern
period runs under ``torch.utils.checkpoint`` (non-reentrant), keeping
only its input for the backward, as the JAX package checkpoints the scan
body. A one-slot pattern's period is one layer. A multi-slot period
(jamba's 8 slots, vision's 5) is nested as in JAX: inside the period's
checkpoint each slot runs under its own, so the backward holds one
slot's internals at a time. Routing is deterministic, so the recompute
routes the same way. ``"dots"`` (save matmul outputs) is not ported yet
and raises.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers


class Layer(nn.Module):
    """One (mixer, ffn) slot: pre-norm residual mixer, then pre-norm FFN."""

    def __init__(self, cfg, kind: str, ffn: str, *, device, dtype):
        super().__init__()
        mixers = {"attn": layers.Attention, "mamba": layers.Mamba,
                  "cross": layers.CrossAttention}
        if kind not in mixers:
            raise ValueError(f"unknown slot kind {kind!r}")
        if ffn not in ("mlp", "moe", "none"):
            raise ValueError(f"unknown ffn kind {ffn!r}")
        self.kind, self.ffn_kind = kind, ffn
        D = cfg.d_model
        self.ln1 = layers.new_param((D,), device, dtype, 1.0)
        self.mix = mixers[kind](cfg, device=device, dtype=dtype)
        if ffn != "none":
            self.ln2 = layers.new_param((D,), device, dtype, 1.0)
            ffn_cls = layers.MoE if ffn == "moe" else layers.MLP
            self.ffn = ffn_cls(cfg, device=device, dtype=dtype)

    def forward(self, h, cfg, *, positions, media=None, cache=None,
                steal_table=None):
        """Returns (h, new_cache, aux)."""
        hin = layers.rmsnorm(h, self.ln1, cfg.norm_eps)
        if self.kind == "attn":
            y, new_cache = self.mix(hin, cfg, positions=positions,
                                    cache=cache, causal=not cfg.is_encoder)
        elif self.kind == "cross":
            y, new_cache = self.mix(hin, cfg, media=media, cache=cache)
        else:
            y, new_cache = self.mix(hin, cfg, cache=cache)
        h = h + y
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if self.ffn_kind != "none":
            hin = layers.rmsnorm(h, self.ln2, cfg.norm_eps)
            if self.ffn_kind == "moe":
                y, aux = self.ffn(hin, cfg, steal_table)
            else:
                y = self.ffn(hin)
            h = h + y
        return h, new_cache, aux


def build_layers(cfg, *, device, dtype) -> nn.ModuleList:
    return nn.ModuleList(
        Layer(cfg, kind, ffn, device=device, dtype=dtype)
        for _ in range(cfg.repeats) for kind, ffn in cfg.pattern)


def init_caches(cfg, batch: int, max_len: int, dtype, device):
    """Per-layer caches (KV for attention, conv and SSM state for Mamba2,
    None for cross attention: prefill projects the media) and one
    ``length``."""
    caches = []
    for _ in range(cfg.repeats):
        for kind, _ in cfg.pattern:
            if kind == "attn":
                c = layers.attn_cache_init(cfg, batch, max_len, dtype, device)
                c.pop("length")
            elif kind == "mamba":
                c = layers.mamba_cache_init(cfg, batch, dtype, device)
            else:
                c = None
            caches.append(c)
    return dict(length=0, layers=caches)


def apply_stack(blocks: nn.ModuleList, cfg, x, *, positions, media=None,
                caches=None, steal_table=None, mode: str = "train"):
    """Run the stack. mode: 'train' (no caches) | 'prefill' (fill caches)
    | 'decode' (read + update caches). ``media`` (B, M, D) feeds the
    cross-attention layers in train and prefill. Returns (x, new_caches,
    aux).

    The caches' K/V buffers are written in place; the returned dict holds
    the same buffers (and each Mamba2 layer's new conv and SSM state, each
    cross layer's projected media) and the advanced ``length``.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "train":
        caches = None
    remat = mode == "train" and cfg.remat != "none"
    if remat and cfg.remat != "full":
        raise NotImplementedError(f"remat={cfg.remat!r} joins with a later "
                                  "slice of the port")
    if caches is None:
        kw = dict(positions=positions, media=media, steal_table=steal_table)
        x, aux = _train_stack(blocks, cfg, x, kw, remat)
        return x, None, aux
    length = caches["length"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_layers = []
    for layer, c in zip(blocks, caches["layers"]):
        c = None if c is None else dict(c, length=length)
        x, nc, a = layer(x, cfg, positions=positions, media=media, cache=c,
                         steal_table=steal_table)
        nc.pop("length", None)
        aux = aux + a
        new_layers.append(nc)
    return x, dict(length=length + x.shape[1], layers=new_layers), aux


def _run_layers(group, cfg, x, aux, kw, remat):
    """The layers of ``group`` in turn, each under its own checkpoint
    when ``remat``; returns (x, aux plus the layers' aux losses)."""
    for layer in group:
        if remat:
            x, _, a = checkpoint(layer, x, cfg, use_reentrant=False, **kw)
        else:
            x, _, a = layer(x, cfg, **kw)
        aux = aux + a
    return x, aux


def _train_stack(blocks, cfg, x, kw, remat):
    """The stack without caches; with ``remat`` a multi-slot period runs
    under one checkpoint holding one per slot (nested, as the JAX
    package's ``apply_stack``), a one-slot period is a layer's own. The
    aux losses add up in layer order on every route."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    period = len(cfg.pattern)
    if not remat or period == 1:
        return _run_layers(blocks, cfg, x, aux, kw, remat)
    for r in range(len(blocks) // period):
        group = blocks[r * period:(r + 1) * period]
        x, aux = checkpoint(_run_layers, group, cfg, x, aux, kw, True,
                            use_reentrant=False)
    return x, aux
