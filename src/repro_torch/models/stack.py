"""The layer stack (port of ``repro/models/stack.py``).

The JAX package stacks each pattern slot's weights on a leading
``repeats`` axis and runs the stack under ``jax.lax.scan``. Here every
layer is its own :class:`Layer` module, held in an ``nn.ModuleList`` in
execution order (layer ``r * len(pattern) + si`` is slot ``si`` of repeat
``r``), and the stack is a Python loop. Caches are a per-layer list that
shares one ``length`` counter, so train, prefill and decode share one
code path. Sharding constraints and ``serialize_slot_gathers`` have no
counterpart.

Remat: in ``mode="train"`` with ``cfg.remat != "none"`` each layer runs
under ``torch.utils.checkpoint`` (non-reentrant), keeping only its input
for the backward, as the JAX package checkpoints each pattern period
(one layer for a one-slot pattern). Routing is deterministic, so the
recompute routes the same way. ``"dots"`` (save matmul outputs) is not
ported yet and raises.
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
        if kind not in ("attn", "mamba"):
            raise NotImplementedError(f"{kind!r} layers join with a later "
                                      "slice of the port")
        if ffn not in ("mlp", "moe", "none"):
            raise ValueError(f"unknown ffn kind {ffn!r}")
        self.kind, self.ffn_kind = kind, ffn
        D = cfg.d_model
        self.ln1 = layers.new_param((D,), device, dtype, 1.0)
        mixer = layers.Attention if kind == "attn" else layers.Mamba
        self.mix = mixer(cfg, device=device, dtype=dtype)
        if ffn != "none":
            self.ln2 = layers.new_param((D,), device, dtype, 1.0)
            ffn_cls = layers.MoE if ffn == "moe" else layers.MLP
            self.ffn = ffn_cls(cfg, device=device, dtype=dtype)

    def forward(self, h, cfg, *, positions, cache=None, steal_table=None):
        """Returns (h, new_cache, aux)."""
        hin = layers.rmsnorm(h, self.ln1, cfg.norm_eps)
        if self.kind == "attn":
            y, new_cache = self.mix(hin, cfg, positions=positions,
                                    cache=cache, causal=not cfg.is_encoder)
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
    """Per-layer caches (KV for attention, conv and SSM state for Mamba2)
    and one ``length``."""
    caches = []
    for _ in range(cfg.repeats):
        for kind, _ in cfg.pattern:
            if kind == "attn":
                c = layers.attn_cache_init(cfg, batch, max_len, dtype, device)
                c.pop("length")
            elif kind == "mamba":
                c = layers.mamba_cache_init(cfg, batch, dtype, device)
            else:
                raise NotImplementedError(f"{kind!r} caches join with a "
                                          "later slice of the port")
            caches.append(c)
    return dict(length=0, layers=caches)


def apply_stack(blocks: nn.ModuleList, cfg, x, *, positions, caches=None,
                steal_table=None, mode: str = "train"):
    """Run the stack. mode: 'train' (no caches) | 'prefill' (fill caches)
    | 'decode' (read + update caches). Returns (x, new_caches, aux).

    The caches' K/V buffers are written in place; the returned dict holds
    the same buffers (and each Mamba2 layer's new conv and SSM state) and
    the advanced ``length``.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "train":
        caches = None
    length = caches["length"] if caches is not None else None
    remat = mode == "train" and cfg.remat != "none"
    if remat and cfg.remat != "full":
        raise NotImplementedError(f"remat={cfg.remat!r} joins with a later "
                                  "slice of the port")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_layers = []
    for i, layer in enumerate(blocks):
        c = None
        if caches is not None and caches["layers"][i] is not None:
            c = dict(caches["layers"][i], length=length)
        if remat:
            x, nc, a = checkpoint(layer, x, cfg, positions=positions,
                                  steal_table=steal_table,
                                  use_reentrant=False)
        else:
            x, nc, a = layer(x, cfg, positions=positions, cache=c,
                             steal_table=steal_table)
        if nc is not None:
            nc.pop("length", None)
        aux = aux + a
        new_layers.append(nc)
    new_caches = None
    if caches is not None:
        new_caches = dict(length=length + x.shape[1], layers=new_layers)
    return x, new_caches, aux
