"""Model facade (port of ``repro/models/model.py``): init / forward /
train loss / prefill / decode.

``init_params`` returns a :class:`Model` module whose parameter names
follow the JAX parameter tree (``embed``, ``final_norm``, ``lm_head``,
``blocks.<layer>.{ln1,mix,ln2,ffn}.*``), so :mod:`repro_torch.convert`
maps one onto the other. The functions take ``(params, cfg, ...)`` like
the JAX ones, so the same weights can run under another config switch
(for example ``moe_impl``). ``jax.random`` cannot be replayed in torch:
weights come from a ``torch.Generator`` with the JAX package's scales,
and equal weights for a comparison come through ``convert.from_jax``.

Modality frontends are stubs, as in the JAX package: an ``embeds_input``
arch (hubert) takes precomputed frame embeddings ``embeds`` (B, S, D) in
place of tokens and has no ``embed`` leaf, only its ``lm_head``; a VLM
takes precomputed patch embeddings ``media`` (B, M, D) for its
cross-attention layers.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import default_device

from . import layers, stack


class Model(nn.Module):
    """Embedding, the layer stack and the (tied) head of one architecture."""

    def __init__(self, cfg, *, device):
        super().__init__()
        dtype = cfg.param_dtype
        D, V = cfg.d_model, cfg.vocab_size
        if not cfg.embeds_input:
            self.embed = layers.new_param((V, D), device, dtype)
        self.blocks = stack.build_layers(cfg, device=device, dtype=dtype)
        self.final_norm = layers.new_param((D,), device, dtype, 1.0)
        if cfg.embeds_input or not cfg.tie_embeddings:
            self.lm_head = layers.new_param((D, V), device, dtype)

    def init_weights(self, generator: torch.Generator):
        if hasattr(self, "embed"):
            layers.normal_(self.embed, 0.02, generator)
        for blk in self.blocks:
            blk.mix.init_weights(generator)
            if blk.ffn_kind != "none":
                blk.ffn.init_weights(generator)
        if hasattr(self, "lm_head"):
            layers.normal_(self.lm_head, self.lm_head.shape[0] ** -0.5,
                           generator)


def init_params(cfg, generator: torch.Generator | None = None,
                device=None) -> Model:
    """Random weights from ``generator`` (seed 0 on ``device`` if None)."""
    dev = default_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Model(cfg, device=dev)
    model.init_weights(generator)
    return model


def param_count(cfg) -> int:
    """Parameters of a config, counted on the meta device (nothing is
    allocated), as ``param_count`` of the JAX package."""
    return sum(p.numel() for p in Model(cfg, device="meta").parameters())


def active_param_count(cfg) -> int:
    """Parameters touched per token: an MoE block's routed experts count
    ``top_k / num_experts`` of theirs (``active_param_count`` of the JAX
    package); counted on the meta device."""
    total = param_count(cfg)
    if cfg.moe_num_experts == 0:
        return total
    expert = sum(p.numel() for name, p in
                 Model(cfg, device="meta").named_parameters()
                 if name.split(".")[-1] in ("wg", "wu", "wd")
                 and ".ffn." in name and p.dim() == 3
                 and p.shape[0] == cfg.moe_num_experts)
    return total - expert + expert * cfg.moe_top_k // cfg.moe_num_experts


def _embed(params: Model, cfg, tokens=None, embeds=None):
    if cfg.embeds_input:
        if embeds is None:
            raise ValueError(f"{cfg.name} takes frontend embeddings")
        return embeds.to(cfg.param_dtype)
    return params.embed[tokens.long()]


def _media(cfg, media):
    return None if media is None else media.to(cfg.param_dtype)


def _head(params: Model, cfg, x):
    x = layers.rmsnorm(x, params.final_norm, cfg.norm_eps)
    w = params.lm_head if hasattr(params, "lm_head") else params.embed.T
    return (x @ w).float()


def _positions(B, S, start, device):
    return (torch.arange(S, dtype=torch.int32, device=device) + start
            ).expand(B, S)


def forward(params: Model, cfg, tokens=None, embeds=None, media=None,
            steal_table=None):
    """Full-sequence logits (teacher forcing / encoder forward). Returns
    (logits, aux_loss)."""
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    x, _, aux = stack.apply_stack(params.blocks, cfg, x,
                                  positions=_positions(B, S, 0, x.device),
                                  media=_media(cfg, media),
                                  steal_table=steal_table, mode="train")
    return _head(params, cfg, x), aux


def train_loss(params: Model, cfg, batch, steal_table=None):
    """Cross-entropy (+ router aux + z-loss), as ``model.py:81-99`` of
    the JAX package. batch: dict with ``tokens`` (or ``embeds``),
    ``labels`` (B, S) (-100 = masked) and optional ``media``. Returns
    (loss, dict(ce, aux, z_loss))."""
    logits, aux = forward(params, cfg, tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          media=batch.get("media"), steal_table=steal_table)
    labels = batch["labels"].long()
    valid = labels >= 0
    labels_safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels_safe[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1)
    ce = -(ll * valid).sum() / denom
    # z-loss stabilises the softmax normaliser at scale
    zl = torch.square(torch.logsumexp(logits, dim=-1))
    z_loss = (zl * valid).sum() / denom
    loss = ce + cfg.router_aux_weight * aux + cfg.z_loss_weight * z_loss
    return loss, dict(ce=ce, aux=aux, z_loss=z_loss)


@torch.no_grad()
def prefill(params: Model, cfg, tokens=None, embeds=None, media=None,
            max_len: int | None = None, steal_table=None):
    """Process a prompt, returning (last_logits (B, 1, V), caches)."""
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[:2]
    caches = stack.init_caches(cfg, B, max_len or S, x.dtype, x.device)
    x, caches, _ = stack.apply_stack(params.blocks, cfg, x,
                                     positions=_positions(B, S, 0, x.device),
                                     media=_media(cfg, media),
                                     caches=caches, mode="prefill",
                                     steal_table=steal_table)
    return _head(params, cfg, x[:, -1:]), caches


@torch.no_grad()
def decode_step(params: Model, cfg, caches, tokens, steal_table=None):
    """One decode step. tokens: (B, 1). Returns (logits, caches); the
    caches' K/V buffers are updated in place (cross layers reuse the
    media projected by prefill)."""
    x = _embed(params, cfg, tokens)
    B = x.shape[0]
    pos = _positions(B, 1, caches["length"], x.device)
    x, caches, _ = stack.apply_stack(params.blocks, cfg, x, positions=pos,
                                     caches=caches, mode="decode",
                                     steal_table=steal_table)
    return _head(params, cfg, x), caches
