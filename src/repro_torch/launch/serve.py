"""Batched serving driver (port of ``repro/launch/serve.py``): prefill a
prompt batch, greedy-decode with KV caches, report latency/throughput.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-14b --batch 4 --prompt-len 64 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --moe-impl kernel

Runs on the CUDA device unless ``--device cpu`` is given. ``--moe-impl
kernel`` sends the expert FFN through the hand-written ``moe_gmm``
kernel (the config's own default is ``einsum``). Weights, prompts and a
VLM's media come from seeded ``torch.Generator``s: the weights from one
on the device, the prompts and media from ones on the host, so a seed
gives the same prompts and media on any device. The media (B, M, D) are
the stub's patch embeddings, drawn N(0, 1) in the parameter dtype as the
JAX launcher draws them. An encoder-only arch has no decode and exits.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs, default_device
from repro_torch.models import model as model_lib


def make_prompts(cfg, batch: int, prompt_len: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, cfg.vocab_size, (batch, prompt_len), generator=g)


def make_media(cfg, batch: int, seed: int):
    """A VLM's stub patch embeddings (B, M, D) in the parameter dtype, or
    None for an arch without media."""
    if not cfg.num_media_tokens:
        return None
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, cfg.num_media_tokens, cfg.d_model),
                       generator=g).to(cfg.param_dtype)


def generate(cfg, params, prompts, gen: int, device=None, steal_table=None,
             media=None):
    """Greedy generation: prefill ``prompts`` (B, P) (with ``media``
    (B, M, D) for a VLM's cross-attention layers), then ``gen - 1``
    decode steps. Returns (tokens (B, gen) on the host, stats) with
    stats = dict(prefill_s, decode_s, length) timed to the device's end.
    """
    dev = default_device(device)
    prompts = prompts.to(dev)
    if media is not None:
        media = media.to(dev)
    B, P = prompts.shape

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, caches = model_lib.prefill(params, cfg, prompts, media=media,
                                       max_len=P + gen,
                                       steal_table=steal_table)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    sync()
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, caches = model_lib.decode_step(params, cfg, caches, tok,
                                               steal_table=steal_table)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1).cpu(), dict(
        prefill_s=t_prefill, decode_s=t_decode, length=caches["length"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--moe-impl", choices=("einsum", "kernel"), default=None,
                    help="expert FFN route (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the CUDA device")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")

    dev = default_device(args.device)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    B, P = args.batch, args.prompt_len
    prompts = make_prompts(cfg, B, P, args.seed)
    media = make_media(cfg, B, args.seed)
    gen, st = generate(cfg, params, prompts, args.gen, dev, media=media)

    per_tok = st["decode_s"] / max(args.gen - 1, 1)
    print(f"[serve] {cfg.name}: batch={B} prompt={P} gen={args.gen}")
    print(f"[serve] prefill {st['prefill_s']*1e3:8.1f} ms "
          f"({B*P/st['prefill_s']:9.0f} tok/s)")
    print(f"[serve] decode  {per_tok*1e3:8.2f} ms/tok "
          f"({B/max(per_tok,1e-9):9.0f} tok/s)")
    print(f"[serve] sample row 0: {gen[0][:16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
