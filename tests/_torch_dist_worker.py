"""The steps of ``tests/test_torch_distributed.py``, sharded or not.

Run as a script, it is one rank of a 4-rank gloo world on the CPU:

    python tests/_torch_dist_worker.py RANK WORLD PORT OUT.npz

It builds the (2, 2) ("data", "model") mesh of ``make_production_mesh``,
places the weights, optimizer state, batches and caches by the role
rules (profile "2d") and runs the dry run's step functions on them:
2 training steps (2 microbatches, f32 accumulation) of reduced
granite-moe-1b-a400m (with the mesh's steal table), reduced qwen2.5-3b
and reduced mamba2-1.3b (the scan on local heads), then prefill and 3
greedy decode steps of reduced qwen3-14b with its caches placed by the
cache specs. Then the same training and serving for reduced qwen3-14b
with 3 q heads over 1 kv head (SPLIT): on the (2, 2) mesh neither head
count divides the model axis, as 40 q and 8 kv heads do not divide 16 at
full width, so K/V and the caches are split along their sequence and
each rank attends over its own key block. Rank 0 writes every loss, the
first step's gradients, the parameters after the steps, every logit and
token, gathered whole, and every rank's attention FLOPs and key-block
lengths (:func:`attention_probe`) to OUT.npz.

Imported, :func:`scenarios` with ``mesh=None`` runs the same code on
plain tensors in one process: the reference the test compares with.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.data import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     mesh_steal_table)
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import stack as stack_lib  # noqa: E402
from repro_torch.optim import (AdamWConfig, accumulate_gradients,  # noqa: E402
                               adamw_init)

MESH = (2, 2)
TRAIN = dict(batch=8, seq=128, micro=2, steps=2)
SPLIT = "qwen3-14b/kv-split"
TRAIN_ARCHS = ("granite-moe-1b-a400m", "qwen2.5-3b", "mamba2-1.3b", SPLIT)
SERVE = dict(batch=4, prompt=16, decode=3)
SERVE_ARCHS = ("qwen3-14b", SPLIT)
PROBE = dict(batch=1, seq=32)
PROBE_KINDS = ("train", "serve")


def reduced(arch: str):
    """The reduced config of ``arch``; SPLIT is reduced qwen3-14b with 3
    q heads over 1 kv head."""
    if arch == SPLIT:
        return dataclasses.replace(configs.get("qwen3-14b").reduced(),
                                   num_heads=3, num_kv_heads=1)
    return configs.get(arch).reduced()


def _grid():
    """The mesh's rank grid and axes, for the unsharded reference."""
    return types.SimpleNamespace(mesh=torch.arange(4).reshape(MESH),
                                 mesh_dim_names=("data", "model"))


def _full(t):
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def _place(tree, mesh, specs):
    return tree if mesh is None else shd.distribute_tree(tree, mesh, specs)


def train(arch: str, mesh) -> dict:
    spec = ShapeSpec("train", TRAIN["seq"], TRAIN["batch"], "train")
    cfg = dryrun.adapt_config(reduced(arch), spec, mesh or _grid(),
                              micro=TRAIN["micro"])
    steal = None
    if cfg.moe_num_experts:
        steal = torch.as_tensor(mesh_steal_table(
            mesh or _grid(), cfg.moe_num_experts, cfg.moe_steal_policy))
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    if mesh is not None:
        shd.distribute_model(params, mesh, shd.param_specs(
            mesh, params, cfg.sharding_profile))
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    state = adamw_init(dict(params.named_parameters()), opt_cfg,
                       period=len(cfg.pattern))
    step = dryrun.make_train_step(cfg, opt_cfg, TRAIN["micro"], steal, mesh)
    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
        global_batch=TRAIN["batch"], seed=1))
    out = {}
    losses, norms = [], []
    for s in range(TRAIN["steps"]):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
        if mesh is not None:
            batch = _place(batch, mesh, shd.batch_specs(mesh, batch))
        if s == 0:                 # the first step's gradients themselves
            from torch.distributed.tensor.experimental import \
                implicit_replication
            named = dict(params.named_parameters())
            with implicit_replication():
                _, grads, _ = accumulate_gradients(
                    lambda b: model_lib.train_loss(
                        params, cfg, dryrun._reshard(b, mesh), steal),
                    named, batch, TRAIN["micro"])
            out.update({f"{arch}/grad/{k}": _full(g)
                        for k, g in grads.items()})
        params, state, loss, gnorm = step(params, state, batch)
        losses.append(_full(loss))
        norms.append(_full(gnorm))
    out.update({f"{arch}/loss": np.stack(losses),
                f"{arch}/grad_norm": np.stack(norms)})
    for name, p in params.named_parameters():
        out[f"{arch}/param/{name}"] = _full(p)
    return out


def serve(arch: str, mesh) -> dict:
    B, P, n = SERVE["batch"], SERVE["prompt"], SERVE["decode"]
    # SPLIT's cache takes one spare position, so that its length splits
    # over the model axis
    max_len = P + n + (arch == SPLIT)
    cfg = dryrun.adapt_config(reduced(arch),
                              ShapeSpec("decode", max_len, B, "decode"),
                              mesh or _grid())
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    if mesh is not None:
        shd.distribute_model(params, mesh, shd.param_specs(
            mesh, params, cfg.sharding_profile))
    caches = stack_lib.init_caches(cfg, B, max_len, cfg.param_dtype, "cpu")
    if mesh is not None:
        caches = _place(caches, mesh, shd.cache_specs(mesh, caches))
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P),
                                           dtype=np.int32))

    def placed(tok):
        return tok if mesh is None else shd.distribute(
            tok, mesh, shd.batch_specs(mesh, {"t": tok})["t"])
    from torch.distributed.tensor.experimental import implicit_replication
    with torch.no_grad(), implicit_replication():
        logits, caches = model_lib.prefill(params, cfg,
                                           tokens=placed(tokens),
                                           caches=caches)
    out = {f"{arch}/logits0": _full(logits)}
    decode = dryrun.make_decode_step(cfg, None)
    gen = []
    for i in range(n):
        nxt = torch.from_numpy(out[f"{arch}/logits{i}"][:, -1].argmax(-1)
                               .astype(np.int32))[:, None]
        gen.append(nxt.numpy())
        logits, caches = decode(params, caches, placed(nxt))
        out[f"{arch}/logits{i + 1}"] = _full(logits)
    out[f"{arch}/tokens"] = np.concatenate(gen, axis=1)
    return out


@contextlib.contextmanager
def attention_calls():
    """(key length, FLOPs) of every plain attention call made while
    entered (a list, filled in call order; FLOPs by ``FlopCounterMode``
    around the call alone)."""
    from torch.utils.flop_counter import FlopCounterMode
    seen = []
    names = ("attention_ref", "attention_lse_ref")
    saved = {n: getattr(kref, n) for n in names}

    def spy(fn):
        def run(q, k, v, *args, **kwargs):
            with FlopCounterMode(display=False) as counter:
                out = fn(q, k, v, *args, **kwargs)
            seen.append((k.shape[1], counter.get_total_flops()))
            return out
        return run
    for n in names:
        setattr(kref, n, spy(saved[n]))
    try:
        yield seen
    finally:
        for n in names:
            setattr(kref, n, saved[n])


def attention_probe(mesh) -> dict:
    """SPLIT's first attention layer on one causal sequence (batch 1,
    which the data axis does not split), in training and in serving (a
    prefill of all but the last position into a cache, then one decode
    step): on this rank, the FLOPs of its attention calls (the plain
    attention's products, counted by ``FlopCounterMode``) and the key
    length each call saw."""
    from torch.distributed.tensor.experimental import implicit_replication
    B, S = PROBE["batch"], PROBE["seq"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, 64)).astype(np.float32))
    pos = torch.arange(S)[None]
    out = {}
    for kind in PROBE_KINDS:
        cfg = dryrun.adapt_config(reduced(SPLIT),
                                  ShapeSpec(kind, S, B, kind),
                                  mesh or _grid())
        params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
        xs = x
        if kind == "serve":
            caches = stack_lib.init_caches(cfg, B, S, cfg.param_dtype, "cpu")
            if mesh is not None:
                caches = _place(caches, mesh, shd.cache_specs(mesh, caches))
        if mesh is not None:
            shd.distribute_model(params, mesh, shd.param_specs(
                mesh, params, cfg.sharding_profile))
            xs = shd.distribute(x, mesh, ())
        attn = params.blocks[0].mix
        with attention_calls() as seen, implicit_replication(), \
                torch.no_grad():
            if kind == "train":
                attn(xs, cfg, positions=pos)
            else:
                cache = dict(caches["layers"][0], length=0)
                _, cache = attn(xs[:, :S - 1], cfg, positions=pos[:, :S - 1],
                                cache=cache)
                attn(xs[:, S - 1:], cfg, positions=pos[:, S - 1:],
                     cache=cache)
        out[f"{kind}/flops"] = sum(f for _, f in seen)
        out[f"{kind}/kv_len"] = [n for n, _ in seen]
    return out


def scenarios(mesh) -> dict:
    out = {}
    for arch in TRAIN_ARCHS:
        out.update(train(arch, mesh))
    for arch in SERVE_ARCHS:
        out.update(serve(arch, mesh))
    return out


def main(rank: int, world: int, port: int, path: str) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_production_mesh(device_type="cpu", shape=MESH)
        out = scenarios(mesh)
        probes = [None] * world
        dist.all_gather_object(probes, attention_probe(mesh))
        for k in probes[0]:
            out[f"{SPLIT}/probe/{k}"] = np.array([p[k] for p in probes])
        if rank == 0:
            np.savez(path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
