"""Dry run: run every (arch × shape × mesh) cell's step once on
placeholder ranks and record what one rank holds, computes and sends
(port of ``repro/launch/dryrun.py``).

The JAX package lowers and compiles each cell against 512 placeholder
devices and reads XLA's ``memory_analysis``, ``cost_analysis`` and the
collectives of the compiled HLO. Here the placeholder devices are the
ranks of torch's fake process group (``init_process_group("fake")``,
rank 0 of 256 or 512), the parameters, optimizer state, batch and caches
are DTensors placed by ``launch/shardings.py`` whose local shards live on
the ``meta`` device (shapes and dtypes, no data), and the step runs once,
eagerly, through the port's own code: the kernels' custom ops allocate
on ``meta`` what they allocate on the card. :class:`Accounting`, a
dispatch mode that sees each rank's local ops (it lets DTensor desugar
its ops first, as ``MemTracker`` does), gives

* memory: the bytes of the arguments' local shards and the peak of the
  bytes live during the step (each storage rounded up to the CUDA
  caching allocator's 512-byte blocks), freed when its storage dies;
* cost: the local ops' FLOPs, by ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter.flop_registry``, the kernels' included);
* collectives: each functional collective's count, result bytes and ring
  wire bytes by kind, and the share whose group spans pods (counted
  here: ``CommDebugMode``'s module tracker fails inside the recompute of
  ``torch.utils.checkpoint``).

All of it is accounting from shapes, not a measurement of a device.
Records go to ``artifacts/dryrun_torch/<cell>.json`` (gitignored) with
the JAX record's keys. The JAX package keeps the meta-free path (its
config's ``attn_impl``/``moe_impl``/``ssm_impl``); ``cfg_overrides``
sends a cell through the kernels.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh multi
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_production_mesh, mesh_steal_table
from repro_torch.models import model as model_lib
from repro_torch.models import stack as stack_lib
from repro_torch.optim import (AdamWConfig, accumulate_gradients, adamw_init,
                               adamw_update)

__all__ = ["ARTIFACTS", "FACTORED_OPT", "MICRO_WANTED", "Accounting",
           "cell_id", "num_microbatches", "adapt_config", "batch_struct",
           "input_specs", "make_train_step", "make_prefill_step",
           "make_decode_step", "abstract_caches", "fake_world",
           "run_cell", "main"]

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")

# archs whose optimizer runs in factored (Adafactor-v + bf16-m) mode with
# bf16 gradient accumulation, as the JAX package's dry run has them
FACTORED_OPT = {"jamba-1.5-large-398b", "llama-3.2-vision-90b",
                "llama4-scout-17b-a16e", "command-r-35b"}

# desired gradient-accumulation microbatches per arch (train_4k), clamped
# to the DP shard count at mesh time
MICRO_WANTED = {
    "llama-3.2-vision-90b": 16,
    "command-r-35b": 16,
    "jamba-1.5-large-398b": 16,
    "llama4-scout-17b-a16e": 8,
    "qwen3-14b": 16,
    "qwen2.5-3b": 4,
    "stablelm-1.6b": 4,
    "granite-moe-1b-a400m": 4,
    "hubert-xlarge": 4,
    "mamba2-1.3b": 4,
}

# the CUDA caching allocator hands out blocks of multiples of 512 bytes
_BLOCK = 512


def cell_id(arch: str, shape: str, mesh_kind: str) -> str:
    return f"{arch}__{shape}__{mesh_kind}"


def num_microbatches(arch: str, shape_spec, mesh) -> int:
    if shape_spec.kind != "train":
        return 1
    sizes = shd.mesh_shape(mesh)
    dp = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    return max(1, min(MICRO_WANTED.get(arch, 4),
                      shape_spec.global_batch // dp))


def adapt_config(cfg, shape_spec, mesh, micro: int = 1):
    """Mesh-dependent config adjustments (the launcher's job).

    * kv_repeat (GQA TP replication) only when the replicated head count
      both divides the query heads (attention math) and is divisible by
      the model axis (sharding math): e.g. command-r 64H/8kv → ×2 = 16
      stored; qwen3 40H/8kv can't (16 ∤ 40) → its KV activations/cache
      fall back to sequence-sharding (flash-decoding style).
    * activation sharding constraints are derived here with divisibility
      fit against the cell's concrete shapes.
    """
    model_axis = shd.mesh_shape(mesh)["model"]
    ba = shd.batch_axes(mesh)
    updates: dict = {}
    kv = cfg.num_kv_heads
    rep = 1
    if cfg.num_heads > 1 and kv < model_axis and model_axis % kv == 0:
        r = model_axis // kv
        if cfg.num_heads % (kv * r) == 0:
            rep = r
            updates["kv_repeat"] = rep
    stored = kv * rep

    rows = shape_spec.global_batch
    if shape_spec.kind == "train":
        rows = max(1, shape_spec.global_batch // micro)
    S = 1 if shape_spec.kind == "decode" else shape_spec.seq_len
    Skv = shape_spec.seq_len if shape_spec.kind == "decode" else S

    def fit(shape, *spec):
        p = shd.fit_spec(mesh, shape, spec)
        entries = p + (None,) * (len(shape) - len(p))
        return entries if any(e is not None for e in entries) else None

    if cfg.num_heads > 1:
        updates["attn_q_spec"] = fit(
            (rows, S, cfg.num_heads, cfg.head_dim), ba, None, "model")
        if stored % model_axis == 0:
            updates["attn_kv_spec"] = fit(
                (rows, Skv, stored, cfg.head_dim), ba, None, "model")
        else:
            # sequence-sharded KV (flash-decoding / context parallel)
            updates["attn_kv_spec"] = fit(
                (rows, Skv, stored, cfg.head_dim), ba, "model", None)
    if cfg.ssm_state:
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        updates["ssm_act_spec"] = fit(
            (rows, S, H, cfg.ssm_head_dim), ba, None, "model")
    if cfg.moe_num_experts:
        T = rows * S
        G = min(cfg.moe_group, T)
        updates["moe_group_spec"] = fit((T // G, G, cfg.d_model),
                                        ba, None, None)
        cap = int(np.ceil(G * cfg.moe_top_k * cfg.capacity_factor
                          / cfg.moe_num_experts))
        ff = cfg.moe_d_ff or cfg.d_ff
        # groups ride the DP axes, experts the model axis
        updates["moe_xin_spec"] = fit(
            (T // G, cfg.moe_num_experts, cap, cfg.d_model),
            ba, "model", None, None)
        updates["moe_h_spec"] = fit(
            (T // G, cfg.moe_num_experts, cap, ff),
            ba, "model", None, None)
    if shape_spec.kind == "train":
        updates["remat"] = "full"
        if len(cfg.pattern) > 1:
            updates["serialize_slot_gathers"] = True
    return dataclasses.replace(cfg, **updates)


# ----------------------------------------------------------------------
# step builders (meta inputs)
# ----------------------------------------------------------------------

def batch_struct(cfg, shape_spec, device="meta", dtypes=None) -> dict:
    """Empty stand-ins for a training or prefill batch; ``dtypes`` maps a
    leaf's name to a dtype in place of the default (the model's for
    embeddings and media, int32 for tokens and labels)."""
    B, S = shape_spec.global_batch, shape_spec.seq_len
    dt = dict(labels=torch.int32, tokens=torch.int32,
              embeds=cfg.param_dtype, media=cfg.param_dtype)
    dt.update(dtypes or {})
    shapes = {"labels": (B, S)}
    if cfg.embeds_input:
        shapes["embeds"] = (B, S, cfg.d_model)
    else:
        shapes["tokens"] = (B, S)
    if cfg.num_media_tokens:
        shapes["media"] = (B, cfg.num_media_tokens, cfg.d_model)
    return {k: torch.empty(v, dtype=dt[k], device=device)
            for k, v in shapes.items()}


def input_specs(arch: str, shape: str, device="meta") -> dict:
    """Stand-ins for every model input of a cell."""
    cfg = configs.get(arch)
    spec = configs.SHAPES[shape]
    if spec.kind in ("train", "prefill"):
        return batch_struct(cfg, spec, device)
    # decode: one new token against a seq_len cache
    return {"tokens": torch.empty((spec.global_batch, 1), dtype=torch.int32,
                                  device=device)}


def _sharded(fn):
    """``fn`` with plain tensors (positions, masks, constants) taken as
    replicated beside DTensors."""
    def run(*args, **kwargs):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return fn(*args, **kwargs)
    return run


def _reshard(batch: dict, mesh) -> dict:
    """A microbatch sliced from a DTensor batch, split again along its
    rows as the batch specs say (a plain batch is returned as it is)."""
    if mesh is None:
        return batch
    specs = shd.batch_specs(mesh, batch)
    return {k: v.redistribute(mesh, shd.placements(mesh, specs[k]))
            for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, num_micro: int,
                    steal_table, mesh=None):
    """step(params, opt_state, batch) -> (params, opt_state, loss,
    grad_norm): gradient accumulation over ``num_micro`` microbatches
    (a bf16 buffer when the optimizer is factored), then AdamW in place.
    With a ``mesh`` the parameters, state and batch are DTensors."""
    acc_dtype = "bfloat16" if opt_cfg.factored else None

    @_sharded
    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        loss, grads, _ = accumulate_gradients(
            lambda b: model_lib.train_loss(params, cfg, _reshard(b, mesh),
                                           steal_table=steal_table),
            named, batch, num_micro, acc_dtype=acc_dtype)
        _, opt_state, metrics = adamw_update(grads, opt_state, named,
                                             opt_cfg)
        return params, opt_state, loss, metrics["grad_norm"]
    return train_step


def make_prefill_step(cfg, steal_table):
    """step(params, batch, caches) -> (last logits, cache length); an
    encoder's forward gives the last position's logits (and no cache)."""
    @_sharded
    def prefill_step(params, batch, caches=None):
        if cfg.is_encoder:
            logits, _ = model_lib.forward(
                params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"), media=batch.get("media"),
                steal_table=steal_table)
            return logits[:, -1]
        logits, caches = model_lib.prefill(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), media=batch.get("media"),
            steal_table=steal_table, caches=caches)
        return logits, caches["length"]
    return torch.no_grad()(prefill_step)


def make_decode_step(cfg, steal_table):
    @_sharded
    def decode_step(params, caches, tokens):
        return model_lib.decode_step(params, cfg, caches, tokens,
                                     steal_table=steal_table)
    return decode_step


def abstract_caches(cfg, batch: int, max_len: int, device="meta"):
    """Decode caches of ``max_len`` positions, with a cross layer's media
    projections in place (prefill would have made them)."""
    caches = stack_lib.init_caches(cfg, batch, max_len, cfg.param_dtype,
                                   device)
    stored = cfg.num_kv_heads * cfg.kv_repeat
    shape = (batch, cfg.num_media_tokens, stored, cfg.head_dim)
    for i, (kind, _) in enumerate(cfg.pattern * cfg.repeats):
        if kind == "cross":
            caches["layers"][i] = {
                k: torch.zeros(shape, dtype=cfg.param_dtype, device=device)
                for k in ("k", "v")}
    return caches


# ----------------------------------------------------------------------
# accounting (memory, FLOPs, collectives of one rank)
# ----------------------------------------------------------------------

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Accounting(TorchDispatchMode):
    """What one rank allocates, computes and sends while it is entered.

    It returns ``NotImplemented`` for an op on DTensors, so DTensor
    desugars it into local ops (redistributions included), which come
    back here; the fake ops of DTensor's own sharding propagation are
    skipped. ``pod_size`` (ranks per pod) marks collectives whose group
    spans pods.
    """

    def __init__(self, pod_size: int | None = None):
        super().__init__()
        self.pod_size = pod_size
        self.live = self.peak = self.flops = 0
        self.collectives: dict[str, dict] = {}
        from torch.utils.weak import WeakIdKeyDictionary
        self._storages = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def known(self, tree) -> None:
        """Tensors that exist before the step (the arguments, buffers):
        an op that returns one of them (an in-place update) adds
        nothing."""
        for t in _tensors(tree):
            self._storages.setdefault(_local(t).untyped_storage(), 0)

    def hold(self, t: torch.Tensor) -> None:
        """Count a tensor's storage as live until it dies."""
        st = _local(t).untyped_storage()
        if st in self._storages:
            return
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._storages[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _collective(self, name: str, args, kwargs, out) -> None:
        import torch.distributed as dist
        kind = _COLLECTIVES[name]
        group = dist.distributed_c10d._resolve_process_group(
            kwargs.get("group_name", args[-1]))
        ranks = dist.get_process_group_ranks(group)
        g = len(ranks)
        outs = out if isinstance(out, (list, tuple)) else [out]
        nbytes = sum(_nbytes(t) for t in outs)
        if kind == "all-reduce":
            wire = 2 * nbytes * (g - 1) // g
        elif kind == "all-gather":
            wire = nbytes * (g - 1) // g
        elif kind == "reduce-scatter":
            wire = nbytes * max(g - 1, 1)
        else:
            wire = nbytes
        cross = self.pod_size is not None and \
            min(ranks) // self.pod_size != max(ranks) // self.pod_size
        rec = self.collectives.setdefault(kind, dict(
            count=0, bytes=0, wire_bytes=0, cross_pod_bytes=0,
            cross_pod_wire_bytes=0))
        rec["count"] += 1
        rec["bytes"] += nbytes
        rec["wire_bytes"] += wire
        if cross:
            rec["cross_pod_bytes"] += nbytes
            rec["cross_pod_wire_bytes"] += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is torch.ops._c10d_functional.wait_tensor.default:
            return args[0]        # eager wait returns its argument
        out = func(*args, **kwargs)
        if active_fake_mode() is not None:   # DTensor's propagation
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func.namespace == "_c10d_functional" \
                and packet.__name__ in _COLLECTIVES:
            self._collective(packet.__name__, args, kwargs, out)
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.hold(t)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree, buffers: bool = True):
    """Every tensor in a nested dict/list/tuple or module (a module's
    buffers too, unless ``buffers`` is False)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        if buffers:
            yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v, buffers)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v, buffers)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in a tree (a module's
    parameters, not its buffers: the MoE ring tables are constants)."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree, buffers=False))


# ----------------------------------------------------------------------
# cell runner
# ----------------------------------------------------------------------

# placeholder ranks: as many as the largest production mesh
FAKE_WORLD = 512


def fake_world(n: int) -> None:
    """A fake process group of at least ``n`` ranks (this process is rank
    0): FAKE_WORLD ranks, kept for the process, so every mesh of the grid
    is built over its first ranks. A world is never replaced by one of
    the same size: DTensor caches its plans by mesh shape, and a plan made
    in a destroyed world would name process groups that are gone."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialised; the "
                               "dry run needs a fake one")
        if dist.get_world_size() >= n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=max(n, FAKE_WORLD))


def run_cell(arch: str, shape: str, mesh_kind: str,
             skip_existing: bool = True, verbose: bool = True,
             variant: str | None = None,
             cfg_overrides: dict | None = None,
             micro_override: int | None = None,
             batch_dtypes: dict | None = None,
             out_dir: str | None = None,
             cfg=None, shape_spec: ShapeSpec | None = None,
             mesh_shape: tuple[int, ...] | None = None) -> dict:
    """Run one cell's step once on placeholder ranks and record it.
    ``variant``/overrides support what-if cells: config fields are
    replaced *after* mesh adaptation; ``cfg`` (a config in place of the
    registry's ``arch``, e.g. a reduced one), ``shape_spec`` (in place of
    ``SHAPES[shape]``) and ``mesh_shape`` (in place of the production
    (16,16) / (2,16,16)) size a cell for a card or a test;
    ``batch_dtypes`` gives batch leaves the dtypes a real run feeds (see
    :func:`batch_struct`)."""
    art = out_dir or ARTIFACTS
    os.makedirs(art, exist_ok=True)
    name = cell_id(arch, shape, mesh_kind) + (f"__{variant}" if variant
                                              else "")
    path = os.path.join(art, name + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    cfg0 = cfg or configs.get(arch)
    spec = shape_spec or configs.SHAPES[shape]
    if shape not in cfg0.shapes():
        rec = dict(arch=arch, shape=shape, mesh=mesh_kind, status="skipped",
                   reason=cfg0.skipped_shapes().get(shape, "n/a"))
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    t0 = time.time()
    multi = mesh_kind == "multi"
    mshape = tuple(mesh_shape or ((2, 16, 16) if multi else (16, 16)))
    fake_world(math.prod(mshape))
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu",
                                shape=mshape)
    n_micro = micro_override or num_microbatches(arch, spec, mesh)
    cfg = adapt_config(cfg0, spec, mesh, micro=n_micro)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    steal = None
    if cfg.moe_num_experts:
        steal = torch.as_tensor(mesh_steal_table(mesh, cfg.moe_num_experts,
                                                 cfg.moe_steal_policy),
                                device="meta")
    acct = Accounting(math.prod(mshape[1:]) if multi else None)
    opt_cfg = None
    try:
        params = model_lib.Model(cfg, device="meta")
        shd.distribute_model(params, mesh,
                             shd.param_specs(mesh, params,
                                             cfg.sharding_profile))
        p_specs = shd.param_specs(mesh, params, cfg.sharding_profile)
        if spec.kind == "train":
            factored = arch in FACTORED_OPT
            opt_cfg = AdamWConfig(factored=factored,
                                  m_dtype="bfloat16" if factored
                                  else "float32")
            opt_state = adamw_init(dict(params.named_parameters()),
                                   opt_cfg, period=len(cfg.pattern))
            batch = batch_struct(cfg, spec, dtypes=batch_dtypes)
            batch = shd.distribute_tree(batch, mesh,
                                        shd.batch_specs(mesh, batch))
            args = (params, opt_state, batch)
            step = make_train_step(cfg, opt_cfg, n_micro, steal, mesh)
        elif spec.kind == "prefill":
            batch = batch_struct(cfg, spec, dtypes=batch_dtypes)
            batch = shd.distribute_tree(batch, mesh,
                                        shd.batch_specs(mesh, batch))
            caches = None
            if not cfg.is_encoder:      # empty: prefill fills them
                caches = stack_lib.init_caches(cfg, spec.global_batch,
                                               spec.seq_len,
                                               cfg.param_dtype, "meta")
                caches = shd.distribute_tree(caches, mesh,
                                             shd.cache_specs(mesh, caches))
            args = (params, batch, caches)
            step = make_prefill_step(cfg, steal)
        else:  # decode
            caches = abstract_caches(cfg, spec.global_batch, spec.seq_len)
            caches["length"] = spec.seq_len - 1
            caches = shd.distribute_tree(caches, mesh,
                                         shd.cache_specs(mesh, caches))
            tokens = {"tokens": torch.empty((spec.global_batch, 1),
                                            dtype=torch.int32,
                                            device="meta")}
            tokens = shd.distribute_tree(tokens, mesh,
                                         shd.batch_specs(mesh, tokens))
            args = (params, caches, tokens["tokens"])
            step = make_decode_step(cfg, steal)
        arg_bytes = _local_bytes(args)
        acct.known([args, steal])
        t_setup = time.time() - t0
        with acct:
            out = step(*args)
            out_bytes = _local_bytes(list(out[2:]) if spec.kind == "train"
                                     else out)
        t_run = time.time() - t0 - t_setup
    except Exception as e:  # record the failure for triage, then re-raise
        rec = dict(arch=arch, shape=shape, mesh=mesh_kind, status="error",
                   error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        raise

    rec = dict(
        arch=arch, shape=shape, mesh=mesh_kind, status="ok",
        variant=variant,
        cfg_overrides={k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in (cfg_overrides or {}).items()
                       if not k.endswith("_spec")},
        opt=(dict(factored=opt_cfg.factored, m_dtype=opt_cfg.m_dtype)
             if spec.kind == "train" else None),
        grad_acc_dtype=("bfloat16" if opt_cfg.factored else "float32")
        if spec.kind == "train" else None,
        mesh_shape=list(mshape),
        num_devices=math.prod(mshape),
        kind=spec.kind,
        global_batch=spec.global_batch, seq_len=spec.seq_len,
        microbatches=n_micro,
        setup_s=round(t_setup, 2), run_s=round(t_run, 2),
        memory=dict(
            argument_bytes=arg_bytes,
            output_bytes=out_bytes,
            temp_bytes=acct.peak,
            peak_bytes=arg_bytes + acct.peak,
            generated_code_bytes=None,
        ),
        cost=dict(
            flops_per_device=acct.flops,
            transcendentals=None,
            bytes_accessed_per_device=None,
        ),
        collectives=acct.collectives,
        param_count=model_lib.param_count(cfg),
        active_param_count=model_lib.active_param_count(cfg),
    )
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        mm = rec["memory"]["peak_bytes"]
        print(f"[dryrun] {name:56s} ok mem/dev={mm/2**30:7.2f}GiB "
              f"flops/dev={acct.flops:.3e} setup={t_setup:.1f}s "
              f"run={t_run:.1f}s", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(configs.ARCHS)
    shapes = [args.shape] if args.shape else list(configs.SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    failures = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                try:
                    run_cell(a, s, m, skip_existing=not args.force)
                except Exception as e:
                    failures.append((a, s, m, str(e)))
                    print(f"[dryrun] FAIL {a} {s} {m}: {e}")
    if failures:
        print(f"\n{len(failures)} cells failed")
        raise SystemExit(1)
    print("\nall requested cells ran on placeholder ranks")


if __name__ == "__main__":
    main()
