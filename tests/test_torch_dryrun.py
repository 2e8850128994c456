"""The port's dry run (``repro_torch.launch.dryrun``) and what it needs:

* (the grid of every arch × shape on placeholder ranks is in
  ``tests/test_torch_dryrun_{grid,multi}_{0,1}.py``);
* ``num_microbatches`` and ``adapt_config`` against JAX's;
* the AdamW state on a mesh placed as ``opt_state_specs`` says;
* ``Accounting`` against hand counts, and each kernel's custom op on
  meta tensors allocating what its CUDA path allocates (saved tensors
  and workspaces included);
* ``remat="dots"``: gradients equal to ``remat="none"`` on reduced
  granite and jamba, only mm outputs kept beside the period inputs;
* ``accumulate_gradients(acc_dtype=)``, bf16 and f32, against JAX's on
  reduced qwen2.5-3b with 4 microbatches.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.optim import accumulate_gradients as jaccumulate

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_dryrun_grid as grid  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.models import model, stack  # noqa: E402
from repro_torch.optim import AdamWConfig, accumulate_gradients, \
    adamw_init  # noqa: E402


@pytest.fixture
def jax_dryrun(monkeypatch):
    # the JAX dry run asks XLA for 512 host devices when it is imported
    # first; the test needs only its pure functions
    monkeypatch.setenv("REPRO_DRYRUN_NO_FAKE_DEVICES", "1")
    from repro.launch import dryrun as jdryrun
    return jdryrun


@pytest.mark.parametrize("sizes", [{"data": 16, "model": 16},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"data": 2, "model": 2},
                                   {"data": 1, "model": 1}],
                         ids=["16x16", "2x16x16", "2x2", "1x1"])
def test_adapt_config_and_microbatches_equal_jax(sizes, jax_dryrun):
    mesh = grid.DuckMesh(sizes)
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            for reduced in (False, True):
                tc, jc = configs.get(arch), jconfigs.get(arch)
                if reduced:
                    tc, jc = tc.reduced(), jc.reduced()
                spec = configs.SHAPES[shape]
                n = dryrun.num_microbatches(arch, spec, sizes)
                assert n == jax_dryrun.num_microbatches(
                    arch, jconfigs.SHAPES[shape], mesh)
                got = dryrun.adapt_config(tc, spec, sizes, micro=n)
                want = jax_dryrun.adapt_config(jc, jconfigs.SHAPES[shape],
                                               mesh, micro=n)
                for f in ("kv_repeat", "attn_q_spec", "attn_kv_spec",
                          "ssm_act_spec", "moe_group_spec", "moe_xin_spec",
                          "moe_h_spec", "remat", "serialize_slot_gathers",
                          "sharding_profile"):
                    assert getattr(got, f) == getattr(want, f), (arch, shape,
                                                                f)


def test_dryrun_state_placements_and_accounting():
    """On a placeholder (2, 2) world: the AdamW state of DTensor weights
    carries the placements of ``opt_state_specs``; the accounting counts a
    matmul's output bytes, FLOPs and its collective as computed by hand."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_production_mesh

    dryrun.fake_world(4)
    mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
    cfg = configs.get("granite-moe-1b-a400m").reduced()
    params = model.Model(cfg, device="meta")
    specs = shd.param_specs(mesh, params)
    shd.distribute_model(params, mesh, specs)
    for factored in (False, True):
        state = adamw_init(dict(params.named_parameters()),
                           AdamWConfig(factored=factored),
                           period=len(cfg.pattern))
        o_specs = shd.opt_state_specs(mesh, state, specs)
        for part in ("m", "v"):
            for k, t in state[part].items():
                leaves = t if isinstance(t, dict) else {"": t}
                want = o_specs[part][k]
                for s, x in leaves.items():
                    assert isinstance(x, DTensor)
                    assert list(x.placements) == shd.placements(
                        mesh, want[s] if s else want), (part, k, s)

    a = shd.distribute(torch.empty(64, 32, device="meta"), mesh,
                       ("data", None))
    w = shd.distribute(torch.empty(32, 48, device="meta"), mesh,
                       ("data", "model"))
    acct = dryrun.Accounting()
    acct.known([a, w])
    with acct:
        out = a @ w                    # gathers w's rows over "data"
    # w: (16, 24) local, gathered to (32, 24); out (32, 24) f32 local
    assert acct.flops == 2 * 32 * 32 * 24
    assert acct.collectives["all-gather"]["count"] == 1
    assert acct.collectives["all-gather"]["bytes"] == 32 * 24 * 4
    assert acct.peak == 2 * 32 * 24 * 4
    assert out.to_local().shape == (32, 24)


def test_run_cell_records_the_jax_keys(tmp_path):
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", "single",
                          verbose=False, cfg=configs.get("qwen2.5-3b")
                          .reduced(), out_dir=str(tmp_path))
    for key in ("arch", "shape", "mesh", "status", "variant",
                "cfg_overrides", "opt", "grad_acc_dtype", "mesh_shape",
                "num_devices", "kind", "microbatches", "memory", "cost",
                "collectives", "param_count", "active_param_count"):
        assert key in rec
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "generated_code_bytes"):
        assert key in rec["memory"]
    again = dryrun.run_cell("qwen2.5-3b", "decode_32k", "single",
                            verbose=False, out_dir=str(tmp_path))
    assert again == rec                  # read back, not run again
    assert os.listdir(tmp_path) == ["qwen2.5-3b__decode_32k__single.json"]


# ----------------------------------------------------------------------
# remat="dots"
# ----------------------------------------------------------------------

def _reduced(arch, **kw):
    return dataclasses.replace(configs.get(arch).reduced(), **kw)


def _grads(arch, remat, B=2, S=16):
    cfg = _reduced(arch, remat=remat)
    tp = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)),
        "labels": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S), dtype=np.int32))}
    if cfg.num_media_tokens:
        batch["media"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_media_tokens, cfg.d_model), dtype=np.float32))
    loss, _ = model.train_loss(tp, cfg, batch)
    return loss, torch.autograd.grad(loss, list(tp.parameters()))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_remat_dots_gives_the_gradients_of_no_remat(arch):
    l0, g0 = _grads(arch, "none")
    l1, g1 = _grads(arch, "dots")
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


DOTS_POLICY = stack.dots_policy


def _saved(arch, remat, monkeypatch):
    """(hidden states the stack's autograd graph saves, the ops the dots
    policy kept in the forward, aten.mm calls in the backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = _reduced(arch, remat=remat)
    tp = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    x = torch.randn(B, S, cfg.d_model, requires_grad=True)
    kept = []

    def recording(ctx, op, *args, **kwargs):
        out = DOTS_POLICY(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and out.name == "MUST_SAVE":
            kept.append(op)
        return out
    monkeypatch.setattr(stack, "dots_policy", recording)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    class MMs(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in stack.SAVED_BY_DOTS:
                MMs.n += 1
            return func(*args, **(kwargs or {}))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _, aux = stack.apply_stack(tp.blocks, cfg, x,
                                      positions=model._positions(B, S, 0,
                                                                 "cpu"),
                                      mode="train")
    with MMs():
        (y.sum() + aux).backward()
    hidden = sum(s == (B, S, cfg.d_model) for s in shapes)
    return hidden, kept, MMs.n, cfg


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_remat_dots_keeps_only_mm_outputs(arch, monkeypatch):
    """Under "dots" the stack's graph saves what "full" saves (each
    period's input) and the checkpoints keep the outputs of aten.mm /
    aten.addmm and nothing else: the backward's recompute runs no product
    without batch dims. With one checkpoint a layer (granite) it calls
    aten.mm exactly as many times fewer than under "full" as the forward
    kept; nested (jamba: a period's checkpoint around each slot's, each
    keeping by the same policy) it calls it fewer times."""
    h_full, kept_full, mm_full, cfg = _saved(arch, "full", monkeypatch)
    h_dots, kept, mm_dots, _ = _saved(arch, "dots", monkeypatch)
    assert h_dots == h_full == (cfg.repeats if len(cfg.pattern) > 1
                                else cfg.num_layers)
    assert kept_full == [] and kept
    assert set(kept) <= set(stack.SAVED_BY_DOTS)
    if len(cfg.pattern) == 1:
        assert mm_dots == mm_full - len(kept)
    else:
        assert mm_dots < mm_full


# ----------------------------------------------------------------------
# accumulate_gradients(acc_dtype=)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("acc_dtype", ["float32", "bfloat16"])
def test_accumulate_gradients_acc_dtype_matches_jax(acc_dtype):
    """Reduced qwen2.5-3b (f32), 4 microbatches: the mean loss and the
    gradients against JAX's ``accumulate_gradients`` with the same buffer
    dtype. f32 at tests/test_kernels.py's f32 gradient tolerance; a bf16
    buffer rounds each partial sum to bf16 on both sides, so a 1e-6
    difference in a microbatch's gradient can land a sum one bf16 ulp
    (2^-8) apart: the kernels' bf16 tolerance."""
    arch = "qwen2.5-3b"
    jc, tc = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    jp_np = jax.tree.map(np.asarray, jp)
    tp = convert.from_jax(jp_np, tc, "cpu")
    rng = np.random.default_rng(3)
    B, S = 8, 16
    batch = {k: rng.integers(0, tc.vocab_size, (B, S), dtype=np.int32)
             for k in ("tokens", "labels")}
    jl, jg, _ = jaccumulate(lambda p, b: jmodel.train_loss(p, jc, b), jp,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            4, acc_dtype=acc_dtype)
    named = dict(tp.named_parameters())
    tl, tg, _ = accumulate_gradients(
        lambda b: model.train_loss(tp, tc, b), named,
        {k: torch.from_numpy(v) for k, v in batch.items()}, 4,
        acc_dtype=getattr(torch, acc_dtype))
    assert all(g.dtype == torch.float32 for g in tg.values())
    rtol, scale = (1e-4, 1e-5) if acc_dtype == "float32" else (3e-2, 1e-2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = convert.to_jax(tg, tc)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        w = np.asarray(flat_want[path], np.float32)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=scale * max(float(np.abs(w).max()), 1e-6),
            err_msg=jax.tree_util.keystr(path))


def _mb(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _rounded(*shapes_dtypes) -> int:
    b = dryrun._BLOCK
    return sum(-(-int(np.prod(s)) * torch.empty((), dtype=d).element_size()
                 // b) * b for s, d in shapes_dtypes)


@pytest.mark.parametrize("op", ["flash_fwd", "flash_bwd", "ssd_scan_fwd",
                                "ssd_scan_bwd", "moe_gmm"])
def test_kernel_ops_on_meta_allocate_what_the_card_does(op):
    """Each kernel's fake implementation returns what its CUDA launch
    allocates, and the accounting counts every byte of it: flash's lse
    (B, H, S) f32 and the backward's delta beside dq, dk, dv; ssd_scan's
    chunk states (B, H, chunks, 128 x 64) f32 and C·Bᵀ (B, chunks, G,
    128, 128) f32 on the tensor-core route, and the backward's dstates;
    moe_gmm's (E·C, F) output."""
    import repro_torch.kernels  # noqa: F401  (registers the ops)
    ops = torch.ops.repro_torch
    bf, f32 = torch.bfloat16, torch.float32
    B, S, H, Hkv, D = 2, 512, 16, 8, 64
    q, k = _mb((B, S, H, D)), _mb((B, S, Hkv, D))
    P, N, G, L = 64, 128, 1, 128
    nc = S // L
    x, a, bm = _mb((B, S, H, P)), _mb((B, S, H), f32), _mb((B, S, G, N))
    lse = _mb((B, H, S), f32)
    states = _mb((B, H, nc, 128 * 64), f32)
    cb = _mb((B, nc, G, 128, 128), f32)
    E, C, Dm, Fe = 4, 64, 128, 96
    xe, we = _mb((E, C, Dm)), _mb((E, Dm, Fe))
    with dryrun.Accounting() as acct:
        if op == "flash_fwd":
            out = ops.flash_attention_fwd(q, k, k, True, 0.125, None, 0)
            want = [((B, S, H, D), bf), ((B, H, S), f32)]
        elif op == "flash_bwd":
            out = ops.flash_attention_bwd(q, k, k, q, lse, q, True, 0.125,
                                          None, 0)
            want = [((B, S, H, D), bf), ((B, S, Hkv, D), bf),
                    ((B, S, Hkv, D), bf), ((B, H, S), f32)]
        elif op == "ssd_scan_fwd":
            out = ops.ssd_scan_fwd(x, a, bm, bm, 128, True)
            want = [((B, S, H, P), bf), ((B, H, N, P), f32),
                    ((B, H, nc, 128 * 64), f32),
                    ((B, nc, G, 128, 128), f32)]
        elif op == "ssd_scan_bwd":
            out = ops.ssd_scan_bwd(x, a, bm, bm, states, cb, x, None, 128)
            want = [((B, S, H, P), bf), ((B, S, H), f32),
                    ((B, S, G, N), bf), ((B, S, G, N), bf),
                    ((B, H, nc, 128 * 64), f32)]
        else:
            out = [ops.moe_gmm(xe, we, E)]
            want = [((E, C, Fe), bf)]
    got = [(tuple(t.shape), t.dtype) for t in out]
    assert got == want
    assert acct.peak == _rounded(*want)
