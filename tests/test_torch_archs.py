"""Port parity of the four architectures that bring new layers: the dense
command-r-35b (GQA, tied 256000-row head at full width), the encoder
hubert-xlarge (frame embeddings in, bidirectional attention, no decode),
llama-3.2-vision-90b (gated cross attention onto media every fifth
layer) and jamba-1.5-large-398b (an 8-slot period: attention, seven
Mamba2 mixers, MoE on the odd slots). Reduced configs, float32, weights
through ``convert.from_jax``, inputs made with numpy from a seed; the
JAX side runs its Pallas kernels in interpret mode where a config selects
them. The vision gates start at zero in both packages, which would hide
a broken cross layer: the numpy tree gets nonzero gates from the seed
before either package loads it.

Also: nested remat of multi-slot periods (gradients equal to no remat,
one saved input per period), ``pipeline_for_arch`` against JAX's, the
shape grid, the JAX-layout round trips of the weights and the AdamW
state for all ten architectures, checkpoints of the four crossing between
the packages, and the launchers on the host."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import pipeline_for_arch  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers, model, stack  # noqa: E402

NEW = ["command-r-35b", "hubert-xlarge", "llama-3.2-vision-90b",
       "jamba-1.5-large-398b"]
DECODERS = [a for a in NEW if a != "hubert-xlarge"]
VISION, JAMBA = "llama-3.2-vision-90b", "jamba-1.5-large-398b"
KERNELS = dict(attn_impl="kernel", ssm_impl="kernel", moe_impl="kernel")
# (arch, routes): jamba also runs all three kernel routes (JAX's Pallas
# kernels in interpret mode, the port's plain versions on the host)
CASES = [pytest.param(a, {}, id=a) for a in NEW] + [
    pytest.param(JAMBA, KERNELS, id=JAMBA + "-kernels")]
TOL = dict(rtol=3e-3, atol=3e-3)          # tests/test_models.py


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get(arch).reduced(), **kw),
            dataclasses.replace(configs.get(arch).reduced(), **kw))


def _with_gates(tree, cfg, seed):
    """The tree with every cross layer's gate drawn from ``seed`` (tanh of
    0.5 to 1.5): a zero gate makes the layer add nothing."""
    rng = np.random.default_rng(seed)
    for si, (kind, _) in enumerate(cfg.pattern):
        if kind == "cross":
            mix = tree["blocks"][si]["mix"]
            mix["gate"] = rng.uniform(0.5, 1.5, mix["gate"].shape).astype(
                mix["gate"].dtype)
    return tree


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(JAX params, the port's model) on the same weights."""
    jc, tc = _cfgs(arch)
    tree = _with_gates(jax.tree.map(np.asarray, jmodel.init_params(
        jc, jax.random.PRNGKey(0))), jc, seed=11)
    return jax.tree.map(jnp.asarray, tree), convert.from_jax(tree, tc, "cpu")


def _inputs(cfg, B, S, seed=0):
    """numpy model inputs: tokens or frame embeddings, media for a VLM."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.embeds_input:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        b["tokens"] = rng.integers(1, cfg.vocab_size, (B, S)).astype(
            np.int32)
    if cfg.num_media_tokens:
        b["media"] = rng.standard_normal(
            (B, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_registry_holds_the_ten_architectures_of_the_jax_package():
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    for name, jc in jconfigs.ARCHS.items():
        got = dataclasses.asdict(configs.get(name))
        want = dataclasses.asdict(jc)
        assert {k: got[k] for k in got} == {k: want[k] for k in got}, name


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_shape_grid_matches_jax(arch):
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    tc, jc = configs.get(arch), jconfigs.get(arch)
    assert tc.shapes() == jc.shapes()
    assert sorted(tc.skipped_shapes()) == sorted(jc.skipped_shapes())


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_pipeline_for_arch_bit_equal_to_jax(arch):
    jc, tc = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jshape = jconfigs.ShapeSpec("t", 24, 3, "train")
    tshape = configs.ShapeSpec("t", 24, 3, "train")
    jp = jpipeline.pipeline_for_arch(jc, jshape, seed=5)
    tp = pipeline_for_arch(tc, tshape, seed=5)
    for step in (0, 9):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert sorted(got) == sorted(want)
        assert ("embeds" in got) == tc.embeds_input
        assert ("media" in got) == bool(tc.num_media_tokens)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------------------
# forward, loss and gradients, prefill and decode against JAX
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,routes", CASES)
def test_forward_logits_match_jax(arch, routes):
    jp, tp = _weights(arch)
    jc, tc = _cfgs(arch, **routes)
    b = _inputs(tc, 2, 16)
    jl, jaux = jmodel.forward(jp, jc, **_j(b))
    with torch.no_grad():
        tl, taux = model.forward(tp, tc, **_t(b))
    assert tl.dtype == torch.float32 and tl.shape == (2, 16, tc.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("arch,routes", CASES)
def test_train_loss_and_grads_match_jax(arch, routes):
    jp, tp = _weights(arch)
    jc, tc = _cfgs(arch, **routes)
    b = _inputs(tc, 2, 16, seed=1)
    b["labels"] = np.random.default_rng(2).integers(
        0, tc.vocab_size, (2, 16)).astype(np.int32)
    b["labels"][0, :3] = -100
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jc, _j(b)), has_aux=True)(jp)
    tl, tm = model.train_loss(tp, tc, _t(b))
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(tl, [p for _, p in tp.named_parameters()])
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for key in ("ce", "aux", "z_loss"):
        assert float(tm[key].detach()) == pytest.approx(
            float(jm[key]), rel=1e-5, abs=1e-7)
    got = convert.to_jax(dict(zip(names, grads)), tc)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jg))[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w = flat_want[path]
        scale = max(float(np.abs(w).max()), 1e-6)
        # f32 on both sides; sums taken in another order (tol relative to
        # the leaf's largest gradient), as tests/test_torch_train.py
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
    if tc.num_media_tokens:        # the gates took a gradient
        gates = [w for p, w in flat_got
                 if getattr(p[-1], "key", None) == "gate"]
        assert gates and all(np.abs(g).max() > 0 for g in gates)


@pytest.mark.parametrize("arch,routes", [c for c in CASES
                                         if c.values[0] in DECODERS])
def test_prefill_and_decode_logits_match_jax(arch, routes):
    jp, tp = _weights(arch)
    jc, tc = _cfgs(arch, **routes)
    S = 12
    b = _inputs(tc, 2, S + 1, seed=3)
    toks, media = b["tokens"], b.get("media")
    jmedia = None if media is None else jnp.asarray(media)
    tmedia = None if media is None else torch.from_numpy(media)
    jl, jcache = jmodel.prefill(jp, jc, tokens=jnp.asarray(toks[:, :S]),
                                media=jmedia, max_len=S + 4)
    tl, tcache = model.prefill(tp, tc, torch.from_numpy(toks[:, :S]),
                               media=tmedia, max_len=S + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["length"] == S
    jd, jcache = jmodel.decode_step(jp, jc, jcache,
                                    jnp.asarray(toks[:, S:S + 1]))
    td, tcache = model.decode_step(tp, tc, tcache,
                                   torch.from_numpy(toks[:, S:S + 1]))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert tcache["length"] == int(jcache["length"]) == S + 1
    # every layer's cache against JAX's slot, repeat r
    P = len(tc.pattern)
    for i, lc in enumerate(tcache["layers"]):
        want = jcache["slots"][i % P]
        for k, t in lc.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[k][i // P]),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"layer {i} {k}")


@pytest.mark.parametrize("arch", DECODERS)
def test_generate_greedy_tokens_equal_jax_loop(arch):
    jp, tp = _weights(arch)
    jc, tc = _cfgs(arch)
    B, P, gen = 2, 10, 6
    b = _inputs(tc, B, P, seed=4)
    prompts, media = b["tokens"], b.get("media")
    logits, caches = jmodel.prefill(
        jp, jc, tokens=jnp.asarray(prompts),
        media=None if media is None else jnp.asarray(media),
        max_len=P + gen)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want = [tok]
    for _ in range(gen - 1):
        logits, caches = jmodel.decode_step(jp, jc, caches, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        want.append(tok)
    want = np.concatenate([np.asarray(t) for t in want], axis=1)
    got, stats = serve.generate(
        tc, tp, torch.from_numpy(prompts), gen, device="cpu",
        media=None if media is None else torch.from_numpy(media))
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["length"] == P + gen - 1


def test_encoder_has_bidirectional_attention():
    """tests/test_models.py:88-97: hubert's forward differs from a causal
    run of the same weights at the first position."""
    _, tp = _weights("hubert-xlarge")
    _, tc = _cfgs("hubert-xlarge")
    e = torch.from_numpy(_inputs(tc, 1, 8)["embeds"])
    with torch.no_grad():
        out1, _ = model.forward(tp, tc, embeds=e)
        out2, _ = model.forward(tp, dataclasses.replace(tc, is_encoder=False),
                                embeds=e)
    assert not np.allclose(out1[:, 0].numpy(), out2[:, 0].numpy(), atol=1e-5)
    assert "embed" not in dict(tp.named_parameters())
    with pytest.raises(ValueError, match="embeddings"):
        model.forward(tp, tc, tokens=torch.ones(1, 4, dtype=torch.long))


@pytest.mark.parametrize("arch", ["command-r-35b", VISION])
def test_kv_repeat_equivalence(arch):
    """tests/test_models.py:137-146: kv_repeat is a layout change only (the
    vision case repeats the cross layers' media k/v too)."""
    _, tp = _weights(arch)
    _, tc = _cfgs(arch)
    b = _t(_inputs(tc, 1, 8))
    with torch.no_grad():
        out1, _ = model.forward(tp, tc, **b)
        out2, _ = model.forward(tp, dataclasses.replace(tc, kv_repeat=2),
                                **b)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_cross_layer_reads_the_media_and_its_gate():
    """Other media change the vision logits; zero gates make them
    irrelevant (the cross layers add nothing)."""
    jp, tp = _weights(VISION)
    _, tc = _cfgs(VISION)
    b = _t(_inputs(tc, 1, 8))
    other = dict(b, media=b["media"] + 1.0)
    with torch.no_grad():
        a, _ = model.forward(tp, tc, **b)
        c, _ = model.forward(tp, tc, **other)
        assert (a - c).abs().max() > 1e-3
        zero = convert.from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
        for blk in zero.blocks:
            if blk.kind == "cross":
                blk.mix.gate.zero_()
        a0, _ = model.forward(zero, tc, **b)
        c0, _ = model.forward(zero, tc, **other)
    assert torch.equal(a0, c0)


# ----------------------------------------------------------------------
# nested remat
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch,routes", [
    pytest.param(VISION, {}, id=VISION),
    pytest.param(JAMBA, {}, id=JAMBA),
    pytest.param(JAMBA, KERNELS, id=JAMBA + "-kernels")])
def test_nested_remat_gives_the_grads_of_no_remat(arch, routes):
    _, tp = _weights(arch)
    b = _inputs(configs.get(arch).reduced(), 2, 16, seed=5)
    b["labels"] = np.random.default_rng(6).integers(
        0, 256, (2, 16)).astype(np.int32)
    out = []
    for remat in ("none", "full"):
        _, tc = _cfgs(arch, remat=remat, **routes)
        loss, _ = model.train_loss(tp, tc, _t(b))
        out.append((loss, torch.autograd.grad(loss, list(tp.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def _saved_hidden_states(arch, remat):
    """(saved tensors of the stack's (B, S, D) shape, all saved tensors)
    that autograd keeps from one train-mode pass of the stack."""
    _, tp = _weights(arch)
    _, tc = _cfgs(arch, remat=remat)
    B, S = 2, 8
    x = torch.randn(B, S, tc.d_model, requires_grad=True)
    media = _t(_inputs(tc, B, S)).get("media")
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _, aux = stack.apply_stack(tp.blocks, tc, x,
                                      positions=model._positions(B, S, 0,
                                                                 "cpu"),
                                      media=media, mode="train")
    (y.sum() + aux).backward()
    assert x.grad is not None
    hidden = sum(s == (B, S, tc.d_model) for s in shapes)
    return hidden, [s for s in shapes if s != (B, S, tc.d_model)], tc


@pytest.mark.parametrize("arch", [VISION, JAMBA, "command-r-35b"])
def test_remat_keeps_one_input_per_period(arch):
    """Under remat "full" the stack saves only each period's input (the
    slots' inputs and internals are recomputed) and the running aux loss,
    a scalar: 2 periods of 5 or 8 layers keep 2 hidden states, where no
    remat keeps many per layer. A one-slot pattern keeps one per layer,
    as before."""
    hidden, others, tc = _saved_hidden_states(arch, "full")
    assert hidden == tc.repeats
    assert all(s == () for s in others), others
    none_hidden, _, _ = _saved_hidden_states(arch, "none")
    assert none_hidden > 2 * tc.num_layers


@pytest.mark.parametrize("arch", [VISION, JAMBA])
def test_nested_remat_runs_each_slot_under_its_own_checkpoint(arch):
    """A train step enters each layer once forward, once in its period's
    recompute and once in its own slot's; the period's recompute stops
    at its last slot's input (torch.utils.checkpoint's early stop), so
    that slot is entered twice. Without the slots' own checkpoints every
    layer would be entered twice and the last once."""
    _, tc = _cfgs(arch, remat="full")
    tp = model.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    entries = [0] * tc.num_layers
    for i, blk in enumerate(tp.blocks):
        blk.register_forward_pre_hook(
            lambda m, a, i=i: entries.__setitem__(i, entries[i] + 1))
    b = _t(_inputs(tc, 2, 8))
    b["labels"] = torch.zeros(2, 8, dtype=torch.int32)
    loss, _ = model.train_loss(tp, tc, b)
    assert entries == [1] * tc.num_layers
    loss.backward()
    P = len(tc.pattern)
    assert entries == ([3] * (P - 1) + [2]) * tc.repeats


# ----------------------------------------------------------------------
# the JAX layout: weights and optimizer state, all ten architectures
# ----------------------------------------------------------------------

def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_to_jax_of_from_jax_is_the_tree_bit_for_bit(arch):
    jc = dataclasses.replace(jconfigs.get(arch).reduced(), dtype="bfloat16")
    tc = dataclasses.replace(configs.get(arch).reduced(), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jc, jax.random.PRNGKey(2)))
    back = convert.to_jax(convert.from_jax(tree, tc, "cpu"), tc)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], _bits(w),
                                      err_msg=jax.tree_util.keystr(path))
    assert ("embed" in back) == (not tc.embeds_input)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_opt_state_layout_and_round_trip(arch):
    """The factored AdamW state of the port takes JAX's layout (a slot's
    stacked leaves factored as JAX factors them: the same paths and
    shapes as ``adamw_init`` of the JAX tree), and
    ``opt_from_jax(opt_to_jax(state))`` is the state, bit for bit."""
    jc, tc = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    kw = dict(lr_peak=0.1, warmup_steps=1, factored=True,
              m_dtype="bfloat16")
    jstate = joptim.adamw_init(jmodel.init_params(jc, jax.random.PRNGKey(0)),
                               joptim.AdamWConfig(**kw))
    tp = model.init_params(tc, torch.Generator().manual_seed(1), "cpu")
    named = dict(tp.named_parameters())
    cfg = optim.AdamWConfig(**kw)
    st = optim.adamw_init(named, cfg, period=len(tc.pattern))
    g = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
         for i, (k, p) in enumerate(named.items())}
    _, st, _ = optim.adamw_update(g, st, named, cfg)
    tree = convert.opt_to_jax(st, tc)
    for part in ("m", "v"):
        want = {jax.tree_util.keystr(p): (x.shape, x.dtype.name) for p, x in
                jax.tree_util.tree_flatten_with_path(jstate[part])[0]}
        got = {jax.tree_util.keystr(p): (x.shape, x.dtype.name) for p, x in
               jax.tree_util.tree_flatten_with_path(tree[part])[0]}
        # bf16 leaves come out as their uint16 bits
        got = {k: (s, "bfloat16" if d == "uint16" else d)
               for k, (s, d) in got.items()}
        assert got == want, part
    back = convert.opt_from_jax(convert.opt_to_jax(st, tc, numpy=False), tc,
                                "cpu")
    assert back["count"] == st["count"] == 1
    assert back["stacked"] == st["stacked"]
    for k, t in st["m"].items():
        assert back["m"][k].dtype == t.dtype and torch.equal(back["m"][k], t)
    assert back["v"].keys() == st["v"].keys()
    for k, t in st["v"].items():
        if isinstance(t, dict):
            assert all(torch.equal(back["v"][k][p], t[p]) for p in t), k
        else:
            assert torch.equal(back["v"][k], t), k


@pytest.mark.parametrize("arch", NEW)
def test_checkpoints_cross_between_the_packages(tmp_path, arch):
    """bf16 weights and a factored AdamW state (bf16 ``m``) after one step:
    the port's checkpoint restores in ``repro.checkpoint`` leaf for leaf,
    bit for bit, and JAX's restores in the port to the same state."""
    jc = dataclasses.replace(jconfigs.get(arch).reduced(), dtype="bfloat16")
    tc = dataclasses.replace(configs.get(arch).reduced(), dtype="bfloat16")
    kw = dict(lr_peak=1e-2, warmup_steps=1, factored=True,
              m_dtype="bfloat16")
    tp = model.init_params(tc, torch.Generator().manual_seed(2), "cpu")
    named = dict(tp.named_parameters())
    ts = optim.adamw_init(named, optim.AdamWConfig(**kw),
                          period=len(tc.pattern))
    _, ts, _ = optim.adamw_update({k: torch.full_like(p, 0.01)
                                   for k, p in named.items()}, ts, named,
                                  optim.AdamWConfig(**kw))
    want = {"params": convert.to_jax(tp, tc),
            "opt": convert.opt_to_jax(ts, tc)}
    CheckpointManager(str(tmp_path / "port")).save_sync(
        1, {"params": convert.to_jax(tp, tc, numpy=False),
            "opt": convert.opt_to_jax(ts, tc, numpy=False)})
    like_p = jmodel.init_params(jc, jax.random.PRNGKey(0))
    like = {"params": like_p, "opt": joptim.adamw_init(
        like_p, joptim.AdamWConfig(**kw))}
    step, tree = jckpt.CheckpointManager(
        str(tmp_path / "port")).restore_latest(like)
    assert step == 1
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(_bits(leaf), flat_want[path],
                                      err_msg=jax.tree_util.keystr(path))

    # the same tree written by JAX, read by the port
    jckpt.save(str(tmp_path / "jax"), 1, tree)
    step, back = CheckpointManager(str(tmp_path / "jax")).restore_latest()
    assert step == 1
    got = convert.from_jax(back["params"], tc, "cpu")
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(got.parameters(), tp.parameters()))
    st = convert.opt_from_jax(back["opt"], tc, "cpu")
    assert st["stacked"] == ts["stacked"] and st["count"] == ts["count"]
    for k, t in ts["m"].items():
        assert torch.equal(st["m"][k].view(torch.int16), t.view(torch.int16))


# ----------------------------------------------------------------------
# init, launchers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_init_bits_are_those_of_the_draw_times_the_scale(dtype):
    """``normal_`` scales the f32 draw in place: the same bits as
    ``(z * scale).to(dtype)`` for a fixed seed."""
    p = torch.empty(37, 19, dtype=dtype)
    layers.normal_(p, 0.02, torch.Generator().manual_seed(9))
    z = torch.randn((37, 19), generator=torch.Generator().manual_seed(9))
    assert torch.equal(p, (z * 0.02).to(dtype))
    tc = configs.get("command-r-35b").reduced()
    a = model.init_params(tc, torch.Generator().manual_seed(3), "cpu")
    b = model.init_params(tc, torch.Generator().manual_seed(3), "cpu")
    z = torch.randn(a.embed.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.embed, z * 0.02)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def test_train_main_hubert_on_the_host(capsys):
    loss = train.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                       "cpu", "--steps", "6", "--global-batch", "2",
                       "--seq-len", "16", "--log-every", "1",
                       "--attn-impl", "kernel"])
    assert np.isfinite(loss)
    assert "hubert-xlarge-smoke" not in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["hubert-xlarge", VISION])
def test_model_casts_embeddings_and_media_to_its_dtype(arch):
    """f32 frame embeddings and media from the pipeline, as ``to_device``
    leaves them, give a bf16 model the logits of inputs cast beforehand."""
    cfg = dataclasses.replace(configs.get(arch).reduced(), dtype="bfloat16")
    m = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = train.to_device(pipeline_for_arch(
        cfg, configs.ShapeSpec("t", 8, 2, "train")).batch_at(0), "cpu")
    kw = {k: b[k] for k in ("tokens", "embeds", "media") if k in b}
    assert all(v.dtype != torch.bfloat16 for v in kw.values())
    cast = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in kw.items()}
    with torch.no_grad():
        got, _ = model.forward(m, cfg, **kw)
        want, _ = model.forward(m, cfg, **cast)
    assert torch.equal(got, want)


def test_serve_main_vision_on_the_host(capsys):
    gen = serve.main(["--arch", VISION, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert gen.shape == (2, 4)
    assert f"[serve] {VISION}-smoke" in capsys.readouterr().out
    m = serve.make_media(configs.get(VISION), 2, 0)
    assert m.shape == (2, 1024, 8192) and m.dtype == torch.bfloat16
    assert serve.make_media(configs.get("command-r-35b"), 2, 0) is None


def test_serve_main_encoder_exits():
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu"])
