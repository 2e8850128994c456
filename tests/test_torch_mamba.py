"""Port parity: reduced mamba2 (2 layers, d 64, 8 SSM heads of 16, state
16, chunk 16, float32) through ``from_jax`` against the JAX model on the
same weights and tokens, on the CPU, on both ``ssm_impl`` routes: the
Mamba layer in training, prefill and decode; the model's loss, every
gradient and a 10-step trajectory; the parameter count; the weight
conversion of a bf16 model. The JAX kernel route runs the Pallas SSD scan
in interpret mode."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.data import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402

ARCH = "mamba2-1.3b"
IMPLS = ["ref", "kernel"]
TOL = dict(rtol=3e-3, atol=3e-3)          # tests/test_models.py
F32_LEAVES = ("A_log", "dt_bias", "D_skip")


def _cfgs(impl="ref", dtype="float32"):
    kw = dict(ssm_impl=impl, dtype=dtype)
    return (dataclasses.replace(jconfigs.get(ARCH).reduced(), **kw),
            dataclasses.replace(configs.get(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs()
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    jp_np = jax.tree.map(np.asarray, jp)
    return jp, jp_np, convert.from_jax(jp_np, tc, "cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (B, S)).astype(
        np.int32)


def _layer0(jp, tp):
    return jax.tree.map(lambda a: a[0], jp["blocks"][0]["mix"]), \
        tp.blocks[0].mix


def _x(B, S, D, seed):
    return (np.random.default_rng(seed).standard_normal((B, S, D))
            ).astype(np.float32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("S", [32, 24])
def test_mamba_layer_train_mode_matches_jax(weights, impl, S):
    jp, _, tp = weights
    jc, tc = _cfgs(impl)
    jmix, tmix = _layer0(jp, tp)
    x = _x(2, S, tc.d_model, 1)
    jy, jcache = jlayers.mamba(jnp.asarray(x), jmix, jc)
    with torch.no_grad():
        ty, tcache = tmix(torch.from_numpy(x), tc)
    assert jcache is None and tcache is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_mamba_layer_prefill_and_decode_match_jax(weights):
    jp, _, tp = weights
    jc, tc = _cfgs()
    jmix, tmix = _layer0(jp, tp)
    B, S = 2, 32
    x = _x(B, S + 1, tc.d_model, 2)
    jcache = jlayers.mamba_cache_init(jc, B, jnp.float32)
    tcache = layers.mamba_cache_init(tc, B, torch.float32, "cpu")
    with torch.no_grad():
        for sl in (slice(0, S), slice(S, S + 1)):       # prefill, decode
            jy, jcache = jlayers.mamba(jnp.asarray(x[:, sl]), jmix, jc,
                                       cache=jcache)
            ty, tcache = tmix(torch.from_numpy(x[:, sl]), tc, cache=tcache)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
            for key in ("conv", "ssm"):
                np.testing.assert_allclose(tcache[key].numpy(),
                                           np.asarray(jcache[key]), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_prefill_decode_match_jax(weights, impl):
    jp, _, tp = weights
    jc, tc = _cfgs(impl)
    toks = _tokens(2, 17, seed=3)
    S = 16
    jl, _ = jmodel.forward(jp, jc, tokens=jnp.asarray(toks))
    jlast, jcache = jmodel.prefill(jp, jc, tokens=jnp.asarray(toks[:, :S]),
                                   max_len=S + 4)
    jd, jcache = jmodel.decode_step(jp, jc, jcache,
                                    jnp.asarray(toks[:, S:S + 1]))
    with torch.no_grad():
        tl, _ = model.forward(tp, tc, torch.from_numpy(toks))
        tlast, tcache = model.prefill(tp, tc, torch.from_numpy(toks[:, :S]),
                                      max_len=S + 4)
        td, tcache = model.decode_step(tp, tc, tcache,
                                       torch.from_numpy(toks[:, S:S + 1]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert tcache["length"] == int(jcache["length"]) == S + 1


def test_prefill_decode_consistency(weights):
    """Mirror of test_models.py:62-86: the last prefill logits and one
    decode step equal a full-sequence forward."""
    _, _, tp = weights
    _, tc = _cfgs("kernel")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(B, S + 1, seed=4))
    with torch.no_grad():
        full, _ = model.forward(tp, tc, toks)
        last, caches = model.prefill(tp, tc, toks[:, :S], max_len=S + 4)
        np.testing.assert_allclose(last[:, 0].numpy(),
                                   full[:, S - 1].numpy(), **TOL)
        dl, caches = model.decode_step(tp, tc, caches, toks[:, S:S + 1])
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, S].numpy(), **TOL)
    assert caches["length"] == S + 1


def _batch(B=2, S=32, seed=0):
    pipe = JTokenPipeline(JPipelineConfig(vocab_size=256, seq_len=S,
                                          global_batch=B, seed=seed))
    b = pipe.batch_at(0)
    b["labels"][0, :3] = -100
    return b


@pytest.mark.parametrize("impl", IMPLS)
def test_train_loss_and_grads_match_jax(weights, impl):
    jp, jp_np, _ = weights
    jc, tc = _cfgs(impl)
    b = _batch()
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jc, {k: jnp.asarray(v) for k, v in
                                            b.items()}), has_aux=True)(jp)
    tp = convert.from_jax(jp_np, tc, "cpu")
    tl, _ = model.train_loss(tp, tc, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(tl, [p for _, p in tp.named_parameters()])
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    got = convert.to_jax(dict(zip(names, grads)), tc)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jg))[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w = flat_want[path]
        scale = max(float(np.abs(w).max()), 1e-6)
        # f32 on both sides, sums in another order: relative to the leaf's
        # largest gradient, as tests/test_torch_train.py
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_ten_step_loss_trajectory_matches_jax_train_step(weights):
    jp, jp_np, _ = weights
    jc, tc = _cfgs("kernel")
    kw = dict(lr_peak=2e-3, warmup_steps=2, total_steps=10)
    jopt, topt = joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    pkw = dict(vocab_size=256, seq_len=32, global_batch=4, seed=5)
    jpipe, tpipe = JTokenPipeline(JPipelineConfig(**pkw)), \
        TokenPipeline(PipelineConfig(**pkw))
    jstep = jax.jit(jtrain.build_train_step(jc, jopt, 1, None))
    jparams, jstate = jp, joptim.adamw_init(jp, jopt)
    tstep = train.build_train_step(tc, topt, 1, None)
    tparams = convert.from_jax(jp_np, tc, "cpu")
    tstate = optim.adamw_init(dict(tparams.named_parameters()), topt,
                              period=len(tc.pattern))
    jl, tl = [], []
    for s in range(10):
        jparams, jstate, _, loss, _ = jstep(jparams, jstate, None,
                                            jpipe.batch_at(s))
        jl.append(float(loss))
        tparams, tstate, _, loss, _ = tstep(
            tparams, tstate, None,
            {k: torch.from_numpy(v) for k, v in tpipe.batch_at(s).items()})
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("reduced", [True, False])
def test_param_count_matches_jax(reduced):
    jc, tc = jconfigs.get(ARCH), configs.get(ARCH)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert model.param_count(tc) == jmodel.param_count(jc)


def test_bf16_model_round_trip_keeps_f32_leaves():
    """to_jax then from_jax of a bf16 model: bit for bit, with A_log,
    dt_bias and D_skip float32 on both sides, as JAX creates them."""
    _, tc = _cfgs(dtype="bfloat16")
    jc, _ = _cfgs(dtype="bfloat16")
    tp = model.init_params(tc, torch.Generator().manual_seed(3), "cpu")
    for name, p in tp.named_parameters():
        want = torch.float32 if name.endswith(F32_LEAVES) else torch.bfloat16
        assert p.dtype == want, name
    tree = jax.tree.map(lambda a: a.view(jnp.bfloat16)
                        if a.dtype == np.uint16 else a, convert.to_jax(tp, tc))
    ref = dict(jax.tree_util.tree_flatten_with_path(
        jmodel.abstract_params(jc))[0])
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert {p for p, _ in got} == set(ref)
    for path, leaf in got:
        assert leaf.shape == ref[path].shape
        assert leaf.dtype == ref[path].dtype, jax.tree_util.keystr(path)
    back = convert.from_jax(tree, tc, "cpu")
    for (n, a), (_, b) in zip(tp.named_parameters(),
                              back.named_parameters()):
        assert a.dtype == b.dtype, n
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), n


def test_from_jax_refuses_a_leaf_of_another_dtype(weights):
    _, jp_np, _ = weights
    _, tc = _cfgs()
    bad = jax.tree.map(lambda a: a, jp_np)
    bad["blocks"][0]["mix"]["A_log"] = \
        bad["blocks"][0]["mix"]["A_log"].astype(np.float16)
    with pytest.raises(ValueError, match="A_log"):
        convert.from_jax(bad, tc, "cpu")


def test_train_main_mamba_on_the_host_learns(capsys):
    loss = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "30", "--global-batch", "4",
                       "--seq-len", "32", "--lr", "2e-3", "--warmup", "5",
                       "--log-every", "15", "--ssm-impl", "kernel"])
    assert np.isfinite(loss) and loss < 5.55
    assert "[train] done: final loss" in capsys.readouterr().out


def test_serve_main_mamba_on_the_host(capsys):
    gen = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    assert tuple(gen.shape) == (2, 4)
    assert "[serve] mamba2-1.3b-smoke" in capsys.readouterr().out
