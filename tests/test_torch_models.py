"""Port parity: reduced configs through ``from_jax`` against the JAX model
on the same weights and tokens (CPU, float32): granite-moe on both MoE
routes (the JAX kernel route runs the Pallas moe_gmm in interpret mode),
the dense qwen2.5-3b (qkv bias, tied), stablelm-1.6b (MHA, untied) and
qwen3-14b (qk-norm), and llama4-scout (top-1 with a shared expert); the
SwiGLU MLP and the shared-expert MoE block alone."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402

ARCH = "granite-moe-1b-a400m"
IMPLS = ["einsum", "kernel"]
# (arch, moe_impl): granite's cases keep the ids they had
CASES = [pytest.param(ARCH, impl, id=impl) for impl in IMPLS] + [
    pytest.param(a, "einsum", id=a) for a in
    ("qwen2.5-3b", "stablelm-1.6b", "qwen3-14b", "llama4-scout-17b-a16e")]
TOL = dict(rtol=3e-3, atol=3e-3)          # tests/test_models.py


def _cfgs(impl, dtype="float32", arch=ARCH):
    jc = dataclasses.replace(jconfigs.get(arch).reduced(), moe_impl=impl,
                             dtype=dtype)
    tc = dataclasses.replace(configs.get(arch).reduced(), moe_impl=impl,
                             dtype=dtype)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jc, tc = _cfgs("einsum", arch=arch)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(ARCH)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_copies_every_leaf_bit_for_bit(dtype):
    jc, tc = _cfgs("einsum", dtype)
    jp = jax.tree.map(np.asarray, jmodel.init_params(jc,
                                                     jax.random.PRNGKey(1)))
    tp = convert.from_jax(jp, tc, "cpu")
    P = len(tc.pattern)
    named = dict(tp.named_parameters())

    def bits(a):
        a = np.ascontiguousarray(a)
        return a.view(np.uint16) if a.dtype.itemsize == 2 else a

    def check(name, leaf):
        t = named.pop(name).detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        np.testing.assert_array_equal(t.numpy(), bits(leaf))

    check("embed", jp["embed"])
    check("final_norm", jp["final_norm"])
    for si, slot in enumerate(jp["blocks"]):
        for path, leaf in jax.tree_util.tree_flatten_with_path(slot)[0]:
            keys = ".".join(k.key for k in path)
            for r in range(tc.repeats):
                check(f"blocks.{r * P + si}.{keys}", leaf[r])
    assert not named, f"port parameters never compared: {sorted(named)}"
    assert tp.embed.dtype == tc.param_dtype


@pytest.mark.parametrize("arch,impl", CASES)
def test_forward_logits_match_jax(arch, impl):
    jp, tp = _weights(arch)
    jc, tc = _cfgs(impl, arch=arch)
    toks = _tokens(2, 12)
    jl, jaux = jmodel.forward(jp, jc, tokens=jnp.asarray(toks))
    with torch.no_grad():
        tl, taux = model.forward(tp, tc, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tl.shape == (2, 12, tc.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch,impl", CASES)
def test_prefill_and_decode_logits_match_jax(arch, impl):
    jp, tp = _weights(arch)
    jc, tc = _cfgs(impl, arch=arch)
    toks = _tokens(2, 13, seed=1)
    S = 12
    jl, jcache = jmodel.prefill(jp, jc, tokens=jnp.asarray(toks[:, :S]),
                                max_len=S + 4)
    tl, tcache = model.prefill(tp, tc, torch.from_numpy(toks[:, :S]),
                               max_len=S + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["length"] == S
    jd, jcache = jmodel.decode_step(jp, jc, jcache,
                                    jnp.asarray(toks[:, S:S + 1]))
    td, tcache = model.decode_step(tp, tc, tcache,
                                   torch.from_numpy(toks[:, S:S + 1]))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert tcache["length"] == int(jcache["length"]) == S + 1
    # the K/V written into the cache equal JAX's
    for i, layer_cache in enumerate(tcache["layers"]):
        np.testing.assert_allclose(layer_cache["k"].numpy(),
                                   np.asarray(jcache["slots"][0]["k"][i]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch,impl", CASES)
def test_generate_greedy_tokens_equal_jax_loop(arch, impl):
    jp, tp = _weights(arch)
    jc, tc = _cfgs(impl, arch=arch)
    B, P, gen = 2, 10, 8
    prompts = _tokens(B, P, seed=2)

    logits, caches = jax.jit(lambda p, t: jmodel.prefill(
        p, jc, tokens=t, max_len=P + gen))(jp, jnp.asarray(prompts))
    step = jax.jit(lambda p, c, t: jmodel.decode_step(p, jc, c, t))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want = [tok]
    for _ in range(gen - 1):
        logits, caches = step(jp, caches, tok)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        want.append(tok)
    want = np.concatenate([np.asarray(t) for t in want], axis=1)

    got, stats = serve.generate(tc, tp, torch.from_numpy(prompts), gen,
                                device="cpu")
    assert got.shape == (B, gen)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["length"] == int(caches["length"]) == P + gen - 1


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = (np.arange(5)[None, :] + np.array([[0], [7]])).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cache_write_past_the_end_raises(weights):
    _, tp = weights
    _, tc = _cfgs("einsum")
    _, caches = model.prefill(tp, tc, torch.from_numpy(_tokens(1, 4)),
                              max_len=4)
    with pytest.raises(ValueError):
        model.decode_step(tp, tc, caches, torch.ones(1, 1, dtype=torch.long))


def test_serve_main_on_the_host(capsys):
    gen = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4", "--moe-impl",
                      "kernel"])
    assert gen.shape == (2, 4)
    assert "[serve] granite-moe-1b-a400m-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("entry", ["default_device", "init_params",
                                   "from_jax", "generate", "serve_main"])
def test_entry_points_without_device_raise_on_a_host_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, tc = _cfgs("einsum")
    calls = {
        "default_device": lambda: repro_torch.default_device(),
        "init_params": lambda: model.init_params(tc),
        "from_jax": lambda: convert.from_jax({}, tc),
        "generate": lambda: serve.generate(tc, None, torch.ones(1, 2), 2),
        "serve_main": lambda: serve.main(["--reduced"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


# ----------------------------------------------------------------------
# the SwiGLU MLP, the shared expert, parameter counts
# ----------------------------------------------------------------------

def _load(module, tree):
    """Copy a JAX layer's parameter dict into a port module."""
    named = dict(module.named_parameters())
    flat = {".".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert sorted(flat) == sorted(named)
    with torch.no_grad():
        for k, leaf in flat.items():
            named[k].copy_(convert.to_tensor(np.asarray(leaf)))


def test_mlp_matches_jax():
    jc, tc = _cfgs("einsum", arch="qwen2.5-3b")
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), jc)
    mlp = layers.MLP(tc, device="cpu", dtype=torch.float32)
    _load(mlp, jp)
    assert mlp.wg.shape == (tc.d_model, tc.d_ff)
    x = np.random.default_rng(4).standard_normal((2, 7, tc.d_model)).astype(
        np.float32)
    want = jlayers.mlp(jnp.asarray(x), jp)
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
def test_shared_expert_moe_matches_jax(impl):
    """llama4-scout's block (reduced: 4 experts top-1, shared expert of
    width d_ff): routed output plus the shared MLP, and the aux loss."""
    jc, tc = _cfgs(impl, arch="llama4-scout-17b-a16e")
    assert tc.moe_shared_expert and tc.moe_top_k == 1
    jp = jlayers.init_moe(jax.random.PRNGKey(5), jc)
    moe = layers.MoE(tc, device="cpu", dtype=torch.float32)
    _load(moe, jp)
    assert moe.shared.wg.shape == (tc.d_model, tc.d_ff)
    x = np.random.default_rng(6).standard_normal((2, 16, tc.d_model)).astype(
        np.float32)
    want, jaux = jlayers.moe(jnp.asarray(x), jp, jc)
    with torch.no_grad():
        got, aux = moe(torch.from_numpy(x), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_counts_match_jax(arch, reduced):
    jc, tc = jconfigs.get(arch), configs.get(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert model.param_count(tc) == jmodel.param_count(jc)
    assert model.active_param_count(tc) == jmodel.active_param_count(jc)


def test_param_counts_match_published_sizes():
    """tests/test_models.py:110-134 for the registered architectures."""
    expected = {
        "qwen2.5-3b": (2.5e9, 3.6e9),
        "qwen3-14b": (13e9, 15.5e9),
        "mamba2-1.3b": (1.1e9, 1.5e9),
        "granite-moe-1b-a400m": (1.0e9, 1.6e9),
        "llama4-scout-17b-a16e": (95e9, 118e9),
        "stablelm-1.6b": (1.4e9, 1.9e9),
        "command-r-35b": (28e9, 38e9),
        "llama-3.2-vision-90b": (80e9, 95e9),
        "jamba-1.5-large-398b": (370e9, 420e9),
        "hubert-xlarge": (0.8e9, 1.3e9),
    }
    assert sorted(expected) == sorted(configs.ARCHS)
    for arch, (lo, hi) in expected.items():
        n = model.param_count(configs.get(arch))
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B"
    cfg = configs.get(ARCH)
    active = model.active_param_count(cfg)
    assert active < model.param_count(cfg) and 0.25e9 < active < 0.65e9
    dense = configs.get("qwen2.5-3b")
    assert model.active_param_count(dense) == model.param_count(dense)
