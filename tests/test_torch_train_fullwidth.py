"""The port's training step against JAX's ``build_train_step`` at full
width with the depth cut to one layer, so that both packages' weights and
Adam state fit the host at float32: granite-moe-1b-a400m (d 1024, 16
heads / 8 KV, 32 experts top-8, vocab 49155), qwen2.5-3b (d 2048, 16
heads / 2 KV of 128, qkv bias, FF 11008, tied vocab 151936) and the
encoder hubert-xlarge (frame embeddings of width 1280, bidirectional MHA
16/16 at head dim 80, FF 5120, 504 targets), remat full.
Same weights (``from_jax``), same batches, the schedule of the on-card
train phase (lr 3e-4, warm-up 2, 10 total). The reduced-size tests cannot
see a fault that only shows at this width: the 32-expert router and its
gradients, the 49155- and 151936-row tied heads, GQA 8:1 at head dim
128, the optimizer over 100 M or 400 M parameters. After the steps the
norm weights (and qkv biases) are compared leaf by leaf: their updates
are where the two packages' weight decay would part.

The JAX side runs its plain routes (its Pallas kernels in interpret mode
take most of a minute a step at this width); the port runs the kernel
routes, which take the plain versions for host tensors."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.configs import ShapeSpec  # noqa: E402
from repro.data.pipeline import pipeline_for_arch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ARCH = "granite-moe-1b-a400m"
STEPS = 4
# float32 on both sides; the two packages sum in other orders, and Adam's
# first updates (about lr times the gradient's sign) carry those last-bit
# differences into the next step's loss
RTOL = 1e-3


# the norm weights and biases after the steps: each element moves by
# about lr (3e-4) a step; the decay alone moves a norm weight by about
# 1e-4 over the four steps
VEC_ATOL = 1e-5
VECTORS = ("ln1", "ln2", "bq", "bk", "bv", "final_norm")


def _run(arch, impls, seq):
    kw = dict(num_layers=1, dtype="float32", remat="full")
    jc = dataclasses.replace(jconfigs.get(arch), attn_impl="ref",
                             moe_impl="einsum", **kw)
    tc = dataclasses.replace(configs.get(arch), **impls, **kw)
    steal = None
    if jc.moe_num_experts:
        E = jc.moe_num_experts
        steal = jrouting.expert_steal_table(jtopo.tpu_pod_2d(1, E),
                                            np.arange(E), jc.moe_steal_policy)
    okw = dict(lr_peak=3e-4, warmup_steps=2, total_steps=10)
    pipe = pipeline_for_arch(jc, ShapeSpec("t", seq, 2, "train"), seed=0)
    batches = [pipe.batch_at(s) for s in range(STEPS)]

    # JAX first, then the port, so that one package's state is alive at a
    # time
    params = jmodel.init_params(jc, jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    jopt = joptim.AdamWConfig(**okw)
    state = joptim.adamw_init(params, jopt)
    jstep = jax.jit(jtrain.build_train_step(jc, jopt, 1, steal))
    want = []
    for b in batches:
        params, state, _, loss, gnorm = jstep(params, state, None, b)
        want.append((float(loss), float(gnorm)))
    want_vec = _vectors(jax.tree.map(np.asarray, params))
    del params, state, jstep

    tparams = convert.from_jax(params_np, tc, "cpu")
    del params_np
    topt = optim.AdamWConfig(**okw)
    tstate = optim.adamw_init(dict(tparams.named_parameters()), topt,
                              period=len(tc.pattern))
    tstep = train.build_train_step(
        tc, topt, 1, None if steal is None else torch.as_tensor(steal))
    got = []
    for b in batches:
        tparams, tstate, _, loss, gnorm = tstep(
            tparams, tstate, None, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        got.append((float(loss), float(gnorm)))
    # loss and global gradient norm, step by step
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL)
    got_vec = _vectors(convert.to_jax(tparams, tc))
    assert sorted(got_vec) == sorted(want_vec) and len(want_vec) >= 3
    for key, w in want_vec.items():
        np.testing.assert_allclose(got_vec[key], w, rtol=0, atol=VEC_ATOL,
                                   err_msg=key)
    return tc


def _vectors(tree):
    """The norm weights and biases of a JAX-layout tree, by path."""
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]
            if getattr(p[-1], "key", None) in VECTORS}


def test_full_width_train_steps_match_jax():
    tc = _run(ARCH, dict(attn_impl="kernel", moe_impl="kernel"), seq=32)
    assert (tc.d_model, tc.moe_num_experts, tc.moe_top_k, tc.vocab_size) \
        == (1024, 32, 8, 49155)


@pytest.mark.parametrize("arch", ["qwen2.5-3b"])
def test_full_width_dense_train_steps_match_jax(arch):
    tc = _run(arch, dict(attn_impl="kernel"), seq=32)
    assert (tc.d_model, tc.num_heads, tc.num_kv_heads, tc.head_dim,
            tc.d_ff, tc.vocab_size, tc.qkv_bias, tc.tie_embeddings) == \
        (2048, 16, 2, 128, 11008, 151936, True, True)


def test_full_width_encoder_train_steps_match_jax():
    tc = _run("hubert-xlarge", dict(attn_impl="kernel"), seq=32)
    assert (tc.d_model, tc.num_heads, tc.num_kv_heads, tc.head_dim,
            tc.d_ff, tc.vocab_size, tc.is_encoder, tc.embeds_input) == \
        (1280, 16, 16, 80, 5120, 504, True, True)
