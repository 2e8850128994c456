"""The port's AdamW on a model's parameters against the JAX package's on
its stacked tree: reduced granite-moe, mamba2, qwen2.5-3b and hubert (two
layers), jamba (two periods of 8 slots) and llama-3.2-vision (two of 5,
a cross layer's (1,) gate among them), float32, factored and not,
three steps of the same gradients on both sides (through ``from_jax``),
every leaf of the parameters and of ``m`` and ``v`` compared in the JAX
layout (``to_jax``, ``opt_to_jax``).

JAX stacks a slot's per-layer weights on a leading ``repeats`` axis, so
its per-layer vectors (norm weights, qkv biases, Mamba2's ``A_log``,
``dt_bias``, ``D_skip`` and conv bias) have rank 2: decoupled weight
decay reaches them, and a factored second moment factors them across
the slot's layers. The decay and learning rate are large so that a leaf
left undecayed differs by far more than the tolerance."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.models import model  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "mamba2-1.3b", "qwen2.5-3b",
         "jamba-1.5-large-398b", "llama-3.2-vision-90b", "hubert-xlarge"]
STEPS = 3
# float32 on both sides, the same operations per element, which XLA may
# contract or reorder (the means of the factored statistics sum in another
# order): an element may land 1 ulp of the leaf's larger values apart, so
# the absolute part is RTOL of the leaf's largest magnitude
RTOL = 1e-6


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}{key}"
        atol = RTOL * float(np.abs(w).max(initial=0.0))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                   err_msg=f"{what}{key}")


@pytest.mark.parametrize("factored", [False, True],
                         ids=["unfactored", "factored"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_on_a_model_matches_jax_leaf_by_leaf(arch, factored):
    jc = jconfigs.get(arch).reduced()
    tc = configs.get(arch).reduced()
    assert tc.repeats >= 2 and tc.dtype == "float32"
    kw = dict(lr_peak=0.1, warmup_steps=1, total_steps=10, weight_decay=0.5,
              factored=factored)
    jcfg, tcfg = joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    jp_np = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape)
                          .astype(a.dtype), jp_np) for _ in range(STEPS)]

    js = joptim.adamw_init(jp, jcfg)
    for g in grads:
        jp, js, _ = joptim.adamw_update(g, js, jp, jcfg)

    tp = convert.from_jax(jp_np, tc, "cpu")
    named = dict(tp.named_parameters())
    ts = optim.adamw_init(named, tcfg, period=len(tc.pattern))
    for g in grads:
        gm = convert.from_jax(g, tc, "cpu")
        _, ts, _ = optim.adamw_update(
            {k: p.detach() for k, p in gm.named_parameters()}, ts, named,
            tcfg)

    _close(convert.to_jax(tp, tc), jax.tree.map(np.asarray, jp), "params")
    got = convert.opt_to_jax(ts, tc)
    assert int(got["count"]) == int(js["count"]) == STEPS
    _close(got["m"], jax.tree.map(np.asarray, js["m"]), "m")
    _close(got["v"], jax.tree.map(np.asarray, js["v"]), "v")


@pytest.mark.parametrize("factored", [False, True],
                         ids=["unfactored", "factored"])
def test_opt_state_round_trips_through_the_jax_layout(factored):
    """opt_from_jax(opt_to_jax(state)) is the same state, bit for bit
    (three layers of one slot; bf16 ``m`` in the factored case)."""
    tc = dataclasses.replace(configs.get("qwen2.5-3b").reduced(),
                             num_layers=3)
    cfg = optim.AdamWConfig(lr_peak=0.1, warmup_steps=1, factored=factored,
                            m_dtype="bfloat16" if factored else "float32")
    tp = model.init_params(tc, torch.Generator().manual_seed(1), "cpu")
    named = dict(tp.named_parameters())
    st = optim.adamw_init(named, cfg, period=1)
    g = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
         for i, (k, p) in enumerate(named.items())}
    _, st, _ = optim.adamw_update(g, st, named, cfg)
    tree = convert.opt_to_jax(st, tc, numpy=False)
    back = convert.opt_from_jax(tree, tc, "cpu")
    assert back["count"] == st["count"] == 1
    assert back["stacked"] == st["stacked"]
    assert back["m"].keys() == st["m"].keys()
    assert back["v"].keys() == st["v"].keys()
    for k, t in st["m"].items():
        assert back["m"][k].dtype == t.dtype and torch.equal(back["m"][k], t)
    for k, t in st["v"].items():
        if isinstance(t, dict):
            assert all(torch.equal(back["v"][k][p], t[p]) for p in t), k
        else:
            assert torch.equal(back["v"][k], t), k
