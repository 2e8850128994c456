"""Port parity of the training slice: the optimizer, the token pipeline,
the steal table, ``train_loss`` and its gradients on reduced granite-moe
(every route combination), a 10-step trajectory against the JAX train
step, and the training launcher. Same numpy inputs or ``from_jax`` weights
on both sides, on the CPU; the JAX kernel routes run the Pallas kernels
in interpret mode."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data import PipelineConfig as JPipelineConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.core import routing, topology  # noqa: E402
from repro_torch.data import PipelineConfig, Prefetcher, TokenPipeline  # noqa: E402,E501
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model  # noqa: E402

ARCH = "granite-moe-1b-a400m"


# ----------------------------------------------------------------------
# data pipeline
# ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_batch_at_bit_equal_to_jax(seed):
    kw = dict(vocab_size=1000, seq_len=48, global_batch=4, seed=seed)
    jp, tp = JTokenPipeline(JPipelineConfig(**kw)), \
        TokenPipeline(PipelineConfig(**kw))
    for step in (0, 3, 117):
        want, got = jp.batch_at(step), tp.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tp.host_batch_at(5, 1, 2)["tokens"],
                                  jp.host_batch_at(5, 1, 2)["tokens"])


def test_prefetcher_yields_batches_in_order():
    tp = TokenPipeline(PipelineConfig(vocab_size=100, seq_len=8,
                                      global_batch=2, seed=3))
    it = Prefetcher(tp.iter_from(4))
    try:
        for step in (4, 5, 6):
            np.testing.assert_array_equal(next(it)["tokens"],
                                          tp.batch_at(step)["tokens"])
    finally:
        it.close()


# ----------------------------------------------------------------------
# steal table
# ----------------------------------------------------------------------


def test_steal_table_for_cpu_counts_one_device(monkeypatch):
    """Under ``cpu`` the launcher counts one device, as the JAX launcher's
    ``len(jax.devices())`` does on a CPU, however many cards the host has
    (64 here: more than granite's 32 experts)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 64)
    cfg = configs.get("granite-moe-1b-a400m")
    assert cfg.moe_num_experts < 64
    n_dev = max(1, cfg.moe_num_experts)          # len(jax.devices()) == 1
    topo = jtopo.tpu_pod_2d(1, n_dev) if n_dev > 1 \
        else jtopo.uma(cfg.moe_num_experts)
    owners = np.arange(cfg.moe_num_experts) % topo.num_cores
    want = jrouting.expert_steal_table(topo, owners, cfg.moe_steal_policy)
    got = train.steal_table_for(cfg, "cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)

@pytest.mark.parametrize("topo", ["pod1x32", "pod2x4", "uma8"])
@pytest.mark.parametrize("policy", ["dfwspt", "dfwsrpt"])
def test_expert_steal_table_equals_jax(topo, policy):
    make = {"pod1x32": lambda m: m.tpu_pod_2d(1, 32),
            "pod2x4": lambda m: m.tpu_pod_2d(2, 4),
            "uma8": lambda m: m.uma(8)}[topo]
    jt, tt = make(jtopo), make(topology)
    np.testing.assert_array_equal(tt.core_distance_matrix(),
                                  jt.core_distance_matrix())
    owners = np.arange(tt.num_cores) % tt.num_cores
    want = jrouting.expert_steal_table(jt, owners, policy, seed=5)
    got = routing.expert_steal_table(tt, owners, policy, seed=5)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------

def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (16, 8), "b": (8,), "e": (3, 4, 5)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_update_matches_jax(factored):
    cfg_kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=10,
                  factored=factored,
                  m_dtype="bfloat16" if factored else "float32")
    jcfg, tcfg = joptim.AdamWConfig(**cfg_kw), optim.AdamWConfig(**cfg_kw)
    p0 = _tree(0, SHAPES)
    jp, tp = _j(p0), _t(p0)
    js, ts = joptim.adamw_init(jp, jcfg), optim.adamw_init(tp, tcfg)
    for step in range(4):
        g = _tree(10 + step, SHAPES)
        jp, js, jm = joptim.adamw_update(_j(g), js, jp, jcfg)
        tp, ts, tm = optim.adamw_update(_t(g), ts, tp, tcfg)
        assert ts["count"] == int(js["count"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ts["m"][k].float().numpy(),
                                   np.asarray(js["m"][k], np.float32),
                                   rtol=1e-5, atol=1e-7)
        jv, tv = js["v"][k], ts["v"][k]
        if isinstance(jv, dict):
            for part in ("vr", "vc"):
                np.testing.assert_allclose(tv[part].numpy(),
                                           np.asarray(jv[part]), rtol=1e-5)
        else:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)


def test_cosine_schedule_matches_jax():
    kw = dict(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    jc, tc = joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    for s in (0, 1, 5, 10, 37, 50, 99, 100, 150):
        assert optim.cosine_schedule(tc, s) == float(
            joptim.cosine_schedule(jc, s))


def test_clip_by_global_norm_matches_jax():
    g = {k: v * 10 for k, v in _tree(3, SHAPES).items()}
    jg, jn = joptim.clip_by_global_norm(_j(g), 1.0)
    tg, tn = optim.clip_by_global_norm(_t(g), 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert float(optim.global_norm(tg)) == pytest.approx(1.0, rel=1e-5)
    for k in SHAPES:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=1e-7)


def test_accumulate_gradients_two_microbatches_match_jax_and_full_batch():
    rng = np.random.default_rng(4)
    w0 = {"w": rng.standard_normal((16, 16)).astype(np.float32),
          "b": np.zeros(16, np.float32)}
    X = rng.standard_normal((64, 16)).astype(np.float32)
    Y = X * 0.5 + 1.0

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2), {}

    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in w0.items()}

    def tloss(b):
        return torch.mean((b["x"] @ tp["w"] + tp["b"] - b["y"]) ** 2), {}

    jb = {"x": jnp.asarray(X), "y": jnp.asarray(Y)}
    tb = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}
    jl, jg, _ = joptim.accumulate_gradients(jloss, _j(w0), jb, 2)
    tl, tg, _ = optim.accumulate_gradients(tloss, tp, tb, 2)
    _, tg1, _ = optim.accumulate_gradients(tloss, tp, tb, 1)
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    for k in w0:
        assert tg[k].dtype == torch.float32
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tg[k].numpy(), tg1[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_compressed_gradients_match_jax():
    jc = tc = None
    for i in range(5):
        g = {k: v * 1e-3 * (1 + 0.1 * i) for k, v in _tree(20 + i,
                                                             SHAPES).items()}
        jd, jc = joptim.compressed_gradients(_j(g), jc)
        td, tc = optim.compressed_gradients(_t(g), tc)
        for k in SHAPES:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(tc.residual[k].numpy(),
                                       np.asarray(jc.residual[k]),
                                       rtol=1e-5, atol=1e-9)
    q, s = optim.compress_int8(torch.tensor([-3.0, 0.5, 2.0]))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    np.testing.assert_allclose(optim.decompress_int8(q, s).numpy(),
                               [-3.0, 0.5, 2.0], atol=float(s))


# ----------------------------------------------------------------------
# the model's training loss and gradients
# ----------------------------------------------------------------------

def _cfgs(attn="ref", moe="einsum", remat="none", dtype="float32"):
    kw = dict(attn_impl=attn, moe_impl=moe, remat=remat, dtype=dtype)
    return (dataclasses.replace(jconfigs.get(ARCH).reduced(), **kw),
            dataclasses.replace(configs.get(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs()
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _steal(E):
    topo = jtopo.tpu_pod_2d(1, E)
    return jrouting.expert_steal_table(topo, np.arange(E), "dfwspt")


def _batch(B=2, S=16, seed=0):
    pipe = JTokenPipeline(JPipelineConfig(vocab_size=256, seq_len=S,
                                          global_batch=B, seed=seed))
    b = pipe.batch_at(0)
    b["labels"][0, :3] = -100                  # masked labels in every run
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("attn", ["ref", "kernel"])
@pytest.mark.parametrize("moe", ["einsum", "kernel"])
def test_train_loss_and_grads_match_jax(weights, attn, moe):
    jp, jp_np = weights
    jc, tc = _cfgs(attn, moe)
    steal = _steal(jc.moe_num_experts)
    b = _batch()
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jc, {k: jnp.asarray(v) for k, v in
                                            b.items()}, steal_table=steal),
        has_aux=True)(jp)
    tp = convert.from_jax(jp_np, tc, "cpu")
    tl, tm = model.train_loss(tp, tc, _torch_batch(b),
                              steal_table=torch.as_tensor(steal))
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(tl, [p for _, p in tp.named_parameters()])
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for key in ("ce", "aux", "z_loss"):
        assert float(tm[key].detach()) == pytest.approx(float(jm[key]),
                                                        rel=1e-5)
    got = convert.to_jax(dict(zip(names, grads)), tc)
    want = jax.tree.map(np.asarray, jg)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        w = flat_want[path]
        scale = max(float(np.abs(w).max()), 1e-6)
        # f32 on both sides; sums taken in another order (tol relative to
        # the leaf's largest gradient)
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_on_and_off_give_equal_grads(weights):
    _, jp_np = weights
    steal = torch.as_tensor(_steal(4))
    b = _torch_batch(_batch())
    out = []
    for remat in ("none", "full"):
        _, tc = _cfgs("kernel", "kernel", remat)
        tp = convert.from_jax(jp_np, tc, "cpu")
        loss, _ = model.train_loss(tp, tc, b, steal_table=steal)
        out.append((loss, torch.autograd.grad(loss, list(tp.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_remat_dots_is_not_ported_and_raises(weights):
    """remat="dots" on the kernel routes gives remat="none"'s loss and
    gradients. (The name dates from when "dots" raised; it is kept so the
    test's history reads on. "dots" is now a selective checkpoint that
    keeps the mm outputs.)"""
    _, jp_np = weights
    steal = torch.as_tensor(_steal(4))
    b = _torch_batch(_batch())
    out = []
    for remat in ("none", "dots"):
        _, tc = _cfgs("kernel", "kernel", remat)
        tp = convert.from_jax(jp_np, tc, "cpu")
        loss, _ = model.train_loss(tp, tc, b, steal_table=steal)
        out.append((loss, torch.autograd.grad(loss, list(tp.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


def test_ten_step_loss_trajectory_matches_jax_train_step(weights):
    """test_system.py:35-72 pattern: the same weights and batches through
    JAX's build_train_step and the port's, loss by loss."""
    jp, jp_np = weights
    jc, tc = _cfgs("kernel", "kernel")
    steal = _steal(jc.moe_num_experts)
    kw = dict(lr_peak=2e-3, warmup_steps=2, total_steps=10)
    jopt, topt = joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    pkw = dict(vocab_size=256, seq_len=16, global_batch=4, seed=5)
    jpipe, tpipe = JTokenPipeline(JPipelineConfig(**pkw)), \
        TokenPipeline(PipelineConfig(**pkw))

    jstep = jax.jit(jtrain.build_train_step(jc, jopt, 1, steal))
    jparams, jstate = jp, joptim.adamw_init(jp, jopt)
    tstep = train.build_train_step(tc, topt, 1, torch.as_tensor(steal))
    tparams = convert.from_jax(jp_np, tc, "cpu")
    tstate = optim.adamw_init(dict(tparams.named_parameters()), topt,
                              period=len(tc.pattern))
    jl, tl = [], []
    for s in range(10):
        jparams, jstate, _, loss, _ = jstep(jparams, jstate, None,
                                            jpipe.batch_at(s))
        jl.append(float(loss))
        tparams, tstate, _, loss, _ = tstep(
            tparams, tstate, None, _torch_batch(tpipe.batch_at(s)))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


# ----------------------------------------------------------------------
# to_jax
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_jax_round_trip_bit_for_bit(dtype):
    _, tc = _cfgs(dtype=dtype)
    tp = model.init_params(tc, torch.Generator().manual_seed(3), "cpu")
    # bf16 leaves come back as their uint16 bits: view them as bf16
    tree = jax.tree.map(lambda a: a.view(jnp.bfloat16)
                        if a.dtype == np.uint16 else a, convert.to_jax(tp, tc))
    back = convert.from_jax(tree, tc, "cpu")
    for (n, a), (_, b) in zip(tp.named_parameters(),
                              back.named_parameters()):
        assert a.dtype == b.dtype == tc.param_dtype or n.endswith("router")
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b), n
    # the tree has the JAX layout: same paths, shapes and dtypes
    jc, _ = _cfgs(dtype=dtype)
    want = jmodel.abstract_params(jc)
    got = jax.tree_util.tree_flatten_with_path(tree)[0]
    ref = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert {p for p, _ in got} == set(ref)
    for path, leaf in got:
        assert leaf.shape == ref[path].shape
        assert leaf.dtype == ref[path].dtype, jax.tree_util.keystr(path)


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------

def test_train_main_on_the_host_learns(capsys):
    """Mirror of test_system.py:83-89 on the host."""
    loss = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "30", "--global-batch", "4",
                       "--seq-len", "32", "--lr", "2e-3", "--warmup", "5",
                       "--log-every", "15", "--attn-impl", "kernel",
                       "--moe-impl", "kernel"])
    assert np.isfinite(loss) and loss < 5.55
    assert "[train] done: final loss" in capsys.readouterr().out


def test_training_reduces_loss_end_to_end_dense():
    """Mirror of test_system.py:24 on reduced stablelm-1.6b (an "mlp"
    FFN slot, MHA, untied head): a tiny LM overfits the deterministic
    synthetic stream."""
    loss = train.main([
        "--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
        "--steps", "60", "--global-batch", "8", "--seq-len", "32", "--lr",
        "3e-3", "--warmup", "10", "--log-every", "30"])
    # well below ln(V) = ln(256) ~ 5.55 after 60 steps
    assert loss < 5.0


def test_train_main_with_microbatches_and_compression():
    loss = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "3", "--global-batch", "4", "--seq-len",
                       "16", "--microbatches", "2", "--compress-grads"])
    assert np.isfinite(loss)


def test_steal_table_for_matches_jax_launcher_on_the_host():
    _, tc = _cfgs()
    if torch.cuda.is_available():
        pytest.skip("the table depends on the device count")
    E = tc.moe_num_experts
    want = jrouting.expert_steal_table(jtopo.tpu_pod_2d(1, max(1, E)),
                                       np.arange(E) % E, tc.moe_steal_policy)
    np.testing.assert_array_equal(train.steal_table_for(tc, "cpu").numpy(),
                                  want)


def test_train_main_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])
