"""The port's checkpoints against the JAX package's: the on-disk layout
both ways (a JAX checkpoint restored by the port, a port checkpoint
restored by ``repro.checkpoint``, with identical logits and optimizer
state), dtypes bit for bit, a bitwise resume on the host, the manager's
garbage collection, the launcher's resume, and the heartbeat monitor."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import PipelineConfig, TokenPipeline  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.runtime import HeartbeatMonitor as JHeartbeatMonitor  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402,E501
                                    restore, save)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.runtime import HeartbeatMonitor  # noqa: E402

ARCH = "qwen2.5-3b"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _tokens(B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (B, S)).astype(
        np.int32)


def _cfgs(dtype):
    return (dataclasses.replace(jconfigs.get(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(configs.get(ARCH).reduced(), dtype=dtype))


def _opt_kw(factored):
    return dict(lr_peak=1e-2, warmup_steps=1, total_steps=10,
                factored=factored,
                m_dtype="bfloat16" if factored else "float32")


def _assert_state_equal(got, want):
    assert got["count"] == want["count"]
    assert got["stacked"] == want["stacked"]
    for part in ("m", "v"):
        assert got[part].keys() == want[part].keys()
        for k, w in want[part].items():
            g = got[part][k]
            pairs = [(g[p], w[p]) for p in w] if isinstance(w, dict) \
                else [(g, w)]
            for a, b in pairs:
                assert a.dtype == b.dtype and torch.equal(_bits(a),
                                                          _bits(b)), k


def test_checkpoint_roundtrip_dtypes(tmp_path):
    """Mirror of test_substrate.py:146: f32, bf16 and int32 bit for bit,
    the tree rebuilt from the keys alone."""
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.randn(5).to(torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)},
            "e": [torch.ones(2), torch.zeros(1, dtype=torch.int32)]}
    save(str(tmp_path), 3, tree)
    index = json.loads((tmp_path / "step_000000003" / "index.json")
                       .read_text())
    assert sorted(index["arrays"]) == ["a", "b/c", "b/d", "e/[0]", "e/[1]"]
    assert index["arrays"]["b/c"]["dtype"] == "bfloat16"
    got = restore(str(tmp_path), 3)
    assert isinstance(got["e"], list)
    for want, g in ((tree["a"], got["a"]), (tree["b"]["c"], got["b"]["c"]),
                    (tree["b"]["d"], got["b"]["d"]),
                    (tree["e"][0], got["e"][0]),
                    (tree["e"][1], got["e"][1])):
        assert g.dtype == want.dtype and g.shape == want.shape
        assert torch.equal(_bits(g), _bits(want))
    assert int(got["b"]["d"]) == 7


@pytest.mark.parametrize("factored", [False, True],
                         ids=["unfactored", "factored"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype, factored):
    jc, tc = _cfgs(dtype)
    jp = jmodel.init_params(jc, jax.random.PRNGKey(0))
    jopt = joptim.AdamWConfig(**_opt_kw(factored))
    js = joptim.adamw_init(jp, jopt)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    jp, js, _ = joptim.adamw_update(grads, js, jp, jopt)
    jckpt.save(str(tmp_path), 1, {"params": jp, "opt": js})

    step, tree = CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 1
    got = convert.from_jax(tree["params"], tc, "cpu")
    want = convert.from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    toks = torch.from_numpy(_tokens())
    with torch.no_grad():
        assert torch.equal(model.forward(got, tc, toks)[0],
                           model.forward(want, tc, toks)[0])
    _assert_state_equal(convert.opt_from_jax(tree["opt"], tc, "cpu"),
                        convert.opt_from_jax(jax.tree.map(np.asarray, js),
                                             tc, "cpu"))


@pytest.mark.parametrize("factored", [False, True],
                         ids=["unfactored", "factored"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype, factored):
    jc, tc = _cfgs(dtype)
    tp = model.init_params(tc, torch.Generator().manual_seed(2), "cpu")
    named = dict(tp.named_parameters())
    topt = optim.AdamWConfig(**_opt_kw(factored))
    ts = optim.adamw_init(named, topt, period=len(tc.pattern))
    _, ts, _ = optim.adamw_update({k: torch.full_like(p, 0.01)
                                   for k, p in named.items()}, ts, named,
                                  topt)
    CheckpointManager(str(tmp_path)).save_sync(
        1, {"params": convert.to_jax(tp, tc, numpy=False),
            "opt": convert.opt_to_jax(ts, tc, numpy=False)})

    like_p = jmodel.init_params(jc, jax.random.PRNGKey(0))
    like = {"params": like_p,
            "opt": joptim.adamw_init(like_p, joptim.AdamWConfig(
                **_opt_kw(factored)))}
    step, tree = jckpt.CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 1
    # every leaf is the port's, bit for bit, in the JAX tree's dtype
    want = {"params": convert.to_jax(tp, tc), "opt": convert.opt_to_jax(
        ts, tc)}
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        arr = np.asarray(leaf)
        if arr.dtype == jnp.bfloat16:
            arr = arr.view(np.uint16)
        np.testing.assert_array_equal(arr, flat_want[path],
                                      err_msg=jax.tree_util.keystr(path))
    # identical logits: the restored tree and the port's own through JAX
    toks = jnp.asarray(_tokens())
    direct = jax.tree.map(lambda a, ref: jnp.asarray(a).view(ref.dtype)
                          if a.dtype == np.uint16 else jnp.asarray(a),
                          want["params"], like_p)
    np.testing.assert_array_equal(
        np.asarray(jmodel.forward(tree["params"], jc, tokens=toks)[0]),
        np.asarray(jmodel.forward(direct, jc, tokens=toks)[0]))


def test_checkpoint_restart_bitwise_resume(tmp_path):
    """Mirror of test_system.py:35 on the port's host path: stop at step
    6, restore into a fresh model and state, and land on the same losses
    and weights bit for bit."""
    tc = configs.get(ARCH).reduced()
    pipe = TokenPipeline(PipelineConfig(vocab_size=tc.vocab_size, seq_len=16,
                                        global_batch=4, seed=5))
    opt_cfg = optim.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=30)
    step_fn = train.build_train_step(tc, opt_cfg, 1, None)

    def fresh():
        p = model.init_params(tc, torch.Generator().manual_seed(1), "cpu")
        return p, optim.adamw_init(dict(p.named_parameters()), opt_cfg,
                                   period=len(tc.pattern))

    def run(start, steps, params, opt):
        losses = []
        for s in range(start, start + steps):
            params, opt, _, loss, _ = step_fn(params, opt, None, {
                k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()})
            losses.append(float(loss))
        return params, opt, losses

    ref_params, _, ref_losses = run(0, 10, *fresh())
    mgr = CheckpointManager(str(tmp_path))
    p2, o2, l_a = run(0, 6, *fresh())
    mgr.save_async(6, {"params": convert.to_jax(p2, tc, numpy=False),
                       "opt": convert.opt_to_jax(o2, tc, numpy=False)})
    p2.embed.data.zero_()          # the snapshot is taken before this
    step, tree = mgr.restore_latest()
    assert step == 6
    p3 = convert.from_jax(tree["params"], tc, "cpu")
    o3 = convert.opt_from_jax(tree["opt"], tc, "cpu")
    p3, _, l_b = run(6, 4, p3, o3)
    assert l_a + l_b == ref_losses
    for (n, a), (_, b) in zip(p3.named_parameters(),
                              ref_params.named_parameters()):
        assert torch.equal(a, b), n


def test_manager_keep_last_and_tmp_dirs(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, keep_last=2)
    for s in (10, 20, 30):
        mgr.save_sync(s, {"x": torch.full((4,), float(s))})
    os.makedirs(os.path.join(d, ".tmp_step_000000040_0"))
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(d)
                   if p.startswith("step_"))
    assert steps == [20, 30] and latest_step(d) == 30
    step, got = mgr.restore_latest()
    assert step == 30 and float(got["x"][0]) == 30.0
    mgr.save_async(50, {"x": torch.ones(2)})
    mgr.wait()
    assert latest_step(d) == 50
    assert sorted(p for p in os.listdir(d) if p.startswith("step_")) == [
        "step_000000030", "step_000000050"]
    assert latest_step(os.path.join(d, "missing")) is None
    assert CheckpointManager(os.path.join(d, "empty")).restore_latest() \
        == (None, None)


def test_train_main_resumes_from_its_latest_step(tmp_path, capsys):
    """The launcher's resume: a run that saved at step 5 and 10 and lost
    step 10 resumes at 5 and ends on the uninterrupted run's loss, bit
    for bit."""
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "10",
            "--global-batch", "4", "--seq-len", "32", "--checkpoint-every",
            "5", "--checkpoint-dir", str(tmp_path)]
    full = train.main(args)
    assert latest_step(str(tmp_path)) == 10
    shutil.rmtree(tmp_path / "step_000000010")
    resumed = train.main(args)
    assert "[train] resumed from step 5" in capsys.readouterr().out
    assert resumed == full


def test_heartbeat_monitor_matches_jax():
    rng = np.random.default_rng(0)
    jm, tm = JHeartbeatMonitor(4), HeartbeatMonitor(4)
    for step in range(12):
        for host in range(4 if step < 9 else 3):   # host 3 stops at 9
            t = 1.0 + 0.05 * rng.standard_normal() + (1.5 if host == 2
                                                      and step > 3 else 0)
            jm.beat(host, t)
            tm.beat(host, t)
        assert tm.stragglers() == jm.stragglers()
        assert tm.missing() == jm.missing()
        np.testing.assert_array_equal(tm.ewma, jm.ewma)
    assert tm.stragglers() == [2] and tm.missing() == [3]
