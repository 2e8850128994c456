"""The port's examples (``repro_torch.examples``) on the host
(``--device cpu``): ``elastic_failover``'s events equal the JAX package's
``Supervisor`` with stub callbacks on the example's schedule, and its
loss falls; ``train_lm`` at 4 steps resumes phase 2 from phase 1's
checkpoint (in ``tmp_path``); ``serve_batch`` serves its three
architectures; the quickstart's drop fractions equal the JAX package's
``route`` on the same numpy logits, and stealing lowers them, and its
simulator steps 1-4 print what ``examples/quickstart.py --sim-only``
prints, line for line. About 30 s in one process, ~2 GB at most
(``train_lm``'s 135M-parameter model)."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import topology as jtopology
from repro.core.routing import RoutingConfig as JRoutingConfig
from repro.core.routing import expert_steal_table as jsteal_table
from repro.core.routing import route as jroute
from repro.runtime import Supervisor as JSupervisor

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.examples import (elastic_failover, quickstart,  # noqa: E402
                                  serve_batch, train_lm)
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401


def _jax_stub_events() -> tuple[list, list]:
    """JAX's Supervisor on the example's schedule with stub callbacks:
    (events, executed steps)."""
    ef, saved, executed = elastic_failover, [], []

    def run_step(s):
        executed.append(s)
        return ef.host_times(s)
    sup = JSupervisor(num_hosts=ef.NUM_HOSTS,
                      checkpoint_every=ef.CHECKPOINT_EVERY,
                      run_step=run_step, save=saved.append,
                      restore=lambda: saved[-1] if saved else 0,
                      remesh=lambda plan: None,
                      topo=jtopology.multi_pod(*ef.TOPOLOGY),
                      mesh_shape=ef.MESH_SHAPE,
                      model_axis_size=ef.MODEL_AXIS)
    sup.run(0, ef.STEPS, inject_failure=ef.FAILURE)
    return sup.events, executed


def test_elastic_failover_events_match_jax_and_loss_falls(capsys):
    events, losses = elastic_failover.main(["--device", "cpu"])
    want, executed = _jax_stub_events()
    assert events == want
    assert len(losses) == len(executed) == 47     # 40 steps + 7 replays
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "[elastic] new mesh (2, 8), 16 devices" in out
    assert "[elastic] finished at step 40" in out


def test_train_lm_resumes_from_its_own_checkpoint(tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(configs, "ARCHS", dict(configs.ARCHS))
    loss = train_lm.main(["--device", "cpu", "--steps", "4",
                          "--global-batch", "2", "--seq-len", "32",
                          "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[example] stablelm-100m: 135.3M params" in out
    assert "[train] resumed from step 2" in out
    assert latest_step(str(tmp_path)) == 4
    assert math.isfinite(loss)
    assert f"[example] final loss {loss:.4f}" in out


def test_serve_batch_serves_three_architectures(capsys):
    tokens = serve_batch.main(["--device", "cpu"])
    assert list(tokens) == list(serve_batch.ARCHS)
    for arch, t in tokens.items():
        assert tuple(t.shape) == (4, 16), arch
    out = capsys.readouterr().out
    for arch in serve_batch.ARCHS:
        assert f"=== {arch} (reduced config) ===" in out
    assert out.count("[serve] prefill") == out.count("[serve] decode") == 3


def test_quickstart_drop_fractions_match_jax(capsys):
    got = quickstart.main(["--device", "cpu"])
    assert got["sim"]["numa"] > got["sim"]["baseline"]
    logits = jnp.asarray(quickstart.moe_logits())
    E = quickstart.EXPERTS
    table = jsteal_table(jtopology.tpu_pod_2d(4, 4), np.arange(E), "dfwspt")
    vanilla = jroute(logits, JRoutingConfig(E, 1, E, steal_attempts=0))
    local = jroute(logits, JRoutingConfig(E, 1, E, steal_attempts=3), table)
    assert got["drop_vanilla"] == float(vanilla["drop_fraction"])
    assert got["drop_stealing"] == float(local["drop_fraction"])
    assert got["drop_stealing"] < got["drop_vanilla"]
    assert math.isfinite(got["loss"])
    assert "with nearest-first stealing" in capsys.readouterr().out


def test_quickstart_sim_steps_print_what_the_jax_quickstart_prints(capsys):
    got = quickstart.main(["--device", "cpu", "--sim-only"])
    ours = capsys.readouterr().out.splitlines()
    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart.py"
    spec = importlib.util.spec_from_file_location("jax_quickstart", path)
    jq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jq)
    jq.main(["--sim-only"])
    theirs = capsys.readouterr().out.splitlines()
    assert ours == theirs
    assert len(ours) == 6 and ours[3].startswith("FFT@16: baseline wf ")
    sim = got["sim"]
    assert f"{sim['baseline']:.2f}x" in ours[3]
    assert f"{sim['numa']:.2f}x" in ours[3]
    assert sim["numa"] > sim["baseline"]
    assert len(sim["grid"]) == 6
    assert all(f"{s}@{t}={v:.2f}x" in ours[4]
               for (s, t), v in sim["grid"].items())
