"""Sharded steps on 4 real ranks against the same code on one process.

Four gloo processes on the CPU (``tests/_torch_dist_worker.py``) form
the (2, 2) ("data", "model") mesh of ``make_production_mesh`` and run the
dry run's step functions with every tensor placed by the role rules
(profile "2d"): 2 training steps (2 microbatches, f32 accumulation) of
reduced granite-moe-1b-a400m with the mesh's steal table, of reduced
qwen2.5-3b and of reduced mamba2-1.3b (its scan on local heads), and
prefill plus 3 greedy decode steps of reduced qwen3-14b
with its caches placed by the cache specs, then the training and serving
of reduced qwen3-14b with 3 q heads over 1 kv head (``worker.SPLIT``),
whose K/V and caches stay split along their sequence over the model
axis. This process runs the same functions on plain tensors.

On SPLIT each rank's attention FLOPs (``FlopCounterMode`` around each
plain attention call, on a batch of 1, which the data axis does not
split) are half the one-process count, and every attention call sees
half the keys, in training and in serving (prefill into a cache, then
a decode step): no K/V or cache position is gathered along the
sequence.

Tolerances (f32 throughout; the sharded run sums partial products and
gradients in another order): losses and gradient norms rtol 1e-5; the
first step's gradients and the logits rtol 1e-5 with an atol of 1e-5
times the leaf's largest element (elements near 0); greedy tokens
exact. Weights after the two AdamW steps: AdamW's normalised step
m/√v moves an element by about lr whatever its gradient's size, so an
element whose gradient is no larger than its rounding error moves either
way by up to lr a step as the rounding decides. Every element must lie
within that (rtol 1e-5, atol 2 × steps × lr), and each element whose
first-step gradient is at least a tenth of its leaf's largest (so held
to 1e-4 of itself above) within rtol 1e-5 and an atol of 1e-3 × lr.
Each worker has its own time limit; ~50 s, 4 processes of ~400 MB.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import _torch_dist_worker as worker  # noqa: E402

WORLD, TIMEOUT = 4, 300
LR = 1e-3                      # the worker's AdamW lr_peak


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's gathered results, the one-process reference); the
    reference runs here while the four ranks run."""
    out = tmp_path_factory.mktemp("dist") / "rank0.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist_worker.py"), str(rank),
         str(WORLD), str(port), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(WORLD)]
    logs = []
    try:
        reference = worker.scenarios(None)
        reference.update({f"{worker.SPLIT}/probe/{k}": np.array([v])
                          for k, v in worker.attention_probe(None).items()})
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode, log[-3000:]) for i, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return dict(np.load(out)), reference


@pytest.fixture(scope="module")
def sharded(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


def test_same_leaves(sharded, reference):
    assert sorted(sharded) == sorted(reference)


@pytest.mark.parametrize("arch", worker.TRAIN_ARCHS)
def test_train_steps_match_one_process(arch, sharded, reference):
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(sharded[f"{arch}/{key}"],
                                   reference[f"{arch}/{key}"], rtol=1e-5,
                                   atol=0, err_msg=key)
    grads = [k for k in reference if k.startswith(f"{arch}/grad/")]
    names = [k for k in reference if k.startswith(f"{arch}/param/")]
    assert grads and len(grads) == len(names)
    for k in grads:
        want = reference[k]
        np.testing.assert_allclose(
            sharded[k], want, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-12), err_msg=k)
    steps = worker.TRAIN["steps"]
    for k in names:
        got, want = sharded[k], reference[k]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=2 * steps * LR, err_msg=k)
        g = np.abs(reference[k.replace("/param/", "/grad/")])
        big = g >= 0.1 * g.max()
        assert big.any(), k
        np.testing.assert_allclose(got[big], want[big], rtol=1e-5,
                                   atol=1e-3 * LR, err_msg=k)


def test_serve_logits_and_tokens_match_one_process(sharded, reference):
    _same_serving("qwen3-14b", sharded, reference)


def test_kv_split_serve_matches_one_process(sharded, reference):
    _same_serving(worker.SPLIT, sharded, reference)


@pytest.mark.parametrize("kind", worker.PROBE_KINDS)
def test_kv_split_attends_over_half_the_keys_on_each_rank(kind, sharded,
                                                          reference):
    key = f"{worker.SPLIT}/probe/{kind}"
    whole = int(reference[f"{key}/flops"][0])
    assert whole > 0
    assert sharded[f"{key}/flops"].tolist() == [whole // 2] * WORLD
    assert whole % 2 == 0
    S = worker.PROBE["seq"]
    calls = 1 if kind == "train" else 2          # serve: prefill, decode
    assert reference[f"{key}/kv_len"].tolist() == [[S] * calls]
    lengths = sharded[f"{key}/kv_len"]
    assert lengths.shape == (WORLD, calls)
    assert lengths.size and (lengths == S // 2).all(), lengths


def _same_serving(arch, sharded, reference):
    np.testing.assert_array_equal(sharded[f"{arch}/tokens"],
                                  reference[f"{arch}/tokens"])
    for i in range(worker.SERVE["decode"] + 1):
        want = reference[f"{arch}/logits{i}"]
        np.testing.assert_allclose(
            sharded[f"{arch}/logits{i}"], want, rtol=1e-5,
            atol=1e-5 * float(np.abs(want).max()), err_msg=f"step {i}")
