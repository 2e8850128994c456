"""Per-rank checkpoint shards and cross-mesh restore, on gloo ranks.

``tests/_torch_checkpoint_worker.py`` runs each world. A JAX process on 4
host devices first saves reduced qwen2.5-3b (bf16) and its AdamW state
placed on a (2, 2) mesh. Then 4 gloo ranks on the (2, 2) ("data",
"model") mesh train reduced qwen2.5-3b (f32, profile "2d") for 2 steps,
``save_sync`` their DTensor state, ``save_async`` it again while step 3
runs its collectives, and restore the JAX checkpoint onto their mesh.
Then 2 ranks, their mesh (1, 2) ordered by
``plan_elastic_remesh(tpu_pod_2d(2, 2), [2, 3], (2, 2), 2)``, restore
the 4-rank checkpoint and run steps 3 and 4. This process runs the 4
steps on plain tensors meanwhile.

Held here: each ``shard_<rank>.npz`` holds that rank's blocks and no
other (each distinct block once, by the lowest rank holding it), no
sharded leaf is written whole, one ``index.json`` lists every entry;
JAX's ``restore``, the port's ``restore`` and the ranks' gathered state
agree bit for bit; the port reads JAX's 4-device checkpoint bit for bit
and places it on the 4-rank mesh; the 2-rank resume tracks the
one-process reference within ``tests/test_torch_distributed.py``'s
tolerances (losses rtol 1e-5; weights rtol 1e-5 with an atol of 2 ×
steps × lr, and an atol of 1e-3 × lr where the first step's gradient is
at least a tenth of its leaf's largest); ``save_async`` under live
collectives commits one step and leaves no ``.tmp_``. Also the commit's
time limit and the specs in the JAX layout against the JAX package's.
About 40 s, 4 processes of ~400 MB at most; each has its own time
limit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.runtime import plan_elastic_remesh as jplan  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, restore  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import _torch_checkpoint_worker as worker  # noqa: E402

TIMEOUT = 300
LR = worker.OPT.lr_peak
MESH = {"data": 2, "model": 2}
STEP = f"step_{worker.SAVE_AT:09d}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, env=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.Popen([sys.executable, str(HERE / worker.__name__)
                             + ".py", *args], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs) -> None:
    logs = []
    try:
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


def _world(mode: str, world: int, d: Path) -> None:
    port = str(_free_port())
    _finish([_start([mode, str(r), str(world), port, str(d)])
             for r in range(world)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the worlds' directory, the one-process reference)."""
    d = tmp_path_factory.mktemp("ckpt_sharded")
    jax_proc = _start(["jax", str(d)], env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu"})
    try:
        reference = worker.reference()
    finally:
        _finish([jax_proc])
    _world("save", 4, d)
    _world("resume", 2, d)
    return d, reference


@pytest.fixture(scope="module")
def d(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


def _spec_leaves(tree, prefix=""):
    """{checkpoint key: spec} of a specs tree (dicts and lists of specs)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_spec_leaves(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, x in enumerate(tree):
            out.update(_spec_leaves(x, f"{prefix}[{i}]/"))
        return out
    return {prefix[:-1]: tree}


def _expected_blocks(shape, spec) -> set:
    """{(writer rank, block index)} of a leaf of ``shape`` placed by
    ``spec`` on the (2, 2) mesh of ranks [[0, 1], [2, 3]]: each distinct
    block once, by the lowest rank that holds it."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    blocks = {}
    for rank in range(4):
        coord = {"data": rank // 2, "model": rank % 2}
        index = []
        for n, e in zip(shape, entries):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            parts, at = 1, 0
            for a in axes:
                parts, at = parts * MESH[a], at * MESH[a] + coord[a]
            index.append((at * n // parts, (at + 1) * n // parts))
        blocks.setdefault(tuple(index), rank)
    return {(r, idx) for idx, r in blocks.items()}


def _port_specs():
    cfg = worker.config(None)
    model = Model(cfg, device="meta")
    p_specs = shd.param_specs(MESH, model, cfg.sharding_profile)
    state = adamw_init(dict(model.named_parameters()), worker.OPT,
                       period=len(cfg.pattern))
    return _spec_leaves({
        "params": convert.specs_to_jax(p_specs, cfg),
        "opt": convert.opt_specs_to_jax(
            shd.opt_state_specs(MESH, state, p_specs), cfg)})


def _index(path: Path) -> dict:
    return json.loads((path / "index.json").read_text())["arrays"]


def _npz(path: Path) -> dict:
    out = {}
    for r in range(4):
        with np.load(path / f"shard_{r}.npz") as z:
            out[r] = {k: z[k] for k in z.files}
    return out


def _port_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


def test_each_rank_writes_only_its_own_blocks(d):
    path = d / "sync" / STEP
    index, files = _index(path), _npz(path)
    with np.load(d / "gathered.npz") as z:
        gathered = {k: z[k] for k in z.files}
    specs = _port_specs()
    assert sorted(index) == sorted(specs)
    sharded = 0
    for key, meta in index.items():
        spec = specs[key] or ()
        if any(e is not None for e in spec):
            sharded += 1
            assert "full" not in meta, key       # never written whole
            got = {(int(sd["id"].rsplit("::shard", 1)[1]),
                    tuple(tuple(p) for p in sd["index"]))
                   for sd in meta["shards"]}
            assert got == _expected_blocks(meta["shape"], spec), key
            for sd in meta["shards"]:
                r = int(sd["id"].rsplit("::shard", 1)[1])
                sl = tuple(slice(a, b) for a, b in sd["index"])
                np.testing.assert_array_equal(files[r][sd["id"]],
                                              gathered[key][sl], err_msg=key)
        else:
            assert meta["full"] == f"{key}::full", key
    assert sharded > len(index) // 2
    # each file holds its rank's entries only; the index names each once
    listed = {sd["id"] for m in index.values() for sd in m.get("shards", [])}
    listed |= {m["full"] for m in index.values() if "full" in m}
    written = []
    for r, entries in files.items():
        for sid in entries:
            assert sid.endswith(f"::shard{r}") or (
                r == 0 and sid.endswith("::full")), (r, sid)
        written += list(entries)
    assert sorted(written) == sorted(listed)
    assert json.loads((path / "index.json").read_text())["num_hosts"] == 4
    assert [p for p in os.listdir(path) if p.startswith(".")] == []


def test_host_twin_mesh_writes_the_same_checkpoint(d):
    """A snapshot on the host twin of the mesh (``convert._host_twin``,
    no process groups) is written as the mesh's own: the same index, the
    same entries in each rank's file, bit for bit."""
    a, b = d / "sync" / STEP, d / "twin" / STEP
    assert _index(a) == _index(b)
    fa, fb = _npz(a), _npz(b)
    for r in range(4):
        assert sorted(fa[r]) == sorted(fb[r]), r
        for k in fa[r]:
            np.testing.assert_array_equal(fa[r][k], fb[r][k], err_msg=k)


def test_jax_restore_port_restore_and_gathered_state_agree(d):
    """JAX's ``restore`` of the 4-rank checkpoint (``like`` from
    ``convert.to_jax`` of a reference model), the port's ``restore`` and
    the ranks' gathered state, bit for bit."""
    path = d / "sync"
    cfg = worker.config(None)
    params, state = worker.fresh(cfg)
    like = {"params": convert.to_jax(params, cfg),
            "opt": convert.opt_to_jax(state, cfg)}
    got_jax = jckpt.restore(str(path), worker.SAVE_AT, like)
    got_port = ckpt._flatten(restore(str(path), worker.SAVE_AT))
    with np.load(d / "gathered.npz") as z:
        gathered = {k: z[k] for k in z.files}
    flat_jax = {k: np.asarray(v) for k, v in
                jckpt.checkpoint._flatten(got_jax).items()}
    assert sorted(flat_jax) == sorted(got_port) == sorted(gathered)
    for k, want in gathered.items():
        np.testing.assert_array_equal(flat_jax[k], want, err_msg=k)
        np.testing.assert_array_equal(got_port[k].numpy(), want, err_msg=k)
        assert flat_jax[k].dtype == want.dtype, k


def test_port_restores_jax_4_device_checkpoint_whole(d):
    index = _index(d / "jax" / "step_000000001")
    assert all("shards" in m and len(m["shards"]) == 4
               for m in index.values())   # one per device, replicas too
    got = ckpt._flatten(restore(str(d / "jax"), 1))
    with np.load(d / "jax_whole.npz") as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    assert got["params/embed"].dtype == torch.bfloat16
    for k, w in want.items():
        np.testing.assert_array_equal(_port_bits(got[k]), w, err_msg=k)


def test_port_places_jax_checkpoint_on_the_4_rank_mesh(d):
    """Each rank held its blocks of ``restore_latest(mesh, specs)`` and of
    ``from_jax`` + ``distribute_model`` to the whole leaves (it exits
    non-zero otherwise) and wrote how many it checked."""
    n_leaves = len(_index(d / "jax" / "step_000000001"))
    counts = [int((d / f"placed_{r}.txt").read_text()) for r in range(4)]
    assert len(set(counts)) == 1 and counts[0] > n_leaves // 2


def test_save_async_under_collectives_commits_once(d):
    path = d / "async"
    assert sorted(os.listdir(path)) == [STEP]
    assert [p for p in os.listdir(path / STEP) if p.startswith(".")] == []
    a = ckpt._flatten(restore(str(path), worker.SAVE_AT))
    b = ckpt._flatten(restore(str(d / "sync"), worker.SAVE_AT))
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_mesh_follows_the_remesh_plan(d):
    plan = jplan(jtopology.tpu_pod_2d(2, 2), worker.RESUME_FAILED, (2, 2), 2)
    order = {dev: r for r, dev in enumerate(sorted(plan.surviving))}
    with np.load(d / "resumed.npz") as z:
        grid = z["grid"]
    assert grid.shape == plan.mesh_shape == (1, 2)
    assert grid.ravel().tolist() == [order[x] for x in plan.surviving]


def test_cross_mesh_resume_tracks_one_process(d, reference):
    with np.load(d / "resumed.npz") as z:
        got = {k: z[k] for k in z.files}
    np.testing.assert_allclose(got["losses"], reference["losses"][
        worker.SAVE_AT:], rtol=1e-5, atol=0)
    steps = worker.STEPS
    names = [k for k in reference["final"]]
    assert names and all(k in got for k in names)
    for k in names:
        want = reference["final"][k]
        np.testing.assert_allclose(got[k], want, rtol=1e-5,
                                   atol=2 * steps * LR, err_msg=k)
        g = np.abs(reference["grads"][k])
        big = g >= 0.1 * g.max()
        assert big.any(), k
        np.testing.assert_allclose(got[k][big], want[big], rtol=1e-5,
                                   atol=1e-3 * LR, err_msg=k)


def test_commit_raises_when_a_rank_never_arrives(tmp_path, monkeypatch):
    """Rank 0 of 2 waits for rank 1's marker and raises at its time limit;
    rank 1 of 2 waits for rank 0's rename and raises: nothing is
    committed, no leaf is gathered in its place."""
    monkeypatch.setattr(ckpt, "COMMIT_TIMEOUT_S", 0.2)
    d = str(tmp_path)
    payload = {"x::full": np.ones(3, np.float32)}
    index = {"x": {"shape": [3], "dtype": "float32", "full": "x::full"}}
    for rank in (0, 1):
        with pytest.raises(TimeoutError):
            ckpt._write(d, 7, payload, index, rank=rank, world=2)
    assert ckpt.latest_step(d) is None


def test_save_async_reraises_the_writer_error(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "COMMIT_TIMEOUT_S", 0.2)
    monkeypatch.setattr(ckpt, "_prepare", lambda d, s, tree: (
        {}, {}, 0, 2))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(3, {"x": torch.ones(2)})
    with pytest.raises(TimeoutError):
        mgr.wait()
    mgr.wait()                   # the error is raised once
    assert ckpt.latest_step(str(tmp_path)) is None


@pytest.fixture
def spec_only(monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)


class _Mesh:
    """Duck-typed mesh (tests/test_system.py:97)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("factored", [False, True],
                         ids=["unfactored", "factored"])
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_specs_in_the_jax_layout_equal_jax(arch, factored, spec_only):
    """``convert.specs_to_jax`` / ``opt_specs_to_jax`` of the port's specs
    equal the JAX package's ``param_specs`` / ``opt_state_shardings`` of
    the stacked tree, leaf by leaf, at full width on a (16, 16) mesh."""
    mesh = {"data": 16, "model": 16}
    cfg = configs.get(arch)
    model = Model(cfg, device="meta")
    p_specs = shd.param_specs(mesh, model, cfg.sharding_profile)
    state = adamw_init(dict(model.named_parameters()),
                       AdamWConfig(factored=factored),
                       period=len(cfg.pattern))
    got = _spec_leaves({"params": convert.specs_to_jax(p_specs, cfg),
                        "opt": convert.opt_specs_to_jax(
                            shd.opt_state_specs(mesh, state, p_specs), cfg)})
    jparams = jmodel.abstract_params(jconfigs.get(arch))
    jmesh = _Mesh(mesh)
    jp = jshd.param_specs(jmesh, jparams, cfg.sharding_profile)
    jstate = jax.eval_shape(lambda p: jadamw_init(
        p, JAdamWConfig(factored=factored)), jparams)
    jo = jshd.opt_state_shardings(jmesh, jstate, jp)
    want = jckpt.checkpoint._flatten({"params": jp, "opt": jo})
    assert want.pop("opt/count") == P() and got.pop("opt/count") is None
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert isinstance(spec, P), k
        assert _trim(got[k]) == _trim(spec), k


def _trim(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def test_fake_process_group_saves_as_one_process(tmp_path):
    """Under the dry run's fake process group (placeholder ranks, kept for
    the process) a save is one process's: ``shard_0.npz``, committed at
    once, where waiting for the other ranks' shards would never end."""
    from repro_torch.launch import dryrun
    dryrun.fake_world(4)
    assert ckpt._world() == (0, 1)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(2, {"x": torch.arange(3.0)})
    mgr.save_sync(4, {"x": torch.ones(3)})
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                             "step_000000004"]
    assert sorted(os.listdir(tmp_path / "step_000000004")) == [
        "index.json", "shard_0.npz"]
    assert torch.equal(restore(str(tmp_path), 2)["x"], torch.arange(3.0))
