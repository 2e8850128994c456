"""The port's sharding rules (``repro_torch.launch.shardings``) against the
JAX package's ``repro.launch.shardings``: ``fit_spec``, and the spec of
every parameter, optimizer-state and cache leaf of all ten architectures
at full width, on duck-typed meshes (16,16), (2,16,16), (2,2) and (1,1),
under each sharding profile.

The JAX side runs on ShapeDtypeStructs (``jax.eval_shape``), the port's on
the meta device. JAX stacks each pattern slot's layers on a leading
``repeats`` axis; the port holds a tensor per layer, so a JAX spec is
compared with its leading ``None`` removed, through ``convert``'s name map
(layer ``r * period + si`` is index ``r`` of slot ``si``). JAX's
``cache_shardings`` and ``opt_state_shardings`` wrap each spec in a
``NamedSharding``, which needs a real mesh: the test replaces that
constructor in the JAX module by one that returns the spec."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import shardings as jshd
from repro.models import model as jmodel
from repro.models import stack as jstack
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x1": {"data": 1, "model": 1}}
PROFILES = ("2d", "ep_only", "ep_replicated")


class _Mesh:
    """Duck-typed mesh (tests/test_system.py:97)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.fixture
def spec_only(monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)


def _keys(path) -> list[str]:
    return jshd._path_keys(path)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jmodel.abstract_params(jconfigs.get(arch))


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return Model(configs.get(arch), device="meta")


def _port_names(keys, cfg):
    """Port names of a JAX leaf's path: top-level as it is, a slot leaf
    once per repeat."""
    if keys[0] != "blocks":
        return [".".join(keys)]
    si, path = int(keys[1]), keys[2:]
    period = len(cfg.pattern)
    return [".".join(["blocks", str(r * period + si), *path])
            for r in range(cfg.repeats)]


def _unstacked(spec, keys):
    spec = tuple(spec)
    if keys[0] == "blocks" and spec:
        assert spec[0] is None, (keys, spec)
        spec = spec[1:]
    return spec


def _compare(jtree, port: dict, cfg, is_leaf=None):
    """Every JAX leaf's spec against the port's for each of its names."""
    flat = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, P) or (is_leaf and
                                                       is_leaf(x)))[0]
    seen = set()
    for path, spec in flat:
        keys = _keys(path)
        for name in _port_names(keys, cfg):
            assert port[name] == _unstacked(spec, keys), (name, spec)
            seen.add(name)
    return seen


def test_fit_spec_equals_jax_on_shapes_and_specs():
    rng = np.random.default_rng(0)
    axes = [None, "data", "model", ("data", "model"), ("pod", "data")]
    for mesh in MESHES.values():
        jm = _Mesh(mesh)
        for _ in range(300):
            nd = int(rng.integers(1, 4))
            shape = tuple(int(x) for x in rng.choice(
                [1, 2, 3, 8, 16, 40, 64, 256, 512], nd))
            spec = tuple(axes[int(i)] for i in rng.integers(0, 5, nd))
            if "pod" not in mesh:
                spec = tuple(None if e == ("pod", "data") else e
                             for e in spec)
            assert shd.fit_spec(mesh, shape, spec) == \
                tuple(jshd.fit_spec(jm, shape, P(*spec))), (shape, spec)
    assert shd.fit_spec(MESHES["16x16"], (40, 512), ("model", "data")) == \
        (None, "data")
    assert shd.fit_spec({"data": 4}, (8, 3, 5), ("data", None, None)) == \
        ("data",)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_specs_equal_jax(arch, mesh_name):
    cfg = configs.get(arch)
    model = _port_model(arch)
    names = {n for n, _ in model.named_parameters()}
    for profile in PROFILES:
        port = shd.param_specs(MESHES[mesh_name], model, profile)
        want = jshd.param_specs(_Mesh(MESHES[mesh_name]), _jax_params(arch),
                                profile)
        assert _compare(want, port, cfg) == names


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_opt_state_specs_equal_jax(arch, mesh_name, spec_only):
    cfg = configs.get(arch)
    mesh = MESHES[mesh_name]
    model = _port_model(arch)
    for factored in (False, True):
        kw = dict(factored=factored,
                  m_dtype="bfloat16" if factored else "float32")
        state = adamw_init(dict(model.named_parameters()), AdamWConfig(**kw),
                           period=len(cfg.pattern))
        jopt = jax.eval_shape(lambda p: jadamw_init(p, JAdamWConfig(**kw)),
                              _jax_params(arch))
        for profile in PROFILES:
            p_specs = shd.param_specs(mesh, model, profile)
            port = shd.opt_state_specs(mesh, state, p_specs)
            jp = jshd.param_specs(_Mesh(mesh), _jax_params(arch), profile)
            want = jshd.opt_state_shardings(_Mesh(mesh), jopt, jp)
            assert _compare(want["m"], port["m"], cfg) == set(state["m"])
            # a factored leaf {vr, vc} is replicated; the slot-wide
            # statistics of per-layer vectors sit under their slot key
            v_port = {}
            for k, v in port["v"].items():
                if isinstance(v, dict):
                    v_port.update({f"{k}.{s}": x for s, x in v.items()})
                else:
                    v_port[k] = v
            flat = jax.tree_util.tree_flatten_with_path(
                want["v"], is_leaf=lambda x: isinstance(x, P))[0]
            for path, spec in flat:
                keys = _keys(path)
                if keys[-1] in ("vr", "vc") and keys[0] == "blocks" \
                        and f"slot{keys[1]}." + ".".join(keys[2:]) in v_port:
                    key = f"slot{keys[1]}." + ".".join(keys[2:])
                    assert v_port[key] == tuple(spec) == ()
                    continue
                for name in _port_names(keys, cfg):
                    assert v_port[name] == _unstacked(spec, keys), name
    # the dry run's AdamW state on a mesh carries exactly these placements
    # (checked on the placeholder world in tests/test_torch_dryrun.py)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(a for a, c in configs.ARCHS.items()
                                        if not c.is_encoder))
def test_cache_specs_equal_jax(arch, mesh_name, spec_only):
    """Decode caches (an encoder has none)."""
    cfg = configs.get(arch)
    mesh = MESHES[mesh_name]
    B, L = 8, 64
    port_caches = dryrun.abstract_caches(cfg, B, L)
    port = shd.cache_specs(mesh, port_caches)
    jc = jax.eval_shape(lambda: jstack.init_caches(
        jconfigs.get(arch), B, L, jnp.dtype(cfg.dtype)))
    want = jshd.cache_shardings(_Mesh(mesh), jc)
    period = len(cfg.pattern)
    seen = 0
    for si, slot in enumerate(want["slots"]):
        if slot is None:
            continue
        for leaf, spec in slot.items():
            for r in range(cfg.repeats):
                layer = port["layers"][r * period + si]
                assert layer[leaf] == _unstacked(spec, ["blocks"]), \
                    (r * period + si, leaf)
                seen += 1
    assert seen == sum(len(c) for c in port["layers"] if c is not None)
    assert tuple(want["length"]) == () and port["length"] is None


def test_placements_on_a_device_mesh():
    """Spec → DTensor placements, on the dry run's placeholder world."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    dryrun.fake_world(4)
    mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
    assert shd.placements(mesh, ("data", "model")) == [Shard(0),
                                                       Shard(1)]
    assert shd.placements(mesh, ("model", "data")) == [Shard(1),
                                                       Shard(0)]
    assert shd.placements(mesh, ((("data", "model")),)) == [Shard(0),
                                                            Shard(0)]
    assert shd.placements(mesh, ()) == [Replicate(), Replicate()]
    with pytest.raises(NotImplementedError):
        shd.placements(mesh, (("model", "data"),))
    t = torch.arange(64.0).reshape(8, 8)
    d = shd.distribute(t, mesh, (("data", "model"), None))
    assert d.to_local().shape == (2, 8)
    assert shd.local_shape(mesh, (8, 8), (("data", "model"),)) == (2, 8)
    # rank 0 keeps the first quarter of the rows (the fake process
    # group moves no data, so only the local shard is meaningful)
    torch.testing.assert_close(d.to_local(), t[:2])
