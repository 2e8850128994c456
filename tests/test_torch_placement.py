"""The port's topology, priority, placement and mesh steal table against
the JAX package's, output for output (``repro_torch.core.{topology,
priority, placement}``, ``repro_torch.launch.mesh``). Both are pure numpy
over the same hop matrices, so arrays must be equal, not merely close."""

from __future__ import annotations

import types

import numpy as np
import pytest

from repro.core import placement as jplacement
from repro.core import priority as jpriority
from repro.core import topology as jtopology
from repro.launch import mesh as jmesh

torch = pytest.importorskip("torch")

from repro_torch.core import placement, priority, topology  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

TOPOLOGIES = {
    "x4600": (lambda m: m.sunfire_x4600(), None),
    "pod16x16": (lambda m: m.tpu_pod_2d(16, 16), (16, 16)),
    "multi2x16x16": (lambda m: m.multi_pod(2, 16, 16), (2, 16, 16)),
    "multi2x4x4": (lambda m: m.multi_pod(2, 4, 4), (2, 4, 4)),
    "uma8": (lambda m: m.uma(8), None),
    "pod4x6-open": (lambda m: m.tpu_pod_2d(4, 6, wrap=False), (4, 6)),
}


def _pair(name):
    make, shape = TOPOLOGIES[name]
    return make(jtopology), make(topology), shape


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_matches_jax(name):
    jt, tt, _ = _pair(name)
    assert tt.name == jt.name
    np.testing.assert_array_equal(tt.core_node, jt.core_node)
    np.testing.assert_array_equal(tt.node_distance, jt.node_distance)
    assert (tt.link_bandwidth, tt.hop_latency) == (jt.link_bandwidth,
                                                   jt.hop_latency)
    assert tt.fingerprint() == jt.fingerprint()
    assert tt.max_distance() == jt.max_distance()
    for core in range(0, tt.num_cores, max(1, tt.num_cores // 7)):
        assert tt.hop_histogram(core) == jt.hop_histogram(core)
        assert tt.numa_factor(0, core) == jt.numa_factor(0, core)
    for node in range(min(tt.num_nodes, 4)):
        assert tt.cores_on_node(node) == jt.cores_on_node(node)
    cores = list(range(0, tt.num_cores, 2))
    jr, tr = jt.restrict(cores), tt.restrict(cores)
    assert tr.name == jr.name
    np.testing.assert_array_equal(tr.core_distance_matrix(),
                                  jr.core_distance_matrix())


def test_bfs_all_pairs_matches_jax():
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (1, 4)]
    np.testing.assert_array_equal(topology._bfs_all_pairs(5, edges),
                                  jtopology._bfs_all_pairs(5, edges))
    with pytest.raises(ValueError, match="disconnected"):
        topology._bfs_all_pairs(3, [(0, 1)])


# the cases of tests/test_priority.py, each through both packages
PRIORITY_CASES = [
    ("x4600", {}),
    ("uma8", {}),
    ("x4600", {"available": [0, 1, 2, 3, 6, 7, 12, 13]}),
    ("x4600", {"occupied_penalty": 0.5, "available": list(range(10))}),
    ("x4600", {"weights": [1.0, 0.6, 0.3, 0.1]}),
    ("pod4x6-open", {}),
    ("multi2x4x4", {}),
]


@pytest.mark.parametrize("name,kw", PRIORITY_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(PRIORITY_CASES)])
def test_priorities_equal_jax(name, kw):
    jt, tt, _ = _pair(name)
    kw = {k: np.asarray(v) if k == "weights" else v for k, v in kw.items()}
    jr, tr = jpriority.priorities(jt, **kw), priority.priorities(tt, **kw)
    for field in ("base", "v1", "v2", "total"):
        np.testing.assert_array_equal(getattr(tr, field), getattr(jr, field))
    np.testing.assert_array_equal(tr.ranking(), jr.ranking())


def test_default_weights_and_bad_weights_match_jax():
    np.testing.assert_array_equal(priority.default_weights(3),
                                  jpriority.default_weights(3))
    bad = np.array([1.0, 1.0, 0.5, 0.2])
    with pytest.raises(ValueError, match="strictly decreasing"):
        priority.priorities(topology.sunfire_x4600(), weights=bad)
    with pytest.raises(ValueError, match="more threads"):
        priority.allocate_threads(topology.uma(4), 5)


@pytest.mark.parametrize("name,n,seed,avail", [
    ("x4600", 16, 1, None), ("x4600", 4, 0, None), ("x4600", 4, 3, None),
    ("x4600", 4, 0, [0, 1, 2, 3, 8, 9, 10, 11]),
    ("pod4x6-open", 10, 2, None), ("multi2x4x4", 20, 5, None),
    ("uma8", 8, 7, None)])
def test_allocate_threads_equals_jax(name, n, seed, avail):
    jt, tt, _ = _pair(name)
    assert priority.allocate_threads(tt, n, available=avail, seed=seed) == \
        jpriority.allocate_threads(jt, n, available=avail, seed=seed)


@pytest.mark.parametrize("name", ["pod16x16", "multi2x16x16", "multi2x4x4",
                                  "x4600"])
def test_device_order_and_layout_cost_equal_jax(name):
    jt, tt, shape = _pair(name)
    shape = shape or (4, 4)
    perm = placement.device_order_priority(tt, shape)
    np.testing.assert_array_equal(perm,
                                  jplacement.device_order_priority(jt, shape))
    assert sorted(perm.tolist()) == list(range(tt.num_cores))
    for order in (perm, placement.device_order_baseline(tt)):
        assert placement.layout_cost(tt, order, shape) == \
            jplacement.layout_cost(jt, order, shape)
    assert placement.master_node(tt, seed=2) == \
        jplacement.master_node(jt, seed=2)
    for start in (0, tt.num_nodes - 1):
        pr = priority.priorities(tt)
        assert placement.first_touch_spill(tt, start, 3, pr) == \
            jplacement.first_touch_spill(jt, start, 3,
                                         jpriority.priorities(jt))
        assert placement.first_touch_spill(tt, start, 3) == \
            jplacement.first_touch_spill(jt, start, 3)


def _meshes(shape, perm):
    """The port's and JAX's view of one rank grid: the port reads
    ``mesh.mesh`` and ``mesh_dim_names``, JAX ``devices`` (with ``.id``)
    and ``axis_names`` (tests/test_system.py:97's duck-typed mesh)."""
    axes = mesh.mesh_axes(len(shape) == 3)
    grid = np.asarray(perm).reshape(shape)
    port = types.SimpleNamespace(mesh=torch.as_tensor(grid),
                                 mesh_dim_names=axes)
    devs = np.vectorize(lambda i: types.SimpleNamespace(id=int(i)),
                        otypes=[object])(grid)
    jax_mesh = types.SimpleNamespace(devices=devs, axis_names=axes)
    return port, jax_mesh


@pytest.mark.parametrize("arch_experts", [
    ("granite-moe-1b-a400m", 32), ("llama4-scout-17b-a16e", 16),
    ("jamba-1.5-large-398b", 16)], ids=lambda a: a[0])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("aware", [False, True],
                         ids=["rank-order", "priority"])
def test_mesh_steal_table_equals_jax(arch_experts, multi, aware):
    arch, E = arch_experts
    from repro_torch import configs
    assert configs.get(arch).moe_num_experts == E
    shape = (2, 16, 16) if multi else (16, 16)
    perm = np.arange(int(np.prod(shape)))
    if aware:
        perm = placement.device_order_priority(
            mesh.production_topology(multi), shape)
    port, jax_mesh = _meshes(shape, perm)
    for policy in ("dfwspt", "dfwsrpt"):
        got = mesh.mesh_steal_table(port, E, policy, seed=3)
        want = jmesh.mesh_steal_table(jax_mesh, E, policy, seed=3)
        assert got.shape == (E, E - 1)
        np.testing.assert_array_equal(got, want)
    assert mesh.coordinator_device(port) == int(perm[0])


def test_production_topology_equals_jax():
    for multi in (False, True):
        jt, tt = jmesh.production_topology(multi), \
            mesh.production_topology(multi)
        np.testing.assert_array_equal(tt.node_distance, jt.node_distance)
        assert tt.name == jt.name


def test_make_production_mesh_orders_ranks_by_priority():
    """A DeviceMesh (4, 4) over the first 16 ranks of the dry run's
    placeholder world: rank order, or the priority permutation's grid
    when topology aware."""
    from repro_torch.launch import dryrun

    dryrun.fake_world(16)
    plain = mesh.make_production_mesh(shape=(4, 4), device_type="cpu")
    assert plain.mesh_dim_names == ("data", "model")
    np.testing.assert_array_equal(plain.mesh.numpy(),
                                  np.arange(16).reshape(4, 4))
    aware = mesh.make_production_mesh(shape=(4, 4), device_type="cpu",
                                      topology_aware=True)
    perm = placement.device_order_priority(topology.tpu_pod_2d(4, 4),
                                           (4, 4))
    np.testing.assert_array_equal(aware.mesh.numpy().reshape(-1), perm)
    with pytest.raises(ValueError, match="needs 1024 ranks"):
        mesh.make_production_mesh(shape=(4, 16, 16), multi_pod=True,
                                  device_type="cpu")
