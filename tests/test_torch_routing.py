"""Port parity: repro_torch.core.routing against repro.core.routing on the
same numpy logits (CPU). Expert and slot ids must be exactly equal,
weights within 1e-6."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import topology  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import routing  # noqa: E402
from repro_torch.models import layers  # noqa: E402

E = 8
TOPO_TABLE = jrouting.expert_steal_table(topology.tpu_pod_2d(2, 4),
                                         np.arange(E), "dfwspt")
TABLES = {
    "ring": routing.ring_steal_table(E),
    "topology": TOPO_TABLE,
    "topology-dfwsrpt": jrouting.expert_steal_table(
        topology.tpu_pod_2d(2, 4), np.arange(E), "dfwsrpt", seed=3),
}


def _logits(kind, T=64, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "tied":
        # few distinct values: many exact ties among the top-k
        return rng.integers(0, 3, (T, E)).astype(np.float32)
    x = rng.standard_normal((T, E)).astype(np.float32)
    if kind == "skewed":
        x[:, :2] += 3.0          # experts 0 and 1 overflow
    return x


def _both(logits, rcfg_kwargs, table):
    jr = jrouting.route(jnp.asarray(logits),
                        jrouting.RoutingConfig(**rcfg_kwargs), table)
    tr = routing.route(torch.from_numpy(logits),
                       routing.RoutingConfig(**rcfg_kwargs), table)
    return jr, tr


def _assert_same(jr, tr):
    np.testing.assert_array_equal(tr["expert"].numpy(),
                                  np.asarray(jr["expert"]))
    np.testing.assert_array_equal(tr["slot"].numpy(), np.asarray(jr["slot"]))
    assert tr["expert"].dtype == torch.int32
    np.testing.assert_allclose(tr["weight"].numpy(), np.asarray(jr["weight"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tr["aux_loss"]), float(jr["aux_loss"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tr["drop_fraction"]),
                               float(jr["drop_fraction"]), atol=1e-7)


@pytest.mark.parametrize("kind", ["random", "tied", "skewed"])
@pytest.mark.parametrize("attempts", [0, 1, 2])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_route_matches_jax(kind, attempts, table):
    top_k = 3 if kind == "tied" else 2
    # tight capacity: overflow everywhere, drops left after the steals
    kwargs = dict(num_experts=E, top_k=top_k, capacity=12,
                  steal_attempts=attempts)
    jr, tr = _both(_logits(kind), kwargs, TABLES[table])
    _assert_same(jr, tr)


def test_route_drops_are_minus_one_and_zero_weight():
    kwargs = dict(num_experts=E, top_k=2, capacity=4, steal_attempts=1)
    jr, tr = _both(_logits("skewed"), kwargs, TABLES["ring"])
    _assert_same(jr, tr)
    dropped = tr["expert"] < 0
    assert dropped.any()
    assert (tr["slot"][dropped] == -1).all()
    assert (tr["weight"][dropped] == 0).all()


def test_tied_logits_keep_lower_expert_first():
    logits = np.zeros((4, E), np.float32)
    logits[:, [1, 5, 6]] = 2.0
    kwargs = dict(num_experts=E, top_k=3, capacity=8, steal_attempts=0)
    jr, tr = _both(logits, kwargs, None)
    _assert_same(jr, tr)
    assert tr["expert"][0].tolist() == [1, 5, 6]


def test_steal_attempts_need_a_table():
    with pytest.raises(ValueError):
        routing.route(torch.zeros(4, E),
                      routing.RoutingConfig(E, 2, 4, steal_attempts=1))


def test_one_hot_gives_zero_rows_for_drops():
    idx = torch.tensor([[2, -1], [0, 3]], dtype=torch.int32)
    got = routing.one_hot(idx, 4, torch.float32).numpy()
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx.numpy()), 4))
    np.testing.assert_array_equal(got, want)
    assert got[0, 1].sum() == 0


@pytest.mark.parametrize("attempts", [0, 2])
def test_dispatch_combine_weights_match_jax(attempts):
    kwargs = dict(num_experts=E, top_k=2, capacity=10,
                  steal_attempts=attempts)
    jr, tr = _both(_logits("skewed", seed=1), kwargs, TABLES["topology"])
    jd, jc = jrouting.dispatch_combine_weights(jr, E, 10)
    td, tc = routing.dispatch_combine_weights(tr, E, 10)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("table", [None, "topology"])
def test_moe_layer_matches_jax(impl, table):
    """The MoE block on both routes; with no table both fall back to the
    ring order (layers.py:274-279)."""
    jcfg = dataclasses.replace(jconfigs.get("granite-moe-1b-a400m").reduced(),
                               moe_num_experts=E, moe_top_k=2, moe_impl=impl,
                               capacity_factor=1.0)
    cfg = dataclasses.replace(configs.get("granite-moe-1b-a400m").reduced(),
                              moe_num_experts=E, moe_top_k=2, moe_impl=impl,
                              capacity_factor=1.0)
    rng = np.random.default_rng(5)
    D, Fe = cfg.d_model, cfg.moe_d_ff
    w = dict(router=rng.standard_normal((D, E)) / 8,
             wg=rng.standard_normal((E, D, Fe)) / 8,
             wu=rng.standard_normal((E, D, Fe)) / 8,
             wd=rng.standard_normal((E, Fe, D)) / 6)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    tab = None if table is None else TABLES[table]
    jy, jaux = jlayers.moe(jnp.asarray(x), {k: jnp.asarray(v)
                                            for k, v in w.items()}, jcfg, tab)
    mod = layers.MoE(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for k, v in w.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
        ty, taux = mod(torch.from_numpy(x), cfg, tab)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_fill_positions_equal_outer_axis_cumsum(seed):
    """The scan along the (E, T) transpose gives the very integers of the
    cumsum along the outer axis of (T, E), at the train shape's T and E,
    with inactive tokens and partly used experts."""
    T, E, cap = 32768, 32, 1100
    rng = np.random.default_rng(seed)
    choice = torch.from_numpy(rng.integers(0, E, T).astype(np.int32))
    active = torch.from_numpy(rng.random(T) < 0.8)
    used = torch.from_numpy(rng.integers(0, 300, E).astype(np.int32))
    placed, pos, new_used = routing._fill_positions(choice, active, used, E,
                                                    cap)
    onehot = routing.one_hot(choice, E, torch.int32) \
        * active[:, None].to(torch.int32)
    pos_in = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    want = pos_in.gather(1, choice.long()[:, None])[:, 0] \
        + used[choice.long()]
    assert pos.dtype == want.dtype
    assert torch.equal(pos, want)
    assert torch.equal(placed, active & (want < cap))
    assert not bool(placed.all()) and bool(placed.any())
    assert torch.equal(new_used, used + torch.minimum(
        onehot.sum(dim=0, dtype=torch.int32), cap - used))
