"""Port parity at the widths of the bf16 edge routes (``moe_gmm``'s
``"wgmma_edge"``, ``ssd_scan``'s ``"tc_edge"``): rows that are not whole
16-byte chunks, of 4- and 8-byte pieces (D 50, F 70; P 50, N 100) and
2-byte ones (D 51, F 77; P 49, N 77), and the training shapes' odd widths
scaled down (D 102, F 51). On the CPU the port's wrappers take their
plain versions; they are held against the JAX package's ops (their
Pallas kernels in interpret mode, or the oracle where a width does not
tile) on the same numpy inputs, at tests/test_kernels.py's tolerances.
The kernels themselves run at these widths on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py: moe_gmm f32 1e-4 (bf16 3e-2, as the card holds
# it); the SSD scan rtol 2e-3, atol 2e-4 (bf16 3e-2)
GMM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SSD_TOL = {"float32": dict(rtol=2e-3, atol=2e-4),
           "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _draw(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------------
# moe_gmm
# ----------------------------------------------------------------------
# (G groups, E experts, C, D, F)
GMM_SHAPES = [
    (1, 3, 33, 50, 70),          # 100- and 140-byte rows: 4-byte pieces
    (2, 2, 40, 51, 77),          # 2-byte rows, two groups
    (1, 2, 70, 102, 51),         # the train gate/up odd widths, scaled
    (2, 2, 17, 51, 102),         # train down odd, scaled; C below 32
]


@pytest.mark.parametrize("G,E,C,D,F", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_edge_widths_vs_jax(G, E, C, D, F, dtype):
    """Forward, grouped over shared experts, against JAX's op on the
    weights tiled G times."""
    jdt, tdt = DTYPES[dtype]
    x, w = _draw((G * E, C, D), 50), _draw((E, D, F), 51, D ** -0.5)
    want = jops.moe_gmm(jnp.asarray(x).astype(jdt),
                        jnp.tile(jnp.asarray(w).astype(jdt), (G, 1, 1)))
    got = ops.moe_gmm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                      expert_period=E)
    assert got.dtype == tdt and got.shape == (G * E, C, F)
    tol = GMM_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("G,E,C,D,F", GMM_SHAPES)
def test_moe_gmm_edge_widths_grads_vs_jax(G, E, C, D, F):
    """dx and dw (summed over the groups) against jax.grad of JAX's op,
    f32 (test_kernels.py:174-180's tolerance)."""
    x, w = _draw((G * E, C, D), 52), _draw((E, D, F), 53, D ** -0.5)
    g = _draw((G * E, C, F), 54)
    want = jax.grad(lambda xx, ww: jnp.sum(
        jops.moe_gmm(xx, jnp.tile(ww, (G, 1, 1))) * g), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = torch.autograd.grad(ops.moe_gmm(tx, tw, expert_period=E), (tx, tw),
                              torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-4, atol=1e-5)


def test_moe_gmm_edge_widths_route():
    """On the card these widths take the edge route in bf16, forward and
    backward, at any C (and 3xTF32 in f32)."""
    for G, E, C, D, F in GMM_SHAPES:
        for backward in (False, True):
            assert gmm_mod.route(torch.bfloat16, C, D, F, True,
                                 backward) == "wgmma_edge"
            assert gmm_mod.route(torch.float32, C, D, F, True,
                                 backward) == "tf32x3"


# ----------------------------------------------------------------------
# ssd_scan
# ----------------------------------------------------------------------
# (S, H, P, G, N, chunk)
SSD_SHAPES = [
    (128, 2, 50, 1, 100, 64),    # 100- and 200-byte rows: 4-, 8-byte pieces
    (96, 4, 49, 2, 77, 32),      # 2-byte rows, two groups, three chunks
    (128, 2, 56, 1, 120, 128),   # the odd train widths (TMA's padding)
]


def _ssd(S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, S, H, P)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((2, S, H))) * 0.3).astype(np.float32)
    b = (rng.standard_normal((2, S, G, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((2, S, G, N)) * 0.3).astype(np.float32)
    return x, a, b, c


@pytest.mark.parametrize("S,H,P,G,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_edge_widths_vs_jax(S, H, P, G, N, chunk, dtype):
    jdt, tdt = DTYPES[dtype]
    x, a, b, c = _ssd(S, H, P, G, N, 60)
    jy, jh = jops.ssd_scan(jnp.asarray(x).astype(jdt), jnp.asarray(a),
                           jnp.asarray(b).astype(jdt),
                           jnp.asarray(c).astype(jdt), chunk=chunk)
    ty, th = ops.ssd_scan(torch.from_numpy(x).to(tdt), torch.from_numpy(a),
                          torch.from_numpy(b).to(tdt),
                          torch.from_numpy(c).to(tdt), chunk=chunk)
    assert ty.dtype == tdt and th.shape == (2, H, N, P)
    np.testing.assert_allclose(_f32(ty), _f32(jy), **SSD_TOL[dtype])
    np.testing.assert_allclose(_f32(th), _f32(jh), **SSD_TOL[dtype])


@pytest.mark.parametrize("S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_scan_edge_widths_grads_vs_jax(S, H, P, G, N, chunk):
    """The four input gradients of sum(y gy) + sum(state gh) against
    jax.grad of JAX's op (the VJP of its oracle), f32."""
    x, a, b, c = _ssd(S, H, P, G, N, 61)
    gy, gh = _draw((2, S, H, P), 62), _draw((2, H, N, P), 63)

    def jloss(*t):
        y, h = jops.ssd_scan(*t, chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(t) for t in (x, a, b, c)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, a, b, c)]
    y, h = ops.ssd_scan(*ts, chunk=chunk)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (h * torch.from_numpy(gh)).sum(), ts)
    for name, g, w in zip("xabc", got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), err_msg=f"d{name}",
                                   **SSD_TOL["float32"])


@pytest.mark.parametrize("S,H,P,G,N,chunk", SSD_SHAPES)
def test_ssd_scan_edge_widths_route_and_meta(S, H, P, G, N, chunk):
    """bf16 at these widths (or one element off alignment) takes
    "tc_edge", with "tc"'s chunk rows, launches and saved tensors: on the
    meta device the op allocates as "tc" does."""
    x = torch.empty((2, S, H, P), dtype=torch.bfloat16, device="meta")
    b = torch.empty((2, S, G, N), dtype=torch.bfloat16, device="meta")
    assert ssd_mod.route(x, b, b) == "tc_edge"
    assert ssd_mod.kernel_rows(chunk, "tc_edge") == \
        ssd_mod.kernel_rows(chunk, "tc")
    y, hT, states, cb = ssd_mod._fwd_outputs(x, b, chunk, True)
    nc = -(-S // ssd_mod.kernel_rows(chunk, "tc_edge"))
    assert states.shape == (2, H, nc, ssd_mod.MAX_STATE * ssd_mod.MAX_HEAD_DIM)
    assert cb.shape == (2, nc, G, ssd_mod.MAX_CHUNK, ssd_mod.MAX_CHUNK)
    flat = torch.empty(2 * S * H * 64 + 1, dtype=torch.bfloat16,
                       device="meta")
    x64 = flat[1:].view(2, S, H, 64)
    b128 = torch.empty((2, S, G, 128), dtype=torch.bfloat16, device="meta")
    assert ssd_mod.route(x64, b128, b128) == "tc_edge"
