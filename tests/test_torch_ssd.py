"""Port parity: the Mamba2 SSD plain versions (``ssd_ref``,
``ssd_chunked_ref``) and the ``ssd_scan`` op against the JAX package's, on
the same numpy inputs, on the CPU. The JAX op runs its Pallas kernel in
interpret mode; its gradient is the VJP of the sequential oracle. The
port's CUDA kernels run on the card in chip_smoke.py and in
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402

# tests/test_kernels.py's SSD tolerances (f32)
TOL = dict(rtol=2e-3, atol=2e-4)
# test_kernels.py:107-121's shapes: (S, H, P, G, N, chunk)
SHAPES = [(128, 2, 16, 1, 8, 32), (256, 4, 32, 2, 16, 64),
          (64, 2, 16, 2, 8, 64)]


def _ssd_inputs(B, S, H, P, G, N, seed, a_scale=0.3, dtype=np.float32):
    """x, a (<= 0), b, c, h0 as numpy, scaled as test_kernels.py's."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(dtype)
    a = (-np.abs(rng.standard_normal((B, S, H))) * a_scale).astype(
        np.float32)
    b = (rng.standard_normal((B, S, G, N)) * 0.3).astype(dtype)
    c = (rng.standard_normal((B, S, G, N)) * 0.3).astype(dtype)
    h0 = (rng.standard_normal((B, H, N, P)) * 0.3).astype(np.float32)
    return x, a, b, c, h0


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("S,H,P,G,N,chunk", SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_ref_and_chunked_ref_vs_jax(S, H, P, G, N, chunk, with_h0):
    x, a, b, c, h0 = _ssd_inputs(2, S, H, P, G, N, 0)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    jy, jh = jref.ssd_ref(*_j(x, a, b, c), h0=jh0, return_state=True)
    ty, th = ref.ssd_ref(*_t(x, a, b, c), h0=th0, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    jy, jh = jref.ssd_chunked_ref(*_j(x, a, b, c), h0=jh0, chunk=chunk,
                                  return_state=True)
    ty, th = ref.ssd_chunked_ref(*_t(x, a, b, c), h0=th0, chunk=chunk,
                                 return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_ssd_decode_continues_a_chunked_prefill():
    """Chunked prefill with its carried state, then single steps, equals
    the JAX package's sequential scan over the whole sequence."""
    x, a, b, c, _ = _ssd_inputs(1, 72, 2, 16, 1, 8, 1)
    want = np.asarray(jref.ssd_ref(*_j(x, a, b, c)))
    tx, ta, tb, tc = _t(x, a, b, c)
    y, h = ref.ssd_chunked_ref(tx[:, :64], ta[:, :64], tb[:, :64],
                               tc[:, :64], chunk=16, return_state=True)
    ys = [y]
    for t in range(64, 72):
        sl = slice(t, t + 1)
        y, h = ref.ssd_ref(tx[:, sl], ta[:, sl], tb[:, sl], tc[:, sl], h0=h,
                           return_state=True)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("S,H,P,G,N,chunk", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_op_vs_jax_kernel(S, H, P, G, N, chunk, dtype):
    x, a, b, c, _ = _ssd_inputs(2, S, H, P, G, N, 2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jx, ja, jb, jc = _j(x, a, b, c)
    jy, jh = jops.ssd_scan(jx.astype(jdt), ja, jb.astype(jdt),
                           jc.astype(jdt), chunk=chunk)
    tx, ta, tb, tc = _t(x, a, b, c)
    before = (ssd_mod.fwd_launches, ssd_mod.bwd_launches)
    ty, th = ops.ssd_scan(tx.to(tdt), ta, tb.to(tdt), tc.to(tdt),
                          chunk=chunk)
    assert (ssd_mod.fwd_launches, ssd_mod.bwd_launches) == before
    assert ty.dtype == tdt and th.dtype == torch.float32
    assert ty.shape == (2, S, H, P) and th.shape == (2, H, N, P)
    tol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)


def _grads_vs_jax(x, a, b, c, chunk, seed):
    """d/d(x, a, b, c) of sum(y * gy) + sum(state * gh) through both ops."""
    rng = np.random.default_rng(seed)
    B, S, H, P = x.shape
    N = b.shape[3]
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, N, P)).astype(np.float32)

    def jloss(xx, aa, bb, cc):
        y, h = jops.ssd_scan(xx, aa, bb, cc, chunk=chunk)
        return jnp.sum(y * gy) + jnp.sum(h * gh)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*_j(x, a, b, c))
    ts = [t.requires_grad_() for t in _t(x, a, b, c)]
    y, h = ops.ssd_scan(*ts, chunk=chunk)
    loss = (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum()
    got = torch.autograd.grad(loss, ts)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("S,H,P,G,N,chunk", SHAPES)
def test_ssd_scan_grads_vs_jax_grad(S, H, P, G, N, chunk):
    got, want = _grads_vs_jax(*_ssd_inputs(2, S, H, P, G, N, 3)[:4], chunk,
                              4)
    for name, g, w in zip("xabc", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_ssd_scan_ragged_sequence_vs_jax():
    """S % chunk != 0: the JAX op takes its oracle, the port its plain
    version (on the card, the kernel masks the partial chunk)."""
    x, a, b, c, _ = _ssd_inputs(2, 100, 4, 16, 2, 8, 5)
    jy, jh = jops.ssd_scan(*_j(x, a, b, c), chunk=32)
    ty, th = ops.ssd_scan(*_t(x, a, b, c), chunk=32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    got, want = _grads_vs_jax(x, a, b, c, 32, 6)
    for name, g, w in zip("xabc", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("chunk", [16, 100])
def test_ssd_scan_grads_finite_at_large_decay(chunk):
    """|a| up to ~60 a step: the upper triangle's exp would overflow if
    it were taken before the mask; the gradients stay finite."""
    x, a, b, c, _ = _ssd_inputs(1, 100 if chunk == 100 else 64, 2, 8, 1, 4,
                                7, a_scale=40.0)
    ts = [t.requires_grad_() for t in _t(x, a, b, c)]
    y, h = ops.ssd_scan(*ts, chunk=chunk)
    grads = torch.autograd.grad(y.sum() + h.sum(), ts)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for g in grads:
        assert torch.isfinite(g).all()


def test_ssd_scan_rejects_bad_inputs():
    x, a, b, c, _ = _t(*_ssd_inputs(1, 16, 3, 4, 2, 4, 8))
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(x, a, b, c)                    # H 3 over G 2
    x, a, b, c, _ = _t(*_ssd_inputs(1, 16, 2, 4, 1, 4, 8))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, a[:, :8], b, c)
    with pytest.raises(ValueError):
        ssd_mod.kernel_chunk(0)
    assert ssd_mod.kernel_chunk(128) == ssd_mod.MAX_CHUNK == 128
    assert ssd_mod.kernel_chunk(16) == 16
