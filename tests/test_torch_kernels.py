"""Port parity: repro_torch's kernel wrappers and plain versions against
the JAX package's kernels (Pallas in interpret mode) and oracles, on the
same numpy inputs, on the CPU. The kernels themselves run on the card in
chip_smoke.py and in the ``cuda``-marked test below."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed, dtype, scale=1.0):
    """One numpy draw, cast the same way (round to nearest even) by both."""
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------------------
# moe_gmm
# ----------------------------------------------------------------------

@pytest.mark.parametrize("E,C,D,F", [(4, 128, 64, 128), (8, 64, 128, 64),
                                     (2, 100, 48, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_vs_jax(E, C, D, F, dtype):
    jx, tx = _inputs((E, C, D), 0, dtype)
    jw, tw = _inputs((E, D, F), 1, dtype)
    want = jops.moe_gmm(jx, jw, block_c=64, block_f=64, block_d=32)
    got = ops.moe_gmm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (E, C, F)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("G,E,C,D,F", [(2, 4, 16, 32, 24), (3, 2, 100, 48,
                                                            72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_grouped_period_vs_tiled_jax(G, E, C, D, F, dtype):
    """x (G·E, C, D) with shared w (E, D, F) equals JAX's call on the
    weights tiled G times (layers.py's kernel path)."""
    jx, tx = _inputs((G * E, C, D), 2, dtype)
    jw, tw = _inputs((E, D, F), 3, dtype)
    want = jops.moe_gmm(jx, jnp.tile(jw, (G, 1, 1)))
    got = ops.moe_gmm(tx, tw, expert_period=E)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_moe_gmm_cpu_takes_plain_version_without_launch():
    _, tx = _inputs((4, 10, 8), 4, "float32")
    _, tw = _inputs((2, 8, 6), 5, "float32")
    before = gmm_mod.launches
    got = ops.moe_gmm(tx, tw, expert_period=2)
    assert gmm_mod.launches == before
    assert torch.equal(got, gmm_mod.moe_gmm_plain(tx, tw, 2))
    want = torch.cat([ref.moe_gmm_ref(tx[:2], tw), ref.moe_gmm_ref(tx[2:],
                                                                  tw)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["rank", "depth", "period", "dtype",
                                  "mixed"])
def test_moe_gmm_rejects_bad_inputs(case):
    x = torch.zeros(4, 8, 16)
    w = torch.zeros(4, 16, 32)
    kwargs = {}
    if case == "rank":
        x = x[0]
    elif case == "depth":
        w = torch.zeros(4, 12, 32)
    elif case == "period":
        w = torch.zeros(3, 16, 32)
        kwargs = dict(expert_period=3)
    elif case == "dtype":
        x, w = x.double(), w.double()
    else:
        w = w.bfloat16()
    with pytest.raises((ValueError, TypeError)):
        ops.moe_gmm(x, w, **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_kernel_on_card(dtype):
    """The CUDA kernel against its plain version (ragged and grouped)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((6, 100, 48), generator=g, device="cuda").to(dtype)
    w = (torch.randn((3, 48, 72), generator=g, device="cuda") / 7).to(dtype)
    before = gmm_mod.launches
    got = ops.moe_gmm(x, w, expert_period=3)
    assert gmm_mod.launches == before + 1
    want = gmm_mod.moe_gmm_plain(x, w, 3)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# plain versions (refs)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(64, 128), (31, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_vs_jax(rows, d, dtype):
    jx, tx = _inputs((rows, d), 6, dtype)
    jw, tw = _inputs((d,), 7, dtype)
    got = ref.rmsnorm_ref(tx, tw, 1e-5)
    want = jref.rmsnorm_ref(jx, jw, 1e-5)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,causal,window,off", [
    (16, 16, 4, 2, True, None, 0),      # GQA causal (training)
    (16, 16, 4, 4, False, None, 0),     # bidirectional (encoder)
    (16, 16, 4, 1, True, 5, 0),         # sliding window, MQA
    (1, 24, 4, 2, True, None, 9),       # decode over a longer cache
    (6, 24, 4, 2, True, None, 3),       # prefill into a cache at offset
])
def test_attention_ref_vs_jax(Sq, Skv, Hq, Hkv, causal, window, off):
    jq, tq = _inputs((2, Sq, Hq, 16), 8, "float32")
    jk, tk = _inputs((2, Skv, Hkv, 16), 9, "float32")
    jv, tv = _inputs((2, Skv, Hkv, 16), 10, "float32")
    got = ref.attention_ref(tq, tk, tv, causal=causal, window=window,
                            kv_offset=off)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=window,
                              kv_offset=off)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(32, 8), (30, 8)])
def test_attention_chunked_ref_vs_jax(S, chunk):
    jq, tq = _inputs((1, S, 4, 8), 11, "float32")
    jk, tk = _inputs((1, S, 2, 8), 12, "float32")
    jv, tv = _inputs((1, S, 2, 8), 13, "float32")
    got = ref.attention_chunked_ref(tq, tk, tv, window=12, chunk=chunk)
    want = jref.attention_chunked_ref(jq, jk, jv, window=12, chunk=chunk)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------
# flash attention (CPU: the wrapper's plain route against the Pallas
# kernel in interpret mode; gradients against jax.grad of the JAX op)
# ----------------------------------------------------------------------

def _qkv(B, Sq, Skv, Hq, Hkv, D, dtype, seed):
    jq, tq = _inputs((B, Sq, Hq, D), seed, dtype)
    jk, tk = _inputs((B, Skv, Hkv, D), seed + 1, dtype)
    jv, tv = _inputs((B, Skv, Hkv, D), seed + 2, dtype)
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("S,Hq,Hkv,D,causal", [
    (128, 4, 4, 32, True),       # MHA causal
    (256, 8, 2, 64, True),       # GQA causal
    (256, 8, 2, 64, False),      # bidirectional (encoder)
    (128, 6, 3, 48, True),       # non-pow2 heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_vs_jax(S, Hq, Hkv, D, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, S, S, Hq, Hkv, D, dtype, 20)
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 3e-4 if dtype == "float32" else 3e-2      # test_kernels.py:63
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_attention_window_vs_jax():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 256, 256, 4, 4, 32, "float32", 23)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=64)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=64)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("off", [0, 9, 100, 192])
def test_flash_attention_decode_offsets_vs_jax(off):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 1, 256, 4, 2, 32, "float32", off)
    want = jops.flash_attention(jq, jk, jv, causal=True, kv_offset=off,
                                block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=True, kv_offset=off)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,causal,window,off", [
    (64, 64, 4, 2, True, None, 0),
    (64, 64, 4, 4, False, None, 0),
    (64, 64, 4, 1, True, 16, 0),
    (1, 24, 4, 2, True, None, 9),
])
def test_flash_attention_grads_vs_jax(Sq, Skv, Hq, Hkv, causal, window,
                                      off):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, Sq, Skv, Hq, Hkv, 16, "float32", 30)
    _, tg = _inputs((2, Sq, Hq, 16), 33, "float32")
    jg = jnp.asarray(tg.numpy())

    def jloss(q, k, v):
        o = jops.flash_attention(q, k, v, causal=causal, window=window,
                                 kv_offset=off, block_q=Sq, block_k=Skv)
        return jnp.sum(o * jg)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*ts, causal=causal, window=window,
                              kv_offset=off)
    got = torch.autograd.grad(out, ts, tg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["rank", "heads", "dtype"])
def test_flash_attention_rejects_bad_inputs(case):
    q, k = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    if case == "rank":
        q = q[0]
    elif case == "heads":
        k = torch.zeros(1, 8, 3, 16)
    else:
        q = q.double()
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, k)


# ----------------------------------------------------------------------
# moe_gmm gradients, rmsnorm wrapper
# ----------------------------------------------------------------------

def test_moe_gmm_grads_vs_jax():
    """test_kernels.py:174-180: dx and dw of the wrapper against jax.grad
    of the JAX op (the VJP of the oracle)."""
    jx, tx = _inputs((2, 64, 32), 40, "float32")
    jw, tw = _inputs((2, 32, 64), 41, "float32")
    _, tg = _inputs((2, 64, 64), 42, "float32")
    jg = jnp.asarray(tg.numpy())
    want = jax.grad(lambda x, w: jnp.sum(jops.moe_gmm(x, w) * jg),
                    argnums=(0, 1))(jx, jw)
    x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    got = torch.autograd.grad(ops.moe_gmm(x, w), (x, w), tg)
    for g, wa in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(wa), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("G,E,C,D,F", [(2, 4, 16, 32, 24), (3, 2, 10, 8, 12),
                                       (2, 3, 100, 24, 40)])
def test_moe_gmm_grouped_period_grads_vs_tiled_jax(G, E, C, D, F):
    """With shared expert weights, dw sums over the groups: the gradient
    of JAX's call on weights tiled G times, summed over the tiles. C 100
    is ragged against the card's 64-row steps of dw's group walk; this
    holds the plain version that the card compares the kernel against."""
    jx, tx = _inputs((G * E, C, D), 43, "float32")
    jw, tw = _inputs((E, D, F), 44, "float32")
    _, tg = _inputs((G * E, C, F), 45, "float32")
    jg = jnp.asarray(tg.numpy())
    want = jax.grad(lambda x, w: jnp.sum(
        jops.moe_gmm(x, jnp.tile(w, (G, 1, 1))) * jg), argnums=(0, 1))(jx, jw)
    x, w = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    got = torch.autograd.grad(ops.moe_gmm(x, w, expert_period=E), (x, w), tg)
    for g, wa in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(wa), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rows,d", [(64, 128), (256, 512), (31, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_wrapper_vs_jax(rows, d, dtype):
    jx, tx = _inputs((rows, d), 50, dtype)
    jw, tw = _inputs((d,), 51, dtype)
    want = jops.rmsnorm(jx, jw)
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2      # test_kernels.py:30
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_rmsnorm_grad_vs_jax():
    jx, tx = _inputs((128, 64), 52, "float32")
    jw = jnp.ones((64,))
    want = jax.grad(lambda x: jops.rmsnorm(x, jw).sum())(jx)
    x = tx.clone().requires_grad_()
    got, = torch.autograd.grad(ops.rmsnorm(x, torch.ones(64)).sum(), x)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-5)


def test_layers_rmsnorm_use_kernel_flag():
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.models import layers
    _, tx = _inputs((4, 6, 32), 53, "float32")
    _, tw = _inputs((32,), 54, "float32")
    before = rms_mod.launches
    a = layers.rmsnorm(tx, tw, 1e-5)
    b = layers.rmsnorm(tx, tw, 1e-5, use_kernel=True)
    assert rms_mod.launches == before          # CPU: the plain version
    assert torch.equal(a, b)
