"""Attention split along its keys (the port's route where the stored KV
heads do not divide the model axis): the blocks' (out, lse) merged by
``merge_blocks`` equal whole attention, forward and backward, on the
CPU.

Each case cuts K/V into n blocks along the sequence, runs
``attention_lse_ref`` on each block at its own ``kv_offset`` (q[0]'s
position less the block's first key's: negative past the first block)
and merges the blocks, as each rank does over its block. It is held
against the port's whole attention (``attention_lse_ref`` over all keys,
whose convention for a row that sees no key is the kernel's: out 0, lse
-inf) and, on the rows that see a key, against the JAX package's
``repro.kernels.ref.attention_ref`` on the same numpy inputs (which
gives NaN on the others). Tolerances are ``tests/test_kernels.py``'s for
f32 attention: 3e-4 (rtol and atol) on outputs, 1e-4 / 1e-5 on
gradients; lse rtol 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.distributed import merge_blocks  # noqa: E402

OUT_TOL = 3e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _inputs(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                      (B, Sq, Hq, D))]


def _blocks(q, k, v, n, **kw):
    """(out, lse) of each of n key blocks, stacked along a new dim 0."""
    L = k.shape[1] // n
    off = kw.pop("kv_offset")
    parts = [ref.attention_lse_ref(q, k[:, r * L:(r + 1) * L],
                                   v[:, r * L:(r + 1) * L],
                                   kv_offset=off - r * L, **kw)
             for r in range(n)]
    return (torch.stack([o for o, _ in parts]),
            torch.stack([l for _, l in parts]))


def _seen(Sq, Skv, causal, window, off):
    """Which query rows see at least one key."""
    pos = np.arange(Sq) + off
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv)
    lo = np.maximum(0, pos - window + 1) if window is not None else 0
    return hi > lo


@settings(max_examples=25, deadline=None, derandomize=True)
@given(B=st.integers(1, 2), Sq=st.integers(1, 24), L=st.integers(1, 8),
       n=st.integers(1, 5), Hkv=st.integers(1, 3), group=st.integers(1, 3),
       D=st.sampled_from([8, 16]), causal=st.sampled_from([True, False]),
       window=st.sampled_from([None, 1, 4, 9]), off=st.integers(-12, 30),
       seed=st.integers(0, 2**16))
def test_block_merge_equals_whole_attention(B, Sq, L, n, Hkv, group, D,
                                            causal, window, off, seed):
    Skv = L * n
    qn, kn, vn, _ = _inputs(B, Sq, Skv, Hkv * group, Hkv, D, seed)
    q, k, v = map(torch.from_numpy, (qn, kn, vn))
    kw = dict(causal=causal, window=window, kv_offset=off)
    out, lse = merge_blocks(*_blocks(q, k, v, n, **kw))
    want, want_lse = ref.attention_lse_ref(q, k, v, **kw)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)
    seen = _seen(Sq, Skv, causal, window, off)
    assert np.isneginf(lse.numpy()[..., ~seen]).all()
    assert (out.numpy()[:, ~seen] == 0).all()
    np.testing.assert_allclose(lse.numpy()[..., seen],
                               want_lse.numpy()[..., seen], rtol=1e-5,
                               atol=1e-5)
    # the whole lse is the logsumexp of the visible scores
    s = np.einsum("bqhd,bkhd->bhqk", qn, np.repeat(kn, group, axis=2)) \
        * D ** -0.5
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= np.arange(Skv)[None] <= (np.arange(Sq) + off)[:, None]
    if window is not None:
        mask &= np.arange(Skv)[None] > (np.arange(Sq) + off)[:, None] \
            - window
    s = np.where(mask, s, -np.inf)[..., seen, :]
    if seen.any():
        m = s.max(-1, keepdims=True)
        np.testing.assert_allclose(
            lse.numpy()[..., seen],
            (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0],
            rtol=1e-5, atol=1e-5)
        jwant = np.asarray(jref.attention_ref(
            jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), **kw))
        np.testing.assert_allclose(out.numpy()[:, seen], jwant[:, seen],
                                   rtol=OUT_TOL, atol=OUT_TOL)


@settings(max_examples=15, deadline=None, derandomize=True)
@given(Sq=st.integers(1, 20), L=st.integers(1, 6), n=st.integers(2, 4),
       Hkv=st.integers(1, 2), group=st.integers(1, 3),
       causal=st.sampled_from([True, False]),
       window=st.sampled_from([None, 3]), off=st.integers(-8, 16),
       seed=st.integers(0, 2**16))
def test_merged_backward_equals_whole_attention(Sq, L, n, Hkv, group, causal,
                                                window, off, seed):
    """Gradients through the merge (and through the merged lse) equal
    autograd through whole attention; rows that see no key get zero."""
    Skv = L * n
    arrays = _inputs(2, Sq, Skv, Hkv * group, Hkv, 16, seed)
    g = torch.from_numpy(arrays[3])
    g_lse = torch.from_numpy(np.random.default_rng(seed + 1)
                             .standard_normal((2, Hkv * group, Sq))
                             .astype(np.float32))
    kw = dict(causal=causal, window=window, kv_offset=off)

    def loss(out, lse):
        return (out * g).sum() + torch.where(torch.isfinite(lse),
                                             lse * g_lse, 0.0).sum()

    def grads(split):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
        if split:
            res = merge_blocks(*_blocks(*ts, n, **dict(kw)))
        else:
            res = ref.attention_lse_ref(*ts, **kw)
        return torch.autograd.grad(loss(*res), ts)
    for got, want in zip(grads(True), grads(False)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("causal,window,off", [
    (True, None, 0), (False, None, 0), (True, 5, 0), (True, None, 9)])
def test_merged_backward_equals_jax(causal, window, off):
    """Where every row sees a key: the gradients of the merged blocks
    equal JAX's autograd through its ``attention_ref``."""
    import jax
    n, Sq, Skv = 4, 16, 24
    qn, kn, vn, gn = _inputs(2, Sq, Skv, 4, 2, 16, 40)
    kw = dict(causal=causal, window=window, kv_offset=off)
    want = jax.grad(lambda q, k, v: jnp.sum(jref.attention_ref(
        q, k, v, **kw) * gn), argnums=(0, 1, 2))(
        *map(jnp.asarray, (qn, kn, vn)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
    out, _ = merge_blocks(*_blocks(*ts, n, **kw))
    got = torch.autograd.grad(out, ts, torch.from_numpy(gn))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_chunked_lse_ref_equals_lse_ref():
    arrays = _inputs(1, 64, 64, 4, 2, 16, 50)
    q, k, v = map(torch.from_numpy, arrays[:3])
    for off in (0, -40):
        got = ref.attention_chunked_lse_ref(q, k, v, window=12,
                                            kv_offset=off, chunk=16)
        want = ref.attention_lse_ref(q, k, v, window=12, kv_offset=off)
        np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(np.isneginf(got[1].numpy()),
                                      np.isneginf(want[1].numpy()))


def test_split_wrapper_on_cpu_is_the_plain_route():
    """``flash_attention_split`` on CPU tensors: the plain (out, lse) and
    the caller's merge; with one block it is whole attention."""
    arrays = _inputs(2, 16, 16, 4, 2, 16, 60)
    q, k, v = map(torch.from_numpy, arrays[:3])
    got = ops.flash_attention_split(
        q, k, v, lambda o, l: merge_blocks(o[None], l[None]),
        causal=True, kv_offset=0)
    want = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("S,n,window", [(4096, 16, None), (32768, 16, None),
                                        (1000, 8, 100), (64, 4, None)])
def test_kernel_flop_formula_splits_the_pairs(S, n, window):
    """The kernel's FLOP formula counts each block's visible pairs (its
    clamp holds for negative offsets): summed over the blocks they are
    the whole's, and under a causal mask the first block holds the most
    (every row sees it), the last the fewest."""
    L = S // n
    pairs = [fa.score_pairs(S, L, True, window, -r * L) for r in range(n)]
    assert sum(pairs) == fa.score_pairs(S, S, True, window, 0)
    if window is None:
        assert pairs == sorted(pairs, reverse=True)
        assert pairs[-1] == L * (L + 1) // 2


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_split_route_runs_on_placeholder_ranks(impl, tmp_path):
    """Reduced qwen3-14b (4 q over 2 kv heads) on the placeholder (16,16)
    mesh: its K/V split along the sequence, a training step runs through
    the plain route and through the kernels' ops on meta tensors
    (``flash_attention_split``: forward op, the merge's all-reduces on
    the fake process group, backward op), and the merge's all-reduces
    are counted."""
    from repro_torch import configs
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(
        "qwen3-14b", "train_4k", "single", skip_existing=False,
        verbose=False, out_dir=str(tmp_path),
        cfg=configs.get("qwen3-14b").reduced(),
        shape_spec=ShapeSpec("train_4k", 512, 32, "train"),
        micro_override=2, cfg_overrides=dict(attn_impl=impl), variant=impl)
    assert rec["status"] == "ok"
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
