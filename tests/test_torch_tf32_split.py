"""3xTF32, the arithmetic of the f32 kernels' tensor-core products, on the
CPU: ``ref.tf32_round`` rounds as ``cvt.rna.tf32.f32`` does, and
``ref.matmul_3xtf32`` (big and small halves, three products) holds the
f32 tolerances of ``tests/test_kernels.py`` with margin against float64
and against the JAX package's oracles on the same numpy inputs, where a
single TF32 product does not: ``moe_gmm`` at depth 1024 (forward, dx,
dw) and attention (forward and gradients) at the reduced widths and at
head dims 80 and 128. Also the routes the wrappers choose before launch:
the 3xTF32 kernels for every f32 shape. The kernels themselves are held
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

GMM_TOL = 1e-4          # moe_gmm f32 (atol = rtol)
FWD_TOL = 3e-4          # flash attention forward, f32
GRAD_TOL = 1e-3         # flash attention gradients, f32
MARGIN = 4              # 3xTF32 must hold a quarter of each tolerance


def _draw(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _excess(got, want, tol):
    """max over elements of |got - want| / (tol + tol |want|): at most 1
    where the tolerance holds."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


# ----------------------------------------------------------------------
# the rounding
# ----------------------------------------------------------------------

def test_tf32_round_is_cvt_rna():
    """10 mantissa bits, to nearest, ties away from zero, carries into
    the exponent; inf and NaN pass; the dropped 13 bits are zero."""
    u = 2.0 ** -10                       # TF32's unit at 1
    x = torch.tensor([1.0, 1 + u / 2, 1 + u + u / 2, -(1 + u / 2),
                      1 + 0.75 * u, 1 + 0.25 * u, 2 - u / 2, 3.0,
                      float("inf"), float("-inf")])
    want = [1.0, 1 + u, 1 + 2 * u, -(1 + u), 1 + u, 1.0, 2.0, 3.0,
            float("inf"), float("-inf")]
    assert ref.tf32_round(x).tolist() == want
    assert torch.isnan(ref.tf32_round(torch.tensor([float("nan")]))).all()
    r = ref.tf32_round(torch.from_numpy(_draw((4096,), 0, 100.0)))
    assert not (r.view(torch.int32) & 0x1FFF).any()


def test_tf32_split_halves_sum_to_x():
    """big + small is x to about 2^-22 relative; big alone to 2^-11."""
    x = torch.from_numpy(_draw((1 << 14,), 1, 10.0))
    big, small = ref.tf32_split(x)
    rel = ((big + small).double() - x.double()).abs() / x.double().abs()
    assert rel.max().item() <= 2.0 ** -21
    assert ((big.double() - x.double()).abs()
            / x.double().abs()).max().item() <= 2.0 ** -11


# ----------------------------------------------------------------------
# moe_gmm at depth 1024
# ----------------------------------------------------------------------

def _gmm_3xtf32(x, w, period, mm):
    """out[z] = x[z] @ w[z mod period] through ``mm``."""
    G = x.shape[0] // period
    return mm(x.reshape(G, period, *x.shape[1:]), w).reshape(
        x.shape[0], x.shape[1], w.shape[2])


GMM_SHAPES = [
    # (Z, C, D, F, period): the training widths' depth 1024 (gate/up) and
    # its down product, grouped; the reduced widths
    (4, 96, 1024, 64, 2),
    (4, 96, 64, 1024, 2),
    (8, 40, 64, 32, 4),
]


@pytest.mark.parametrize("Z,C,D,F,P", GMM_SHAPES)
def test_moe_gmm_3xtf32_holds_f32_tolerance(Z, C, D, F, P):
    """Forward, dx = g w^T and dw = sum over groups of x^T g by 3xTF32
    against float64 and the JAX oracle, within a quarter of 1e-4 (dw, a
    sum of 192 products of about 14, reaches 0.08 of it, where a plain
    float32 matmul reaches 0.12-0.15)."""
    x = _draw((Z, C, D), 10)
    w = _draw((P, D, F), 11, D ** -0.5)
    g = _draw((Z, C, F), 12)
    tx, tw, tg = (torch.from_numpy(a) for a in (x, w, g))
    G = Z // P
    got = _gmm_3xtf32(tx, tw, P, ref.matmul_3xtf32).numpy()
    want = _gmm_3xtf32(tx.double(), tw.double(), P, torch.matmul).numpy()
    jw = np.tile(w, (G, 1, 1))
    oracle = np.asarray(jref.moe_gmm_ref(jnp.asarray(x), jnp.asarray(jw)))
    assert _excess(got, want, GMM_TOL) <= 1 / MARGIN
    assert _excess(got, oracle, GMM_TOL) <= 1 / MARGIN
    # the backward's products at their own depths (F for dx, G*C for dw)
    dx = _gmm_3xtf32(tg, tw.transpose(1, 2), P, ref.matmul_3xtf32)
    dx64 = _gmm_3xtf32(tg.double(), tw.double().transpose(1, 2), P,
                       torch.matmul)
    xt = tx.reshape(G, P, C, D).permute(1, 3, 0, 2).reshape(P, D, G * C)
    gt = tg.reshape(G, P, C, F).permute(1, 0, 2, 3).reshape(P, G * C, F)
    dw = ref.matmul_3xtf32(xt, gt)
    dw64 = xt.double() @ gt.double()
    _, vjp = jax.vjp(jref.moe_gmm_ref, jnp.asarray(x), jnp.asarray(jw))
    jdx, jdw = vjp(jnp.asarray(g))
    jdw = np.asarray(jdw).reshape(G, P, D, F).sum(0)
    assert _excess(dx.numpy(), dx64.numpy(), GMM_TOL) <= 1 / MARGIN
    assert _excess(dx.numpy(), np.asarray(jdx), GMM_TOL) <= 1 / MARGIN
    assert _excess(dw.numpy(), dw64.numpy(), GMM_TOL) <= 1 / MARGIN
    assert _excess(dw.numpy(), jdw, GMM_TOL) <= 1 / MARGIN


def test_one_tf32_product_fails_moe_gmm_tolerance():
    """A single TF32 product at depth 1024 misses 1e-4: why the split."""
    x = torch.from_numpy(_draw((2, 96, 1024), 20))
    w = torch.from_numpy(_draw((2, 1024, 64), 21, 1024 ** -0.5))
    one = ref.tf32_round(x) @ ref.tf32_round(w)
    want = x.double() @ w.double()
    assert _excess(one.numpy(), want.numpy(), GMM_TOL) > 1
    assert _excess((ref.matmul_3xtf32(x, w)).numpy(), want.numpy(),
                   GMM_TOL) <= 1 / MARGIN


# ----------------------------------------------------------------------
# attention: forward and gradients
# ----------------------------------------------------------------------

def _mask(S, causal, window):
    pos = torch.arange(S)
    m = torch.ones((S, S), dtype=torch.bool)
    if causal:
        m &= pos[None, :] <= pos[:, None]
    if window is not None:
        m &= pos[None, :] > pos[:, None] - window
    return m


def _attention_3xtf32(q, k, v, do, causal, window):
    """Forward and gradients with every product by 3xTF32 (f32 softmax):
    S = Q K^T, O = P V, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q,
    dS = P (dP - rowsum(dO O)); GQA sums dK and dV over the group."""
    mm = ref.matmul_3xtf32
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    group, scale = Hq // Hkv, D ** -0.5
    qh, doh = (t.permute(0, 2, 1, 3) for t in (q, do))
    kh, vh = (t.repeat_interleave(group, 2).permute(0, 2, 1, 3)
              for t in (k, v))
    s = (mm(qh, kh.transpose(-1, -2)) * scale).masked_fill(
        ~_mask(S, causal, window), float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    out = mm(p, vh)
    ds = p * (mm(doh, vh.transpose(-1, -2))
              - (doh * out).sum(-1, keepdim=True))
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale
    dv = mm(p.transpose(-1, -2), doh)

    def kv(t):
        return t.reshape(B, Hkv, group, S, D).sum(2).permute(0, 2, 1, 3)
    return (out.permute(0, 2, 1, 3), dq.permute(0, 2, 1, 3), kv(dk),
            kv(dv))


def _attention_f64(q, k, v, do, causal, window):
    """Forward and gradients in float64 (autograd)."""
    ts = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    qq, kk, vv = ts
    group = q.shape[2] // k.shape[2]
    kr, vr = (t.repeat_interleave(group, 2) for t in (kk, vv))
    s = torch.einsum("bqhd,bkhd->bhqk", qq, kr) * q.shape[3] ** -0.5
    s = s.masked_fill(~_mask(q.shape[1], causal, window), float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vr)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do).double())
    return (out.detach(), *grads)


ATTN_SHAPES = [
    # (B, S, Hq, Hkv, D, causal, window): the reduced widths (4 q over 2
    # kv heads of 16, and a window), hubert-xlarge's bidirectional head
    # dim 80, a GQA head dim 128
    (2, 64, 4, 2, 16, True, None),
    (2, 48, 4, 2, 16, True, 16),
    (1, 64, 4, 4, 80, False, None),
    (1, 64, 4, 2, 128, True, None),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", ATTN_SHAPES)
def test_attention_3xtf32_holds_f32_tolerances(B, S, Hq, Hkv, D, causal,
                                               window):
    """Output within a quarter of 3e-4 and dq, dk, dv within a quarter of
    1e-3 of float64 and of the JAX oracle (``attention_ref`` and its VJP)."""
    q = _draw((B, S, Hq, D), 30)
    k = _draw((B, S, Hkv, D), 31)
    v = _draw((B, S, Hkv, D), 32)
    do = _draw((B, S, Hq, D), 33)
    got = _attention_3xtf32(*(torch.from_numpy(a) for a in (q, k, v, do)),
                            causal, window)
    want = _attention_f64(q, k, v, do, causal, window)
    jout, vjp = jax.vjp(
        lambda a, b, c: jref.attention_ref(a, b, c, causal=causal,
                                           window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    oracle = (jout, *vjp(jnp.asarray(do)))
    for i, tol in enumerate((FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        assert _excess(got[i].numpy(), want[i].numpy(), tol) <= 1 / MARGIN
        assert _excess(got[i].numpy(), np.asarray(oracle[i]),
                       tol) <= 1 / MARGIN


# ----------------------------------------------------------------------
# the routes
# ----------------------------------------------------------------------

def _path_configs():
    for cfg in configs.ARCHS.values():
        yield cfg
        yield cfg.reduced()


def test_every_f32_attention_of_the_paths_takes_3xtf32():
    """Each arch's head dim, full width and reduced, and every flash case
    of chip_smoke.py is a width the f32 kernels take (at most 128); f32
    takes the 3xTF32 kernels and bf16 the wgmma ones."""
    dims = {cfg.head_dim for cfg in _path_configs()
            if any(slot[0] == "attn" for slot in cfg.pattern)}
    dims |= {case[6] for case in chip_smoke.FLASH_CASES}
    assert {16, 64, 80, 128} <= dims and max(dims) <= fa.MAX_HEAD_DIM
    assert fa.route(torch.float32) == "tf32x3"
    assert fa.route(torch.bfloat16) == "wgmma"


def test_every_f32_moe_gmm_takes_3xtf32():
    """Each MoE arch's expert products (d_model x moe_d_ff and back), full
    width and reduced, forward and backward, every chip_smoke.py moe_gmm
    case, and widths that are not whole 16-byte chunks or unaligned
    pointers take 3xTF32 in f32; only bf16 keeps FMA tiles for those."""
    shapes = {(cfg.d_model, cfg.moe_d_ff) for cfg in _path_configs()
              if cfg.moe_num_experts}
    assert (64, 32) in shapes and (1024, 512) in shapes
    shapes |= {case[3:5] for case in chip_smoke.GMM_CASES}
    assert (50, 70) in shapes
    for D, F in shapes:
        for a, b in ((D, F), (F, D)):
            for C in (8, 80, 1280):
                for aligned in (True, False):
                    for backward in (False, True):
                        assert gmm_mod.route(torch.float32, C, a, b, aligned,
                                             backward) == "tf32x3"
    assert gmm_mod.route(torch.bfloat16, 64, 48, 72, True) == "wgmma"
    assert gmm_mod.route(torch.bfloat16, 32, 48, 72, True) == "wgmma_decode"
    assert gmm_mod.route(torch.bfloat16, 32, 48, 72, True,
                         backward=True) == "wgmma"
    assert gmm_mod.route(torch.bfloat16, 64, 44, 72, True) == "fma"
    assert gmm_mod.route(torch.bfloat16, 64, 48, 72, False) == "fma"


def test_f32_order_alone_misses_moe_gmm_tolerance_at_dw_depth():
    """Why the card holds f32 moe_gmm against float64: dw at the training
    shape sums G*C = 2560 products of unit size, and a sequential f32 sum
    of such (the plain version's order) is off the exact sum by more than
    1e-4 (1 + |exact|) wherever |exact| < 0.5, as about 132 thousand of
    dw's 16.7 million elements are; the kernels' scheme (8-deep partial
    sums added in float64) stays within a quarter of it."""
    g = torch.Generator().manual_seed(0)
    N, K = 40_000, 2560
    seq = torch.zeros(N)
    exact = torch.zeros(N, dtype=torch.float64)
    sliced = torch.zeros(N, dtype=torch.float64)
    for _ in range(K // 64):
        t = torch.randn(N, 64, generator=g) * torch.randn(N, 64, generator=g)
        for j in range(64):
            seq += t[:, j]
        exact += t.double().sum(1)
        sliced += t.reshape(N, 8, 8).sum(2).double().sum(1)
    seq_err = (seq.double() - exact).abs().max().item()
    assert seq_err > GMM_TOL * 1.5
    assert _excess(sliced.numpy(), exact.numpy(), GMM_TOL) <= 1 / MARGIN
