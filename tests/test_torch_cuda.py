"""The port's kernels on the card: each kernel (forward and backward)
against its plain version, with its launch counter; the dense layer slot
in bf16 against float32, a checkpoint round trip of a card model, and
the simulator's kernel on the golden fixture's 25 keys.
Marked ``cuda``;
they skip on a host without a CUDA device. This file imports no JAX, so
it runs where only PyTorch is installed:

    REPRO_SIM_CACHE=0 PYTHONPATH=src python -m pytest -q -m cuda \
        tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,Hq,Hkv,D,causal,window,off", [
    (100, 100, 4, 2, 32, True, None, 0),
    (130, 130, 6, 3, 48, True, 64, 0),
    (96, 96, 4, 4, 128, False, None, 0),
    (1, 24, 4, 2, 64, True, None, 9),
    # the bf16 kernels' tile edges: interior and diagonal tiles, a partial
    # last q tile, the 128-wide tiles, zero-padded columns (D 48), the
    # element-load variant (D 36), chunked prefill, a window off the tile
    # grid
    (1024, 1024, 16, 8, 64, True, None, 0),
    (1000, 1000, 16, 8, 64, True, None, 0),
    (512, 512, 8, 4, 128, True, None, 0),
    (300, 300, 6, 3, 48, True, None, 0),
    (200, 200, 4, 2, 36, True, None, 0),
    (64, 320, 8, 4, 64, True, None, 256),
    (700, 700, 8, 2, 64, True, 200, 0),
    (384, 384, 4, 4, 128, False, None, 0),
    # the dense training paths' head layouts: qwen2.5-3b's GQA 16/2 at
    # head dim 128, stablelm-1.6b's MHA 32/32 at 64
    (512, 512, 16, 2, 128, True, None, 0),
    (512, 512, 32, 32, 64, True, None, 0),
    # hubert-xlarge's: bidirectional MHA 16/16 at head dim 80 (the D-128
    # tiles with 48 padded columns), and a ragged edge
    (512, 512, 16, 16, 80, False, None, 0),
    (300, 300, 4, 4, 80, False, None, 0),
    # the f32 kernels' tiles (64 q rows; 64 or 32 keys in the forward and
    # dQ passes, 64 keys and 64, 32 or 16 q rows in dK/dV): S at a tile's
    # edge -1, +0, +1 at the reduced head dim 16, at 64 and at 96 and 128,
    # and head dim 30 (rows not whole 16-byte chunks: element loads)
    (63, 63, 4, 2, 16, True, None, 0),
    (64, 64, 4, 2, 16, True, None, 0),
    (65, 65, 4, 2, 16, False, None, 0),
    (127, 127, 4, 2, 64, True, None, 0),
    (128, 128, 4, 1, 64, True, None, 0),
    (129, 129, 4, 2, 64, False, None, 0),
    (95, 95, 4, 4, 96, True, None, 0),
    (97, 97, 4, 2, 128, True, 40, 0),
    (50, 50, 2, 1, 30, True, None, 0),
])
def test_flash_attention_kernel_on_card(dtype, Sq, Skv, Hq, Hkv, D, causal,
                                        window, off):
    """Forward and backward kernels against the plain version's autograd."""
    from repro_torch.kernels import flash_attention as fa
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, Sq, Hq, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((2, Skv, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((2, Skv, Hkv, D), generator=g, device="cuda").to(dtype)
    do = torch.randn((2, Sq, Hq, D), generator=g, device="cuda").to(dtype)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.fwd_launches, fa.bwd_launches)
    kind = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    routed = fa.route_launches[kind]
    out = ops.flash_attention(*ts, causal=causal, window=window,
                              kv_offset=off)
    got = torch.autograd.grad(out, ts, do)
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 3)
    assert fa.route_launches[kind] == routed + 4
    rs = [t.float().requires_grad_() for t in (q, k, v)]
    ref_out = fa.flash_attention_plain(*rs, causal=causal, window=window,
                                       kv_offset=off)
    want = torch.autograd.grad(ref_out, rs, do.float())
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref_out, rtol=tol, atol=tol)
    gtol = 1e-3 if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b, rtol=gtol, atol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_repeats_bits(dtype):
    """The backward has no atomics: two runs give the same bits."""
    from repro_torch.kernels import flash_attention as fa
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, 1000, 16, 64), generator=g, device="cuda").to(dtype)
    k = torch.randn((2, 1000, 8, 64), generator=g, device="cuda").to(dtype)
    v = torch.randn((2, 1000, 8, 64), generator=g, device="cuda").to(dtype)
    do = torch.randn((2, 1000, 16, 64), generator=g, device="cuda").to(dtype)
    args = (True, 0.125, None, 0)
    out, lse = fa.flash_attention_fwd(q, k, v, *args)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, *args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_wide_heads():
    _card()
    q = torch.zeros((1, 8, 4, 160), device="cuda")
    k = torch.zeros((1, 8, 2, 160), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, k, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D,offset", [
    (31, 96, 0),
    # the widths the ten architectures normalise, at a few rows; 1001 and
    # 77 rows fill no "bulk" tile of any width (tiles hold a power of two
    # rows); D 128 and 96 take "vector" (rows of at most 512 bytes)
    (8, 1280, 0), (4, 4096, 0), (4, 5120, 0), (2, 8192, 0), (40, 128, 0),
    (1001, 1024, 0), (77, 8192, 0), (1001, 128, 0), (333, 2048, 0),
    # the "plain" route: rows not whole 16-byte vectors, and x one element
    # off 16-byte alignment
    (33, 50, 0), (1001, 1024, 1),
])
def test_rmsnorm_kernel_on_card(dtype, rows, D, offset):
    from repro_torch.kernels import rmsnorm as rms_mod
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    buf = torch.randn((rows * D + offset,), generator=g, device="cuda")
    x = buf.to(dtype)[offset:].view(rows, D)
    w = torch.randn((D,), generator=g, device="cuda").to(dtype)
    row_bytes = D * x.element_size()
    kind = ("plain" if offset or row_bytes % 16 else
            "vector" if row_bytes <= 512 else "bulk")
    assert rms_mod.route(x, w) == kind
    before = rms_mod.launches
    routed = dict(rms_mod.route_launches)
    got = ops.rmsnorm(x, w, 1e-5)
    assert rms_mod.launches == before + 1
    assert {k: v - routed[k] for k, v in rms_mod.route_launches.items()} \
        == {k: int(k == kind) for k in routed}
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               rms_mod.rmsnorm_plain(x, w, 1e-5).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_backward_kernel_on_card(dtype):
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((6, 40, 48), generator=g, device="cuda").to(dtype)
    w = (torch.randn((3, 48, 24), generator=g, device="cuda") / 7).to(dtype)
    gy = torch.randn((6, 40, 24), generator=g, device="cuda").to(dtype)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (gmm_mod.launches, gmm_mod.bwd_launches)
    kind = "tf32x3" if dtype == torch.float32 else "wgmma"
    routed = gmm_mod.route_launches[kind]
    got = torch.autograd.grad(ops.moe_gmm(xs, ws, 3), (xs, ws), gy)
    assert (gmm_mod.launches, gmm_mod.bwd_launches) == (before[0] + 1,
                                                        before[1] + 2)
    assert gmm_mod.route_launches[kind] == routed + 3
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(gmm_mod.moe_gmm_plain(xr, wr, 3), (xr, wr), gy)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_forward_kernel_on_card(dtype):
    """Ragged and grouped forward, one counted launch."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((6, 100, 48), generator=g, device="cuda").to(dtype)
    w = (torch.randn((3, 48, 72), generator=g, device="cuda") / 7).to(dtype)
    before = gmm_mod.launches
    got = ops.moe_gmm(x, w, expert_period=3)
    assert gmm_mod.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(),
                               gmm_mod.moe_gmm_plain(x, w, 3).float(),
                               rtol=tol, atol=tol)


def _offset(t, off):
    """t's values in a contiguous tensor whose data starts ``off``
    elements into its storage (off 0: t itself)."""
    if not off:
        return t
    flat = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = flat[off:].view(t.shape)
    view.copy_(t)
    return view


def _gmm_inputs(Z, C, D, F, P, dtype, seed=0, off=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((Z, C, D), generator=g, device="cuda").to(dtype)
    w = (torch.randn((P, D, F), generator=g, device="cuda") / D ** 0.5
         ).to(dtype)
    gy = torch.randn((Z, C, F), generator=g, device="cuda").to(dtype)
    return tuple(_offset(t, off) for t in (x, w, gy))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 8, 17, 32])
def test_moe_gmm_decode_on_card(C):
    """The bf16 decode route (C <= 32): two groups per expert stacked into
    one block's tokens, D 264 and F 200 ragged against the 64-wide stages
    and tiles; one launch on "wgmma_decode"."""
    _card()
    x, w, _ = _gmm_inputs(8, C, 264, 200, 4, torch.bfloat16)
    assert gmm_mod.route(x.dtype, C, 264, 200, True) == "wgmma_decode"
    before = gmm_mod.route_launches["wgmma_decode"]
    got = ops.moe_gmm(x, w, expert_period=4)
    assert gmm_mod.route_launches["wgmma_decode"] == before + 1
    torch.testing.assert_close(got.float(),
                               gmm_mod.moe_gmm_plain(x, w, 4).float(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 65, 127, 128, 129])
def test_moe_gmm_forward_tile_edges_on_card(dtype, C):
    """The wgmma and 3xTF32 routes' 128 x 128 tiles: C at and around a
    tile's rows (one consumer's 64, 128), F 136 a ragged column tile."""
    _card()
    x, w, _ = _gmm_inputs(4, C, 256, 136, 2, dtype)
    got = ops.moe_gmm(x, w, expert_period=2)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(),
                               gmm_mod.moe_gmm_plain(x, w, 2).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Z,C,D,F,P", [
    (1, 64, 64, 64, 1),            # one tile of each product
    (4, 100, 264, 200, 2),         # G = 2, ragged C inside dw's group walk
    (6, 100, 264, 200, 3),
    (64, 72, 1024, 512, 32),       # the train shapes' widths, small C
    (64, 72, 512, 1024, 32),
    # the 3xTF32 route: the reduced widths (64-wide tiles), dw's 32-row
    # depth stages at C 31, 32, 33 and a 128-row tile's edge
    (4, 40, 64, 32, 2),
    (4, 40, 32, 64, 2),
    (4, 31, 64, 36, 2),
    (4, 32, 64, 36, 2),
    (4, 33, 64, 36, 2),
    (2, 129, 128, 132, 1),
    (3, 33, 50, 70, 3),            # rows not whole 16-byte chunks
    (4, 100, 51, 77, 2),           # rows only 2-byte aligned
])
def test_moe_gmm_backward_shapes_on_card(dtype, Z, C, D, F, P):
    """dx and dw against the plain version's autograd; two launches."""
    _card()
    x, w, gy = _gmm_inputs(Z, C, D, F, P, dtype)
    before = gmm_mod.bwd_launches
    dx, dw = gmm_mod.moe_gmm_bwd(x, w, gy, P)
    assert gmm_mod.bwd_launches == before + 2
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(gmm_mod.moe_gmm_plain(xr, wr, P), (xr, wr),
                               gy)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for a, b in zip((dx, dw), want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_backward_repeats_bits(dtype):
    """dw sums over the groups in registers in a fixed order: two runs
    give the same bits."""
    _card()
    x, w, gy = _gmm_inputs(6, 100, 264, 200, 3, dtype)
    first = gmm_mod.moe_gmm_bwd(x, w, gy, 3)
    again = gmm_mod.moe_gmm_bwd(x, w, gy, 3)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# bf16 calls of the edge route ("wgmma_edge"): rows in 4-byte pieces (D
# 50, F 70), rows only 2-byte aligned (D 51, F 77), the training shapes'
# odd widths at a small C (x rows in 8-byte pieces, w rows in 4-byte
# ones, and the reverse), C at and around the 128-row tile and below the
# decode route's 32, and aligned widths with every tensor one element off
# 16-byte alignment (2-byte pieces); a second tile of the odd train
# widths at C 132 and 260, and 2-byte rows in x alone (F 80) or w alone
# (D 56)
GMM_EDGE = [
    (3, 33, 50, 70, 3, 0),
    (4, 100, 51, 77, 2, 0),
    (4, 130, 1020, 510, 2, 0),
    (4, 130, 510, 1020, 2, 0),
    (4, 128, 264, 136, 2, 1),
    (4, 129, 51, 77, 4, 0),
    (6, 8, 51, 77, 3, 0),
    (4, 100, 264, 200, 2, 1),
    (4, 132, 1020, 510, 2, 0),
    (4, 260, 510, 1020, 2, 0),
    (4, 96, 51, 80, 2, 0),
    (4, 96, 56, 77, 2, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("Z,C,D,F,P,off", GMM_EDGE)
def test_moe_gmm_edge_route_on_card(Z, C, D, F, P, off):
    """The edge route forward and backward against the plain version (one
    forward and two backward launches, all on "wgmma_edge"); two backward
    runs give the same bits."""
    _card()
    x, w, gy = _gmm_inputs(Z, C, D, F, P, torch.bfloat16, off=off)
    assert gmm_mod.route(x.dtype, C, D, F, off == 0) == "wgmma_edge"
    routed = gmm_mod.route_launches["wgmma_edge"]
    got = gmm_mod.moe_gmm(x, w, P)
    dx, dw = gmm_mod.moe_gmm_bwd(x, w, gy, P)
    assert gmm_mod.route_launches["wgmma_edge"] == routed + 3
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = gmm_mod.moe_gmm_plain(xr, wr, P)
    dwant = torch.autograd.grad(want, (xr, wr), gy)
    for a, b in zip((got, dx, dw), (want.detach(),) + dwant):
        torch.testing.assert_close(a.float(), b.float(), rtol=3e-2,
                                   atol=3e-2)
    for a, b in zip(gmm_mod.moe_gmm_bwd(x, w, gy, P), (dx, dw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (4, 100, 264, 200, 2)),
    (torch.bfloat16, (4, 100, 264, 200, 2)),
    (torch.bfloat16, (4, 130, 1020, 510, 2)),      # the edge route
])
def test_moe_gmm_backward_makes_no_copy(dtype, shape):
    """A backward reads x, w and g as stored, at aligned and odd widths:
    the profiler sees the two moe_gmm kernels and no other kernel."""
    from torch.profiler import ProfilerActivity, profile
    _card()
    x, w, gy = _gmm_inputs(*shape, dtype)
    P = shape[4]
    gmm_mod.moe_gmm_bwd(x, w, gy, P)        # build and load outside
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gmm_mod.moe_gmm_bwd(x, w, gy, P)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2 and all("moe_gmm" in n for n in names), names


def _ssd_inputs(B, S, H, P, G, N, dtype, a_scale=0.3, seed=0, off=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((B, S, H, P), generator=g, device="cuda") * 0.5
         ).to(dtype)
    a = -(torch.randn((B, S, H), generator=g, device="cuda") * a_scale).abs()
    b = (torch.randn((B, S, G, N), generator=g, device="cuda") * 0.3
         ).to(dtype)
    c = (torch.randn((B, S, G, N), generator=g, device="cuda") * 0.3
         ).to(dtype)
    return tuple(_offset(t, off) for t in (x, a, b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,P,G,N,chunk", [
    (256, 4, 64, 1, 128, 128),     # the path's widths, short
    (100, 2, 32, 1, 16, 128),      # one partial chunk
    (300, 4, 16, 2, 8, 128),       # a partial last chunk, two groups
    (130, 3, 48, 3, 16, 32),       # widths that do not tile
    # the 128-row tile's edges at the path's widths, and a head sum over
    # more than one head per group
    (127, 4, 64, 1, 128, 128),
    (128, 4, 64, 1, 128, 128),
    (129, 4, 64, 1, 128, 128),
    (512, 8, 64, 2, 128, 128),
    # bf16's "tc_edge": N and P multiples of 8 (TMA's bounds zero the
    # padding), rows in 4- and 8-byte pieces (P 50, N 100), rows only
    # 2-byte aligned (P 49, N 77) at a partial last chunk and two groups
    (300, 4, 56, 1, 120, 128),
    (260, 4, 50, 1, 100, 128),
    (300, 4, 49, 2, 77, 128),
    (130, 3, 24, 3, 40, 32),
])
def test_ssd_scan_kernel_on_card(dtype, S, H, P, G, N, chunk):
    """Forward and backward kernels against the plain version's autograd
    in f32 (test_kernels.py's SSD tolerance; bf16 3e-2)."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    _card()
    x, a, b, c = _ssd_inputs(2, S, H, P, G, N, dtype)
    g = torch.Generator(device="cuda").manual_seed(1)
    gy = torch.randn((2, S, H, P), generator=g, device="cuda").to(dtype)
    gh = torch.randn((2, H, N, P), generator=g, device="cuda")
    ts = [t.clone().requires_grad_() for t in (x, a, b, c)]
    kind = ssd_mod.route(x, b)
    assert kind == ("tf32x3" if dtype == torch.float32 else
                    "tc" if N % 16 == 0 and P % 16 == 0 else "tc_edge")
    before = (ssd_mod.fwd_launches, ssd_mod.bwd_launches)
    routed = ssd_mod.route_launches[kind]
    y, h = ops.ssd_scan(*ts, chunk=chunk)
    got = torch.autograd.grad((y.float() * gy.float()).sum()
                              + (h * gh).sum(), ts)
    nf, nb = ssd_mod.LAUNCHES[kind]
    assert (ssd_mod.fwd_launches, ssd_mod.bwd_launches) == (before[0] + nf,
                                                            before[1] + nb)
    assert ssd_mod.route_launches[kind] == routed + nf + nb
    rs = [t.float().requires_grad_() for t in (x, a, b, c)]
    ry, rh = ssd_mod.ssd_scan_plain(*rs, chunk=chunk)
    want = torch.autograd.grad((ry * gy.float()).sum() + (rh * gh).sum(), rs)
    tol = dict(rtol=2e-3, atol=2e-4) if dtype == torch.float32 else \
        dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(y.float(), ry, **tol)
    torch.testing.assert_close(h, rh, **tol)
    for a_, b_ in zip(got, want):
        scale = float(b_.abs().max())
        torch.testing.assert_close(a_.float(), b_, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(scale, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_backward_repeats_bits(dtype):
    """Two backward runs on the same inputs give the same bits (the head
    sums of dB and dC run in a fixed order, with no atomics), on the
    3xTF32 route (f32) and the tensor-core route (bf16)."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    _card()
    x, a, b, c = _ssd_inputs(2, 512, 4, 64, 1, 128, dtype)
    assert ssd_mod.route(x, b) == ("tf32x3" if dtype == torch.float32
                                   else "tc")
    g = torch.Generator(device="cuda").manual_seed(2)
    gy = torch.randn((2, 512, 4, 64), generator=g,
                     device="cuda").to(dtype)
    gh = torch.randn((2, 4, 128, 64), generator=g, device="cuda")
    _, _, saved = ssd_mod.ssd_scan_fwd(x, a, b, c, 128, True)
    first = ssd_mod.ssd_scan_bwd(x, a, b, c, saved, gy, gh, 128)
    second = ssd_mod.ssd_scan_bwd(x, a, b, c, saved, gy, gh, 128)
    for u, v in zip(first, second):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,off", [(64, 128, 1), (50, 100, 1),
                                     (56, 120, 0)])
def test_ssd_scan_edge_route_on_card(P, N, off):
    """bf16 "tc_edge" with every input ``off`` elements into its storage
    (2-byte pieces), or at N and P off a multiple of 16: forward and
    backward against the plain version, two forward and three backward
    launches, and two backward runs give the same bits."""
    from repro_torch.kernels import ssd_scan as ssd_mod
    _card()
    x, a, b, c = _ssd_inputs(2, 300, 4, P, 1, N, torch.bfloat16, off=off)
    assert ssd_mod.route(x, b, c) == "tc_edge"
    g = torch.Generator(device="cuda").manual_seed(3)
    gy = _offset(torch.randn((2, 300, 4, P), generator=g,
                             device="cuda").to(torch.bfloat16), off)
    gh = torch.randn((2, 4, N, P), generator=g, device="cuda")
    routed = ssd_mod.route_launches["tc_edge"]
    y, h, saved = ssd_mod.ssd_scan_fwd(x, a, b, c, 128, True)
    got = ssd_mod.ssd_scan_bwd(x, a, b, c, saved, gy, gh, 128)
    assert ssd_mod.route_launches["tc_edge"] == routed + 5
    again = ssd_mod.ssd_scan_bwd(x, a, b, c, saved, gy, gh, 128)
    for u, v in zip(got, again):
        assert torch.equal(u, v)
    rs = [t.float().requires_grad_() for t in (x, a, b, c)]
    ry, rh = ssd_mod.ssd_scan_plain(*rs, chunk=128)
    want = torch.autograd.grad((ry * gy.float()).sum() + (rh * gh).sum(), rs)
    torch.testing.assert_close(y.float(), ry, rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(h, rh, rtol=3e-2, atol=3e-2)
    for a_, b_ in zip(got, want):
        scale = max(float(b_.abs().max()), 1.0)
        torch.testing.assert_close(a_.float(), b_, rtol=3e-2,
                                   atol=3e-2 * scale)


@pytest.mark.cuda
def test_ssd_scan_kernel_refuses_wide_states():
    _card()
    x, a, b, c = _ssd_inputs(1, 8, 2, 16, 1, 160, torch.float32)
    with pytest.raises(ValueError, match="state width"):
        ops.ssd_scan(x, a, b, c)
    x, a, b, c = _ssd_inputs(1, 8, 2, 16, 1, 16, torch.float32)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, a.double(), b, c)


def _dense_cfg(dtype):
    """qwen2.5-3b's slot (GQA 8:1, qkv bias, SwiGLU MLP) at a card-test
    width: d 512, 8 heads / 1 KV head of 64, FF 1024."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(
        configs.get("qwen2.5-3b").reduced(), d_model=512, num_heads=8,
        num_kv_heads=1, head_dim=64, d_ff=1024, dtype=dtype,
        attn_impl="kernel")


@pytest.mark.cuda
def test_dense_slot_bf16_against_f32_on_card():
    """One attention + MLP layer (flash kernels) in bf16 against the same
    weights in float32 (plain route): output and input gradient within
    bf16's tolerance, relative to their largest element."""
    import copy
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers, stack
    _card()
    cfg32 = _dense_cfg("float32")
    layer = stack.Layer(cfg32, "attn", "mlp", device="cuda",
                        dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    layer.mix.init_weights(g)
    layer.ffn.init_weights(g)
    with torch.no_grad():
        for b in (layer.mix.bq, layer.mix.bk, layer.mix.bv):
            b.normal_(0, 0.1, generator=g)
    lb = copy.deepcopy(layer).to(torch.bfloat16)
    x = torch.randn((2, 256, 512), generator=g, device="cuda")
    gy = torch.randn((2, 256, 512), generator=g, device="cuda")
    pos = torch.arange(256, device="cuda").expand(2, 256)
    out = {}
    before = (fa.fwd_launches, fa.bwd_launches)
    for dtype, mod, impl in ((torch.bfloat16, lb, "kernel"),
                             (torch.float32, layer, "ref")):
        cfg = dataclasses.replace(
            _dense_cfg(str(dtype).removeprefix("torch.")), attn_impl=impl)
        xi = x.to(dtype).requires_grad_()
        y, _, _ = mod(xi, cfg, positions=pos)
        out[dtype] = (y.float(), torch.autograd.grad(y, xi, gy.to(dtype))[0]
                      .float())
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 3)
    for a, b in zip(out[torch.bfloat16], out[torch.float32]):
        assert torch.isfinite(a).all()
        assert ((a - b).abs().max() / b.abs().max()).item() < 3e-2
    assert isinstance(lb.ffn, layers.MLP)


@pytest.mark.cuda
def test_checkpoint_round_trip_of_a_card_model(tmp_path):
    """A bf16 model and its AdamW state on the card, one step taken,
    saved and restored into a fresh model and state on the card: every
    weight and moment bit for bit."""
    from repro_torch import convert, optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import model
    _card()
    cfg = _dense_cfg("bfloat16")
    p = model.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
    named = dict(p.named_parameters())
    ocfg = optim.AdamWConfig(lr_peak=1e-3, warmup_steps=1)
    st = optim.adamw_init(named, ocfg, period=len(cfg.pattern))
    _, st, _ = optim.adamw_update({k: torch.ones_like(v) * 1e-3
                                   for k, v in named.items()}, st, named,
                                  ocfg)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"params": convert.to_jax(p, cfg, numpy=False),
                       "opt": convert.opt_to_jax(st, cfg, numpy=False)})
    step, tree = mgr.restore_latest()
    assert step == 1
    p2 = convert.from_jax(tree["params"], cfg, "cuda")
    st2 = convert.opt_from_jax(tree["opt"], cfg, "cuda")
    for (n, a), (_, b) in zip(p.named_parameters(), p2.named_parameters()):
        assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b), n
    assert st2["count"] == st["count"] == 1
    for k, v in st["m"].items():
        assert torch.equal(st2["m"][k], v), k
    for k, v in st["v"].items():
        assert st2["v"][k].is_cuda and torch.equal(st2["v"][k], v), k


@pytest.mark.cuda
def test_sim_kernel_matches_golden_on_card():
    """tests/data/sim_golden.json's 25 keys through the simulator's kernel
    (one launch for the batch): every recorded metric exactly, and the
    kernel counted its launch."""
    import json
    import os

    from repro_torch.core import placement, topology
    from repro_torch.core.sim import SweepPlan, bots
    from repro_torch.kernels import sim
    _card()
    gold = json.load(open(os.path.join(os.path.dirname(__file__), "data",
                                       "sim_golden.json")))
    topos = {"sunfire": topology.sunfire_x4600(),
             "tpu2x4": topology.tpu_pod_2d(2, 4)}
    wls = {"fft_small": bots.fft(n=1 << 10, cutoff=8),
           "sparselu_small": bots.sparselu(n=8)}
    plan, keys = SweepPlan(), []
    for tn, topo in topos.items():
        for wn, wl in wls.items():
            for sched in ("bf", "cilk", "wf", "dfwspt", "dfwsrpt",
                          "dfwshier"):
                plan.add(topo, list(range(8)), wl, sched, seed=7)
                keys.append(f"{tn}/{wn}/{sched}")
    sf = topos["sunfire"]
    plan.add(sf, list(range(16)), wls["fft_small"], "wf", seed=3,
             root_data_nodes=placement.first_touch_spill(sf, 0, 2),
             runtime_data_node=0, migration_rate=0.15)
    keys.append("sunfire/fft_small/wf+baseline-numa")
    assert sorted(keys) == sorted(gold)
    before = sim.launches
    res = plan.run(device="cuda")
    assert sim.launches == before + 1
    for r, key in zip(res, keys):
        assert r.engine == "cuda"
        for m, want in gold[key].items():
            assert getattr(r, m) == want, (key, m)


def _sim_cells(trace: bool):
    """Six prepared cells of the port's simulator (every scheduler, the
    baseline context with migration and a preempt fault on half)."""
    from repro_torch.core import topology
    from repro_torch.core.sim import (Machine, SimParams, bots, policy,
                                      runtime)
    m = Machine(topology.sunfire_x4600(), SimParams(trace=trace),
                device="cpu")
    wl = bots.fft(n=1 << 12, cutoff=8)
    out = []
    for i, sched in enumerate(("bf", "cilk", "wf", "dfwspt", "dfwsrpt",
                               "dfwshier")):
        ectx = m.context(16, binding="linear", placement="spill:2@0",
                         runtime_data=0, migration_rate=0.15,
                         faults=("preempt:2",) if i % 2 else ())
        out.append(runtime._prepare_ctx(ectx, wl, policy.get_spec(sched), i))
    return out


@pytest.mark.cuda
def test_sim_traced_kernel_matches_plain_on_card():
    """The traced instantiation of csrc/sim.cu against the plain version
    on six cells: every metric and every event, launched on its route."""
    from repro_torch.core.sim import _engine_py
    from repro_torch.kernels import sim
    _card()
    before = dict(sim.route_launches)
    got = sim.run_batch(_sim_cells(True), "cuda")
    assert sim.route_launches["traced"] == before["traced"] + 1
    assert sim.route_launches["untraced"] == before["untraced"]
    untraced = sim.run_batch(_sim_cells(False), "cuda")
    for g, u, ctx in zip(got, untraced, _sim_cells(True)):
        want = _engine_py.run(ctx)
        tg, tw = g.pop("trace"), want.pop("trace")
        assert g == want == u
        assert tg == tw and tg.n_exec == g["executed"]


@pytest.mark.cuda
def test_sim_deadline_zero_on_card():
    """A deadline under a nanosecond (0 ns at the kernel) stops every
    cell at its first check, traced or not, each a CellTimeout in its own
    slot; ``timeout=0`` is no deadline, as in ``resolve_timeout``."""
    from repro_torch.core.sim import CellTimeout
    from repro_torch.kernels import sim
    _card()
    outs = sim.run_batch(_sim_cells(False)[:3] + _sim_cells(True)[3:],
                         "cuda", timeout=1e-12)
    assert len(outs) == 6
    assert all(isinstance(o, CellTimeout) and o.engine == "cuda"
               for o in outs)
    untimed = sim.run_batch(_sim_cells(False)[:3], "cuda")
    assert sim.run_batch(_sim_cells(False)[:3], "cuda",
                         timeout=0.0) == untimed
