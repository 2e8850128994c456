"""The port's kernels on the card: each kernel (forward and backward)
against its plain version, with its launch counter. Marked ``cuda``;
they skip on a host without a CUDA device. This file imports no JAX, so
it runs where only PyTorch is installed:

    REPRO_SIM_CACHE=0 PYTHONPATH=src python -m pytest -q -m cuda \
        tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_gmm as gmm_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


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
    out = ops.flash_attention(*ts, causal=causal, window=window,
                              kv_offset=off)
    got = torch.autograd.grad(out, ts, do)
    assert (fa.fwd_launches, fa.bwd_launches) == (before[0] + 1,
                                                  before[1] + 3)
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
def test_flash_attention_backward_repeats_bits():
    """The backward has no atomics: two runs give the same bits."""
    from repro_torch.kernels import flash_attention as fa
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, 1000, 16, 64), generator=g, device="cuda").bfloat16()
    k = torch.randn((2, 1000, 8, 64), generator=g, device="cuda").bfloat16()
    v = torch.randn((2, 1000, 8, 64), generator=g, device="cuda").bfloat16()
    do = torch.randn((2, 1000, 16, 64), generator=g, device="cuda").bfloat16()
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
def test_rmsnorm_kernel_on_card(dtype):
    from repro_torch.kernels import rmsnorm as rms_mod
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((31, 96), generator=g, device="cuda").to(dtype)
    w = torch.randn((96,), generator=g, device="cuda").to(dtype)
    before = rms_mod.launches
    got = ops.rmsnorm(x, w, 1e-5)
    assert rms_mod.launches == before + 1
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
    got = torch.autograd.grad(ops.moe_gmm(xs, ws, 3), (xs, ws), gy)
    assert (gmm_mod.launches, gmm_mod.bwd_launches) == (before[0] + 1,
                                                        before[1] + 2)
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


def _gmm_inputs(Z, C, D, F, P, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((Z, C, D), generator=g, device="cuda").to(dtype)
    w = (torch.randn((P, D, F), generator=g, device="cuda") / D ** 0.5
         ).to(dtype)
    gy = torch.randn((Z, C, F), generator=g, device="cuda").to(dtype)
    return x, w, gy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [64, 65, 127, 129])
def test_moe_gmm_forward_tile_edges_on_card(dtype, C):
    """The wgmma route's 128 x 128 tiles: C at and around a tile's rows
    (one consumer's 64, 128), F 136 a ragged column tile."""
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
def test_moe_gmm_backward_repeats_bits():
    """dw sums over the groups in registers in a fixed order: two runs
    give the same bits."""
    _card()
    x, w, gy = _gmm_inputs(6, 100, 264, 200, 3, torch.bfloat16)
    first = gmm_mod.moe_gmm_bwd(x, w, gy, 3)
    again = gmm_mod.moe_gmm_bwd(x, w, gy, 3)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_moe_gmm_backward_makes_no_copy():
    """A bf16 backward of aligned widths reads x, w and g as stored: the
    profiler sees the two moe_gmm kernels and no other kernel."""
    from torch.profiler import ProfilerActivity, profile
    _card()
    x, w, gy = _gmm_inputs(4, 100, 264, 200, 2, torch.bfloat16)
    gmm_mod.moe_gmm_bwd(x, w, gy, 2)        # build and load outside
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gmm_mod.moe_gmm_bwd(x, w, gy, 2)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2 and all("moe_gmm" in n for n in names), names


def _ssd_inputs(B, S, H, P, G, N, dtype, a_scale=0.3, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((B, S, H, P), generator=g, device="cuda") * 0.5
         ).to(dtype)
    a = -(torch.randn((B, S, H), generator=g, device="cuda") * a_scale).abs()
    b = (torch.randn((B, S, G, N), generator=g, device="cuda") * 0.3
         ).to(dtype)
    c = (torch.randn((B, S, G, N), generator=g, device="cuda") * 0.3
         ).to(dtype)
    return x, a, b, c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,P,G,N,chunk", [
    (256, 4, 64, 1, 128, 128),     # the path's widths, short
    (100, 2, 32, 1, 16, 128),      # one partial chunk
    (300, 4, 16, 2, 8, 128),       # a partial last chunk, two groups
    (130, 3, 48, 3, 16, 32),       # widths that do not tile
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
    before = (ssd_mod.fwd_launches, ssd_mod.bwd_launches)
    y, h = ops.ssd_scan(*ts, chunk=chunk)
    got = torch.autograd.grad((y.float() * gy.float()).sum()
                              + (h * gh).sum(), ts)
    assert (ssd_mod.fwd_launches, ssd_mod.bwd_launches) == (before[0] + 1,
                                                            before[1] + 2)
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
def test_ssd_scan_kernel_refuses_wide_states():
    _card()
    x, a, b, c = _ssd_inputs(1, 8, 2, 16, 1, 160, torch.float32)
    with pytest.raises(ValueError, match="state width"):
        ops.ssd_scan(x, a, b, c)
    x, a, b, c = _ssd_inputs(1, 8, 2, 16, 1, 16, torch.float32)
    with pytest.raises(TypeError):
        ops.ssd_scan(x, a.double(), b, c)
