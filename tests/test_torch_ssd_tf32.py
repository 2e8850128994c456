"""The f32 ``ssd_scan`` route (``"tf32x3"``, 3xTF32 on wgmma) emulated on
the CPU: its dual form, forward and backward, written out as the kernels
compute it, every product through ``ref.matmul_3xtf32`` at the route's
chunk rows (``kernel_rows(chunk, "tf32x3")``), held against the JAX
package's oracle (``repro.kernels.ref.ssd_ref`` and its VJP) on the same
numpy inputs within a quarter of the SSD f32 tolerance; a single TF32
product in its place misses it. Also the routes ``ssd_scan.route`` picks
before launch for every f32 and bf16 shape of the paths. The kernels
themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

What the emulation fixes, as ``csrc/ssd_scan.cu`` does:

* per chunk of L rows, A = cumsum(a), eA = exp(A), w = exp(A_last - A),
  the decay D masked before the exp; C B^T and B C^T of each chunk and
  group once (``cb``); y = eA (C h) + (C B^T * D) x; the state, held as
  h^T (P x N), h^T <- exp(A_last) h^T + x^T (w B), the update a product
  of its own added in f32;
* the backward's carried gradient dh^T <- exp(A_last) dh^T + (eA dy)^T C,
  likewise; dx = w (B dh') + (B C^T * D^T) dy; dC and dB summed over the
  group's heads in f32, each head's (exp(A) dy) h^T and (w x) dh'^T a
  product of its own, plus (sum over heads of dP * D) B and its
  transpose with C;
* da without C h: the chunk's dA_t = dy_t . y_t - x_t . dx_t, plus
  <dh', h'> (the end state's gradient against the end state) on the last
  row, then its reverse cumsum over the chunk.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401

RTOL, ATOL = 2e-3, 2e-4    # tests/test_kernels.py's SSD tolerance (f32)
MARGIN = 4                 # 3xTF32 must hold a quarter of it


def _draw(B, S, H, P, G, N, a_scale=1.0, seed=0):
    """x, a, b, c as chip_smoke.py's ssd_phase draws them: x and b, c
    normal x 0.5, a = -softplus(normal) x the heads' decays (1 .. 16) x
    a_scale."""
    rng = np.random.default_rng(seed)
    decay = np.exp(np.linspace(0.0, np.log(16.0), H))
    x = rng.standard_normal((B, S, H, P)) * 0.5
    z = rng.standard_normal((B, S, H))
    a = -np.logaddexp(0.0, z) * decay * a_scale
    b = rng.standard_normal((B, S, G, N)) * 0.5
    c = rng.standard_normal((B, S, G, N)) * 0.5
    gy = rng.standard_normal((B, S, H, P))
    gh = rng.standard_normal((B, H, N, P))
    return [v.astype(np.float32) for v in (x, a, b, c, gy, gh)]


def _one_tf32(a, b):
    """A single TF32 product (each operand rounded once)."""
    return ref.tf32_round(a) @ ref.tf32_round(b)


def _chunk_factors(ah, r0, n):
    """A, eA, w and the decay D (rows t, columns s) of rows r0 .. r0+n of
    ah (B, H, S)."""
    A = torch.cumsum(ah[..., r0:r0 + n], -1)
    tri = torch.ones((n, n), dtype=torch.bool).tril()
    D = torch.exp((A[..., :, None] - A[..., None, :]).masked_fill(
        ~tri, float("-inf")))
    return A, torch.exp(A), torch.exp(A[..., -1:] - A), D


def emulate_fwd(x, a, b, c, L, mm=ref.matmul_3xtf32):
    """The route's forward: y (B, S, H, P), the final state (B, H, N, P),
    the state at every chunk's start and the one after the last (h^T,
    (B, H, P, N) each), and cb: (C B^T, B C^T) per chunk and group."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    xh, ah = x.permute(0, 2, 1, 3), a.permute(0, 2, 1)
    bh, ch = (t.permute(0, 2, 1, 3) for t in (b, c))      # (B, G, S, N)
    hT = torch.zeros((B, H, P, N))
    states, cbs, ys = [], [], []
    for r0 in range(0, S, L):
        n = min(L, S - r0)
        A, eA, w, D = _chunk_factors(ah, r0, n)
        xc = xh[:, :, r0:r0 + n]
        bc, cc = bh[:, :, r0:r0 + n], ch[:, :, r0:r0 + n]
        cb, cbT = mm(cc, bc.transpose(-1, -2)), mm(bc, cc.transpose(-1, -2))
        cbs.append((cb, cbT))
        br, cr = (t.repeat_interleave(rep, 1) for t in (bc, cc))
        y = eA[..., None] * mm(cr, hT.transpose(-1, -2)) \
            + mm(cb.repeat_interleave(rep, 1) * D, xc)
        ys.append(y)
        states.append(hT)
        upd = mm(xc.transpose(-1, -2), w[..., None] * br)
        hT = eA[..., -1, None, None] * hT + upd
    states.append(hT)
    y = torch.cat(ys, 2).permute(0, 2, 1, 3)
    return y, hT.transpose(-1, -2), states, cbs


def emulate_bwd(x, a, b, c, y, states, cbs, gy, gh, L,
                mm=ref.matmul_3xtf32):
    """The route's backward from the forward's y, states and cb: (dx, da,
    db, dc), its three kernels in order."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    xh, ah, dyh, yh = (t.permute(0, 2, 1, 3) if t.dim() == 4
                       else t.permute(0, 2, 1) for t in (x, a, gy, y))
    bh, ch = (t.permute(0, 2, 1, 3) for t in (b, c))
    starts = list(range(0, S, L))
    # 1. the carried state gradient in reverse; <dh', h'> of each chunk
    dh = gh.transpose(-1, -2).clone()                      # dh^T (P x N)
    dstates, dots = [None] * len(starts), [None] * len(starts)
    for i in reversed(range(len(starts))):
        r0 = starts[i]
        n = min(L, S - r0)
        A, eA, w, D = _chunk_factors(ah, r0, n)
        dstates[i] = dh
        dots[i] = (dh * states[i + 1]).sum((-1, -2))
        cr = ch[:, :, r0:r0 + n].repeat_interleave(rep, 1)
        upd = mm((eA[..., None] * dyh[:, :, r0:r0 + n]).transpose(-1, -2),
                 cr)
        dh = eA[..., -1, None, None] * dh + upd
    dx, da, db, dc = [], [], [], []
    for i, r0 in enumerate(starts):
        n = min(L, S - r0)
        A, eA, w, D = _chunk_factors(ah, r0, n)
        xc, dyc, yc = (t[:, :, r0:r0 + n] for t in (xh, dyh, yh))
        bc, cc = bh[:, :, r0:r0 + n], ch[:, :, r0:r0 + n]
        br = bc.repeat_interleave(rep, 1)
        dhN = dstates[i].transpose(-1, -2)                 # dh' (N x P)
        # 2. dx and da of every chunk and head
        cbT = cbs[i][1].repeat_interleave(rep, 1)
        dxc = w[..., None] * mm(br, dhN) \
            + mm(cbT * D.transpose(-1, -2), dyc)
        dA = (dyc * yc).sum(-1) - (xc * dxc).sum(-1)
        dA[..., -1] += dots[i]
        dx.append(dxc)
        da.append(dA.flip(-1).cumsum(-1).flip(-1))
        # 3. dC and dB of every chunk and group, summed over its heads
        hN = states[i].transpose(-1, -2)                   # h (N x P)
        dC_inter = eA[..., None] * mm(dyc, hN.transpose(-1, -2))
        dB_inter = w[..., None] * mm(xc, dhN.transpose(-1, -2))
        gsum = (mm(dyc, xc.transpose(-1, -2)) * D)
        gsumT = (mm(xc, dyc.transpose(-1, -2)) * D.transpose(-1, -2))

        def heads(t):
            return t.reshape(B, G, rep, *t.shape[2:]).sum(2)
        dc.append(heads(dC_inter) + mm(heads(gsum), bc))
        db.append(heads(dB_inter) + mm(heads(gsumT), cc))
    dx = torch.cat(dx, 2).permute(0, 2, 1, 3)
    da = torch.cat(da, 2).permute(0, 2, 1)
    db = torch.cat(db, 2).permute(0, 2, 1, 3)
    dc = torch.cat(dc, 2).permute(0, 2, 1, 3)
    return dx, da, db, dc


def _oracle(x, a, b, c, gy, gh):
    """JAX's sequential oracle: y, the final state and the gradients of
    sum(y gy) + sum(hT gh) in x, a, b, c."""
    (y, hT), vjp = jax.vjp(
        lambda *t: jref.ssd_ref(*t, return_state=True),
        *(jnp.asarray(v) for v in (x, a, b, c)))
    grads = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    return [np.asarray(v) for v in (y, hT, *grads)]


def _share(got, want, scale=1.0):
    """The worst element's share of the SSD tolerance (atol x scale)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want)
                  / (ATOL * scale + RTOL * np.abs(want))).max())


def _shares(inputs, chunk, mm=ref.matmul_3xtf32):
    """Each output's (y, state, dx, da, db, dc) share of the tolerance
    against the oracle, the gradients at atol x max|gradient|."""
    x, a, b, c, gy, gh = (torch.from_numpy(v) for v in inputs)
    L = ssd_mod.kernel_rows(chunk, "tf32x3")
    y, hT, states, cbs = emulate_fwd(x, a, b, c, L, mm)
    grads = emulate_bwd(x, a, b, c, y, states, cbs, gy, gh, L, mm)
    want = _oracle(*inputs)
    got = [y, hT, *grads]
    return [_share(g.numpy(), w, 1.0 if i < 2 else np.abs(w).max())
            for i, (g, w) in enumerate(zip(got, want))]


CASES = [
    # (B, S, H, P, G, N, chunk, |a| scale): the reduced widths (jamba's
    # and mamba2's reduced configs: N 16, P 16, chunk 16), mamba2's
    # widths at a short sequence, large decays, two groups, and widths
    # that do not tile with a partial last chunk
    (2, 64, 4, 16, 1, 16, 16, 1.0),
    (2, 512, 4, 64, 1, 128, 128, 1.0),
    (2, 256, 4, 64, 1, 128, 128, 40.0),
    (2, 256, 4, 64, 2, 128, 128, 1.0),
    (2, 200, 4, 48, 1, 8, 128, 1.0),
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,a_scale", CASES)
def test_3xtf32_scan_holds_ssd_tolerance(B, S, H, P, G, N, chunk, a_scale):
    """y, the final state and every gradient within a quarter of the SSD
    f32 tolerance of JAX's oracle."""
    shares = _shares(_draw(B, S, H, P, G, N, a_scale), chunk)
    assert max(shares) <= 1 / MARGIN, dict(zip(
        ("y", "state", "dx", "da", "db", "dc"), shares))


def test_one_tf32_product_misses_ssd_tolerance():
    """The same dual form with one TF32 product in place of three misses
    the tolerance at mamba2's widths: why the split."""
    inputs = _draw(2, 512, 4, 64, 1, 128)
    one = _shares(inputs, 128, _one_tf32)
    assert one[0] > 1, one
    assert max(_shares(inputs, 128)) <= 1 / MARGIN


def test_route_rows_and_launches():
    """The route's chunk rows (64), and two forward and three backward
    launches a call."""
    assert ssd_mod.kernel_rows(128, "tf32x3") == 64
    assert ssd_mod.kernel_rows(16, "tf32x3") == 16
    assert ssd_mod.kernel_rows(128, "tc") == 128
    assert ssd_mod.kernel_rows(128, "tc_edge") == 128
    assert ssd_mod.LAUNCHES["tf32x3"] == (2, 3)
    assert ssd_mod.LAUNCHES["tc_edge"] == ssd_mod.LAUNCHES["tc"] == (2, 3)
    assert set(ssd_mod.route_launches) == set(ssd_mod.LAUNCHES)


def _ssd_path_shapes():
    """(P, G, N, chunk) of every Mamba2 arch, full width and reduced."""
    for cfg in configs.ARCHS.values():
        for c in (cfg, cfg.reduced()):
            if any(slot[0] == "mamba" for slot in c.pattern):
                yield c.ssm_head_dim, c.ssm_groups, c.ssm_state, c.ssm_chunk


def _tensors(S, H, P, G, N, dtype, offset):
    """x and b on the CPU, their data offset by ``offset`` elements."""
    def at(shape):
        n = int(np.prod(shape))
        return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)
    return at((1, S, H, P)), at((1, S, G, N))


def test_every_f32_scan_takes_3xtf32():
    """mamba2 and jamba at full and reduced width, every chip_smoke.py
    SSD case and the card tests' shapes, aligned and not: f32 takes the
    3xTF32 kernels; bf16 keeps "tc" where N and P are multiples of 16 and
    the tensors aligned, else "tc_edge" (the same kernels with the edge
    loads and masked stores)."""
    shapes = {(P, G, N) for P, G, N, _ in _ssd_path_shapes()}
    assert (64, 1, 128) in shapes and (16, 1, 16) in shapes
    shapes |= {(case[4], case[5], case[6]) for case in chip_smoke.SSD_CASES}
    shapes |= {(64, 1, 128), (32, 1, 16), (16, 2, 8), (48, 3, 16),
               (64, 2, 128)}                # tests/test_torch_cuda.py
    for P, G, N in shapes:
        assert N <= ssd_mod.MAX_STATE and P <= ssd_mod.MAX_HEAD_DIM
        for offset in (0, 1):
            x, b = _tensors(8, 2 * G, P, G, N, torch.float32, offset)
            assert ssd_mod.route(x, b) == "tf32x3"
            x, b = _tensors(8, 2 * G, P, G, N, torch.bfloat16, offset)
            tiles = N % 16 == 0 and P % 16 == 0 and offset == 0
            assert ssd_mod.route(x, b) == ("tc" if tiles else "tc_edge")
