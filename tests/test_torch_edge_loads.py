"""A model, in numpy, of the edge loads of the bf16 tensor-core kernels:
the loads that fill a swizzled shared-memory panel where TMA cannot take
the rows (a row length that is not a multiple of 16 bytes, or a base off
16-byte alignment).

* ``csrc/ssd_scan.cu`` (route ``"tc_edge"``, ``ld_pieces`` / ``ld_elems``):
  every thread of a 256-thread block copies pieces of W bytes, W the
  widest of 16, 8, 4 that divides both the row length and the base
  (``piece``), by cp.async with src-size zero fill, stepping down the rows
  of one column of pieces; rows only 2-byte aligned go element by element
  through registers.
* ``csrc/moe_gmm.cu`` (route ``"wgmma_edge"``, ``edge_load_half`` /
  ``edge_half``): two threads a row, each loads the five 16-byte granules
  that cover its half of the row's 64 columns into registers, shifts them
  into place by word selects and a funnel shift and stores four 16-byte
  chunks.

Each model follows the kernel's own index arithmetic, moves bytes from a
flat "global memory" into a "shared memory" that counts writes, and the
tests check, for odd widths and unaligned bases, that every element of a
tile lands exactly once where wgmma reads it (``wgmma_bf16.cuh``'s
``sw_offset``), that every element past the matrix's last row or column
reads 0, and that no copy reads outside the 16-byte granules that hold
the matrix's bytes (so no read leaves a page the tensor touches).
"""

import numpy as np
import pytest


def sw_offset(rows: int, r: int, c: int) -> int:
    """wgmma_bf16.cuh ``sw_offset<ROWS>``: byte of element (r, c) of a
    swizzled tile of ``rows`` rows (64-column panels, 128-byte lines, the
    16-byte chunk c of row r at chunk c ^ (r % 8))."""
    return ((c // 64) * (rows * 128) + r * 128
            + (((c % 64) // 8) ^ (r % 8)) * 16 + (c % 8) * 2)


def piece(base: int, cols: int) -> int:
    """ssd_scan.cu ``tc::piece``: the widest piece (16, 8, 4 or 2 bytes)
    that divides the base address and the row length of rows of ``cols``
    bf16 elements."""
    v = base | cols * 2
    return 16 if v % 16 == 0 else 8 if v % 8 == 0 else 4 if v % 4 == 0 else 2


class Memory:
    """A flat global memory holding a row-major bf16 tensor (``nrows`` rows
    of ``ld`` elements) at byte ``tbase``, each element a distinct nonzero
    value, and slack bytes around it that are not 0. The matrix the loads
    read is ``cols`` columns of it from column ``col0`` (one head's or
    group's slice of a row, or the whole row)."""

    def __init__(self, nrows, ld, tbase, cols=None, col0=0, seed=0):
        self.rows, self.ld = nrows, ld
        self.cols = ld if cols is None else cols
        self.base = tbase + 2 * col0
        size = tbase + 2 * ld * nrows + 64
        self.bytes = np.random.default_rng(seed).integers(
            1, 255, size, dtype=np.uint8)
        vals = np.arange(1, nrows * ld + 1, dtype=np.uint16)
        self.bytes[tbase:tbase + 2 * nrows * ld] = vals.view(np.uint8)
        # the 16-byte granules that hold an element of the matrix
        self.granules = {(self.base + 2 * (r * ld + c)) // 16
                         for r in range(nrows) for c in range(self.cols)}

    def value(self, r, c):
        a = self.base + 2 * (r * self.ld + c)
        return int(self.bytes[a:a + 2].view(np.uint16)[0])

    def read(self, addr, n):
        for g in range(addr // 16, (addr + n - 1) // 16 + 1):
            assert g in self.granules, f"read of granule {g} outside the matrix"
        return self.bytes[addr:addr + n]


class Shared:
    """Shared memory that counts how often each byte is written."""

    def __init__(self, size):
        self.bytes = np.zeros(size, dtype=np.uint8)
        self.writes = np.zeros(size, dtype=np.int32)

    def write(self, addr, data):
        self.bytes[addr:addr + len(data)] = data
        self.writes[addr:addr + len(data)] += 1


def check_tile(mem, smem, R, panels, r0, c0, nrows):
    """Every element (t, c) of an R-row tile of ``panels`` 64-column
    panels is written exactly once where wgmma reads it and holds the
    matrix's element (r0 + t, c0 + c), or 0 past the matrix (or from row
    ``nrows`` of the tile on)."""
    assert (smem.writes == 1).all(), "a byte written other than once"
    for t in range(R):
        for c in range(64 * panels):
            off = sw_offset(R, t, c)
            got = int(smem.bytes[off:off + 2].view(np.uint16)[0])
            gr, gc = r0 + t, c0 + c
            inside = t < nrows and gr < mem.rows and gc < mem.cols
            assert got == (mem.value(gr, gc) if inside else 0), (t, c)


# ----------------------------------------------------------------------
# ssd_scan.cu: ld_pieces / ld_elems (256 threads; a chunk's 128 rows)
# ----------------------------------------------------------------------
KT, R = 256, 128


def ssd_ld_pieces(mem, smem, W, row0, nrows, panels):
    """``ld_pieces<W>``: thread i keeps column c of pieces and steps down
    the rows; the shared address is formed as the kernel forms it."""
    kE, kPer = W // 2, 64 // (W // 2)
    per_row = panels * kPer
    step = KT // per_row
    for tid in range(KT):
        c = (tid % per_row) * kE
        nbytes = 2 * max(0, min(kE, mem.cols - c))
        base = sw_offset(R, 0, c)
        chunk = (c % 64) // 8
        t = tid // per_row
        while t < R:
            n = nbytes if t < nrows else 0
            # base + t * 128 + ((chunk ^ (t % 8)) - chunk) * 16 (mod 2^32)
            s = (base + t * 128 + (((chunk ^ (t % 8)) - chunk) * 16)) % 2**32
            assert s == sw_offset(R, t, c) and s % W == 0
            src = mem.base + 2 * ((row0 + t) * mem.ld + c)
            data = np.zeros(W, dtype=np.uint8)
            if n:
                assert src % W == 0, "a cp.async source off its size"
                data[:n] = mem.read(src, n)
            smem.write(s, data)
            t += step


def ssd_ld_elems(mem, smem, row0, nrows, panels):
    """``ld_elems``: each 16-byte chunk by eight element loads."""
    per_row = panels * 8
    for i in range(R * per_row):
        t, c = i // per_row, (i % per_row) * 8
        words = np.zeros(8, dtype=np.uint16)
        for e in range(8):
            if t < nrows and c + e < mem.cols:
                a = mem.base + 2 * ((row0 + t) * mem.ld + c + e)
                words[e] = mem.read(a, 2).view(np.uint16)[0]
        smem.write(sw_offset(R, t, c), words.view(np.uint8))


# (label, P or N columns, heads or groups in the row stride, panels,
# base offset in elements): the SSD edge shapes (x and dy: P columns,
# one panel; B and C: N columns, two panels)
SSD_TILES = [
    ("x P 50", 50, 4, 1, 0),
    ("B N 100", 100, 1, 2, 0),
    ("x P 49 (2-byte rows)", 49, 4, 1, 0),
    ("B N 77, 2 groups (2-byte rows)", 77, 2, 2, 0),
    ("x P 64 one element off", 64, 4, 1, 1),
    ("B N 128 one element off", 128, 1, 2, 1),
    ("x P 50 one element off", 50, 4, 1, 1),
    ("x P 56 (TMA's shape, by the loader)", 56, 4, 1, 0),
]


@pytest.mark.parametrize("label,cols,heads,panels,off", SSD_TILES)
@pytest.mark.parametrize("row0,nrows", [(0, 128), (256, 77)])
def test_ssd_loader_places_every_element_once(label, cols, heads, panels,
                                              off, row0, nrows):
    """A chunk's tile of the last head (its columns at h * cols of a row of
    heads * cols) through the loader the kernel picks for its alignment
    (pieces of ``piece(tensor base, cols)`` bytes); a partial chunk (77
    valid rows) reads 0 past its rows."""
    h, rows = heads - 1, row0 + 128 + 8
    mem = Memory(rows, heads * cols, 64 + 2 * off, cols=cols, col0=h * cols)
    W = piece(64 + 2 * off, cols)
    smem = Shared(R * 128 * panels)
    if W == 2:
        ssd_ld_elems(mem, smem, row0, nrows, panels)
    else:
        ssd_ld_pieces(mem, smem, W, row0, nrows, panels)
    check_tile(mem, smem, R, panels, row0, 0, nrows)


def test_ssd_piece_widths():
    """The piece width of the SSD edge shapes: rows of P 50 (100 bytes)
    take 4-byte pieces, N 100 (200 bytes) 8-byte ones, odd widths or a
    base one element off 2-byte element loads, P 56 and N 120 whole
    16-byte pieces (TMA takes those)."""
    assert piece(0, 50) == 4 and piece(0, 100) == 8
    assert piece(0, 49) == 2 and piece(0, 77) == 2
    assert piece(2, 64) == 2 and piece(2, 128) == 2
    assert piece(0, 56) == 16 and piece(0, 120) == 16
    assert piece(4, 64) == 4 and piece(8, 64) == 8


# ----------------------------------------------------------------------
# moe_gmm.cu: edge_load_half and edge_half (two threads a row)
# ----------------------------------------------------------------------

def funnel_r(lo, hi, s):
    return ((int(hi) << 32 | int(lo)) >> s) & 0xFFFFFFFF


def gmm_load_half(mem, gr, gc, h):
    """``edge_load_half``: granules 4 h .. 4 h + 4 of the row (r, columns
    c ..), counted from the one that holds its first byte, 0 past its
    valid bytes; (words, m, n)."""
    n = min(64, mem.cols - gc) if gr < mem.rows and gc < mem.cols else 0
    s0 = mem.base + 2 * (gr * mem.ld + gc)
    m, end = s0 % 16, (s0 % 16 + 2 * n if n else 0)
    words = np.zeros(20, dtype=np.uint32)
    for k in range(5):
        if 16 * (4 * h + k) < end:
            words[4 * k:4 * k + 4] = mem.read(
                (s0 & ~15) + 16 * (4 * h + k), 16).view(np.uint32)
    return words, m, n


def gmm_shift_half(words, m, n):
    """``edge_half``'s arithmetic: the half's 20 words shifted left by m
    bytes (two words where m & 8, one where m & 4, a half word where m &
    2), 0 from column n (counted from the half's first) on: 16 words."""
    u = [int(w) for w in words]
    for k in range(18):
        u[k] = u[k + 2] if m & 8 else u[k]
    for k in range(17):
        u[k] = u[k + 1] if m & 4 else u[k]
    for k in range(16):
        u[k] = funnel_r(u[k], u[k + 1], 16) if m & 2 else u[k]
    if n < 32:
        for k in range(16):
            u[k] = 0 if 2 * k >= n else (u[k] & 0xFFFF if 2 * k + 1 >= n
                                         else u[k])
    return np.array(u[:16], dtype=np.uint32)


def gmm_panel(mem, R, r0, c0, panels_cols):
    """One operand's panels of R rows: the tile of rows r0 .. r0 + R - 1
    and the 64-column panels at ``panels_cols``, each row by two threads
    (half h: chunks 4 h .. 4 h + 3 of its line)."""
    smem = Shared(len(panels_cols) * R * 128)
    for pn, c in enumerate(panels_cols):
        for r in range(R):
            for h in range(2):
                words, m, n = gmm_load_half(mem, r0 + r, c, h)
                out = gmm_shift_half(words, m, n - 32 * h)
                for q in range(4):
                    smem.write(pn * R * 128 + r * 128
                               + (((4 * h + q) ^ (r & 7)) << 4),
                               out[4 * q:4 * q + 4].view(np.uint8))
    return smem


# (label, matrix rows, cols, base offset in elements, panel rows R, the
# tile's first row and first column): x at D 1020 (2040-byte rows, a
# base that moves by 8 bytes a row), w at F 510 (1020-byte rows), D 51 /
# F 77 (2-byte rows), a base one element off, and the last column tile
GMM_TILES = [
    ("x D 1020, A rows", 300, 1020, 0, 128, 128, 64),
    ("x D 1020, last column tile", 140, 1020, 0, 128, 0, 960),
    ("w F 510, B panel", 1020, 510, 0, 64, 64, 256),
    ("w F 510, last column tile", 1020, 510, 0, 64, 960, 448),
    ("D 51, past the rows", 100, 51, 0, 128, 0, 0),
    ("F 77, one element off", 51, 77, 1, 64, 0, 64),
    ("D 1024, one element off", 200, 1024, 1, 128, 64, 512),
]


@pytest.mark.parametrize("label,rows,cols,off,R,r0,c0", GMM_TILES)
def test_moe_gmm_edge_places_every_element_once(label, rows, cols, off, R,
                                                r0, c0):
    mem = Memory(rows, cols, 96 + 2 * off)
    smem = gmm_panel(mem, R, r0, c0, [c0])
    nrows = rows - r0
    check_tile(mem, smem, R, 1, r0, c0, nrows)


def test_moe_gmm_edge_two_panels():
    """dw's A (two 64-row panels of x, side by side in columns) and the
    forward's B (two 64-column panels) at F 510: panel p at p * R * 128."""
    mem = Memory(130, 510, 98)
    smem = gmm_panel(mem, 64, 64, 448, [448, 512])
    for p, c0 in enumerate([448, 512]):
        part = Shared(64 * 128)
        part.bytes[:] = smem.bytes[p * 64 * 128:(p + 1) * 64 * 128]
        part.writes[:] = smem.writes[p * 64 * 128:(p + 1) * 64 * 128]
        check_tile(mem, part, 64, 1, 64, c0, 130 - 64)
