"""BOTS-like task-DAG generators (paper §V benchmarks); own copy of
``repro/core/sim/bots.py``.

Each generator reproduces the *tasking structure* of the corresponding
Barcelona OpenMP Task Suite benchmark — recursion shape, fan-out, parallel
combine waves after taskwaits, and memory profile — at a
simulation-friendly scale. Work units are arbitrary (the simulator reports
speedups, which is what the paper reports too).

Memory profiles (``mem_intensity``, ``f_root``, ``f_parent``) follow the
paper's characterization: FFT / Strassen / Sort are "data intensive"
(multi-GB arrays allocated by the master → large first-touch/root traffic)
while NQueens / Floorplan are compute-dominated.
"""

from __future__ import annotations

import numpy as np

from .runtime import TaskSpec, Workload
from .table import table_from_arrays

__all__ = ["fft", "sort", "strassen", "nqueens", "floorplan", "sparselu",
           "fft_flat", "sort_flat", "strassen_flat", "nqueens_flat",
           "sparselu_flat", "WORKLOADS", "make", "PAPER_MIN_TASKS"]

# the paper-scale tier targets BOTS-like task counts (FFT medium spawns
# ~10M tasks); anything above this floor exercises the same regimes.
PAPER_MIN_TASKS = 1_000_000


def _wave(total_work: float, chunk: float, f_root: float,
          f_parent: float) -> list[TaskSpec]:
    """A parallel combine wave: ~total_work split into chunk-sized tasks."""
    n = max(1, int(round(total_work / chunk)))
    w = total_work / n
    return [TaskSpec(work_pre=w, f_root=f_root, f_parent=f_parent)
            for _ in range(n)]


def fft(n: int = 1 << 15, cutoff: int = 1 << 4) -> Workload:
    """Cooley-Tukey recursion: two half-size sub-FFTs, then a parallel
    butterfly/twiddle wave (BOTS parallelizes the combine too).

    BOTS FFT (medium) spawns ~10M tasks over ~6 GB of master-allocated
    arrays; the butterfly wave streams the full root array → high f_root.
    Scaled here to ~n/cutoff leaf tasks.
    """
    def rec(m: int) -> TaskSpec:
        if m <= cutoff:
            return TaskSpec(work_pre=m * np.log2(max(m, 2)),
                            f_root=0.75, f_parent=0.25)
        kids = [rec(m // 2), rec(m // 2)]
        post = _wave(1.0 * m, chunk=4.0 * cutoff, f_root=0.8, f_parent=0.2)
        return TaskSpec(work_pre=0.1 * m, work_post=0.05 * m,
                        f_root=0.8, f_parent=0.2,
                        children=kids, post_children=post)
    return Workload("fft", rec(n), mem_intensity=0.9)


def sort(n: int = 1 << 15, cutoff: int = 1 << 4) -> Workload:
    """BOTS sort (cilksort): 4-way split, parallel merge wave after the
    taskwait. 8.5 GB root array (large input) ⇒ data intensive."""
    def rec(m: int) -> TaskSpec:
        if m <= cutoff:
            return TaskSpec(work_pre=m * np.log2(max(m, 2)),
                            f_root=0.7, f_parent=0.3)
        kids = [rec(m // 4) for _ in range(4)]
        post = _wave(1.2 * m, chunk=4.0 * cutoff, f_root=0.75, f_parent=0.25)
        return TaskSpec(work_pre=0.05 * m, work_post=0.05 * m,
                        f_root=0.75, f_parent=0.25,
                        children=kids, post_children=post)
    return Workload("sort", rec(n), mem_intensity=0.8)


def strassen(depth: int = 5, base_work: float = 512.0) -> Workload:
    """Strassen: 7 recursive multiplies, then a parallel add/sub wave.

    ~7 GB of matrices; adds/subs at every level stream big temporaries →
    high parent-locality payoff, which is why the paper sees the largest
    scheduler win here (+17% DFWSRPT).
    """
    def rec(d: int) -> TaskSpec:
        # matrices at depth d have (1/2^d)^2 the area; work ~ area^1.5.
        area = 4.0 ** (depth - d)
        if d == 0:
            return TaskSpec(work_pre=base_work, f_root=0.45, f_parent=0.55)
        kids = [rec(d - 1) for _ in range(7)]
        post = _wave(2.0 * area, chunk=32.0, f_root=0.4, f_parent=0.6)
        return TaskSpec(work_pre=0.3 * area, work_post=0.05 * area,
                        f_root=0.4, f_parent=0.6,
                        children=kids, post_children=post)
    return Workload("strassen", rec(depth), mem_intensity=0.85)


def nqueens(n: int = 11, cutoff_depth: int = 4, seed: int = 0) -> Workload:
    """NQueens: irregular tree, tiny per-task state (the board copy) —
    compute bound, so NUMA effects are small (paper: +1.35% at best) and
    breadth-first's perfect balancing wins."""
    rng = np.random.RandomState(seed)

    def rec(depth: int, branch: int) -> TaskSpec:
        if depth >= cutoff_depth:
            # leaf explores the remaining subtree serially
            w = float(rng.randint(40, 120)) * (n - depth)
            return TaskSpec(work_pre=w, f_root=0.05, f_parent=0.1)
        # some placements are pruned — irregular fan-out
        k = max(1, branch - int(rng.randint(0, max(branch // 2, 1))))
        kids = [rec(depth + 1, branch - 1) for _ in range(k)]
        return TaskSpec(work_pre=2.0, work_post=0.5,
                        f_root=0.05, f_parent=0.1, children=kids)
    return Workload("nqueens", rec(0, n), mem_intensity=0.15)


def floorplan(branch: int = 6, depth: int = 5, seed: int = 1) -> Workload:
    """Floorplan: branch-and-bound over cell placements; small shared
    grid, moderate locality."""
    rng = np.random.RandomState(seed)

    def rec(d: int) -> TaskSpec:
        if d >= depth:
            return TaskSpec(work_pre=float(rng.randint(20, 80)),
                            f_root=0.2, f_parent=0.2)
        k = max(1, branch - int(rng.randint(0, branch // 2 + 1)))
        kids = [rec(d + 1) for _ in range(k)]
        return TaskSpec(work_pre=3.0, work_post=1.0,
                        f_root=0.2, f_parent=0.2, children=kids)
    return Workload("floorplan", rec(0), mem_intensity=0.3)


def sparselu(n: int = 20) -> Workload:
    """SparseLU (omp-for flavour): sequential outer k-loop, each step
    spawning a wide wave of block-update tasks over the master-allocated
    blocked matrix. The k-chain is modeled with nested post-waves."""
    def step(k: int) -> TaskSpec:
        wave = [TaskSpec(work_pre=30.0, f_root=0.6, f_parent=0.2)
                for _ in range(max(1, k * k // 4))]
        nxt = [step(k - 1)] if k > 1 else []
        # diagonal factorization (serial) → update wave → next k step
        return TaskSpec(work_pre=10.0, work_post=2.0, f_root=0.6,
                        f_parent=0.1, children=wave, post_children=nxt)
    return Workload("sparselu", step(n - 1), mem_intensity=0.7)


# ----------------------------------------------------------------------
# Flat (iterative, tree-free) CSR builders for paper-scale task counts.
#
# The divide-and-conquer benchmarks above are *uniform*: every node at a
# given recursion level has identical work/profile/fan-out, so the whole
# CSR table can be laid out level-by-level with numpy tiling — no
# TaskSpec objects, no recursion, millions of tasks in ~a second. For
# identical parameters these produce tables exactly equal to
# ``compile_tree`` of the recursive builders (covered by tests).
# ----------------------------------------------------------------------


def _uniform_flat(levels: list[dict], leaf: dict,
                  mem_intensity: float, name: str) -> Workload:
    """Build a Workload table for a uniform recursive tree.

    ``levels[k]`` describes the internal nodes at depth k:
      wp, wpo, fr, fp   — the node's own scalars,
      nch               — number of recursive children,
      nw, wave_w, wave_fr, wave_fp — its post-taskwait combine wave.
    ``leaf`` (wp, fr, fp) describes the nodes below the last level.

    Ids are assigned in BFS block order (matching ``compile_tree``):
    after the root, each node's block is [children..., wave...], blocks
    in parent-id order. A node's expansion block depends only on its
    level, so every per-level segment is one numpy tile.
    """
    if not levels:
        return Workload(name, None, mem_intensity, table=table_from_arrays(
            np.array([leaf["wp"]]), np.zeros(1),
            np.array([leaf["fr"]]), np.array([leaf["fp"]]),
            np.zeros(1, np.int64), np.zeros(1, np.int64)))
    lv0 = levels[0]
    seg_wp = [np.array([lv0["wp"]])]
    seg_wpo = [np.array([lv0["wpo"]])]
    seg_fr = [np.array([lv0["fr"]])]
    seg_fp = [np.array([lv0["fp"]])]
    seg_nc = [np.array([lv0["nch"]], np.int64)]
    seg_npw = [np.array([lv0["nw"]], np.int64)]
    count = 1
    for k, lv in enumerate(levels):
        child = levels[k + 1] if k + 1 < len(levels) else None
        nch, nw = lv["nch"], lv["nw"]
        if child is not None:
            c_wp, c_wpo = child["wp"], child["wpo"]
            c_fr, c_fp = child["fr"], child["fp"]
            c_nc, c_npw = child["nch"], child["nw"]
        else:
            c_wp, c_wpo = leaf["wp"], 0.0
            c_fr, c_fp = leaf["fr"], leaf["fp"]
            c_nc = c_npw = 0
        pat = lambda c_val, w_val, dt=np.float64: np.tile(
            np.array([c_val] * nch + [w_val] * nw, dtype=dt), count)
        seg_wp.append(pat(c_wp, lv["wave_w"]))
        seg_wpo.append(pat(c_wpo, 0.0))
        seg_fr.append(pat(c_fr, lv["wave_fr"]))
        seg_fp.append(pat(c_fp, lv["wave_fp"]))
        seg_nc.append(pat(c_nc, 0, np.int64))
        seg_npw.append(pat(c_npw, 0, np.int64))
        count *= nch
    tbl = table_from_arrays(
        np.concatenate(seg_wp), np.concatenate(seg_wpo),
        np.concatenate(seg_fr), np.concatenate(seg_fp),
        np.concatenate(seg_nc), np.concatenate(seg_npw))
    return Workload(name, None, mem_intensity, table=tbl)


def _wave_count(total_work: float, chunk: float) -> int:
    return max(1, int(round(total_work / chunk)))


def fft_flat(n: int = 1 << 21, cutoff: int = 1 << 3) -> Workload:
    """Flat-table twin of :func:`fft` (same structure, no TaskSpec tree)."""
    levels = []
    m = n
    while m > cutoff:
        total = 1.0 * m
        nw = _wave_count(total, 4.0 * cutoff)
        levels.append(dict(wp=0.1 * m, wpo=0.05 * m, fr=0.8, fp=0.2,
                           nch=2, nw=nw, wave_w=total / nw,
                           wave_fr=0.8, wave_fp=0.2))
        m //= 2
    leaf = dict(wp=m * np.log2(max(m, 2)), fr=0.75, fp=0.25)
    return _uniform_flat(levels, leaf, mem_intensity=0.9, name="fft")


def sort_flat(n: int = 1 << 22, cutoff: int = 1 << 4) -> Workload:
    """Flat-table twin of :func:`sort`."""
    levels = []
    m = n
    while m > cutoff:
        total = 1.2 * m
        nw = _wave_count(total, 4.0 * cutoff)
        levels.append(dict(wp=0.05 * m, wpo=0.05 * m, fr=0.75, fp=0.25,
                           nch=4, nw=nw, wave_w=total / nw,
                           wave_fr=0.75, wave_fp=0.25))
        m //= 4
    leaf = dict(wp=m * np.log2(max(m, 2)), fr=0.7, fp=0.3)
    return _uniform_flat(levels, leaf, mem_intensity=0.8, name="sort")


def strassen_flat(depth: int = 6, base_work: float = 512.0) -> Workload:
    """Flat-table twin of :func:`strassen`."""
    levels = []
    for d in range(depth, 0, -1):  # root has d == depth
        area = 4.0 ** (depth - d)
        total = 2.0 * area
        nw = _wave_count(total, 32.0)
        levels.append(dict(wp=0.3 * area, wpo=0.05 * area, fr=0.4, fp=0.6,
                           nch=7, nw=nw, wave_w=total / nw,
                           wave_fr=0.4, wave_fp=0.6))
    leaf = dict(wp=base_work, fr=0.45, fp=0.55)
    return _uniform_flat(levels, leaf, mem_intensity=0.85, name="strassen")


# ----------------------------------------------------------------------
# Irregular paper tier: level-synchronous builder with per-node random
# fan-out. Unlike the uniform builders above there is no per-level tile
# to repeat — instead each BFS level's child counts are drawn as one
# vectorized randint and the CSR arrays grow level by level, so a
# multi-million-task irregular tree still never materializes a TaskSpec.
# ----------------------------------------------------------------------


def nqueens_flat(n: int = 16, cutoff_depth: int = 6,
                 seed: int = 0) -> Workload:
    """Paper-scale twin of :func:`nqueens` (irregular fan-out, no tree).

    Same tasking structure and memory profile as the recursive builder —
    internal nodes spawn ``max(1, branch - randint(0, branch//2))``
    children with ``branch = n - depth``, leaves explore the remaining
    subtree serially — but the fan-outs of a whole level are drawn in
    one vectorized call and appended straight to the CSR arrays
    (level-synchronous BFS id order, which is exactly the layout
    ``table_from_arrays`` expects). Defaults give ~1.7M tasks, the
    BOTS-medium regime. Deterministic per seed; the rng *stream* differs
    from the recursive builder's depth-first draw order, so this is its
    own tier, not a bit-twin.
    """
    if cutoff_depth < 1:
        raise ValueError("cutoff_depth must be >= 1")
    rng = np.random.RandomState(seed)
    seg_wp, seg_nc = [], []
    m = 1  # nodes at the current level (root)
    for depth in range(cutoff_depth):
        branch = n - depth
        if branch < 1:
            raise ValueError(f"cutoff_depth {cutoff_depth} too deep for "
                             f"n={n} (branch hits zero)")
        draws = rng.randint(0, max(branch // 2, 1), size=m)
        k = np.maximum(1, branch - draws).astype(np.int64)
        seg_wp.append(np.full(m, 2.0))
        seg_nc.append(k)
        m = int(k.sum())
    # leaves explore their remaining placements serially
    leaf_w = rng.randint(40, 120, size=m).astype(np.float64) \
        * float(n - cutoff_depth)
    seg_wp.append(leaf_w)
    seg_nc.append(np.zeros(m, np.int64))
    wp = np.concatenate(seg_wp)
    nc = np.concatenate(seg_nc)
    total = wp.shape[0]
    n_internal = total - m
    wpo = np.zeros(total)
    wpo[:n_internal] = 0.5
    tbl = table_from_arrays(
        wp, wpo, np.full(total, 0.05), np.full(total, 0.1),
        nc, np.zeros(total, np.int64))
    return Workload("nqueens", None, mem_intensity=0.15, table=tbl)


def sparselu_flat(n: int = 240) -> Workload:
    """Paper-scale twin of :func:`sparselu` (flat CSR, no tree).

    SparseLU is the one BOTS benchmark whose parallelism is a
    *sequential outer chain*: step k factorizes a diagonal block, spawns
    a wave of ~k²/4 block updates, and only then (post-taskwait) steps
    to k-1. The chain folds directly into the level-by-level CSR
    layout: BFS id order is [step, its wave..., next step, its wave...]
    because wave tasks are leaves — so the whole table is two
    ``np.repeat`` patterns over the chain, never a TaskSpec. For equal
    ``n`` this is an exact twin of ``compile_tree(sparselu(n).root)``
    (covered by tests); the default ``n=240`` gives ~1.14M tasks, the
    BOTS-large regime.
    """
    if n < 2:
        raise ValueError("sparselu needs n >= 2")
    ks = np.arange(n - 1, 0, -1, dtype=np.int64)
    wcounts = np.maximum(1, ks * ks // 4)
    # interleaved [chain node, its wave] segments, one pair per k
    counts = np.empty(2 * ks.size, np.int64)
    counts[0::2] = 1
    counts[1::2] = wcounts

    def pat(chain_vals, wave_val, dt=np.float64):
        vals = np.empty(2 * ks.size, dt)
        vals[0::2] = chain_vals
        vals[1::2] = wave_val
        return np.repeat(vals, counts)

    npw_chain = np.ones(ks.size, np.int64)
    npw_chain[-1] = 0           # k == 1 ends the chain
    tbl = table_from_arrays(
        pat(10.0, 30.0), pat(2.0, 0.0), pat(0.6, 0.6), pat(0.1, 0.2),
        pat(wcounts, 0, np.int64), pat(npw_chain, 0, np.int64))
    return Workload("sparselu", None, mem_intensity=0.7, table=tbl)


WORKLOADS = {
    "fft": fft, "sort": sort, "strassen": strassen,
    "nqueens": nqueens, "floorplan": floorplan, "sparselu": sparselu,
}

PAPER_BUILDERS = {
    "fft": fft_flat, "sort": sort_flat, "strassen": strassen_flat,
    "nqueens": nqueens_flat, "sparselu": sparselu_flat,
}


def workload_cache_key(name: str, scale: str) -> str:
    """Content-addressed key of one ``make(name, scale)`` product.

    Builder identity = the instance coordinates plus a hash of the
    builder sources (this module *and* the table layout it compiles
    into): editing either changes the key, so stale cached tables miss
    instead of shadowing new code.
    """
    from . import bots as _self, compile_cache, table
    return compile_cache.digest_key(
        "workload", name, scale,
        compile_cache.source_fingerprint(_self, table))


def make(name: str, scale: str = "medium") -> Workload:
    """Scaled instances. 'medium'/'large' mirror the paper's input sets;
    'paper' builds flat tables at BOTS-like task counts (≥1M tasks) for
    the data-intensive benchmarks.

    Compiled tables persist in the :mod:`~.compile_cache`: a warm
    machine re-opens a paper-scale table as a read-only memory map in
    milliseconds instead of re-running the builder for seconds. A cache
    hit returns a table-only workload (``root is None``) — the engines
    and every ``make`` call site consume only the table.
    """
    from .compile_cache import get_cache
    cache = get_cache()
    key = workload_cache_key(name, scale) if cache is not None else None
    if cache is not None:
        wl = cache.get_workload(key)
        if wl is not None:
            return wl
    wl = _build(name, scale)
    if cache is not None:
        cache.put_workload(key, wl)
    return wl


def _build(name: str, scale: str) -> Workload:
    if scale == "paper":
        builder = PAPER_BUILDERS.get(name)
        if builder is None:
            raise ValueError(
                f"no paper-scale tier for {name!r}; available: "
                f"{sorted(PAPER_BUILDERS)}")
        return builder()
    if name == "fft":
        return fft(n=(1 << 15) if scale == "medium" else (1 << 16))
    if name == "sort":
        return sort(n=(1 << 15) if scale == "medium" else (1 << 16))
    if name == "strassen":
        return strassen(depth=5 if scale == "medium" else 6)
    if name == "nqueens":
        return nqueens(n=11 if scale == "medium" else 12)
    if name == "floorplan":
        return floorplan(depth=5 if scale == "medium" else 6)
    if name == "sparselu":
        return sparselu(n=20 if scale == "medium" else 28)
    raise KeyError(name)
