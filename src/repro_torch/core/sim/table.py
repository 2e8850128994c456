"""Flat, structure-of-arrays task tables for the NANOS simulator (own copy
of ``repro/core/sim/table.py``).

A :class:`TaskTable` is the compiled form of a :class:`TaskSpec` tree:
one integer id per task, CSR-style child/post-wave ranges, and parallel
numpy arrays for the per-task scalars. Ids are assigned in BFS order so
that every task's ``children`` and ``post_children`` occupy *contiguous*
id ranges — the runtime then never touches a Python object per task,
only integer indices into these arrays.

Tasks also carry a *memory-profile class* id: the (f_root, f_parent)
pairs of a benchmark tree repeat heavily (a whole combine wave shares
one profile), so the runtime can precompute NUMA penalty lookup tables
per class × node instead of recomputing the penalty formula per task.

Everything here is **iterative** — no recursion — so paper-scale trees
(millions of tasks) compile without hitting the interpreter stack limit;
the CSR index arrays are derived from the per-task child counts with
vectorized cumsum/repeat, never a per-task Python append.

The arrays stay numpy on the host: the card's wrapper
(:mod:`repro_torch.kernels.sim`) copies each table of a batch to the
device once, and every cell of that workload reads the one copy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TaskTable", "table_from_arrays", "compile_tree"]


class TaskTable:
    """CSR task tables (see module docstring).

    Attributes (all length ``n`` unless noted):
      work_pre, work_post:    float64 work units (pre-spawn / join).
      f_root, f_parent:       float64 memory-traffic fractions.
      first_child, num_children:  child id range [fc, fc+nc).
      first_post, num_post:       post-wave id range [fp, fp+np).
      parent:                 parent id (-1 for the root).
      cls:                    memory-profile class id per task.
      cls_f_root, cls_f_parent:  (num_classes,) class profiles.
    """

    __slots__ = ("n", "work_pre", "work_post", "f_root", "f_parent",
                 "first_child", "num_children", "first_post", "num_post",
                 "parent", "cls", "cls_f_root", "cls_f_parent",
                 "_serial_cache", "_lists", "_fingerprint")

    def __init__(self, work_pre, work_post, f_root, f_parent,
                 first_child, num_children, first_post, num_post, parent):
        def as_f(a):
            return np.ascontiguousarray(a, dtype=np.float64)

        def as_i(a):
            return np.ascontiguousarray(a, dtype=np.int64)

        self.work_pre = as_f(work_pre)
        self.work_post = as_f(work_post)
        self.f_root = as_f(f_root)
        self.f_parent = as_f(f_parent)
        self.first_child = as_i(first_child)
        self.num_children = as_i(num_children)
        self.first_post = as_i(first_post)
        self.num_post = as_i(num_post)
        self.parent = as_i(parent)
        self.n = int(self.work_pre.shape[0])
        # memory-profile classes: dedupe (f_root, f_parent) pairs. A
        # complex view gives an exact lexicographic pair sort without
        # the much slower np.unique(..., axis=0) path.
        pairs = self.f_root + 1j * self.f_parent
        uniq, inv = np.unique(pairs, return_inverse=True)
        self.cls = np.ascontiguousarray(inv, dtype=np.int64)
        self.cls_f_root = np.ascontiguousarray(uniq.real)
        self.cls_f_parent = np.ascontiguousarray(uniq.imag)
        self._serial_cache: dict = {}
        self._lists = None
        self._fingerprint = None

    def fingerprint(self) -> str:
        """Stable content digest of the compiled workload structure.

        Hashes the defining per-task arrays (work, memory profiles,
        child/post counts — the CSR index arrays and classes are derived
        from these, so they add nothing). Two tables with equal
        fingerprints describe the same computation regardless of how
        they were built (tree compile vs paper-scale direct builder),
        which is exactly the identity the persistent result store keys
        on; the digest equals the JAX package's for equal arrays. Cached:
        paper-scale tables are tens of MB and the digest is a one-time
        ~100 ms cost per workload.
        """
        if self._fingerprint is None:
            import hashlib
            h = hashlib.blake2b(digest_size=16)
            for arr in (self.work_pre, self.work_post, self.f_root,
                        self.f_parent, self.num_children, self.num_post):
                h.update(arr.tobytes())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    @property
    def num_classes(self) -> int:
        return int(self.cls_f_root.shape[0])

    def total_work(self) -> float:
        return float(self.work_pre.sum() + self.work_post.sum())

    def lists(self):
        """Python-list views of the hot arrays (cached).

        The plain engine indexes these ~10x faster than numpy scalar
        indexing; the card's kernel reads the arrays.
        """
        if self._lists is None:
            self._lists = (
                self.work_pre.tolist(), self.work_post.tolist(),
                self.first_child.tolist(), self.num_children.tolist(),
                self.first_post.tolist(), self.num_post.tolist(),
                self.parent.tolist(), self.cls.tolist(),
            )
        return self._lists

    # every array a table consists of, including the derived CSR
    # indices and profile classes — persisting the derived arrays too
    # lets :meth:`restore` skip the np.unique class dedup (~100 ms at
    # paper scale) and keep mmap'd blobs untouched.
    ARRAY_FIELDS = ("work_pre", "work_post", "f_root", "f_parent",
                    "first_child", "num_children", "first_post",
                    "num_post", "parent", "cls", "cls_f_root",
                    "cls_f_parent")

    def saved_arrays(self) -> dict:
        """All defining + derived arrays, keyed by field name."""
        return {name: getattr(self, name) for name in self.ARRAY_FIELDS}

    @classmethod
    def restore(cls, arrays: dict,
                fingerprint: "str | None" = None) -> "TaskTable":
        """Rebuild a table from :meth:`saved_arrays` output *as is*.

        Trusted-restore path for the compile cache: the arrays (often
        read-only memory maps) are adopted without the ``__init__``
        normalization or class recompute, and a known fingerprint is
        pre-seeded so a restored paper-scale table never hashes its
        tens of MB just to be identified.
        """
        missing = [f for f in cls.ARRAY_FIELDS if f not in arrays]
        if missing:
            raise ValueError(f"table restore missing arrays: {missing}")
        self = object.__new__(cls)
        for name in cls.ARRAY_FIELDS:
            setattr(self, name, arrays[name])
        self.n = int(self.work_pre.shape[0])
        self._serial_cache = {}
        self._lists = None
        self._fingerprint = fingerprint
        return self


def table_from_arrays(work_pre, work_post, f_root, f_parent,
                      num_children, num_post) -> TaskTable:
    """Build a table from per-task scalars + child/post counts.

    The tasks must already be in BFS id order (each task's children
    followed by its post wave form one contiguous block, blocks laid out
    in parent-id order). The CSR index arrays follow from the counts:
    ``first_child[i] = 1 + sum(blocks[:i])`` and the parent of every id
    in block *i* is *i* — both fully vectorized.
    """
    nc = np.ascontiguousarray(num_children, dtype=np.int64)
    npw = np.ascontiguousarray(num_post, dtype=np.int64)
    n = nc.shape[0]
    blocks = nc + npw
    fc = np.empty(n, dtype=np.int64)
    fc[0] = 1
    if n > 1:
        np.cumsum(blocks[:-1], out=fc[1:])
        fc[1:] += 1
    fpw = fc + nc
    parent = np.empty(n, dtype=np.int64)
    parent[0] = -1
    parent[1:] = np.repeat(np.arange(n, dtype=np.int64), blocks)
    return TaskTable(work_pre, work_post, f_root, f_parent,
                     fc, nc, fpw, npw, parent)


def compile_tree(root) -> TaskTable:
    """Compile a :class:`TaskSpec` tree into a :class:`TaskTable`.

    Iterative BFS: a single pass collects the specs in id order, then
    the scalar arrays are gathered with ``np.fromiter`` and the CSR
    indices derived vectorized.
    """
    specs = [root]
    i = 0
    while i < len(specs):
        s = specs[i]
        if s.children:
            specs.extend(s.children)
        if s.post_children:
            specs.extend(s.post_children)
        i += 1
    from operator import attrgetter
    n = len(specs)
    wp = np.fromiter(map(attrgetter("work_pre"), specs), np.float64, n)
    wpo = np.fromiter(map(attrgetter("work_post"), specs), np.float64, n)
    fr = np.fromiter(map(attrgetter("f_root"), specs), np.float64, n)
    fp = np.fromiter(map(attrgetter("f_parent"), specs), np.float64, n)
    nc = np.fromiter(map(len, map(attrgetter("children"), specs)),
                     np.int64, n)
    npw = np.fromiter(map(len, map(attrgetter("post_children"), specs)),
                      np.int64, n)
    return table_from_arrays(wp, wpo, fr, fp, nc, npw)
