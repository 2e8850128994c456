"""Persistent, content-addressed compile cache for the simulator (own
copy of ``repro/core/sim/compile_cache.py``, keyed as that one is, under
a root of its own).

The runtime precomputes a lot before the first event fires: paper-scale
:class:`~.table.TaskTable` builds take seconds, the serial-reference
walk ~0.5 s, context/victim-plan lowering a few ms. All of it is *pure*
— a function of content that can be fingerprinted — so this module
persists every compile product on disk and loads it back zero-copy,
taking a cold process from seconds to milliseconds:

* **task tables** — every array of a compiled table saved as an
  ``.npy`` blob, keyed by builder identity (workload name, scale, and a
  hash of the builder sources), loaded back via
  ``np.load(mmap_mode="r")`` so a paper-scale table opens without
  reading (or copying) its tens of MB; the engines treat table arrays
  as read-only, so the memory-mapped pages are shared across processes.
  The card's wrapper packs a memory-mapped table exactly as a built
  one: the same bits reach the kernel.
* **serial references** — the scalar from :func:`~.runtime.serial_time`
  keyed by (table fingerprint, topology fingerprint, data nodes, µ, λ):
  the full serial walk runs once per machine, ever. JSON round-trips
  Python floats exactly (repr is shortest-round-trip), so replayed
  values are bit-identical.
* **context lowerings** — the paper-priority thread binding and the
  first-touch spill walk, keyed by (topology fingerprint, spec, seed).
* **victim plans** — the compiled sweep programs of
  :func:`~.policy.compile_victim_plan`, keyed by (topology fingerprint,
  victim policy, core binding).

There is no compiled-kernel entry: ``kernels/_build.py`` keys the CUDA
build of ``csrc/sim.cu`` by its source hash under ``kernels/build/``.

Location & control
------------------

The root defaults to ``$XDG_CACHE_HOME/repro-sim-torch`` (usually
``~/.cache/repro-sim-torch``), apart from the JAX package's
``repro-sim``, so that neither package reads the other's artifacts;
override it with ``REPRO_TORCH_SIM_CACHE=/path``, disable caching
entirely with ``REPRO_TORCH_SIM_CACHE=0`` (every consult is then a
no-op). Clearing the cache is just ``rm -rf`` — every artifact is
rebuilt on demand.

Durability & integrity
----------------------

Writes are atomic: array artifacts are staged into a ``*.tmp-<pid>``
sibling directory and ``os.rename``\\ d into place, scalar artifacts go
through ``mkstemp`` + ``os.replace``. Two processes racing a write both
succeed (content under a key is identical by construction — last
rename wins with equivalent bytes). Every artifact carries a manifest
with a checksum and per-array dtype/shape/byte-size records; a torn,
corrupted, or version-mismatched artifact is detected at load, warned
about once, deleted best-effort, and the caller rebuilds — corruption
can cost time, never correctness. Array *data* checksums are verified
eagerly for small artifacts; multi-MB blobs are validated structurally
(header + exact byte size) so a hit stays O(ms) — export
``REPRO_TORCH_SIM_CACHE_VERIFY=1`` to force full data verification.

Layout::

    <root>/
      tables/<key>/manifest.json + <array>.npy
      serial/<key>.json
      contexts/<key>.json
      plans/<key>.json
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import warnings

import numpy as np

__all__ = ["CompileCache", "get_cache", "reset_cache", "cache_root",
           "source_fingerprint", "digest_key"]

ENV_VAR = "REPRO_TORCH_SIM_CACHE"
VERIFY_VAR = "REPRO_TORCH_SIM_CACHE_VERIFY"
FORMAT = "repro-sim-compile-cache"
VERSION = 1

# artifacts at or below this byte size get their data checksums verified
# on every load; larger ones are validated structurally unless
# REPRO_TORCH_SIM_CACHE_VERIFY=1 (full verification would read — and so page
# in — every mmap'd byte, defeating the zero-copy load).
_VERIFY_LIMIT = 1 << 20


def cache_root() -> "str | None":
    """Resolve the cache root directory (``None`` = caching disabled)."""
    env = os.environ.get(ENV_VAR)
    if env is not None:
        env = env.strip()
        if env in ("", "0", "off", "none"):
            return None
        return env
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "repro-sim-torch")


# (env value at resolution time, cache instance or None); re-resolved
# whenever REPRO_TORCH_SIM_CACHE changes.
_cache_state: "tuple[str | None, CompileCache | None] | None" = None


def get_cache() -> "CompileCache | None":
    """The process-wide cache handle (``None`` when disabled).

    One handle is shared by every consumer — ``bots.make``, the serial
    reference, context/plan lowering, grid sweeps — so hit/miss
    statistics aggregate across a whole run.
    """
    global _cache_state
    env = os.environ.get(ENV_VAR)
    state = _cache_state
    if state is not None and state[0] == env:
        return state[1]
    root = cache_root()
    cache = CompileCache(root) if root is not None else None
    _cache_state = (env, cache)
    return cache


def reset_cache() -> None:
    """Drop the cached handle (tests / after changing
    ``REPRO_TORCH_SIM_CACHE``)."""
    global _cache_state
    _cache_state = None


def digest_key(*material) -> str:
    """Stable 32-hex digest of arbitrary repr-able key material."""
    return hashlib.blake2b(repr(material).encode(),
                           digest_size=16).hexdigest()


_source_fps: dict = {}


def source_fingerprint(*modules) -> str:
    """Content hash of the given modules' source files (cached).

    Used as the *builder identity* component of table keys: editing a
    workload builder (or the table layout it compiles into) changes the
    hash, so stale artifacts miss instead of shadowing the new code.
    """
    key = tuple(m.__name__ for m in modules)
    fp = _source_fps.get(key)
    if fp is None:
        h = hashlib.blake2b(digest_size=16)
        for m in modules:
            with open(m.__file__, "rb") as f:
                h.update(f.read())
        fp = h.hexdigest()
        _source_fps[key] = fp
    return fp


def _checksum(payload) -> str:
    return hashlib.blake2b(
        json.dumps(payload, sort_keys=True, separators=(",", ":")).encode(),
        digest_size=16).hexdigest()


class CompileCache:
    """On-disk artifact cache rooted at ``root`` (see module docstring).

    All ``get_*`` methods return ``None`` on a miss *or* on a corrupt /
    version-mismatched artifact (after a one-time warning naming it);
    all ``put_*`` methods are atomic and silently tolerate a concurrent
    writer. ``stats()`` reports per-category hits/misses/corruptions.
    """

    def __init__(self, root: str):
        self.root = os.fspath(root)
        self.hits: dict = {}
        self.misses: dict = {}
        self.corrupt: dict = {}
        self._warned: set = set()
        self._verify_all = bool(os.environ.get(VERIFY_VAR))

    def __repr__(self) -> str:
        return (f"CompileCache({self.root!r}: hits={self.hits}, "
                f"misses={self.misses})")

    def stats(self) -> dict:
        return dict(hits=dict(self.hits), misses=dict(self.misses),
                    corrupt=dict(self.corrupt))

    def hit_count(self, category: "str | None" = None) -> int:
        if category is not None:
            return self.hits.get(category, 0)
        return sum(self.hits.values())

    # -- bookkeeping ----------------------------------------------------
    def _tally(self, book: dict, category: str) -> None:
        book[category] = book.get(category, 0) + 1

    def _discard(self, category: str, key: str, path: str,
                 why: str) -> None:
        """Corrupt artifact: warn once, tally, remove best-effort."""
        self._tally(self.corrupt, category)
        self._tally(self.misses, category)
        if path not in self._warned:
            self._warned.add(path)
            warnings.warn(
                f"compile cache: discarding {category}/{key} ({why}); "
                "rebuilding from scratch", RuntimeWarning, stacklevel=4)
        try:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            elif os.path.exists(path):
                os.unlink(path)
        except OSError:
            pass

    def _dir(self, category: str) -> str:
        return os.path.join(self.root, category)

    # -- scalar (JSON) artifacts ----------------------------------------
    def _json_path(self, category: str, key: str) -> str:
        return os.path.join(self.root, category, key + ".json")

    def put_json(self, category: str, key: str, payload) -> None:
        """Atomically store a small JSON-able payload under a key."""
        d = self._dir(category)
        os.makedirs(d, exist_ok=True)
        doc = {"format": FORMAT, "version": VERSION, "key": key,
               "payload": payload, "checksum": _checksum(payload)}
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f, separators=(",", ":"))
            os.replace(tmp, self._json_path(category, key))
        except OSError:
            # cache dir vanished / quota / read-only fs: caching is
            # best-effort, never a failure of the caller
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def get_json(self, category: str, key: str):
        """Load a JSON payload; ``None`` on miss/corruption."""
        path = self._json_path(category, key)
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            self._tally(self.misses, category)
            return None
        except (ValueError, OSError):
            self._discard(category, key, path, "unparseable JSON")
            return None
        if doc.get("format") != FORMAT or doc.get("version") != VERSION:
            self._discard(category, key, path, "version mismatch")
            return None
        payload = doc.get("payload")
        if _checksum(payload) != doc.get("checksum"):
            self._discard(category, key, path, "checksum mismatch")
            return None
        self._tally(self.hits, category)
        return payload

    # -- array artifacts (directory of .npy + manifest) -----------------
    def _array_dir(self, category: str, key: str) -> str:
        return os.path.join(self.root, category, key)

    def put_arrays(self, category: str, key: str,
                   arrays: "dict[str, np.ndarray]", meta: dict) -> None:
        """Atomically store named arrays + metadata under a key.

        Stages everything into a ``<key>.tmp-<pid>`` sibling and renames
        the directory into place; a concurrent writer's rename losing
        the race is fine (equal keys hold equal content).
        """
        final = self._array_dir(category, key)
        if os.path.isdir(final):
            return                      # first write wins
        parent = self._dir(category)
        try:
            os.makedirs(parent, exist_ok=True)
            stage = tempfile.mkdtemp(prefix=key + ".tmp-", dir=parent)
        except OSError:
            return
        try:
            manifest_arrays = {}
            for name, arr in arrays.items():
                arr = np.ascontiguousarray(arr)
                np.save(os.path.join(stage, name + ".npy"), arr)
                manifest_arrays[name] = {
                    "file": name + ".npy",
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                    "nbytes": int(arr.nbytes),
                    "blake2b": hashlib.blake2b(
                        arr.tobytes(), digest_size=16).hexdigest(),
                }
            payload = {"arrays": manifest_arrays, "meta": meta}
            doc = {"format": FORMAT, "version": VERSION, "key": key,
                   "payload": payload, "checksum": _checksum(payload)}
            with open(os.path.join(stage, "manifest.json"), "w",
                      encoding="utf-8") as f:
                json.dump(doc, f, separators=(",", ":"))
            try:
                os.rename(stage, final)
            except OSError:
                shutil.rmtree(stage, ignore_errors=True)  # lost the race
        except OSError:
            shutil.rmtree(stage, ignore_errors=True)

    def get_arrays(self, category: str, key: str,
                   mmap: bool = True):
        """Load ``(arrays, meta)`` back; ``None`` on miss/corruption.

        Arrays come back as read-only memory maps (``mmap=True``) —
        opening is O(header), data pages fault in on demand — or plain
        in-memory copies. Structural validation (manifest checksum,
        dtype/shape/byte size per array) always runs; data checksums
        run for small artifacts or under ``REPRO_TORCH_SIM_CACHE_VERIFY=1``.
        """
        adir = self._array_dir(category, key)
        mpath = os.path.join(adir, "manifest.json")
        try:
            with open(mpath, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            self._tally(self.misses, category)
            return None
        except (ValueError, OSError):
            self._discard(category, key, adir, "unparseable manifest")
            return None
        if doc.get("format") != FORMAT or doc.get("version") != VERSION:
            self._discard(category, key, adir, "version mismatch")
            return None
        payload = doc.get("payload")
        if not isinstance(payload, dict) or \
                _checksum(payload) != doc.get("checksum"):
            self._discard(category, key, adir, "manifest checksum mismatch")
            return None
        arrays = {}
        total = sum(rec["nbytes"] for rec in payload["arrays"].values())
        verify = self._verify_all or total <= _VERIFY_LIMIT
        for name, rec in payload["arrays"].items():
            path = os.path.join(adir, rec["file"])
            try:
                arr = np.load(path, mmap_mode="r" if mmap else None,
                              allow_pickle=False)
            except (ValueError, OSError):
                self._discard(category, key, adir,
                              f"torn/unreadable array {rec['file']!r}")
                return None
            if (str(arr.dtype) != rec["dtype"]
                    or list(arr.shape) != rec["shape"]
                    or int(arr.nbytes) != rec["nbytes"]
                    or not arr.flags["C_CONTIGUOUS"]):
                self._discard(category, key, adir,
                              f"array {rec['file']!r} does not match its "
                              "manifest record")
                return None
            if verify and hashlib.blake2b(
                    arr.tobytes(), digest_size=16).hexdigest() \
                    != rec["blake2b"]:
                self._discard(category, key, adir,
                              f"array {rec['file']!r} data checksum "
                              "mismatch")
                return None
            arrays[name] = arr
        self._tally(self.hits, category)
        return arrays, payload["meta"]

    # ------------------------------------------------------------------
    # Typed helpers: task tables / workloads
    # ------------------------------------------------------------------
    def get_workload(self, key: str):
        """Load a cached :class:`~.runtime.Workload` (mmap-backed table)."""
        hit = self.get_arrays("tables", key)
        if hit is None:
            return None
        arrays, meta = hit
        from .runtime import Workload
        from .table import TaskTable
        try:
            tbl = TaskTable.restore(arrays, fingerprint=meta["fingerprint"])
        except (KeyError, ValueError):
            self._discard("tables", key, self._array_dir("tables", key),
                          "incomplete table artifact")
            return None
        return Workload(meta["name"], None, float(meta["mem_intensity"]),
                        table=tbl)

    def put_workload(self, key: str, workload) -> None:
        """Store a workload's compiled table (+ identity metadata)."""
        from .runtime import ensure_table
        tbl = ensure_table(workload)
        meta = dict(name=workload.name,
                    mem_intensity=float(workload.mem_intensity),
                    tasks=int(tbl.n),
                    fingerprint=tbl.fingerprint())
        self.put_arrays("tables", key, tbl.saved_arrays(), meta)

    # ------------------------------------------------------------------
    # Typed helpers: serial references
    # ------------------------------------------------------------------
    def get_serial(self, key: str) -> "float | None":
        payload = self.get_json("serial", key)
        if payload is None:
            return None
        try:
            return float(payload["serial"])
        except (KeyError, TypeError, ValueError):
            self._discard("serial", key, self._json_path("serial", key),
                          "malformed serial record")
            return None

    def put_serial(self, key: str, value: float) -> None:
        self.put_json("serial", key, {"serial": float(value)})

    # ------------------------------------------------------------------
    # Typed helpers: context lowerings (int tuples)
    # ------------------------------------------------------------------
    def get_int_tuple(self, category: str, key: str) -> "tuple | None":
        payload = self.get_json(category, key)
        if payload is None:
            return None
        try:
            return tuple(int(v) for v in payload["values"])
        except (KeyError, TypeError, ValueError):
            self._discard(category, key, self._json_path(category, key),
                          "malformed tuple record")
            return None

    def put_int_tuple(self, category: str, key: str, values) -> None:
        self.put_json(category, key, {"values": [int(v) for v in values]})

    # ------------------------------------------------------------------
    # Typed helpers: victim plans
    # (per-thread group/unit/victim nestings — [th][group][unit][victim])
    # ------------------------------------------------------------------
    def get_victim_groups(self, key: str):
        payload = self.get_json("plans", key)
        if payload is None:
            return None
        try:
            return [[[[int(v) for v in unit] for unit in group]
                     for group in per_thread]
                    for per_thread in payload["groups"]]
        except (KeyError, TypeError, ValueError):
            self._discard("plans", key, self._json_path("plans", key),
                          "malformed victim-plan record")
            return None

    def put_victim_groups(self, key: str, groups) -> None:
        self.put_json("plans", key, {"groups": groups})
