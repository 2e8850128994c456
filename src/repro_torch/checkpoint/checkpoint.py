"""Atomic, async, sharded checkpoints in the JAX package's on-disk layout,
with cross-mesh restore (port of ``repro/checkpoint/checkpoint.py``)::

    <dir>/step_000000123/       (written as .tmp_step_000000123, then
        index.json               renamed into place)
        shard_<rank>.npz

``index.json`` holds ``step``, ``num_hosts`` (the ranks that wrote) and,
per leaf, its global ``shape``, its ``dtype`` and either ``full``, the
npz entry ``<key>::full`` that holds it whole, or ``shards``, a list of
``{"id": "<key>::shard<rank>", "index": [[start, stop], ...]}``: each
block with its slice of the global array, as JAX's index maps give it.
The keys are those of the JAX package's ``_flatten``: the tree's path
with dict keys sorted and list indices as ``[i]``
(``params/blocks/[0]/mix/wq``, ``opt/m/...``, ``opt/count``). A training
run saves ``{"params": convert.to_jax(model, cfg, numpy=False), "opt":
convert.opt_to_jax(state, cfg, numpy=False)}``, so a checkpoint written
by either package restores in the other.

bf16 leaves are written as numpy's 2-byte void (``V2``) under the dtype
name ``"bfloat16"``, as ``np.savez`` writes JAX's ``ml_dtypes`` arrays;
on reading, ``"bfloat16"`` maps to ``torch.bfloat16`` here (numpy needs
``ml_dtypes`` to name it). Leaves are CPU tensors, DTensors or numpy
arrays on the way in and CPU tensors on the way out.

**One process** (no process group, a world of one, or the dry run's fake
process group) writes every leaf whole into ``shard_0.npz``.

**Several ranks** (an initialised ``torch.distributed`` world of more
than one): every rank writes only its own blocks. A DTensor leaf over
more than one device is written by blocks, each distinct block once, by
the lowest rank that holds it (replicas are not repeated; JAX's reader
fills overlapping slices all the same), as ``<key>::shard<rank>`` in
``shard_<rank>.npz``. A leaf replicated on every device of its mesh, or
a plain tensor, is written whole once (by the mesh's lowest rank, rank 0
for a plain tensor). No leaf is gathered onto one rank to be saved. The
commit: the index is built from metadata gathered with
``all_gather_object`` on the caller's thread, before any write begins
(a collective on a writer thread would interleave with the training
loop's); every rank writes into the one ``.tmp_step_N`` directory and
then a marker ``.done_<rank>``; rank 0 writes ``index.json``, waits for
every marker (raising after COMMIT_TIMEOUT_S seconds: a rank's shards that
never arrive fail the save, they are never replaced by a gather),
removes the markers and renames the directory to ``step_N``. Every
other rank's write returns only once that rename is seen, so ``wait()``
returns after the commit on every rank. Only rank 0 collects old steps.

Restore reassembles each leaf from its shards (global zeros, each
block's slice filled) whichever mesh wrote it; ``restore_latest(mesh,
specs)`` then places the leaves on another mesh, as JAX's ``restore(...,
shardings=...)`` does.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{9})$")
_INDEX_RE = re.compile(r"^\[(\d+)\]$")
# how long a commit waits for the other ranks' shards, or for rank 0's
# rename, before it raises
COMMIT_TIMEOUT_S = 600.0


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{key: leaf} with JAX's path keys; dict keys sorted, list and tuple
    items as ``[i]``, None an empty subtree."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(_flatten(x, f"{prefix}[{i}]/"))
        return out
    if tree is None:
        return {}
    return {prefix[:-1]: tree}


def _unflatten(flat: dict[str, Any]) -> Any:
    """The nested tree of ``flat``'s keys: ``[i]`` parts become lists."""
    root: dict = {}
    for key, leaf in flat.items():
        node, parts = root, key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(_INDEX_RE.match(k) for k in node):
            return [lists(node[f"[{i}]"]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _to_numpy(leaf) -> np.ndarray:
    """The array to store, on the host, bf16 as ``V2``. A card tensor is
    copied; a host leaf is taken as it is, not copied. A DTensor gives
    its local block."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.to_local()
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    arr = np.asarray(leaf)
    return arr.view(np.dtype("V2")) if arr.dtype.name == "bfloat16" else arr


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its recorded dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(np.ascontiguousarray(arr))


def _dtype_name(leaf) -> str:
    """The index's dtype name of a leaf (numpy's; ``"bfloat16"``)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _world() -> tuple[int, int]:
    """(rank, world size) of the ranks that save together: those of the
    initialised process group. (0, 1) without one, or under a fake one
    (the dry run's placeholder ranks, all in this one process)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_backend() != "fake":
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def latest_step(directory: str) -> int | None:
    """The newest committed step (``.tmp_`` directories never count)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def _block(leaf):
    """(writer rank, index map) of this rank's block of a DTensor over
    several devices, or None when it is replicated on all of them. The
    writer is the lowest rank holding the same block."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, placements = leaf.device_mesh, leaf.placements
    for p in placements:
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"cannot save a leaf placed {p}")
    if all(isinstance(p, Replicate) for p in placements):
        return None
    coord = mesh.get_coordinate()
    if coord is None:                       # not on this leaf's mesh
        return -1, None
    holders = mesh.mesh[tuple(c if isinstance(p, Shard) else slice(None)
                              for c, p in zip(coord, placements))]
    shape, offset = compute_local_shape_and_global_offset(
        leaf.shape, mesh, placements)
    return int(holders.min()), [[int(o), int(o) + int(n)]
                                for o, n in zip(offset, shape)]


def _plan(tree: Any, rank: int, world: int):
    """(payload this rank writes, index of every leaf). With several
    ranks the sharded leaves' blocks are gathered from all ranks."""
    payload: dict[str, np.ndarray] = {}
    index: dict[str, Any] = {}
    mine: dict[str, dict] = {}
    for key, leaf in _flatten(tree).items():
        dt = _is_dtensor(leaf)
        block = _block(leaf) if world > 1 and dt \
            and leaf.device_mesh.size() > 1 else None
        meta: dict[str, Any] = {"shape": list(np.shape(leaf)),
                                "dtype": _dtype_name(leaf)}
        index[key] = meta
        if block is None:
            meta["full"] = f"{key}::full"
            writer = int(leaf.device_mesh.mesh.min()) if dt and world > 1 \
                else 0
            if rank == writer:
                payload[meta["full"]] = _to_numpy(leaf)
            continue
        meta["shards"] = []
        writer, idx = block
        if writer == rank:
            sid = f"{key}::shard{rank}"
            payload[sid] = _to_numpy(leaf)
            mine[key] = {"id": sid, "index": idx}
    if world > 1:
        import torch.distributed as dist
        gathered: list = [None] * world
        dist.all_gather_object(gathered, mine)
        for blocks in gathered:
            for key, sd in blocks.items():
                index[key]["shards"].append(sd)
    return payload, index


def _wait_for(what: str, ready) -> None:
    """Poll ``ready`` until it holds; raise after COMMIT_TIMEOUT_S."""
    deadline = time.monotonic() + COMMIT_TIMEOUT_S
    while not ready():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint commit: {what} not seen after "
                               f"{COMMIT_TIMEOUT_S:.0f} s")
        time.sleep(0.02)


def _write(directory: str, step: int, payload: dict, index: dict,
           rank: int = 0, world: int = 1) -> str:
    """Write this rank's ``payload`` into the step's ``.tmp_`` directory
    and commit it (see the module's docstring)."""
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, f".tmp_{name}")
    final = os.path.join(directory, name)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"shard_{rank}.npz"), **payload)
    if rank == 0:
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump({"step": step, "arrays": index, "num_hosts": world}, f)
    if world > 1:
        open(os.path.join(tmp, f".done_{rank}"), "w").close()
        if rank != 0:
            _wait_for(f"step {step} renamed by rank 0",
                      lambda: os.path.isdir(final)
                      and not os.path.exists(tmp))
            return final
        markers = [os.path.join(tmp, f".done_{r}") for r in range(world)]
        _wait_for(f"step {step}'s shards of every rank",
                  lambda: all(os.path.exists(m) for m in markers))
        for m in markers:
            os.remove(m)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _prepare(directory: str, step: int, tree: Any):
    """On the caller's thread: this rank's payload and the index (the one
    collective), after rank 0 clears a stale ``.tmp_`` of this step."""
    rank, world = _world()
    if rank == 0:
        shutil.rmtree(os.path.join(directory, f".tmp_step_{step:09d}"),
                      ignore_errors=True)
    payload, index = _plan(tree, rank, world)
    return payload, index, rank, world


def save(directory: str, step: int, tree: Any) -> str:
    """Write one checkpoint step (synchronous; on every rank of a
    multi-rank world). Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    payload, index, rank, world = _prepare(directory, step, tree)
    return _write(directory, step, payload, index, rank, world)


def restore(directory: str, step: int) -> Any:
    """Restore a step as CPU tensors of their recorded dtypes, the tree
    rebuilt from the keys (``[i]`` parts as lists); a leaf saved by
    blocks is reassembled whole, whatever mesh wrote it."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    payload: dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(path)):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                payload.update({k: z[k] for k in z.files})

    def load(key):
        meta = index["arrays"][key]
        if "full" in meta:
            arr = payload[meta["full"]]
        else:
            # bf16 (and any other V2) is assembled as its 16-bit words
            dt = np.dtype(np.uint16) if meta["dtype"] == "bfloat16" \
                else np.dtype(meta["dtype"])
            arr = np.zeros(meta["shape"], dtype=dt)
            for sd in meta["shards"]:
                block = payload[sd["id"]]
                sl = tuple(slice(p[0], p[1]) if isinstance(p, list) else p
                           for p in sd["index"])
                arr[sl] = block.view(dt) if block.dtype.kind == "V" \
                    else block
        return _to_tensor(arr, meta["dtype"]).reshape(meta["shape"])

    return _unflatten({k: load(k) for k in index["arrays"]})


class CheckpointManager:
    """Async keep-last-k manager used by the training launcher."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree: Any):
        """Move ``tree`` to host memory and gather the index on the
        caller's thread, then write in the background. The host leaves
        must be the caller's own, left alone until the write ends:
        ``convert.to_jax`` and ``convert.opt_to_jax`` with
        ``numpy=False`` give such copies, a snapshot of a model that
        trains on."""
        self.wait()
        payload, index, rank, world = _prepare(self.directory, step, tree)

        def work():
            try:
                _write(self.directory, step, payload, index, rank, world)
                if rank == 0:
                    self._gc()
            except BaseException as e:      # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree: Any):
        self.wait()
        save(self.directory, step, tree)
        if _world()[0] == 0:
            self._gc()

    def wait(self):
        """Return once the last write is committed (on every rank: after
        rank 0's rename); raise what the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, mesh=None, specs=None):
        """(step, tree) of the newest committed step, or (None, None).
        With a ``mesh``, each leaf is placed on it by the matching spec
        of ``specs`` (a tree of the checkpoint's layout, None to keep a
        leaf on the host: ``convert.specs_to_jax`` and
        ``convert.opt_specs_to_jax`` give it from ``launch/shardings``'
        specs); the mesh may differ from the one that saved."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        tree = restore(self.directory, step)
        if mesh is not None:
            from repro_torch.launch.shardings import distribute_tree
            tree = distribute_tree(tree, mesh, specs)
        return step, tree

    def _gc(self):
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := _STEP_RE.match(d)))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
