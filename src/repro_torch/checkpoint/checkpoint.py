"""Atomic, async checkpoints in the JAX package's on-disk layout (port of
``repro/checkpoint/checkpoint.py``)::

    <dir>/step_000000123/       (written as .tmp_step_000000123_0,
        index.json               then renamed into place)
        shard_0.npz

``index.json`` holds ``step``, ``num_hosts`` and, per leaf, its
``shape``, ``dtype`` and the npz entry ``<key>::full`` that holds it. The
keys are those of the JAX package's ``_flatten``: the tree's path with
dict keys sorted and list indices as ``[i]`` (``params/blocks/[0]/mix/wq``,
``opt/m/...``, ``opt/count``). A training run saves ``{"params":
convert.to_jax(model, cfg, numpy=False), "opt": convert.opt_to_jax(state,
cfg, numpy=False)}``, so a checkpoint written by either package restores
in the other.

bf16 leaves are written as numpy's 2-byte void (``V2``) under the dtype
name ``"bfloat16"``, as ``np.savez`` writes JAX's ``ml_dtypes`` arrays;
on reading, ``"bfloat16"`` maps to ``torch.bfloat16`` here (numpy needs
``ml_dtypes`` to name it). Leaves are CPU tensors on the way in and out
(numpy arrays are taken too). One host (host 0 of 1) writes every leaf
whole; the JAX package's per-shard entries of a multi-device array have
no counterpart until the port is distributed.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{9})$")
_INDEX_RE = re.compile(r"^\[(\d+)\]$")


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


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name) on the host, bf16 as ``V2``. A card
    tensor is copied; a host leaf is taken as it is, not copied."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.dtype("V2")), "bfloat16"
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its recorded dtype."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(np.ascontiguousarray(arr))


def latest_step(directory: str) -> int | None:
    """The newest committed step (``.tmp_`` directories never count)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def _write(directory: str, step: int, stored: dict[str, tuple]) -> str:
    """Commit ``stored`` ({key: (array, dtype name)}) as one step."""
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, f".tmp_{name}_0")
    final = os.path.join(directory, name)
    os.makedirs(tmp, exist_ok=True)
    index: dict[str, Any] = {"step": step, "arrays": {}, "num_hosts": 1}
    payload: dict[str, np.ndarray] = {}
    for key, (arr, dtype) in stored.items():
        sid = f"{key}::full"
        payload[sid] = arr
        index["arrays"][key] = {"shape": list(arr.shape), "dtype": dtype,
                                "full": sid}
    np.savez(os.path.join(tmp, "shard_0.npz"), **payload)
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(directory: str, step: int, tree: Any) -> str:
    """Write one checkpoint step (synchronous). Returns the committed
    path."""
    return _write(directory, step, {k: _to_numpy(x) for k, x in
                                    _flatten(tree).items()})


def restore(directory: str, step: int) -> Any:
    """Restore a step as CPU tensors of their recorded dtypes, the tree
    rebuilt from the keys (``[i]`` parts as lists)."""
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
        if "full" not in meta:
            raise NotImplementedError(f"{key}: per-shard entries (a "
                                      "multi-device save) join with "
                                      "distribution")
        t = _to_tensor(payload[meta["full"]], meta["dtype"])
        return t.reshape(meta["shape"])

    return _unflatten({k: load(k) for k in index["arrays"]})


class CheckpointManager:
    """Async keep-last-k manager used by the training launcher."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree: Any):
        """Move ``tree`` to host memory on the caller's thread, then write
        it in the background. The host leaves must be the caller's own,
        left alone until the write ends: ``convert.to_jax`` and
        ``convert.opt_to_jax`` with ``numpy=False`` give such copies, a
        snapshot of a model that trains on."""
        stored = {k: _to_numpy(x) for k, x in _flatten(tree).items()}
        self.wait()

        def work():
            _write(self.directory, step, stored)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, step: int, tree: Any):
        self.wait()
        save(self.directory, step, tree)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self):
        """(step, tree) of the newest committed step, or (None, None)."""
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore(self.directory, step)

    def _gc(self):
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := _STEP_RE.match(d)))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
