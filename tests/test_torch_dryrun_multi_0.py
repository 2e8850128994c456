"""The port's dry run over half the grid's archs (part 0 of 2) on the
two-pod mesh (2,16,16): every arch × shape on placeholder ranks, ``ok`` or
``skipped`` with JAX's reason, argument bytes equal to JAX's specs' local
shards (see ``tests/_torch_dryrun_grid.py``), and the gradient
collectives of a training step crossing pods."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_dryrun_grid as grid  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402


@pytest.fixture
def spec_only(monkeypatch):
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("arch,shape", grid.grid(0))
def test_dryrun_cell_on_two_pods(arch, shape, tmp_path, spec_only):
    grid.check_cell(arch, shape, "multi", tmp_path)
