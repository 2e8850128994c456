"""Import hygiene of the port: ``repro_torch`` (the simulator under
``core/sim`` included) and ``chip_smoke.py`` import neither JAX nor
anything of the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = __import__("json").loads(out.splitlines()[-1])
    assert "repro_torch.models.model" in loaded
    for m in ("repro_torch.core.stealing", "repro_torch.core.sim.machine",
              "repro_torch.core.sim._engine_py", "repro_torch.kernels.sim"):
        assert m in loaded, m
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_no_import_statement_names_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _forbidden(n)] == []
