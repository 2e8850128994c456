"""Import hygiene of the port: ``repro_torch`` (the simulator under
``core/sim`` included, its trace, result store and compile cache too) and
``chip_smoke.py`` import neither JAX nor anything of the JAX package
``repro``."""

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
              "repro_torch.core.sim._engine_py", "repro_torch.kernels.sim",
              "repro_torch.core.sim.trace", "repro_torch.core.sim.store",
              "repro_torch.core.sim.compile_cache"):
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


TESTS = sorted((ROOT / "tests").glob("test_torch_*.py"))
CACHE = "repro_torch.core.sim.compile_cache"


def _imports(path: Path, module: str) -> set:
    """Every module that ``path`` (the module ``module``) imports, at the
    top or inside a function, relative imports resolved, with the packages
    above each (importing a module runs them) and, for a ``from`` import,
    each name as a possible submodule."""
    parts = module.split(".")
    pkg = parts if path.name == "__init__.py" else parts[:-1]
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names = [mod] + [f"{mod}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            bits = name.split(".")
            out.update(".".join(bits[:k]) for k in range(1, len(bits) + 1))
    return out


def _reach_the_cache() -> set:
    """The port's modules, and ``chip_smoke``, that reach the simulator's
    compile cache through their imports at any depth."""
    graph = {"chip_smoke": _imports(ROOT / "chip_smoke.py", "chip_smoke")}
    for m in MODULES:
        p = ROOT / "src" / Path(*m.split("."))
        path = p / "__init__.py" if p.is_dir() else p.with_suffix(".py")
        graph[m] = _imports(path, m)
    reach, grew = {CACHE}, True
    while grew:
        new = {m for m, deps in graph.items() if m not in reach
               and deps & reach}
        reach |= new
        grew = bool(new)
    return reach


def test_port_tests_that_reach_the_simulator_keep_its_cache_in_tmp():
    """Every port test module whose imports reach the simulator's compile
    cache imports the fixture that points the cache at a temp dir
    (``tests/_torch_sim_cache.py``), so the tests never read or fill
    ``~/.cache/repro-sim-torch``."""
    reach = _reach_the_cache()
    assert {"repro_torch.core.sim", "repro_torch.examples.quickstart",
            "repro_torch.kernels.sim", "chip_smoke"} <= reach
    users = {p.name: _imports(p, p.stem) for p in TESTS}
    users = {name: deps for name, deps in users.items() if deps & reach}
    assert {"test_torch_sim.py", "test_torch_examples.py"} <= set(users)
    assert sorted(name for name, deps in users.items()
                  if "_torch_sim_cache" not in deps) == []
