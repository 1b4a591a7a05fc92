"""No module of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``), and
the yardstick (``reference/``, ``costs/``) imports nothing of the port."""
import ast
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "out" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_every_module_is_scanned():
    rel = {p.relative_to(HERE).as_posix() for p in MODULES}
    assert {"run.py", "harness.py", "reference/dprt.py", "costs/dprt.py",
            "programs/dprt.py", "metrics/mfu.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(HERE).as_posix() for p in MODULES])
def test_no_jax_or_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("kind", ["reference", "costs"])
def test_yardstick_imports_nothing_of_the_port(kind):
    for path in (HERE / kind).glob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path


def test_the_scan_tells_repro_from_repro_torch(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.radon\nfrom repro_torch import x\n")
    assert top_level_imports(src) == {"repro_torch"}
    src.write_text("import repro.core\nimportlib.import_module('jax.numpy')\n")
    assert top_level_imports(src) == {"repro", "jax"}


def test_the_run_finds_jax_or_repro_loaded_but_not_repro_torch(monkeypatch):
    # other test files in this process may have loaded JAX and the JAX
    # package: hide their entries for the test (monkeypatch restores them)
    for key in list(sys.modules):
        if key.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, "repro_torch.radon",
                        types.ModuleType("repro_torch.radon"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert harness.forbidden_modules() == ["jax", "repro"]
