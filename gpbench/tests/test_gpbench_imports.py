"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program; top-level names compared whole."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gp_grief_tpu"}


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "gp_grief_tpu_torch" not in imported_top_names(path)


def test_whole_names_compared():
    # The port's name begins with the JAX package's; only whole names count.
    assert "gp_grief_tpu_torch" not in FORBIDDEN and "gp_grief_tpu" in FORBIDDEN
    from gpbench.run import forbidden_modules

    assert "gp_grief_tpu_torch" not in forbidden_modules()
