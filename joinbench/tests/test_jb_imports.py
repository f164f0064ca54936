"""What the benchmark's modules import, read from their source."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
MODULES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "hwbloomradixjoin_tpu",
             # the repository's JAX-era harness: not the port's
             "bench", "measurements", "tools"}
STANDALONE = ("reference.py", "datagen.py", "costs.py", "filterhash.py",
              "control.py")


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_modules_found():
    assert {"run.py", "reference.py", "datagen.py", "costs.py"} <= {
        p.name for p in MODULES}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", STANDALONE)
def test_yardstick_imports_nothing_of_the_port(name):
    assert "hwbloomradixjoin_tpu_torch" not in top_level_imports(HERE / name)
