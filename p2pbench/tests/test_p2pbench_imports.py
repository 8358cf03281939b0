"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: each import's top-level name is
compared whole (the port, ``repro_torch``, begins with ``repro``)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path)
    assert "repro_torch" not in found
    assert found <= {"__future__", "contextlib", "importlib", "math", "typing", "torch", "p2pbench"}, found
    assert all(line.split()[1].startswith("p2pbench.reference") for line in path.read_text().splitlines()
               if line.startswith("from p2pbench") or line.startswith("import p2pbench"))


def test_the_scan_sees_a_jax_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nfrom jax import numpy\nimport repro_torch\n")
    assert top_level_imports(bad) == {"repro", "jax", "repro_torch"}
