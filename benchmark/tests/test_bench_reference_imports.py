"""The plain reference imports nothing of the program, the JAX package or
JAX (top-level module names compared whole)."""

import ast
from pathlib import Path

FORBIDDEN = {"diffsvc_tpu_torch", "diffsvc_tpu", "jax", "jaxlib", "flax"}
REF = Path(__file__).resolve().parents[1] / "reference"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = sorted(REF.glob("*.py"))
    assert files
    for f in files:
        assert not top_level_imports(f) & FORBIDDEN, f


def test_the_check_sees_the_prefix_whole():
    # the port's name begins with the JAX package's: a prefix test would
    # flag the port, a whole-name test does not
    from benchmark import harness

    assert "diffsvc_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "diffsvc_tpu" in harness.FORBIDDEN
