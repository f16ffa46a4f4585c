"""Nothing under qrbench/ imports JAX or the JAX package, and the
references import nothing of the program either.  Top-level module names
are compared whole: ``qrkit_tpu_torch`` is the system under test."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "qrkit_tpu"}


def imported(path: Path):
    """Top-level names of every module ``path`` imports (relative imports
    resolved inside qrbench)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("qrbench" if node.level else node.module.split(".")[0])
    return out


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "qrkit_tpu_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "dataclasses", "math", "numpy", "torch", "qrbench"}
    text = path.read_text()
    assert "from .." not in text and "import qrbench" not in text


def test_the_names_compare_whole():
    from qrbench.run import FORBIDDEN as RUN_FORBIDDEN, forbidden_modules

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert all(m.split(".")[0] != "qrkit_tpu" for m in forbidden_modules())
