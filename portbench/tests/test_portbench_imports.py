"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Modules compare by their
top-level name whole (the part before the first dot), so `repro_torch`
is not `repro`."""
import ast
import pathlib

import pytest

PB = pathlib.Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(PB.rglob("*.py"))


def top_levels(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not top_levels(path) & JAX


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert not top_levels(path) & (JAX | {"repro_torch"})
    text = path.read_text()
    assert "importlib" not in text and "__import__" not in text


def test_the_guard_tells_the_packages_apart():
    assert "repro_torch".split(".")[0] not in JAX
    assert "repro.kernels".split(".")[0] in JAX
