"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port: module names are compared by their
top-level name, whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "optix_ray_tracer_tpu"}
PORT = "optix_ray_tracer_tpu_torch"


def top_levels(path: Path) -> set:
    """The top-level names of every module a file imports, wherever in the
    file (relative imports excluded: they stay in the package)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not (top_levels(path) & JAX_SIDE)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_levels(path)
    assert PORT not in names and not (names & JAX_SIDE)
    assert names <= {"__future__", "dataclasses", "numpy", "torch"}


def test_the_scan_tells_the_names_apart(tmp_path):
    f = tmp_path / "x.py"
    f.write_text(f"import {PORT}.models\nfrom {PORT} import io\n")
    assert top_levels(f) == {PORT}
    assert not (top_levels(f) & JAX_SIDE)
    f.write_text("import optix_ray_tracer_tpu.ops as o\n")
    assert top_levels(f) & JAX_SIDE
