"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: an AST scan of every import,
comparing the top-level module name whole (``mcl_3dl_tpu_torch`` begins
with ``mcl_3dl_tpu``)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "mcl_3dl_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def modules(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.name))
def test_no_jax_import(path):
    assert not set(top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", modules("reference"),
                         ids=lambda p: str(p.name))
def test_reference_imports_nothing_of_the_port(path):
    assert not set(top_level_imports(path)) & (JAX | {"mcl_3dl_tpu_torch"})


def test_whole_name_compare():
    """A module named like the port is not taken for the JAX package."""
    assert "mcl_3dl_tpu_torch" not in JAX
    assert "mcl_3dl_tpu_torch".split(".")[0] != "mcl_3dl_tpu"
