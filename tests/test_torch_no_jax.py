"""The PyTorch port stands alone: no module of ``annsearch_tpu_torch``
imports JAX or the JAX package.

A static walk of the sources, not a look at ``sys.modules``: the test
process may import JAX for other reasons before any of these run."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parent.parent / "annsearch_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "annsearch_tpu")


def _imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_package_has_sources():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES}
    assert {"__init__.py", "lib.py", "interop.py",
            "ops/ivf_scan_fused.py", "models/ivf_base.py",
            "ops/flat_scan_fused.py", "ops/graph.py", "models/graph.py"} <= names


def test_every_kernel_source_has_a_loader_entry():
    """Each ``csrc/*.cu`` exports the C entry points that ``ops/_cuda.py``
    binds, and no more: a kernel cannot be added without its signature."""
    import re

    from annsearch_tpu_torch.ops import _cuda

    sources = {p.name for p in _cuda.SOURCE_DIR.glob("*.cu")}
    assert sources == {"ivf_scan.cu", "ivf_scan_bf16.cu", "flat_scan.cu", "mma_probe.cu"}
    exported = set()
    for p in _cuda.SOURCE_DIR.glob("*.cu"):
        exported |= set(re.findall(r'extern "C" int (\w+)\(', p.read_text()))
    assert exported == set(_cuda._SIGNATURES)
    assert "annsearch_flat_scan" in exported
    for header in ("lex_min.cuh", "mma_terms.cuh", "bitonic.cuh", "hopper.cuh"):
        assert (_cuda.SOURCE_DIR / header).exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_import(path):
    roots = _imported_roots(ast.parse(path.read_text(), filename=str(path)))
    assert not roots & set(FORBIDDEN), f"{path} imports {roots & set(FORBIDDEN)}"


def test_walker_catches_jax_imports():
    src = "import jax.numpy as jnp\nfrom annsearch_tpu.ops import topk\n"
    assert {"jax", "annsearch_tpu"} <= _imported_roots(ast.parse(src))
    assert "jax" in _imported_roots(ast.parse("import importlib\nimportlib.import_module('jax')"))
    # relative imports stay inside the package
    assert _imported_roots(ast.parse("from .ops import topk")) == set()


def test_smoke_script_has_no_jax_import():
    path = PKG.parent / "chip_smoke.py"
    roots = _imported_roots(ast.parse(path.read_text()))
    assert not roots & set(FORBIDDEN)
