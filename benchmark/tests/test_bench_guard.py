"""Nothing under benchmark/ imports JAX or the JAX package, by the
top-level name of each import compared whole (spi_tpu_torch passes,
spi_tpu fails), and the harness's own check of loaded modules agrees."""

import ast
import sys
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "spi_tpu"}


def imported_tops(source: str) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): imported_tops(p.read_text()) & FORBIDDEN
             for p in ROOT.rglob("*.py")}
    assert {k: v for k, v in found.items() if v} == {}


def test_names_are_compared_whole():
    assert imported_tops("import spi_tpu_torch.ops\nfrom spi_tpu_torch import x") \
        & FORBIDDEN == set()
    assert imported_tops("from spi_tpu.ops import x") & FORBIDDEN == {"spi_tpu"}
    assert imported_tops("import jax.numpy as jnp") & FORBIDDEN == {"jax"}


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "reference").glob("*.py"):
        assert not imported_tops(p.read_text()) & {"spi_tpu_torch", "spi_tpu", "jax"}, p


def test_run_sees_loaded_modules_by_whole_name(monkeypatch):
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spi_tpu_torchx.ops", sys.modules["json"])
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys.modules["json"])
    assert "jaxlib" in run.forbidden_modules()
