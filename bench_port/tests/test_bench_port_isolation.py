"""No module of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` begins with ``repro``),
and the reference, the generators and the query texts import nothing of
the program either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
INDEPENDENT = ("reference", "datagen", "queries")
MODULES = sorted(BENCH.rglob("*.py"))


def imported(path: Path):
    """(top-level name, relative level, dotted module) of every import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            yield mod.split(".")[0], node.level, mod


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    found = {top for top, level, _ in imported(path) if level == 0} & FORBIDDEN
    assert not found, f"{path.name} imports {found}"


@pytest.mark.parametrize("path", [p for p in MODULES if p.relative_to(BENCH).parts[0]
                                  in INDEPENDENT],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_side_imports_nothing_of_the_program(path):
    for top, level, mod in imported(path):
        assert top != "repro_torch", f"{path.name} imports {mod}"
        if level == 0:
            assert top != "bench_port" or mod.split(".")[1] in INDEPENDENT, mod
        elif level >= 2:
            # ``from ..x import`` stays inside the independent packages
            assert mod.split(".")[0] in INDEPENDENT, f"{path.name}: ..{mod}"


def test_run_time_check_compares_whole_names(monkeypatch):
    import sys
    import types
    import repro_torch.core.executor  # noqa: F401  (the port, loaded)
    from bench_port.harness import cell
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert cell.forbidden_modules() == ["repro"]
