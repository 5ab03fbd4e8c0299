"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``.

A fresh interpreter that imports the port's entry points must not have
``jax`` or ``repro`` in ``sys.modules``, and no module under
``src/repro_torch`` may name them in an import statement.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401 — the test process has both packages; the child must not
import pytest
import torch  # noqa: F401

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys, repro_torch, repro_torch.core.executor, "
        "repro_torch.core.kernel_backend, repro_torch.data.tpch_queries, "
        "repro_torch.kernels.ops, repro_torch.sql, repro_torch.optimizer, "
        "repro_torch.data.clickbench, repro_torch.configs, "
        "repro_torch.kernels.decode_attention, repro_torch.models.layers, "
        "repro_torch.models.lm, repro_torch.models.convert, "
        "repro_torch.serve_lm, repro_torch.substrait, "
        "repro_torch.substrait.wire, repro_torch.substrait.router, "
        "repro_torch.core.fallback, repro_torch.observability, "
        "repro_torch.observability.profile, repro_torch.observability.journal, "
        "repro_torch.observability.tracer, repro_torch.observability.dist\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_module_of_the_port_imports_jax_or_the_reference(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_chip_smoke_imports_neither():
    path = PORT.parents[1] / "chip_smoke.py"
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, bad
