"""The port stands alone: it and chip_smoke.py import torch, never jax,
and nothing of the JAX package `repro`."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def test_serve_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.launch.serve\n"
            "import repro_torch.serving.engine, repro_torch.models.model_zoo\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


def test_metro_run_loads_neither_jax_nor_repro():
    """The metro package and a whole run_metro (its lazy imports: the
    sanitizer, the tracer, the profile's search counter) stay clear of
    jax and repro."""
    code = ("import sys, repro_torch.metro, repro_torch.launch.serve as s\n"
            "s.run_metro(scenario='diurnal_day', hours=2.0, verbose=False,"
            " policies=('greedy', 'tabu', 'fleet'), device='cpu',"
            " device_threshold=10**9, sanitize=True, postmortem=True)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_no_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)
