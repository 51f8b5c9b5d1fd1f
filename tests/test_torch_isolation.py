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
            "import repro_torch.models.encdec, repro_torch.convert\n"
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


def test_training_loads_neither_jax_nor_repro():
    """The training slice's modules and one reduced `launch.train.run`
    (and the ICU offline phase, one step) on the CPU stay clear of jax
    and repro."""
    code = ("import sys, tempfile\n"
            "import repro_torch.training.optimizer\n"
            "import repro_torch.training.train_loop\n"
            "import repro_torch.checkpoint.checkpointer\n"
            "import repro_torch.launch.train as t\n"
            "d = tempfile.mkdtemp()\n"
            "t.run('qwen2-1.5b', reduced=True, steps=2, batch=2, seq=16,"
            " device='cpu', checkpoint_dir=d, log_fn=lambda *_: None)\n"
            "t.train_offline(1, device='cpu', log_fn=lambda *_: None)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


def test_scan_backwards_load_neither_jax_nor_repro():
    """The scans' modules, their wrappers under autograd and their
    backward wrappers on the CPU stay clear of jax and repro."""
    code = ("import sys, torch\n"
            "from repro_torch.kernels import mlstm_chunk as mk, "
            "ssm_scan as sk\n"
            "g = torch.Generator().manual_seed(0)\n"
            "x, dy = (torch.randn(1, 5, 2, 4, generator=g) for _ in "
            "range(2))\n"
            "s = [x, torch.rand(1, 5, 2), -torch.rand(2), "
            "torch.randn(1, 5, 3), torch.randn(1, 5, 3), torch.randn(2)]\n"
            "sk.ssm_scan_backward(*s, dy, None)\n"
            "m = [x, x, x, torch.randn(1, 5, 2), torch.randn(1, 5, 2)]\n"
            "mk.mlstm_chunk_backward(*m, dy)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


def test_remat_utils_analysis_examples_load_neither_jax_nor_repro():
    """utils.flops (a param count through the FakeTensorMode init),
    analysis, the four examples and a remat model's loss and gradients on
    the CPU stay clear of jax and repro."""
    code = ("import sys, torch\n"
            "import repro_torch.analysis, repro_torch.analysis.__main__\n"
            "import repro_torch.examples.serve_hierarchical\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.long_context_decode\n"
            "import repro_torch.examples.llm_fleet_allocation\n"
            "from repro_torch.configs import get_config, get_shape\n"
            "from repro_torch.data.pipeline import make_batch\n"
            "from repro_torch.models import build_model\n"
            "from repro_torch.utils import flops\n"
            "cfg = get_config('zamba2-2.7b')\n"
            "flops.step_flops(cfg, get_shape('train_4k'))\n"
            "cfg = cfg.reduced(layers=12, d_model=64, vocab=128)\n"
            "m = build_model(cfg, remat=True)\n"
            "p = m.init(torch.Generator().manual_seed(0), device='cpu')\n"
            "leaves = [p['embed'], p['stack']['shared']['attn']['wq']]\n"
            "for t in leaves:\n"
            "    t.requires_grad_(True)\n"
            "torch.autograd.grad(m.loss(p, make_batch(cfg, 1, 16)), leaves)\n"
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
