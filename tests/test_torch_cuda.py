"""Tests that need the card: the CUDA lstm_cell kernel against its plain
version, and the device search on CUDA against the same search on the CPU.
Marked `cuda`; each skips with a reason where torch sees no CUDA device.
Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import scheduler_torch
from repro_torch.core import simulator as port_sim
from repro_torch.core.tiers import CC, ED, ES
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_plain

pytestmark = pytest.mark.cuda

SHAPES = [(4, 76, 16), (8, 17, 8), (128, 64, 128), (32, 130, 256),
          (8, 76, 32), (16, 76, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lstm_cell_kernel_matches_plain(cuda, shape):
    b, i, h = shape
    g = torch.Generator().manual_seed(b * 1000 + i + h)
    s = 1.0 / np.sqrt(i + h)
    args = [torch.randn(b, i, generator=g), torch.randn(b, h, generator=g),
            torch.randn(b, h, generator=g),
            torch.randn(i, 4, h, generator=g) * s,
            torch.randn(h, 4, h, generator=g) * s,
            torch.randn(4, h, generator=g) * 0.1]
    args = [a.to(cuda) for a in args]
    before = lstm_cell.launches
    h_k, c_k = lstm_cell(*args)
    torch.cuda.synchronize()
    assert lstm_cell.launches == before + 1
    h_p, c_p = lstm_cell_plain(*args)
    torch.testing.assert_close(h_k, h_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fleet", [(1, 1), (2, 3)], ids=["1x1", "2x3"])
@pytest.mark.parametrize("objective", ["weighted", "unweighted", "last"])
def test_device_search_cuda_matches_cpu(cuda, objective, fleet):
    rng = np.random.default_rng(3)
    jobs = [[port_sim.JobSpec(name=f"J{i}", release=float(r.integers(0, 20)),
                              weight=float(r.integers(1, 4)),
                              proc={t: float(r.integers(1, 25))
                                    for t in (CC, ES, ED)},
                              trans={CC: float(r.integers(0, 40)),
                                     ES: float(r.integers(0, 10)), ED: 0.0})
             for i in range(40)]
            for r in (np.random.default_rng(s) for s in range(3))]
    init = [[int(x) for x in rng.integers(0, 3, 40)] for _ in range(3)]
    kw = dict(objective=objective, machines_per_tier=fleet)
    v_cpu, a_cpu = scheduler_torch.tabu_search_batched(jobs, init,
                                                       device="cpu", **kw)
    v_gpu, a_gpu = scheduler_torch.tabu_search_batched(jobs, init,
                                                       device=cuda, **kw)
    for a, b in zip(a_gpu, a_cpu):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(v_gpu, v_cpu)
