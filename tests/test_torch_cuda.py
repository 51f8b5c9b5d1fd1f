"""Tests that need the card: the CUDA kernels (lstm_cell, flash_attention,
ssm_scan, mlstm_chunk) against their plain versions, the reduced zamba2
and xlstm models on CUDA against the same models on the CPU, and the
device search on CUDA against the same search on the CPU.
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
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_plain
from repro_torch.kernels.mlstm_chunk import mlstm_chunk, mlstm_chunk_plain
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
from repro_torch.models import build_model

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


# tests/test_kernels.py::ATTN_CASES, then zamba2's prefill shape and
# ragged cases: b, hq, hkv, lq, lk, d, causal, window, softcap
FLASH_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, None),
    (1, 8, 1, 128, 128, 128, True, None, 50.0),
    (2, 4, 4, 256, 256, 64, True, 128, None),
    (1, 4, 2, 128, 512, 64, True, None, None),
    (1, 2, 2, 1, 256, 64, True, None, None),
    (2, 2, 2, 128, 128, 32, False, None, None),
    (1, 4, 4, 256, 256, 64, True, 64, 30.0),
    (4, 32, 32, 512, 512, 80, True, None, None),
    (1, 4, 2, 1, 300, 64, True, None, None),
    (2, 4, 2, 100, 100, 80, True, 33, None),
    (1, 8, 1, 64, 64, 256, False, None, 50.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    b, hq, hkv, lq, lk, d, causal, window, softcap = case
    g = torch.Generator().manual_seed(sum(case[:6]))
    q = torch.randn(b, hq, lq, d, generator=g).to(cuda, dtype)
    k = torch.randn(b, hkv, lk, d, generator=g).to(cuda, dtype)
    v = torch.randn(b, hkv, lk, d, generator=g).to(cuda, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(),
                               flash_attention_plain(q, k, v, **kw).float(),
                               atol=tol, rtol=tol)


# tests/test_kernels.py::SSM_CASES (b, l, h, p, n), zamba2's prefill, then
# ragged shapes (H * P not a multiple of a block's 64 rows, N not a power
# of two, L not a multiple of the 32 staged steps)
SSM_SHAPES = [(2, 64, 2, 8, 16), (2, 128, 4, 16, 16), (1, 256, 8, 32, 64),
              (4, 512, 80, 64, 64), (2, 37, 3, 24, 20), (1, 70, 5, 80, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SSM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_scan_kernel_matches_plain(cuda, shape, dtype):
    b, l, h, p, n = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(b, l, h, p, generator=g).to(cuda, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=g)).to(cuda)
    a = -torch.exp(torch.randn(h, generator=g) * 0.5).to(cuda)
    bm = torch.randn(b, l, n, generator=g).to(cuda, dtype)
    cm = torch.randn(b, l, n, generator=g).to(cuda, dtype)
    d = torch.randn(h, generator=g).to(cuda)
    before = ssm_scan.launches
    y, hf = ssm_scan(x, dt, a, bm, cm, d)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    y_p, h_p = ssm_scan_plain(x, dt, a, bm, cm, d)
    # y is rounded to bf16 on output; the state is float32 on both sides
    tol = 3e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hf, h_p, atol=3e-4, rtol=3e-4)


def test_reduced_zamba2_cuda_matches_cpu(cuda):
    """Prefill and greedy decode of the reduced zamba2 on the card (the
    kernels) against the same parameters on the CPU (the plain path)."""
    model = build_model(get_config("zamba2-2.7b").reduced(d_model=128,
                                                          vocab=256))
    params = model.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    cpu = _to(params, "cpu")
    tokens = torch.randint(0, 256, (2, 96),
                           generator=torch.Generator().manual_seed(1))
    f0, s0 = flash_attention.launches, ssm_scan.launches
    with torch.inference_mode():
        lg, cg = model.prefill(params, {"tokens": tokens.to(cuda)},
                               max_len=100)
        lc, cc = model.prefill(cpu, {"tokens": tokens}, max_len=100)
        assert (flash_attention.launches - f0, ssm_scan.launches - s0) \
            == (1, 5)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
        for _ in range(4):
            lg, cg = model.decode_step(params, tok.to(cuda), cg)
            lc, cc = model.decode_step(cpu, tok, cc)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
            tok = lc.argmax(-1)
    assert (flash_attention.launches - f0, ssm_scan.launches - s0) == (1, 5)


# tests/test_kernels.py::MLSTM_CASES (b, l, h, d), the reduced xlstm's
# D = 128, xlstm-350m's prefill shape, then ragged lengths (the last chunk
# of 64 cut short) and a head dim that is not a multiple of 64
MLSTM_SHAPES = [(1, 64, 2, 64), (2, 128, 4, 32), (2, 256, 4, 16),
                (2, 256, 2, 128), (4, 512, 4, 512), (1, 100, 2, 128),
                (2, 300, 3, 512), (1, 70, 1, 80)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MLSTM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mlstm_chunk_kernel_matches_plain(cuda, shape, dtype):
    b, l, h, d = shape
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(b, l, h, d, generator=g).to(cuda, dtype)
               for _ in range(3))
    ig = torch.randn(b, l, h, generator=g).to(cuda)
    fg = (torch.randn(b, l, h, generator=g) + 2.0).to(cuda)
    before = mlstm_chunk.launches
    y, (c, n, m) = mlstm_chunk(q, k, v, ig, fg)
    torch.cuda.synchronize()
    assert mlstm_chunk.launches == before + 1
    assert y.dtype == dtype and y.shape == q.shape
    y_p, (c_p, n_p, m_p) = mlstm_chunk_plain(q, k, v, ig, fg)
    # tests/test_kernels.py's tolerances; y is rounded to bf16 on output,
    # the state is float32 on both sides
    tol = (5e-4, 5e-3) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol[0],
                               rtol=tol[1])
    torch.testing.assert_close(c, c_p, atol=5e-4, rtol=5e-3)
    torch.testing.assert_close(n, n_p, atol=5e-4, rtol=5e-3)
    torch.testing.assert_close(m, m_p, atol=1e-5, rtol=0)


def test_reduced_xlstm_cuda_matches_cpu(cuda):
    """Prefill and greedy decode of the reduced xlstm (one group of 7
    mLSTM blocks and 1 sLSTM block) on the card (the kernel) against the
    same parameters on the CPU (the plain path): 7 kernel launches per
    prefill, none per decode step."""
    model = build_model(get_config("xlstm-350m").reduced(d_model=128,
                                                         vocab=256))
    params = model.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    cpu = _to(params, "cpu")
    tokens = torch.randint(0, 256, (2, 96),
                           generator=torch.Generator().manual_seed(1))
    before = mlstm_chunk.launches
    with torch.inference_mode():
        lg, cg = model.prefill(params, {"tokens": tokens.to(cuda)},
                               max_len=100)
        lc, cc = model.prefill(cpu, {"tokens": tokens}, max_len=100)
        assert mlstm_chunk.launches - before == 7
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
        for _ in range(4):
            lg, cg = model.decode_step(params, tok.to(cuda), cg)
            lc, cc = model.decode_step(cpu, tok, cc)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
            tok = lc.argmax(-1)
    assert mlstm_chunk.launches - before == 7


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
