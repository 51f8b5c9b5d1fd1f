"""Tests that need the card: the CUDA kernels (lstm_cell, lstm_sequence,
flash_attention, ssm_scan, mlstm_chunk) against their plain versions, the
bf16 (tensor-core) and float32 (CUDA-core) kernels of ssm_scan and
mlstm_chunk against each other, the bf16 flash kernel against
scaled_dot_product_attention, the reduced zamba2 and xlstm models on CUDA
against the same models on the CPU, and the device search on CUDA against
the same search on the CPU (both regimes, the greedy init and the
contention-aware fleet search), and the metro engine on CUDA: a chaos pack
to the reference's committed event-log CRC, and the default pack's fleet
policy identical on CUDA and on the CPU.
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
from repro_torch.kernels.lstm_cell import (lstm_cell, lstm_cell_plain,
                                           lstm_sequence,
                                           lstm_sequence_plain)
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


@pytest.mark.parametrize("t_len", [1, 48, 130])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lstm_sequence_kernel_matches_plain(cuda, shape, t_len):
    """A whole layer in one launch against the scanned plain cell: h_T,
    c_T and the hidden sequence at lstm_cell's 1e-5."""
    b, i, h = shape
    g = torch.Generator().manual_seed(b * 1000 + i + h + t_len)
    s = 1.0 / np.sqrt(i + h)
    args = [torch.randn(t_len, b, i, generator=g),
            torch.randn(i, 4, h, generator=g) * s,
            torch.randn(h, 4, h, generator=g) * s,
            torch.randn(4, h, generator=g) * 0.1]
    args = [a.to(cuda) for a in args]
    before = lstm_sequence.launches
    h_k, c_k, hs_k = lstm_sequence(*args, return_sequence=True)
    torch.cuda.synchronize()
    assert lstm_sequence.launches == before + 1
    h_p, c_p, hs_p = lstm_sequence_plain(*args, return_sequence=True)
    assert hs_k.shape == (t_len, b, h)
    torch.testing.assert_close(h_k, h_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(c_k, c_p, atol=1e-5, rtol=0)
    torch.testing.assert_close(hs_k, hs_p, atol=1e-5, rtol=0)


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


def _int_jobs(rng, n):
    return [port_sim.JobSpec(name=f"J{i}", release=float(rng.integers(0, 20)),
                             weight=float(rng.integers(1, 4)),
                             proc={t: float(rng.integers(1, 25))
                                   for t in (CC, ES, ED)},
                             trans={CC: float(rng.integers(0, 40)),
                                    ES: float(rng.integers(0, 10)), ED: 0.0})
            for i in range(n)]


@pytest.mark.parametrize("initial", [True, False], ids=["explicit", "greedy"])
@pytest.mark.parametrize("fleet", [(1, 1), (2, 3)], ids=["1x1", "2x3"])
@pytest.mark.parametrize("objective", ["weighted", "unweighted", "last"])
def test_pass_regime_and_greedy_cuda_match_cpu(cuda, objective, fleet,
                                               initial):
    """Ragged wards padded to 4 x their movable bucket (the pass regime);
    with an explicit initial, 30 % frozen and 3 + 3 reservations."""
    rng = np.random.default_rng(11)
    sizes = (16, 11, 6)
    jobs = [_int_jobs(rng, n) for n in sizes]
    kw = dict(objective=objective, machines_per_tier=fleet, pad_to=64)
    init = None
    if initial:
        init = [[int(x) for x in rng.integers(0, 3, n)] for n in sizes]
        kw["frozen"] = [list(rng.random(n) < 0.3) for n in sizes]
        kw["reserved"] = [{t: [port_sim.Reservation(
            arrival=float(r + rng.integers(0, 40)),
            proc=float(rng.integers(1, 25)), release=float(r), weight=1.0)
            for r in rng.integers(0, 20, 3)] for t in (CC, ES)}
            for _ in sizes]
    v_cpu, a_cpu = scheduler_torch.tabu_search_batched(jobs, init,
                                                       device="cpu", **kw)
    v_gpu, a_gpu = scheduler_torch.tabu_search_batched(jobs, init,
                                                       device=cuda, **kw)
    for a, b in zip(a_gpu, a_cpu):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(v_gpu, v_cpu)


def test_search_fleet_cuda_matches_cpu(cuda):
    from repro_torch.core import problems, scheduler
    wards = []
    for i in range(4):
        jobs = problems.metro_jobs(np.random.default_rng(24 + i), n=10)
        wards.append([type(j)(name=j.name, release=float(round(j.release)),
                              weight=j.weight, proc=j.proc, trans=j.trans)
                      for j in jobs])
    mpt = {CC: 2, ES: 1}
    got = scheduler.search_fleet(wards, machines_per_tier=mpt, device=cuda)
    ref = scheduler.search_fleet(wards, machines_per_tier=mpt, device="cpu")
    assert got.assignments == ref.assignments
    assert got.naive_assignments == ref.naive_assignments
    assert (got.sweeps, got.naive_reported) == (ref.sweeps,
                                                ref.naive_reported)
    assert got.fleet.weighted_sum == ref.fleet.weighted_sum


# tests/test_kernels.py::ATTN_CASES, then zamba2's prefill shape, ragged
# cases, head dims that are not multiples of 16 (the bf16 kernel pads them
# with zero columns), a decode-like single query over 512 keys, and GQA, a
# window, softcap and ragged L together: b, hq, hkv, lq, lk, d, causal,
# window, softcap
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
    (2, 4, 2, 200, 200, 40, True, None, None),
    (1, 4, 4, 130, 130, 72, False, None, None),
    (1, 32, 32, 1, 512, 80, True, None, None),
    (2, 32, 4, 300, 300, 80, True, 64, 30.0),
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


def test_flash_attention_bf16_matches_sdpa(cuda):
    """The bf16 tensor-core kernel against PyTorch's own causal attention
    at zamba2's prefill shape, at the bf16 tolerance."""
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(4, 32, 512, 80, generator=g).to(cuda,
                                                          torch.bfloat16)
               for _ in range(3))
    out = flash_attention(q, k, v, causal=True)
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                            is_causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


# tests/test_kernels.py::SSM_CASES (b, l, h, p, n), zamba2's prefill, then
# ragged shapes (H * P not a multiple of a block's 64 rows, N not a power
# of two, L not a multiple of the 32 staged steps), then a state carried
# across 32 chunks of 64 steps
SSM_SHAPES = [(2, 64, 2, 8, 16), (2, 128, 4, 16, 16), (1, 256, 8, 32, 64),
              (4, 512, 80, 64, 64), (2, 37, 3, 24, 20), (1, 70, 5, 80, 128),
              (1, 2048, 4, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SSM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_scan_kernel_matches_plain(cuda, shape, dtype):
    x, dt, a, bm, cm, d = _ssm_inputs(shape, dtype, cuda)
    before = ssm_scan.launches
    y, hf = ssm_scan(x, dt, a, bm, cm, d)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    y_p, h_p = ssm_scan_plain(x, dt, a, bm, cm, d)
    # y is rounded to bf16 on output; the state is float32 on both sides
    tol = 3e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hf, h_p, atol=3e-4, rtol=3e-4)


def _ssm_inputs(shape, dtype, device):
    b, l, h, p, n = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(b, l, h, p, generator=g).to(device, dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=g)).to(device)
    a = -torch.exp(torch.randn(h, generator=g) * 0.5).to(device)
    bm = torch.randn(b, l, n, generator=g).to(device, dtype)
    cm = torch.randn(b, l, n, generator=g).to(device, dtype)
    d = torch.randn(h, generator=g).to(device)
    return x, dt, a, bm, cm, d


@pytest.mark.parametrize("shape", [(4, 512, 80, 64, 64), (2, 37, 3, 24, 20),
                                   (1, 70, 5, 80, 128), (1, 2048, 4, 64, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_scan_bf16_and_f32_kernels_agree(cuda, shape):
    """The tensor-core kernel (bf16) and the CUDA-core kernel (float32) on
    the same bf16-valued inputs, within the bf16 bars: y 2e-2, the float32
    state 3e-4."""
    args = _ssm_inputs(shape, torch.bfloat16, cuda)
    f32 = [t.float() for t in args]
    y16, h16 = ssm_scan(*args)
    y32, h32 = ssm_scan(*f32)
    torch.cuda.synchronize()
    torch.testing.assert_close(y16.float(), y32, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(h16, h32, atol=3e-4, rtol=3e-4)


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
                (2, 300, 3, 512), (1, 70, 1, 80), (1, 1000, 2, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MLSTM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mlstm_chunk_kernel_matches_plain(cuda, shape, dtype):
    q, k, v, ig, fg = _mlstm_inputs(shape, dtype, cuda)
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


def _mlstm_inputs(shape, dtype, device):
    b, l, h, d = shape
    g = torch.Generator().manual_seed(sum(shape))
    q, k, v = (torch.randn(b, l, h, d, generator=g).to(device, dtype)
               for _ in range(3))
    ig = torch.randn(b, l, h, generator=g).to(device)
    fg = (torch.randn(b, l, h, generator=g) + 2.0).to(device)
    return q, k, v, ig, fg


@pytest.mark.parametrize("shape", [(4, 512, 4, 512), (1, 100, 2, 128),
                                   (2, 300, 3, 512), (1, 1000, 2, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mlstm_chunk_bf16_and_f32_kernels_agree(cuda, shape):
    """The tensor-core kernel (bf16) and the CUDA-core kernel (float32) on
    the same bf16-valued inputs, within the bf16 bars: y 2e-2, C and n
    5e-4 / 5e-3, m 1e-5."""
    args = _mlstm_inputs(shape, torch.bfloat16, cuda)
    y16, s16 = mlstm_chunk(*args)
    y32, s32 = mlstm_chunk(*[t.float() for t in args])
    torch.cuda.synchronize()
    torch.testing.assert_close(y16.float(), y32, atol=2e-2, rtol=2e-2)
    for a, b in zip(s16[:2], s32[:2]):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-3)
    torch.testing.assert_close(s16[2], s32[2], atol=1e-5, rtol=0)


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


def test_metro_crash_pack_gives_the_committed_crc_on_cuda(cuda):
    import json
    from pathlib import Path

    from repro_torch.launch import serve
    bench = json.loads((Path(__file__).resolve().parents[1]
                        / "BENCH_scheduler.json").read_text())
    before = scheduler_torch.tabu_search_batched.calls
    out = serve.run_metro(scenario="mass_casualty_crash",
                          policies=("tabu",), device_threshold=10 ** 9,
                          device=cuda, verbose=False)
    assert out["tabu"]["event_log_hash"] == \
        bench["metro_scenarios"]["mass_casualty_crash"]["event_log_hash_tabu"]
    assert out["tabu"]["device_searches"] == 7 == \
        scheduler_torch.tabu_search_batched.calls - before


def test_metro_default_fleet_cuda_matches_cpu(cuda):
    from repro_torch.launch import serve
    out = {dev: serve.run_metro(scenario="default", policies=("fleet",),
                                hours=0.5, device_threshold=10 ** 9,
                                device=dev, verbose=False)["fleet"]
           for dev in (cuda, "cpu")}
    assert out[cuda]["device_searches"] > 0
    for s in out.values():
        s.pop("seconds")
        s.pop("events_per_s")
    assert out[cuda] == out["cpu"]
