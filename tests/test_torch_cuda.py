"""Tests that need the card: the CUDA kernels (lstm_cell, lstm_sequence,
flash_attention, ssm_scan, mlstm_chunk) against their plain versions
(lstm_cell and lstm_sequence also on bf16 inputs, flash_attention also
with more queries than keys and on query rows from an offset), the
bf16 (tensor-core) and float32 (CUDA-core) kernels of ssm_scan and
mlstm_chunk against each other, the bf16 flash kernel against
scaled_dot_product_attention, the reduced zamba2 and xlstm models on CUDA
against the same models on the CPU, and the device search on CUDA against
the same search on the CPU (both regimes, the greedy init and the
contention-aware fleet search), and the metro engine on CUDA: a chaos pack
to the reference's committed event-log CRC, and the default pack's fleet
policy identical on CUDA and on the CPU; the rest of the LLM zoo reduced
on CUDA against the CPU, and chip_smoke.py's one-group checks at full
width in float32 (ONE_GROUP_CHECKS).
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
    # Lq > Lk (tests/test_torch_attention.py::LQ_GT_LK_CASES)
    (2, 4, 2, 128, 16, 32, False, None, None),
    (1, 4, 4, 256, 128, 64, False, None, 50.0),
    (2, 4, 2, 256, 128, 32, True, None, None),
    (1, 2, 1, 256, 128, 64, True, 64, None),
    (1, 2, 2, 256, 128, 32, False, 32, None),
    # the bf16 kernel's tensor-map edges (chip_smoke.HOPPER_ATTN): D = 80
    # and 256 with L not a multiple of 64 or 128, one query, D = 36 (the
    # staging path), window 0
    (2, 8, 2, 200, 333, 80, True, None, None),
    (1, 4, 1, 70, 150, 256, True, 100, 50.0),
    (3, 4, 4, 1, 77, 80, False, None, None),
    (1, 4, 2, 90, 130, 36, True, None, None),
    (2, 4, 2, 96, 96, 64, True, 0, None),
]


def _views(tensors, offset):
    """Copies of `tensors` as contiguous views `offset` elements into
    larger buffers."""
    out = []
    for t in tensors:
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out.append(buf[offset:].view(t.shape))
        out[-1].copy_(t)
    return out


@pytest.mark.parametrize("offset", [8, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_kernel_on_offset_views_matches_plain(cuda, dtype,
                                                              offset):
    """q, k, v as views whose bases lie 8 elements (16 bytes: TMA's rule
    holds) or 3 (it fails: the bf16 kernel's staging path) into larger
    buffers, against the plain version, forward and backward."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_lse)
    case = (2, 8, 4, 200, 200, 128, True, None, None)
    q, k, v, dout = _views(_flash_args(case, dtype, cuda), offset)
    out = flash_attention(q, k, v, causal=True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q, k, v, causal=True).float(),
        atol=tol, rtol=tol)
    o, lse = flash_attention_lse(q, k, v, causal=True)
    got = flash_attention_backward(q, k, v, o, lse, dout, causal=True)
    want = flash_attention_backward_plain(q, k, v, o, lse, dout, causal=True)
    for name, a, b_ in zip("qkv", got, want):
        _assert_grad_close(a, b_, dtype, f"d{name}")


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


@pytest.mark.parametrize("window", [None, 100])
def test_query_rows_from_an_offset_launch_the_kernel(cuda, window):
    """`ops._attention_local` on a slice of the query rows placed by
    `q_offset` (a "model" rank's rows where the heads do not divide it):
    one launch of the kernel on the keys up to the slice's last query,
    against the full plain attention's rows."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(2, 4, 512, 64, generator=g).to(cuda)
               for _ in range(3))
    k, v = k[:, :2].contiguous(), v[:, :2].contiguous()
    full = flash_attention_plain(q, k, v, causal=True, window=window)
    for off in (0, 192, 384):
        before = flash_attention.launches
        out = ops._attention_local(q[:, :, off:off + 128].contiguous(), k, v,
                                   True, window, None, None, 128, 128,
                                   q_offset=off)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        torch.testing.assert_close(out, full[:, :, off:off + 128],
                                   atol=2e-5, rtol=2e-5)


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


@pytest.mark.parametrize("mix", ["all", "h"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lstm_cell_kernel_bf16_matches_plain(cuda, shape, mix):
    """bf16 inputs, float32 math: every input bf16, or h alone (h' in
    bf16, c' in float32), within one bf16 rounding (2e-2)."""
    b, i, h = shape
    g = torch.Generator().manual_seed(b * 1000 + i + h + 1)
    s = 1.0 / np.sqrt(i + h)
    args = [torch.randn(b, i, generator=g), torch.randn(b, h, generator=g),
            torch.randn(b, h, generator=g),
            torch.randn(i, 4, h, generator=g) * s,
            torch.randn(h, 4, h, generator=g) * s,
            torch.randn(4, h, generator=g) * 0.1]
    which = range(6) if mix == "all" else (1,)
    args = [a.to(cuda, torch.bfloat16) if j in which else a.to(cuda)
            for j, a in enumerate(args)]
    before = lstm_cell.launches
    h_k, c_k = lstm_cell(*args)
    torch.cuda.synchronize()
    assert lstm_cell.launches == before + 1
    assert (h_k.dtype, c_k.dtype) == (args[1].dtype, args[2].dtype)
    h_p, c_p = lstm_cell_plain(*args)
    torch.testing.assert_close(h_k.float(), h_p.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(c_k.float(), c_p.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("t_len", [1, 48, 130])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lstm_sequence_kernel_bf16_matches_plain(cuda, shape, t_len):
    """bf16 xs and weights: h and c carried in bf16 from step to step, as
    the scanned plain cell carries them, within 2e-2."""
    b, i, h = shape
    g = torch.Generator().manual_seed(b * 1000 + i + h + t_len + 1)
    s = 1.0 / np.sqrt(i + h)
    args = [torch.randn(t_len, b, i, generator=g),
            torch.randn(i, 4, h, generator=g) * s,
            torch.randn(h, 4, h, generator=g) * s,
            torch.randn(4, h, generator=g) * 0.1]
    args = [a.to(cuda, torch.bfloat16) for a in args]
    before = lstm_sequence.launches
    h_k, c_k, hs_k = lstm_sequence(*args, return_sequence=True)
    torch.cuda.synchronize()
    assert lstm_sequence.launches == before + 1
    h_p, c_p, hs_p = lstm_sequence_plain(*args, return_sequence=True)
    assert h_k.dtype == c_k.dtype == hs_k.dtype == torch.bfloat16
    for got, want in ((h_k, h_p), (c_k, c_p), (hs_k, hs_p)):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0)


# the rest of the LLM zoo, reduced (tests/llm_parity.py's sizes), float32
LLM_ARCHS = {"gemma-2b": {}, "qwen2-1.5b": {},
             "qwen2-int8": {"kv_cache_dtype": "int8"}, "gemma2-27b": {},
             "mixtral-8x7b": {}, "llama-3.2-vision-11b": {},
             "seamless-m4t-large-v2": {}}


@pytest.mark.parametrize("name", sorted(LLM_ARCHS))
def test_reduced_llm_cuda_matches_cpu(cuda, name):
    """Prefill and greedy decode of a reduced arch on the card (the flash
    kernel in prefill) against the same noised parameters on the CPU;
    one flash launch per attention block in prefill, none in decode."""
    import dataclasses

    from repro_torch.data.pipeline import make_batch
    arch = "qwen2-1.5b" if name == "qwen2-int8" else name
    cfg = get_config(arch)
    layers = 2 if len(cfg.group_pattern) <= 2 else None
    cfg = dataclasses.replace(cfg.reduced(layers=layers, d_model=128,
                                          vocab=256), **LLM_ARCHS[name])
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    cpu = _map(cpu, lambda t: t + (0.05 * torch.randn(t.shape, generator=g))
               .to(t.dtype))
    params = _to(cpu, cuda)
    batch = make_batch(cfg, 2, 40, seed=2)
    if cfg.is_encdec:
        attn = cfg.encoder_layers + 2 * cfg.num_layers
    else:
        attn = cfg.num_groups * sum(
            k in ("attn", "attn_local", "attn_global", "moe", "cross")
            for k in cfg.group_pattern)
    f0 = flash_attention.launches
    with torch.inference_mode():
        lg, cg = model.prefill(params, _to(batch, cuda), max_len=44)
        lc, cc = model.prefill(cpu, batch, max_len=44)
        assert flash_attention.launches - f0 == attn
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
        for _ in range(4):
            lg, cg = model.decode_step(params, tok.to(cuda), cg)
            lc, cc = model.decode_step(cpu, tok, cc)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
            tok = lc.argmax(-1)
    assert flash_attention.launches - f0 == attn


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("name", ["gemma2-27b", "qwen2-1.5b", "mixtral-8x7b",
                                  "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_one_group_full_width_cuda_matches_cpu(cuda, name):
    """chip_smoke.py's one-group check of `name` (ONE_GROUP_CHECKS): full
    width, float32, noised parameters, card against CPU at 2e-3."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.check_llm_one_group(torch, flash_attention, name)


# ---------------------------------------------------------------- training
# the backward kernels against their plain versions on the same record,
# and the gradients of the models that train through them. Tolerances:
# float32 1e-4 absolute and relative (the kernels sum in another order
# than the plain versions: over 4H per step and T steps for the LSTM,
# over Lq or Lk for flash); bfloat16 gradients come out rounded to bf16 on
# both sides from float32 math, so they differ by about one rounding:
# 2e-2, and for flash every row within 1e-2 relative L2 of the plain row
# (chip_smoke.py's FLASH_BF16_ROW_REL), a row's norm taken as at least a
# tenth of the mean row norm: a row whose gradient cancels to noise (dq of
# a query with one live key is P (dP - D) = 0) has no relative error to
# hold.
GRAD_F32_TOL = 1e-4
GRAD_BF16_TOL = 2e-2
ROW_REL = 1e-2


def _lstm_record(shape, t_len, dtype, seed, cuda):
    b, i, h = shape
    g = torch.Generator().manual_seed(seed)
    s = 1.0 / np.sqrt(i + h)
    args = [torch.randn(t_len, b, i, generator=g),
            torch.randn(i, 4, h, generator=g) * s,
            torch.randn(h, 4, h, generator=g) * s,
            torch.randn(4, h, generator=g) * 0.1]
    ups = [torch.randn(b, h, generator=g), torch.randn(b, h, generator=g),
           torch.randn(t_len, b, h, generator=g)]
    return ([a.to(cuda, dtype) for a in args],
            [u.to(cuda, dtype) for u in ups])


ICU_TRAIN_SHAPES = [(32, 76, 16), (32, 17, 8), (32, 76, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t_len", [1, 48, 130])
@pytest.mark.parametrize("shape", SHAPES + ICU_TRAIN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_sequence_backward_kernel_matches_plain(cuda, shape, t_len,
                                                     dtype):
    """The training forward's record (hs, gates, cs) against the plain
    training forward's, then the backward kernels against
    lstm_sequence_backward_plain on the kernel's record with upstream
    gradients on h_T, c_T and hs (T = 130: the chunk ring wraps many
    times); a second call bit-equal to the first (no atomics), and a call
    without dxs giving the same weight gradients bit for bit."""
    from repro_torch.kernels.lstm_cell import (
        lstm_sequence_backward, lstm_sequence_backward_plain,
        lstm_sequence_train, lstm_sequence_train_plain)
    args, ups = _lstm_record(shape, t_len, dtype, sum(shape) + t_len, cuda)
    rec = lstm_sequence_train(*args)
    want = lstm_sequence_train_plain(*args)
    fwd_tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, exp in zip(rec, want):
        torch.testing.assert_close(got.float(), exp.float(), atol=fwd_tol,
                                   rtol=0)
    xs, wx, wh, _ = args
    before = lstm_sequence_backward.launches
    grads = lstm_sequence_backward(xs, wx, wh, *rec[2:], *ups)
    torch.cuda.synchronize()
    assert lstm_sequence_backward.launches == before + 1
    again = lstm_sequence_backward(xs, wx, wh, *rec[2:], *ups)
    no_dxs = lstm_sequence_backward(xs, wx, wh, *rec[2:], *ups,
                                    need_dxs=False)
    plain = lstm_sequence_backward_plain(xs, wx, wh, *rec[2:], *ups)
    tol = GRAD_F32_TOL if dtype == torch.float32 else GRAD_BF16_TOL
    for got, exp in zip(grads, plain):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), exp.float(), atol=tol,
                                   rtol=tol)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    assert no_dxs[0] is None
    assert all(torch.equal(a, b) for a, b in zip(grads[1:], no_dxs[1:]))


@pytest.mark.parametrize("need_dxs", [True, False])
@pytest.mark.parametrize("shape", ICU_TRAIN_SHAPES + [(32, 130, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_sequence_backward_is_two_hand_written_launches(cuda, shape,
                                                             need_dxs):
    """One call of lstm_sequence_backward runs at most two device kernels,
    the fused kernel and the reduction, and none from cuBLAS or cuDNN
    (counted over 20 calls: the profiler can drop a record of a window
    this short)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.lstm_cell import (lstm_sequence_backward,
                                               lstm_sequence_train)
    args, ups = _lstm_record(shape, 48, torch.float32, sum(shape), cuda)
    rec = lstm_sequence_train(*args)
    call = (args[0], args[1], args[2], *rec[2:], ups[0])
    lstm_sequence_backward(*call, need_dxs=need_dxs)
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            lstm_sequence_backward(*call, need_dxs=need_dxs)
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()
              if e.device_type != DeviceType.CPU}
    assert 0 < sum(counts.values()) <= 2 * calls, counts
    assert all("lstm_bwd" in n for n in counts), counts
    assert not any(w in n.lower() for n in counts
                   for w in ("gemm", "cublas", "cudnn")), counts


@pytest.mark.parametrize("depth", [1, 2])
def test_icu_lstm_grads_reach_every_parameter_on_cuda(cuda, depth):
    """The repaired fault: on the card loss.backward() sets .grad on every
    wx, wh and b (not only the head), equal to the CPU's."""
    import dataclasses

    from repro_torch.configs.icu_lstm import ICU_WORKLOADS
    from repro_torch.data import icu
    from repro_torch.kernels.lstm_cell import lstm_sequence_backward
    from repro_torch.models.lstm import ICULSTM
    for base in ICU_WORKLOADS:
        cfg = dataclasses.replace(base, depth=depth)
        x, y = icu.generate(cfg, 32, seed=4)
        models = {dev: ICULSTM(cfg, generator=torch.Generator()
                               .manual_seed(3), device=dev)
                  for dev in (cuda, "cpu")}
        grads = {}
        for dev, model in models.items():
            before = lstm_sequence_backward.launches
            model.loss({"features": torch.as_tensor(x, device=dev),
                        "labels": torch.as_tensor(y, device=dev)}).backward()
            if dev == cuda:
                assert lstm_sequence_backward.launches == before + depth
            grads[dev] = {n: p.grad for n, p in model.named_parameters()}
        for name, g in grads[cuda].items():
            assert g is not None and bool(torch.isfinite(g).all()), name
            assert bool(g.abs().max() > 0), name
            torch.testing.assert_close(g.cpu(), grads["cpu"][name],
                                       atol=GRAD_F32_TOL, rtol=GRAD_F32_TOL)


FLASH_GRAD_CASES = FLASH_CASES + [
    (2, 12, 2, 256, 256, 128, True, None, None),   # qwen2's GQA 6:1
    (1, 4, 2, 200, 200, 64, True, 64, 50.0),       # gemma2's window, softcap
    (1, 2, 1, 128, 256, 64, True, 32, None),       # Lq < Lk with a window
    (1, 2, 2, 64, 64, 32, True, 0, None),          # no row has a live key
]


def _flash_args(case, dtype, cuda):
    b, hq, hkv, lq, lk, d = case[:6]
    g = torch.Generator().manual_seed(sum(case[:6]) + 1)
    q = torch.randn(b, hq, lq, d, generator=g).to(cuda, dtype)
    k = torch.randn(b, hkv, lk, d, generator=g).to(cuda, dtype)
    v = torch.randn(b, hkv, lk, d, generator=g).to(cuda, dtype)
    dout = torch.randn(b, hq, lq, d, generator=g).to(cuda, dtype)
    return q, k, v, dout


def _assert_grad_close(got, want, dtype, name):
    assert got.dtype == dtype and got.shape == want.shape, name
    g, w = got.float(), want.float()
    tol = GRAD_F32_TOL if dtype == torch.float32 else GRAD_BF16_TOL
    torch.testing.assert_close(g, w, atol=tol, rtol=tol, msg=name)
    if dtype == torch.bfloat16:
        gap, size = (g - w).norm(dim=-1), w.norm(dim=-1)
        floor = 0.1 * size.mean()
        assert bool((gap <= ROW_REL * torch.clamp(size, min=floor)).all()), \
            name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_GRAD_CASES, ids=str)
def test_flash_attention_backward_kernel_matches_plain(cuda, case, dtype):
    """The training forward's row log-sum-exp against the plain one, and
    the backward kernel against flash_attention_backward_plain on the
    kernel's out and lse."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_plain,
        flash_attention_lse, flash_attention_lse_plain)
    q, k, v, dout = _flash_args(case, dtype, cuda)
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    out, lse = flash_attention_lse(q, k, v, **kw)
    _, lse_p = flash_attention_lse_plain(q, k, v, **kw)
    live = torch.isfinite(lse_p)
    assert bool((torch.isfinite(lse) == live).all())
    torch.testing.assert_close(lse[live], lse_p[live], atol=1e-4, rtol=1e-5)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == before + 1
    want = flash_attention_backward_plain(q, k, v, out, lse, dout, **kw)
    for name, a, b_ in zip("qkv", got, want):
        _assert_grad_close(a, b_, dtype, f"d{name}")
    # deterministic: no atomics, a second call gives the same bits
    again = flash_attention_backward(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("case", [(2, 12, 2, 128, 128, 128, True, None,
                                   None),
                                  (1, 4, 2, 100, 100, 64, True, 33, 50.0)],
                         ids=str)
def test_flash_attention_autograd_on_cuda_matches_cpu(cuda, case):
    """flash_attention under autograd on the card: one forward and one
    backward launch, gradients equal to autograd of the plain version on
    the CPU."""
    from repro_torch.kernels.flash_attention import flash_attention_backward
    q, k, v, dout = _flash_args(case, torch.float32, cuda)
    kw = dict(causal=case[6], window=case[7], softcap=case[8])
    grads = {}
    for dev in (cuda, "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        before = (flash_attention.launches, flash_attention_backward.launches)
        out = flash_attention(*leaves, **kw)
        out.backward(dout.to(dev))
        if dev == cuda:
            assert (flash_attention.launches - before[0],
                    flash_attention_backward.launches - before[1]) == (1, 1)
        grads[dev] = [t.grad for t in leaves]
    for name, a, b_ in zip("qkv", grads[cuda], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b_, atol=GRAD_F32_TOL,
                                   rtol=GRAD_F32_TOL, msg=f"d{name}")


def test_kernels_without_backward_raise_under_grad(cuda):
    """lstm_cell, the one kernel left without a backward, raises
    NotImplementedError on a CUDA input that requires grad, and launches
    as before under no_grad."""
    g = torch.Generator().manual_seed(0)
    cell = [torch.randn(s, generator=g).to(cuda)
            for s in ((2, 5), (2, 4), (2, 4), (5, 4, 4), (4, 4, 4), (4, 4))]
    grad_args = [a.clone().requires_grad_() if j == 0 else a
                 for j, a in enumerate(cell)]
    with pytest.raises(NotImplementedError, match="lstm_cell"):
        lstm_cell(*grad_args)
    before = lstm_cell.launches
    with torch.no_grad():
        lstm_cell(*grad_args)
    torch.cuda.synchronize()
    assert lstm_cell.launches == before + 1


# the scans' backward kernels: their test shapes, ragged ones (L not a
# multiple of a segment or chunk, P not a multiple of a block's 16 rows,
# N not a power of two, D not a multiple of 64, L < 64), and the training
# shapes (zamba2-2.7b 4 x 1024, xlstm-350m 8 x 1024)
SSM_GRAD_SHAPES = [(2, 64, 2, 8, 16), (2, 37, 3, 24, 20), (1, 70, 5, 80, 128),
                   (1, 300, 4, 64, 64), (4, 1024, 80, 64, 64)]
MLSTM_GRAD_SHAPES = [(1, 64, 2, 64), (2, 100, 2, 128), (1, 40, 3, 80),
                     (2, 300, 4, 512), (8, 1024, 4, 512)]


def _assert_scan_grad_close(got, want, name):
    """_assert_grad_close with float32's absolute bar scaled by the
    gradient's largest entry (at least 1): the scans' gradients are
    float32 sums of thousands of terms (P x N per step, H x P heads, D
    and its column blocks), whose rounding scales with the terms, so an
    entry that cancels to near 0 carries the error of its largest terms
    (measured on the card: within 4e-6 of the largest entry)."""
    if want.dtype != torch.float32:
        _assert_grad_close(got, want, want.dtype, name)
        return
    assert got.dtype == want.dtype and got.shape == want.shape, name
    atol = GRAD_F32_TOL * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=atol, rtol=GRAD_F32_TOL,
                               msg=name)


def _scan_cotangents(shapes, dtypes, seed, cuda):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(cuda, dt)
            for s, dt in zip(shapes, dtypes)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SSM_GRAD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssm_scan_backward_kernel_matches_plain(cuda, shape, dtype):
    """The backward kernel against ssm_scan_backward_plain with
    cotangents on y and on the final state, and with y's alone (None for
    the state); one launch each."""
    from repro_torch.kernels.ssm_scan import (ssm_scan_backward,
                                              ssm_scan_backward_plain)
    b, l, h, p, n = shape
    args = _ssm_inputs(shape, dtype, cuda)
    dy, dstate = _scan_cotangents([(b, l, h, p), (b, h, p, n)],
                                  [dtype, torch.float32], sum(shape), cuda)
    for state in (dstate, None):
        before = ssm_scan_backward.launches
        got = ssm_scan_backward(*args, dy, state)
        torch.cuda.synchronize()
        assert ssm_scan_backward.launches == before + 1
        want = ssm_scan_backward_plain(*args, dy, state)
        for name, a_, w in zip(("dx", "ddt", "da", "db", "dc", "dd"), got,
                               want):
            _assert_scan_grad_close(a_, w, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MLSTM_GRAD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mlstm_chunk_backward_kernel_matches_plain(cuda, shape, dtype):
    """The backward kernel against mlstm_chunk_backward_plain with
    cotangents on y and on (C, n, m), and with y's alone (None for the
    state); one launch each (its six kernels counted once)."""
    from repro_torch.kernels.mlstm_chunk import (mlstm_chunk_backward,
                                                 mlstm_chunk_backward_plain)
    b, l, h, d = shape
    args = _mlstm_inputs(shape, dtype, cuda)
    dy, dc, dn, dm = _scan_cotangents(
        [(b, l, h, d), (b, h, d, d), (b, h, d), (b, h)],
        [dtype] + [torch.float32] * 3, sum(shape), cuda)
    for state in ((dc, dn, dm), (None, None, None)):
        before = mlstm_chunk_backward.launches
        got = mlstm_chunk_backward(*args, dy, *state)
        torch.cuda.synchronize()
        assert mlstm_chunk_backward.launches == before + 1
        want = mlstm_chunk_backward_plain(*args, dy, *state)
        for name, a_, w in zip(("dq", "dk", "dv", "di", "df"), got, want):
            _assert_scan_grad_close(a_, w, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scan_backward_kernels_are_deterministic(cuda, dtype):
    """Two runs of each backward give the same bits: the sums over heads
    and column blocks go through per-block partials in a fixed order,
    with no atomics."""
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_backward
    from repro_torch.kernels.ssm_scan import ssm_scan_backward
    shape = (2, 300, 8, 64, 64)
    args = _ssm_inputs(shape, dtype, cuda)
    dy, dstate = _scan_cotangents([(2, 300, 8, 64), (2, 8, 64, 64)],
                                  [dtype, torch.float32], 1, cuda)
    runs = [ssm_scan_backward(*args, dy, dstate) for _ in range(2)]
    for a_, b_ in zip(*runs):
        assert torch.equal(a_, b_)
    shape = (2, 200, 2, 512)
    args = _mlstm_inputs(shape, dtype, cuda)
    dy, dc, dn, dm = _scan_cotangents(
        [shape, (2, 2, 512, 512), (2, 2, 512), (2, 2)],
        [dtype] + [torch.float32] * 3, 2, cuda)
    runs = [mlstm_chunk_backward(*args, dy, dc, dn, dm) for _ in range(2)]
    for a_, b_ in zip(*runs):
        assert torch.equal(a_, b_)


def test_scan_autograd_on_cuda_matches_cpu(cuda):
    """ssm_scan and mlstm_chunk under autograd on the card: one forward
    and one backward launch each, gradients of a loss on y and on the
    final state equal to autograd of the plain versions on the CPU."""
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_backward
    from repro_torch.kernels.ssm_scan import ssm_scan_backward
    for fn, bwd, args in (
            (ssm_scan, ssm_scan_backward,
             _ssm_inputs((2, 100, 3, 24, 16), torch.float32, cuda)),
            (mlstm_chunk, mlstm_chunk_backward,
             _mlstm_inputs((2, 100, 2, 64), torch.float32, cuda))):
        grads = {}
        for dev in (cuda, "cpu"):
            leaves = [t.detach().to(dev).requires_grad_() for t in args]
            before = (fn.launches, bwd.launches)
            y, state = fn(*leaves)
            last = state[-1] if isinstance(state, tuple) else state
            (y.sum() + (last * last).sum()).backward()
            if dev == cuda:
                assert (fn.launches - before[0],
                        bwd.launches - before[1]) == (1, 1)
            grads[dev] = [t.grad for t in leaves]
        for k, (a_, b_) in enumerate(zip(grads[cuda], grads["cpu"])):
            torch.testing.assert_close(a_.cpu(), b_, atol=GRAD_F32_TOL,
                                       rtol=GRAD_F32_TOL, msg=f"{fn} {k}")


@pytest.mark.parametrize("name", ["zamba2-2.7b", "xlstm-350m"])
def test_reduced_scan_models_train_on_cuda(cuda, name):
    """loss.backward() of the reduced zamba2 and xlstm on the card reaches
    every parameter leaf through the scans' backward kernels (one launch
    per Mamba2 or mLSTM block), each gradient within 1e-3 of its largest
    CPU entry (float32 sums in another order through two layers, as
    tests/test_torch_backward.py holds the CPU to the reference)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk_backward
    from repro_torch.kernels.ssm_scan import ssm_scan_backward
    from repro_torch.training import optimizer
    cfg = get_config(name).reduced(layers=2, d_model=128, vocab=256)
    model = build_model(cfg)
    params = model.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    batch = make_batch(cfg, 2, 96, seed=0)
    bwd, block = (ssm_scan_backward, "mamba") if name.startswith("zamba2") \
        else (mlstm_chunk_backward, "mlstm")
    per_loss = list(cfg.group_pattern).count(block) * cfg.num_groups
    grads = {}
    for dev in (cuda, "cpu"):
        p = optimizer.tree_map(lambda t: t.detach().to(dev), params)
        leaves = optimizer.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        before = bwd.launches
        loss = model.loss(p, {k: v.to(dev) for k, v in batch.items()})
        grads[dev] = torch.autograd.grad(loss, leaves)
        if dev == cuda:
            assert bwd.launches - before == per_loss
    for g, c in zip(grads[cuda], grads["cpu"]):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(
            g.cpu(), c, rtol=0, atol=1e-3 * max(float(c.abs().max()), 1e-6))
