"""The port's mLSTM on the CPU against the JAX reference: the plain version
and the sequential oracle against the Pallas kernel in interpret mode and
the reference's oracle, the chunkwise form against the reference's
`mlstm_chunk_jnp`, the (c0, n0, m0) handoff, ragged lengths, bf16, the op
the models call, and the wrapper's checks. Inputs are drawn with numpy
from a seed and handed to both packages. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances of tests/test_kernels.py: 5e-4 absolute and
5e-3 relative, m at 1e-5."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.mlstm_chunk import mlstm_chunk as pallas_mlstm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mlstm_chunk import (MAX_HEAD_DIM, mlstm_chunk,
                                             mlstm_chunk_plain)

# tests/test_kernels.py::MLSTM_CASES: b, l, h, d, chunk, block_h
MLSTM_CASES = [
    (1, 64, 2, 64, 16, 1),
    pytest.param((2, 128, 4, 32, 32, 2), marks=pytest.mark.slow),
    pytest.param((2, 256, 4, 16, 64, 4), marks=pytest.mark.slow)]
ATOL, RTOL, M_ATOL = 5e-4, 5e-3, 1e-5


def _inputs(b, l, h, d, seed=0):
    """q, k, v, i, f as the reference's tests draw them: normal, with the
    forget pre-activation shifted by +2."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, d), dtype=np.float32)
               for _ in range(3))
    ig = rng.standard_normal((b, l, h), dtype=np.float32)
    fg = rng.standard_normal((b, l, h), dtype=np.float32) + 2.0
    return q, k, v, ig, fg


def _close(got, want, what=""):
    """(y, (C, n, m)) pairs: y, C, n at 5e-4/5e-3, m at 1e-5."""
    (y, (c, n, m)), (yr, (cr, nr, mr)) = got, want
    as_np = lambda t: (t.float().numpy() if isinstance(t, torch.Tensor)
                       else np.asarray(t, np.float32))
    for name, a, b in (("y", y, yr), ("C", c, cr), ("n", n, nr)):
        np.testing.assert_allclose(as_np(a), as_np(b), atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what} {name}")
    np.testing.assert_allclose(as_np(m), as_np(mr), atol=M_ATOL,
                               err_msg=f"{what} m")


@pytest.mark.parametrize("case", MLSTM_CASES, ids=str)
def test_plain_and_oracle_match_pallas_and_jax_oracle(case):
    b, l, h, d, chunk, bh = case
    args = _inputs(b, l, h, d, seed=sum(case))
    jargs = tuple(map(jnp.asarray, args))
    targs = tuple(map(torch.from_numpy, args))
    pallas = pallas_mlstm(*jargs, chunk=chunk, block_h=bh, interpret=True)
    oracle = jax_ref.mlstm_chunk_reference(*jargs)
    plain = mlstm_chunk_plain(*targs, chunk=chunk, block_h=bh)
    seq = ref.mlstm_chunk_reference(*targs)
    assert plain[0].dtype == torch.float32
    assert tuple(plain[1][0].shape) == (b, h, d, d)
    assert tuple(plain[1][1].shape) == (b, h, d)
    assert tuple(plain[1][2].shape) == (b, h)
    for what, got in (("plain", plain), ("sequential", seq)):
        _close(got, pallas, f"{what} vs pallas")
        _close(got, oracle, f"{what} vs jax oracle")


def test_chunkwise_matches_jax_chunkwise():
    """tests/test_kernels.py::test_mlstm_chunk_jnp_matches_sequential's
    shape: the torch chunkwise form against `mlstm_chunk_jnp`, and both
    against the sequential oracle."""
    args = _inputs(2, 256, 4, 32, seed=5)
    want = jax_ref.mlstm_chunk_jnp(*map(jnp.asarray, args), chunk=64)
    got = ref.mlstm_chunk_torch(*map(torch.from_numpy, args), chunk=64)
    _close(got, want, "chunkwise")
    _close(got, ref.mlstm_chunk_reference(*map(torch.from_numpy, args)),
           "chunkwise vs sequential")


def test_state_handoff_two_halves_equal_the_whole():
    """Running [L/2:L] from the state after [0:L/2] (the prefill -> decode
    invariant) equals the second half of the whole run, and the
    reference's oracle from the same c0, n0, m0."""
    b, l, h, d = 1, 128, 2, 32
    q, k, v, ig, fg = map(torch.from_numpy, _inputs(b, l, h, d, seed=3))
    y_full, s_full = ref.mlstm_chunk_reference(q, k, v, ig, fg)
    half = l // 2
    _, (c0, n0, m0) = mlstm_chunk_plain(q[:, :half], k[:, :half],
                                        v[:, :half], ig[:, :half],
                                        fg[:, :half])
    tail = (q[:, half:], k[:, half:], v[:, half:], ig[:, half:],
            fg[:, half:])
    y2, s2 = ref.mlstm_chunk_reference(*tail, c0=c0, n0=n0, m0=m0)
    _close((y2, s2), (y_full[:, half:], s_full), "halves vs whole")
    want = jax_ref.mlstm_chunk_reference(
        *(jnp.asarray(t.numpy()) for t in tail), c0=jnp.asarray(c0.numpy()),
        n0=jnp.asarray(n0.numpy()), m0=jnp.asarray(m0.numpy()))
    _close((y2, s2), want, "handoff vs jax oracle")


@pytest.mark.parametrize("l", [100, 300])
def test_ragged_length_matches_sequential_oracle(l):
    """A length the chunk does not divide: the plain version takes the
    sequential oracle (the CUDA kernel masks the last chunk instead)."""
    args = _inputs(1, l, 2, 16, seed=l)
    got = mlstm_chunk(*map(torch.from_numpy, args))
    _close(got, jax_ref.mlstm_chunk_reference(*map(jnp.asarray, args)),
           f"L={l}")


def test_bfloat16_inputs_match_reference():
    """q, k, v in bf16: y comes back in bf16, the state in float32, both
    as the reference's oracle computes them from the same bf16 inputs."""
    q, k, v, ig, fg = _inputs(1, 64, 2, 32, seed=6)
    q16, k16, v16 = (torch.from_numpy(t).to(torch.bfloat16)
                     for t in (q, k, v))
    y, (c, n, m) = mlstm_chunk(q16, k16, v16, torch.from_numpy(ig),
                               torch.from_numpy(fg))
    assert y.dtype == torch.bfloat16
    assert c.dtype == n.dtype == m.dtype == torch.float32
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    yr, (cr, nr, mr) = jax_ref.mlstm_chunk_reference(
        as_jax(q16), as_jax(k16), as_jax(v16), jnp.asarray(ig),
        jnp.asarray(fg))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yr, np.float32), atol=2e-2,
                               rtol=2e-2)
    _close((y.float(), (c, n, m)), (np.asarray(yr, np.float32),
                                    (cr, nr, mr)), "bf16 state")


@pytest.mark.parametrize("l,path", [(128, "sequential"),
                                    (256, "chunkwise")])
def test_ops_mlstm_on_cpu_takes_the_reference_path(l, path):
    """Below L = 256 the sequential oracle, from 256 the chunkwise form at
    chunk 256, as the reference's op off the TPU; no kernel launch."""
    args = _inputs(2, l, 2, 16, seed=7)
    targs = tuple(map(torch.from_numpy, args))
    before = mlstm_chunk.launches
    got = ops.mlstm(*targs, chunk=64)
    assert mlstm_chunk.launches == before
    want_path = (ref.mlstm_chunk_reference(*targs) if path == "sequential"
                 else ref.mlstm_chunk_torch(*targs, chunk=256))
    torch.testing.assert_close(got[0], want_path[0], atol=0, rtol=0)
    for a, b in zip(got[1], want_path[1]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    _close(got, jax_ops.mlstm(*map(jnp.asarray, args), chunk=64),
           "ops.mlstm")


def test_zero_length_gives_the_zero_state():
    q, k, v, ig, fg = map(torch.from_numpy, _inputs(2, 0, 3, 8))
    y, (c, n, m) = mlstm_chunk(q, k, v, ig, fg)
    assert y.shape == (2, 0, 3, 8)
    assert not c.any() and not n.any() and bool((m == -1e30).all())


def _args(**change):
    names = ("q", "k", "v", "i_gate", "f_gate")
    args = dict(zip(names, map(torch.from_numpy, _inputs(2, 16, 3, 8))))
    args.update(change)
    return args


@pytest.mark.parametrize("change,msg", [
    ({"q": torch.zeros(2, 16, 3)}, "4 dims"),
    ({"f_gate": torch.zeros(2, 16, 3, 1)}, "3 dims"),
    ({"k": torch.zeros(2, 16, 3, 9)}, "one shape"),
    ({"i_gate": torch.zeros(2, 15, 3)}, "gate shapes"),
    ({"v": torch.zeros(2, 16, 8, 3).transpose(2, 3)}, "contiguous"),
    ({"q": torch.zeros(1, 2, 1, MAX_HEAD_DIM + 1),
      "k": torch.zeros(1, 2, 1, MAX_HEAD_DIM + 1),
      "v": torch.zeros(1, 2, 1, MAX_HEAD_DIM + 1),
      "i_gate": torch.zeros(1, 2, 1), "f_gate": torch.zeros(1, 2, 1)},
     "exceeds"),
    ({"f_gate": torch.zeros(2, 16, 3, device="meta")}, "different devices"),
], ids=["ndim", "gate-ndim", "k", "gates", "contiguous", "head-dim",
        "devices"])
def test_wrapper_rejects_bad_inputs(change, msg):
    with pytest.raises(ValueError, match=msg):
        mlstm_chunk(**_args(**change))


@pytest.mark.parametrize("change,msg", [
    ({"q": torch.zeros(2, 16, 3, 8, dtype=torch.float16),
      "k": torch.zeros(2, 16, 3, 8, dtype=torch.float16),
      "v": torch.zeros(2, 16, 3, 8, dtype=torch.float16)}, "float32 or"),
    ({"v": torch.zeros(2, 16, 3, 8, dtype=torch.bfloat16)}, "one dtype"),
    ({"i_gate": torch.zeros(2, 16, 3, dtype=torch.bfloat16)}, "gates in"),
], ids=["float16", "mixed", "gate-bf16"])
def test_wrapper_rejects_bad_dtypes(change, msg):
    with pytest.raises(TypeError, match=msg):
        mlstm_chunk(**_args(**change))


# --- the bf16 tensor-core design of csrc/mlstm_chunk.cu, modelled on the CPU
# The kernel walks chunks of 64 steps and runs its four products on
# mma.m16n8k16 (bf16 operands, float32 sums). Its arithmetic, modelled
# here in plain torch (float32 sums of exact bf16 products), is held
# against a float64 sequential oracle at the bars the card holds the
# kernel to: y 2e-2, C and n 5e-4 / 5e-3, m 1e-5. q, k and v are bf16 as
# given; S, n_in and the update's operand k w_out / sqrt(D) go in as
# bf16 hi + lo (two products each; n's update is the row sums of the
# latter), and C is carried in shared memory as bf16 hi + lo (~16 bits),
# so q C_in reads it as two operands: one bf16 rounding of S, the
# update's operand or C misses a bar (the last test). The gates' scans,
# n and m themselves, the row sums of S and the denominators stay
# float32.
TC_CHUNK = 64
BF16_Y_TOL = 2e-2


def _bf16(t):
    """t rounded to bf16 once, kept in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _split(t):
    """t as the sum of its bf16 hi and lo parts, the two operands the
    kernel feeds to two products."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _tensor_core_model(q, k, v, ig, fg, *, once=()):
    """q, k, v bf16-valued float32. Per chunk: q k^T from the exact
    operands, 1/sqrt(D) applied to the float32 result; S = that times
    exp(g_u - cm_t) [u <= t]; y = (S v + exp(m_in - cm_t) q C_in) / den
    with den from S's float32 row sums and q . n_in; C <- carry C
    + (k w_out / sqrt(D))^T v, and n <- carry n + the row sums of that
    operand. S, the update's operand and n_in (in q . n_in) are split into
    bf16 hi + lo, and C is carried as bf16 hi + lo; S, the update's
    operand and C are rounded to bf16 once instead where named in `once`
    ("s", "kw", "c"). Returns (y rounded to bf16, (C, n, m))."""
    part = {key: _bf16 if key in once else _split
            for key in ("s", "kw", "c")}
    bsz, l, h, d = q.shape
    scale = 1.0 / d ** 0.5
    c = torch.zeros(bsz, h, d, d)
    n = torch.zeros(bsz, h, d)
    m = torch.full((bsz, h), ref.NEG_INF)
    ys = []
    for t0 in range(0, l, TC_CHUNK):
        qc, kc, vc, ic, fc = (t[:, t0:t0 + TC_CHUNK]
                              for t in (q, k, v, ig, fg))
        tn = qc.shape[1]
        causal = torch.tril(torch.ones(tn, tn, dtype=torch.bool))
        b = torch.cumsum(torch.nn.functional.logsigmoid(fc), dim=1)
        g = ic - b                                               # (B, T, H)
        cm = torch.maximum(torch.cummax(g, dim=1).values, m[:, None])
        w = torch.where(causal[None, :, :, None],
                        torch.exp(g[:, None] - cm[:, :, None]), 0.0)
        s = torch.einsum("bthd,buhd->btuh", qc, kc) * scale * w
        inter = torch.exp(m[:, None] - cm)                       # (B, T, H)
        num = (torch.einsum("btuh,buhe->bthe", part["s"](s), vc)
               + torch.einsum("bthd,bhde->bthe", qc, c) * inter[..., None])
        qn = torch.einsum("bthd,bhd->bth", qc, _split(n))
        den = torch.maximum(torch.abs(s.sum(dim=2) + inter * qn),
                            torch.exp(-(b + cm)))
        ys.append(num / den[..., None])
        cm_l = cm[:, -1]
        kw = kc * scale * torch.exp(g - cm_l[:, None])[..., None]
        carry = torch.exp(m - cm_l)
        c = part["c"](c * carry[..., None, None]
                      + torch.einsum("buhd,buhe->bhde", part["kw"](kw), vc))
        n = n * carry[..., None] + part["kw"](kw).sum(dim=1)
        m = b[:, -1] + cm_l
    return _bf16(torch.cat(ys, dim=1)), (c, n, m)


def _sequential_f64(q, k, v, ig, fg):
    """The stabilised recurrence step by step in float64."""
    q, k, v, ig, fg = (t.double() for t in (q, k, v, ig, fg))
    bsz, l, h, d = q.shape
    k = k / d ** 0.5
    c = torch.zeros(bsz, h, d, d, dtype=torch.float64)
    n = torch.zeros(bsz, h, d, dtype=torch.float64)
    m = torch.full((bsz, h), ref.NEG_INF, dtype=torch.float64)
    ys = []
    for t in range(l):
        log_f = torch.nn.functional.logsigmoid(fg[:, t])
        m_new = torch.maximum(log_f + m, ig[:, t])
        fdec = torch.exp(log_f + m - m_new)
        iamp = torch.exp(ig[:, t] - m_new)
        c = (c * fdec[..., None, None] + iamp[..., None, None]
             * torch.einsum("bhd,bhe->bhde", k[:, t], v[:, t]))
        n = n * fdec[..., None] + iamp[..., None] * k[:, t]
        den = torch.maximum(
            torch.abs(torch.einsum("bhd,bhd->bh", n, q[:, t])),
            torch.exp(-m_new))
        ys.append(torch.einsum("bhde,bhd->bhe", c, q[:, t]) / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1), (c, n, m)


@pytest.fixture
def one_thread():
    """The model and the float64 oracle are long chains of tensor ops: one
    thread keeps each test process from contending with the other test
    workers for the cores. Restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(shape, seed):
    """The bf16-valued inputs of a case and the float64 oracle's result,
    computed once for the tests that share them."""
    args = _bf16_inputs(shape, seed)
    return args, _sequential_f64(*args)


@functools.lru_cache(maxsize=None)
def _model(shape, seed, once=()):
    return _tensor_core_model(*_case(shape, seed)[0], once=once)


def _bf16_inputs(shape, seed):
    q, k, v, ig, fg = map(torch.from_numpy, _inputs(*shape, seed=seed))
    return _bf16(q), _bf16(k), _bf16(v), ig, fg


def _meets_bars(got, want):
    (y, (c, n, m)), (y64, (c64, n64, m64)) = got, want
    return (torch.allclose(y, y64.float(), atol=BF16_Y_TOL,
                           rtol=BF16_Y_TOL)
            and torch.allclose(c, c64.float(), atol=ATOL, rtol=RTOL)
            and torch.allclose(n, n64.float(), atol=ATOL, rtol=RTOL)
            and torch.allclose(m, m64.float(), atol=M_ATOL, rtol=0))


# xlstm-350m's head shape (D = 512) at 2 of its heads over a 512-token
# prompt, then tests/test_torch_cuda.py's ragged shapes
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(1, 512, 2, 512), (1, 100, 2, 128),
                                   (2, 300, 3, 512), (1, 70, 1, 80)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_model_meets_the_card_bars(shape, seed, one_thread):
    y, (c, n, m) = _model(shape, seed)
    y64, (c64, n64, m64) = _case(shape, seed)[1]
    torch.testing.assert_close(y, y64.float(), atol=BF16_Y_TOL,
                               rtol=BF16_Y_TOL)
    for name, got, want in (("C", c, c64), ("n", n, n64)):
        torch.testing.assert_close(got, want.float(), atol=ATOL, rtol=RTOL,
                                   msg=lambda e, name=name: f"{name}: {e}")
    torch.testing.assert_close(m, m64.float(), atol=M_ATOL, rtol=0)


@pytest.mark.parametrize("once", ["s", "kw", "c"])
def test_one_rounding_of_a_float32_operand_misses_the_bars(once,
                                                           one_thread):
    """Why each float32 operand takes two bf16 parts: rounded once, S
    (feeding y) misses y's bar and the update's operand or the carried C
    misses C's, at xlstm-350m's head dim."""
    shape, seed = (1, 512, 2, 512), 0
    want = _case(shape, seed)[1]
    assert _meets_bars(_model(shape, seed), want)
    assert not _meets_bars(_model(shape, seed, once=(once,)), want)
