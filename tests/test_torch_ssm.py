"""The port's SSM scan on the CPU against the JAX reference: the plain
version against the Pallas kernel in interpret mode, the sequential
oracle (with an initial state) against the reference's oracle, the op the
models call, and the wrapper's checks. Inputs are drawn with numpy from a
seed and handed to both packages. The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerance 3e-4, as tests/test_kernels.py holds the
Pallas kernel."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain

# tests/test_kernels.py::SSM_CASES: b, l, h, p, n, chunk, block_h
SSM_CASES = [(2, 64, 2, 8, 16, 64, 2), (2, 128, 4, 16, 16, 32, 2),
             (1, 256, 8, 32, 64, 64, 4)]
TOL = 3e-4


def _inputs(b, l, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, l, n), dtype=np.float32)
    cm = rng.standard_normal((b, l, n), dtype=np.float32)
    d = rng.standard_normal(h, dtype=np.float32)
    return x, dt, a, bm, cm, d


def test_plain_matches_pallas_interpret():
    b, l, h, p, n, chunk, bh = SSM_CASES[0]
    args = _inputs(b, l, h, p, n, seed=1)
    y_ref, h_ref = pallas_ssm(*map(jnp.asarray, args), chunk=chunk,
                              block_h=bh, interpret=True)
    y, hf = ssm_scan_plain(*map(torch.from_numpy, args), chunk=chunk,
                           block_h=bh)
    assert y.dtype == torch.float32 and hf.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_reference_matches_jax_reference(case):
    b, l, h, p, n = case[:5]
    args = _inputs(b, l, h, p, n, seed=sum(case))
    y_ref, h_ref = jax_ref.ssm_scan_reference(*map(jnp.asarray, args))
    y, hf = ref.ssm_scan_reference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_ref), atol=TOL,
                               rtol=TOL)


def test_state_handoff_matches_reference():
    """tests/test_kernels.py::test_ssm_scan_state_handoff_equals_split_scan
    on the port: scanning [L/2:L] from the state after [0:L/2] equals the
    second half of the whole scan, and the reference's oracle with the
    same h0."""
    b, l, h, p, n = 1, 128, 2, 8, 16
    args = list(map(torch.from_numpy, _inputs(b, l, h, p, n, seed=3)))
    x, dt, a, bm, cm, d = args
    y_full, h_full = ref.ssm_scan_reference(*args)
    half = l // 2
    _, h_half = ref.ssm_scan_reference(x[:, :half], dt[:, :half], a,
                                       bm[:, :half], cm[:, :half], d)
    tail = (x[:, half:], dt[:, half:], a, bm[:, half:], cm[:, half:], d)
    y2, h2 = ref.ssm_scan_reference(*tail, h0=h_half)
    np.testing.assert_allclose(y2.numpy(), y_full[:, half:].numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-4,
                               rtol=1e-4)
    y_j, h_j = jax_ref.ssm_scan_reference(
        *(jnp.asarray(t.numpy()) for t in tail),
        h0=jnp.asarray(h_half.numpy()))
    np.testing.assert_allclose(y2.numpy(), np.asarray(y_j), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_j), atol=TOL,
                               rtol=TOL)


def test_ops_ssm_on_cpu_takes_the_reference_path():
    args = _inputs(2, 48, 3, 8, 16, seed=4)
    y_ref, h_ref = jax_ops.ssm(*map(jnp.asarray, args), chunk=256)
    before = ssm_scan.launches
    y, hf = ops.ssm(*map(torch.from_numpy, args), chunk=256)
    assert ssm_scan.launches == before
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_ref), atol=TOL,
                               rtol=TOL)


def test_plain_bfloat16_matches_reference():
    """x, b, c in bf16: y comes back in bf16, the state in float32, both
    as the reference's oracle computes them from the same bf16 inputs."""
    x, dt, a, bm, cm, d = _inputs(1, 64, 2, 16, 16, seed=5)
    x16, b16, c16 = (torch.from_numpy(t).to(torch.bfloat16)
                     for t in (x, bm, cm))
    y, hf = ssm_scan(x16, torch.from_numpy(dt), torch.from_numpy(a), b16,
                     c16, torch.from_numpy(d))
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    y_ref, h_ref = jax_ref.ssm_scan_reference(
        as_jax(x16), jnp.asarray(dt), jnp.asarray(a), as_jax(b16),
        as_jax(c16), jnp.asarray(d))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_ref), atol=TOL,
                               rtol=TOL)


def _args(**change):
    names = ("x", "dt", "a", "b", "c", "d")
    args = dict(zip(names, map(torch.from_numpy,
                               _inputs(2, 16, 3, 4, 8, seed=0))))
    args.update(change)
    return args


@pytest.mark.parametrize("change,msg", [
    ({"x": torch.zeros(2, 16, 3)}, "4 dims"),
    ({"dt": torch.zeros(2, 15, 3)}, "dt shape"),
    ({"a": torch.zeros(4)}, "must both be"),
    ({"c": torch.zeros(2, 16, 9)}, "must both be"),
    ({"x": torch.zeros(2, 16, 4, 3).transpose(2, 3)}, "contiguous"),
], ids=["ndim", "dt", "a", "c", "contiguous"])
def test_wrapper_rejects_bad_inputs(change, msg):
    with pytest.raises(ValueError, match=msg):
        ssm_scan(**_args(**change))


@pytest.mark.parametrize("change,msg", [
    ({"x": torch.zeros(2, 16, 3, 4, dtype=torch.float16)}, "float32 or"),
    ({"b": torch.zeros(2, 16, 8, dtype=torch.bfloat16)}, "one dtype"),
    ({"dt": torch.zeros(2, 16, 3, dtype=torch.bfloat16)}, "in float32"),
], ids=["float16", "mixed", "dt-bf16"])
def test_wrapper_rejects_bad_dtypes(change, msg):
    with pytest.raises(TypeError, match=msg):
        ssm_scan(**_args(**change))


# --- the bf16 tensor-core design of csrc/ssm_scan.cu, modelled on the CPU --
# The kernel runs the chunked SSD form in chunks of 64 steps with
# mma.m16n8k16 (bf16 operands, float32 sums). Its arithmetic, modelled
# here in plain torch (float32 sums of exact bf16 products), is held
# against a float64 sequential oracle at the bars the card holds the
# kernel to: y 2e-2, the float32 state 3e-4. Every product takes either
# operands that are bf16 as given (x, B, C) or a float32 operand split
# into bf16 hi + lo, which carries ~16 bits: one bf16 rounding misses
# both bars (the last test).
TC_CHUNK = 64
SSM_BF16_Y_TOL = 2e-2


def _bf16(t):
    """t rounded to bf16 once, kept in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _split(t):
    """t as the sum of its bf16 hi and lo parts, the two operands the
    kernel feeds to two products."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _tensor_core_model(x, dt, a, bm, cm, d, *, once=()):
    """x, bm, cm bf16-valued float32. Per chunk: s = cumsum(dt a);
    G = C B^T (exact products); M = G exp(s_t - s_u) dt_u [u <= t];
    y = M x + exp(s_t) C h_in^T + D x; h <- exp(s_T) h
    + (dt x exp(s_T - s))^T B. M, h_in and the state operand W are split
    into bf16 hi + lo, or rounded once where named in `once` ("m", "h",
    "w"). A ragged last chunk is padded with dt = 0, x = 0. Returns y
    rounded to bf16 and the state."""
    part = {k: _bf16 if k in once else _split for k in ("m", "h", "w")}
    bsz, l, h, p = x.shape
    n = bm.shape[-1]
    state = torch.zeros(bsz, h, p, n)
    causal = torch.tril(torch.ones(TC_CHUNK, TC_CHUNK, dtype=torch.bool))
    ys = []
    for t0 in range(0, l, TC_CHUNK):
        tn = min(TC_CHUNK, l - t0)

        def pad(t):
            out = t.new_zeros((bsz, TC_CHUNK) + t.shape[2:])
            out[:, :tn] = t[:, t0:t0 + tn]
            return out
        xc, dtc, bc, cc = pad(x), pad(dt), pad(bm), pad(cm)
        s = torch.cumsum(dtc * a, dim=1)                         # (B, T, H)
        g = cc @ bc.transpose(1, 2)                              # (B, T, U)
        decay = torch.exp(s[:, :, None, :] - s[:, None, :, :])  # (B,T,U,H)
        m = part["m"](torch.where(causal[None, :, :, None],
                                  g[..., None] * decay * dtc[:, None], 0.0))
        y = (torch.einsum("btuh,buhp->bthp", m, xc)
             + torch.exp(s)[..., None]
             * torch.einsum("btn,bhpn->bthp", cc, part["h"](state))
             + xc * d[:, None])
        ys.append(y[:, :tn])
        w = dtc[..., None] * xc * torch.exp(s[:, -1:] - s)[..., None]
        state = (state * torch.exp(s[:, -1])[..., None, None]
                 + torch.einsum("buhp,bun->bhpn", part["w"](w), bc))
    return _bf16(torch.cat(ys, dim=1)), state


def _sequential_f64(x, dt, a, bm, cm, d):
    """The recurrence step by step in float64."""
    x, dt, a, bm, cm, d = (t.double() for t in (x, dt, a, bm, cm, d))
    bsz, l, h, p = x.shape
    state = torch.zeros(bsz, h, p, bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(l):
        state = (state * torch.exp(dt[:, t] * a)[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t, :, None],
                                bm[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return torch.stack(ys, dim=1) + x * d[:, None], state


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
    x, dt, a, bm, cm, d = map(torch.from_numpy, _inputs(*shape, seed=seed))
    return _bf16(x), dt, a, _bf16(bm), _bf16(cm), d


def _meets_bars(got, want):
    (y, state), (y64, state64) = got, want
    return (torch.allclose(y, y64.float(), atol=SSM_BF16_Y_TOL,
                           rtol=SSM_BF16_Y_TOL)
            and torch.allclose(state, state64.float(), atol=TOL, rtol=TOL))


# zamba2's head shape (P = N = 64) at 8 of its 80 independent heads over
# a 512-token prompt, then tests/test_torch_cuda.py's ragged shapes
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", [(1, 512, 8, 64, 64), (2, 37, 3, 24, 20),
                                   (1, 70, 5, 80, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_model_meets_the_card_bars(shape, seed, one_thread):
    y, state = _model(shape, seed)
    y64, state64 = _case(shape, seed)[1]
    torch.testing.assert_close(y, y64.float(), atol=SSM_BF16_Y_TOL,
                               rtol=SSM_BF16_Y_TOL)
    torch.testing.assert_close(state, state64.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("once", ["m", "h", "w"])
def test_one_rounding_of_a_float32_operand_misses_the_bars(once,
                                                           one_thread):
    """Why each float32 operand takes two products: rounded to bf16 once,
    M (feeding y) or the state operand W misses its bar at zamba2's head
    shape, and h_in (feeding y) at seed 1."""
    shape, seed = (1, 512, 8, 64, 64), 1
    want = _case(shape, seed)[1]
    assert _meets_bars(_model(shape, seed), want)
    assert not _meets_bars(_model(shape, seed, once=(once,)), want)
