"""The port's SSM scan on the CPU against the JAX reference: the plain
version against the Pallas kernel in interpret mode, the sequential
oracle (with an initial state) against the reference's oracle, the op the
models call, and the wrapper's checks. Inputs are drawn with numpy from a
seed and handed to both packages. The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerance 3e-4, as tests/test_kernels.py holds the
Pallas kernel."""
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
