"""The port's mLSTM on the CPU against the JAX reference: the plain version
and the sequential oracle against the Pallas kernel in interpret mode and
the reference's oracle, the chunkwise form against the reference's
`mlstm_chunk_jnp`, the (c0, n0, m0) handoff, ragged lengths, bf16, the op
the models call, and the wrapper's checks. Inputs are drawn with numpy
from a seed and handed to both packages. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances of tests/test_kernels.py: 5e-4 absolute and
5e-3 relative, m at 1e-5."""
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
