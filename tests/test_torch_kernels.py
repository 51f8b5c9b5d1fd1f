"""The port's lstm_cell and lstm_sequence on the CPU: their plain versions
against the JAX reference (the Pallas kernel in interpret mode, stepped
and scanned, and the jnp oracle), and the wrappers' checks. The CUDA
kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jax_ref
from repro.kernels.lstm_cell import lstm_cell as pallas_lstm_cell
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.lstm_cell import (lstm_cell, lstm_cell_plain,
                                           lstm_sequence,
                                           lstm_sequence_plain)

# (B, I, H): the first two test shapes, then the phenotype workload at the
# execute and calibrate batches
SHAPES = [(4, 76, 16), (8, 17, 8), (8, 76, 32), (16, 76, 32)]
SEQ_LENS = [1, 5, 48]
ATOL = 1e-5


def _inputs(b, i, h, seed=0):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(i + h)
    return (rng.standard_normal((b, i)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32),
            rng.standard_normal((b, h)).astype(np.float32),
            (rng.standard_normal((i, 4, h)) * s).astype(np.float32),
            (rng.standard_normal((h, 4, h)) * s).astype(np.float32),
            (rng.standard_normal((4, h)) * 0.1).astype(np.float32))


def _torch(args):
    return [torch.from_numpy(a) for a in args]


def _seq_inputs(b, i, h, t_len, seed=0):
    """xs (T, B, I) and one layer's weights, drawn as `_inputs` draws
    them."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(i + h)
    return (rng.standard_normal((t_len, b, i)).astype(np.float32),
            (rng.standard_normal((i, 4, h)) * s).astype(np.float32),
            (rng.standard_normal((h, 4, h)) * s).astype(np.float32),
            (rng.standard_normal((4, h)) * 0.1).astype(np.float32))


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_interpret(shape):
    args = _inputs(*shape)
    h_ref, c_ref = pallas_lstm_cell(*map(jnp.asarray, args), interpret=True)
    h, c = lstm_cell_plain(*_torch(args))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_matches_jax_reference(shape):
    """kernels.ref.lstm_cell_reference on the flattened (I, 4H) layout."""
    b, i, hd = shape
    x, h0, c0, wx, wh, bias = _inputs(*shape, seed=1)
    flat = (x, h0, c0, wx.reshape(i, 4 * hd), wh.reshape(hd, 4 * hd),
            bias.reshape(4 * hd))
    h_ref, c_ref = jax_ref.lstm_cell_reference(*map(jnp.asarray, flat))
    h, c = ref.lstm_cell_reference(*_torch(flat))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lstm_step_matches_reference_op(shape):
    """ops.lstm_step on CPU tensors takes the plain version and counts
    no kernel launch."""
    args = _inputs(*shape, seed=2)
    h_ref, c_ref = ref_ops.lstm_step(*map(jnp.asarray, args))
    before = lstm_cell.launches
    h, c = ops.lstm_step(*_torch(args))
    assert lstm_cell.launches == before
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=ATOL)


@pytest.mark.parametrize("which,shape,msg", [
    ("wx", (76, 4, 8), "wx shape"),
    ("wh", (16, 4, 8), "wh shape"),
    ("b", (4, 8), "b shape"),
    ("c", (4, 8), "must"),
], ids=["wx", "wh", "b", "c"])
def test_wrapper_rejects_bad_shapes(which, shape, msg):
    args = dict(zip(("x", "h", "c", "wx", "wh", "b"),
                    _torch(_inputs(4, 76, 16))))
    args[which] = torch.zeros(shape)
    with pytest.raises(ValueError, match=msg):
        lstm_cell(**args)


def test_wrapper_rejects_non_float32():
    """float16 is neither of the two dtypes the kernel reads."""
    args = _torch(_inputs(4, 76, 16))
    args[3] = args[3].to(torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lstm_cell(*args)


# which of (x, h, c, wx, wh, b) are bfloat16: all, the weights only, and
# h alone (so h' and c' come back in different dtypes)
BF16_MIXES = {"all": (1, 1, 1, 1, 1, 1), "weights": (0, 0, 0, 1, 1, 1),
              "h": (0, 1, 0, 0, 0, 0)}
# one bfloat16 rounding of h' or c' (|c'| < 4: 2^-6) on either side
BF16_ATOL = 2 ** -6


def _bf16_mix(args, mix):
    """numpy inputs as torch tensors and as jnp arrays, those marked in
    `mix` rounded to bfloat16 on both sides."""
    port = [t.to(torch.bfloat16) if m else t
            for t, m in zip(_torch(args), mix)]
    ref = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if m
           else jnp.asarray(t.numpy()) for t, m in zip(port, mix)]
    return port, ref


@pytest.mark.parametrize("mix", sorted(BF16_MIXES))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plain_bf16_inputs_match_pallas_interpret(shape, mix):
    """bfloat16 inputs, float32 math: the plain cell against the Pallas
    cell in interpret mode, h' and c' in h's and c's dtypes, within one
    bfloat16 rounding."""
    port, ref_args = _bf16_mix(_inputs(*shape, seed=7), BF16_MIXES[mix])
    h_ref, c_ref = pallas_lstm_cell(*ref_args, interpret=True)
    for fn in (lstm_cell_plain, lstm_cell):
        h, c = fn(*port)
        assert h.dtype == port[1].dtype and c.dtype == port[2].dtype
        assert str(h.dtype).removeprefix("torch.") == str(h_ref.dtype)
        np.testing.assert_allclose(h.float().numpy(),
                                   np.asarray(h_ref, np.float32),
                                   atol=BF16_ATOL)
        np.testing.assert_allclose(c.float().numpy(),
                                   np.asarray(c_ref, np.float32),
                                   atol=BF16_ATOL)


def test_wrapper_rejects_non_contiguous():
    args = _torch(_inputs(4, 76, 16))
    args[0] = torch.zeros(76, 4).t()
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cell(*args)


@pytest.mark.parametrize("t_len", SEQ_LENS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sequence_plain_is_a_scan_of_the_plain_cell(shape, t_len):
    """lstm_sequence_plain is lstm_cell_plain scanned from h = c = 0, bit
    for bit, so the port's CPU numbers do not move."""
    xs, wx, wh, b = _torch(_seq_inputs(*shape, t_len, seed=3))
    h = c = torch.zeros(shape[0], shape[2])
    hs = []
    for xt in xs:
        h, c = lstm_cell_plain(xt, h, c, wx, wh, b)
        hs.append(h)
    h_s, c_s, hs_s = lstm_sequence_plain(xs, wx, wh, b, return_sequence=True)
    assert torch.equal(h_s, h) and torch.equal(c_s, c)
    assert torch.equal(hs_s, torch.stack(hs))


@pytest.mark.parametrize("t_len", SEQ_LENS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sequence_plain_matches_pallas_interpret_scan(shape, t_len):
    """Against the reference's Pallas cell in interpret mode, scanned over
    T as the reference's ICULSTM.forward scans it: h_T, c_T and every
    step's h within the cell's 1e-5."""
    xs, wx, wh, b = _seq_inputs(*shape, t_len, seed=4)
    h = c = jnp.zeros((shape[0], shape[2]), jnp.float32)
    hs = []
    for xt in xs:
        h, c = pallas_lstm_cell(jnp.asarray(xt), h, c, jnp.asarray(wx),
                                jnp.asarray(wh), jnp.asarray(b),
                                interpret=True)
        hs.append(np.asarray(h))
    h_p, c_p, hs_p = lstm_sequence_plain(*_torch((xs, wx, wh, b)),
                                         return_sequence=True)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h), atol=ATOL)
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c), atol=ATOL)
    np.testing.assert_allclose(hs_p.numpy(), np.stack(hs), atol=ATOL)


@pytest.mark.parametrize("return_sequence", [False, True])
def test_lstm_sequence_on_cpu_is_the_plain_version(return_sequence):
    """lstm_sequence and ops.lstm_layer on CPU tensors take the plain
    version and count no kernel launch."""
    args = _torch(_seq_inputs(8, 76, 32, 48, seed=5))
    before = lstm_sequence.launches
    want = lstm_sequence_plain(*args, return_sequence=return_sequence)
    for got in (lstm_sequence(*args, return_sequence=return_sequence),
                ops.lstm_layer(*args, return_sequence=return_sequence)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if return_sequence:
            assert got[2].shape == (48, 8, 32)
            assert torch.equal(got[2], want[2])
        else:
            assert got[2] is None
    assert lstm_sequence.launches == before


@pytest.mark.parametrize("which,shape,msg", [
    ("xs", (48, 4), "must have 3 dims"),
    ("wx", (76, 4, 8), "wx shape"),
    ("wh", (16, 4, 8), "wh shape"),
    ("b", (4, 8), "b shape"),
], ids=["xs", "wx", "wh", "b"])
def test_sequence_wrapper_rejects_bad_shapes(which, shape, msg):
    args = dict(zip(("xs", "wx", "wh", "b"),
                    _torch(_seq_inputs(4, 76, 16, 5))))
    args[which] = torch.zeros(shape)
    with pytest.raises(ValueError, match=msg):
        lstm_sequence(**args)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sequence_plain_bf16_matches_pallas_interpret_scan(shape):
    """bfloat16 xs and weights: h and c carried in bfloat16 from step to
    step, as the Pallas cell scanned over T returns them; every step's h
    within one bfloat16 rounding of h."""
    t_len = 48
    port, ref_args = _bf16_mix(_seq_inputs(*shape, t_len, seed=8),
                               (1, 1, 1, 1))
    xs, wx, wh, b = ref_args
    h = c = jnp.zeros((shape[0], shape[2]), jnp.bfloat16)
    hs = []
    for xt in xs:
        h, c = pallas_lstm_cell(xt, h, c, wx, wh, b, interpret=True)
        hs.append(np.asarray(h, np.float32))
    h_p, c_p, hs_p = lstm_sequence(*port, return_sequence=True)
    assert h_p.dtype == c_p.dtype == hs_p.dtype == torch.bfloat16
    np.testing.assert_allclose(h_p.float().numpy(), np.asarray(h, np.float32),
                               atol=BF16_ATOL)
    np.testing.assert_allclose(c_p.float().numpy(), np.asarray(c, np.float32),
                               atol=BF16_ATOL)
    np.testing.assert_allclose(hs_p.float().numpy(), np.stack(hs),
                               atol=BF16_ATOL)


def test_sequence_wrapper_rejects_non_float32():
    args = _torch(_seq_inputs(4, 76, 16, 5))
    args[2] = args[2].to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        lstm_sequence(*args)


def test_sequence_wrapper_rejects_non_contiguous():
    args = _torch(_seq_inputs(4, 76, 16, 5))
    args[0] = torch.zeros(4, 5, 76).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_sequence(*args)


def test_library_path_is_keyed_by_sources_and_flags(monkeypatch):
    from repro_torch.kernels import build
    path = build.library_path("lstm_cell")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("liblstm_cell-") and path.suffix == ".so"
    assert build.library_path("lstm_cell") == path
    assert build.log_path("lstm_cell") == path.with_suffix(".log")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("lstm_cell") != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_ext

    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("lstm_cell")


def test_reference_pallas_lstm_cell_has_no_gradient():
    """What the port's `lstm_cell` mirrors by raising NotImplementedError
    under grad on the card: `jax.grad` through the reference's Pallas
    cell (interpret mode, as off the TPU) raises, so the reference has no
    one-step gradient to port."""
    import jax
    rng = np.random.default_rng(0)
    x, h, c, wx, wh, b = (
        jnp.asarray(rng.standard_normal(s), jnp.float32)
        for s in ((4, 8), (4, 16), (4, 16), (8, 4, 16), (16, 4, 16),
                  (4, 16)))
    h_new, _ = pallas_lstm_cell(x, h, c, wx, wh, b, interpret=True)
    assert h_new.shape == (4, 16)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda x: pallas_lstm_cell(x, h, c, wx, wh, b,
                                            interpret=True)[0].sum())(x)
