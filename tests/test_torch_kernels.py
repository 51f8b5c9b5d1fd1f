"""The port's lstm_cell on the CPU: its plain version against the JAX
reference (the Pallas kernel in interpret mode and the jnp oracle), and
the wrapper's checks. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jax_ref
from repro.kernels.lstm_cell import lstm_cell as pallas_lstm_cell
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.lstm_cell import lstm_cell, lstm_cell_plain

SHAPES = [(4, 76, 16), (8, 17, 8)]      # (B, I, H)
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
    args = _torch(_inputs(4, 76, 16))
    args[3] = args[3].to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        lstm_cell(*args)


def test_wrapper_rejects_non_contiguous():
    args = _torch(_inputs(4, 76, 16))
    args[0] = torch.zeros(76, 4).t()
    with pytest.raises(ValueError, match="contiguous"):
        lstm_cell(*args)


def test_library_path_is_keyed_by_sources_and_flags(monkeypatch):
    from repro_torch.kernels import build
    path = build.library_path("lstm_cell")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("liblstm_cell-") and path.suffix == ".so"
    assert build.library_path("lstm_cell") == path
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
