"""The port's ICU LSTM classifiers and engine against the JAX reference,
on the CPU (the plain lstm_cell path on both sides).

Parameters come from the reference's `ICULSTM.init` and cross over as
numpy arrays through `repro_torch.convert`. Tolerance atol 1e-4: the
48-step recurrence compounds float32 rounding of two different matmul
implementations, step after step, well past the 1e-5 of a single cell.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lstm import ICULSTM as RefICULSTM
from repro_torch import convert
from repro_torch.configs.icu_lstm import ICU_WORKLOADS
from repro_torch.data import icu
from repro_torch.launch import serve
from repro_torch.models.lstm import ICULSTM
from repro_torch.serving.engine import ClassifierEngine

ATOL = 1e-4


def _pair(cfg, seed=0):
    ref = RefICULSTM(cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  ref.init(jax.random.PRNGKey(seed)))
    port = ICULSTM(cfg, device="cpu")
    port.load_state_dict(convert.icu_lstm_params_from_numpy(tree))
    return ref, tree, port


@pytest.mark.parametrize("cfg", ICU_WORKLOADS, ids=lambda c: c.name)
def test_icu_lstm_forward_and_loss_match_reference(cfg):
    ref, tree, port = _pair(cfg)
    x, y = icu.generate(cfg, 4, seed=2)
    p = jax.tree_util.tree_map(jnp.asarray, tree)
    ref_logits = np.asarray(ref.forward(p, jnp.asarray(x)))
    ref_loss = float(ref.loss(p, {"features": jnp.asarray(x),
                                  "labels": jnp.asarray(y)}))
    with torch.no_grad():
        logits = port(torch.from_numpy(x))
        loss = float(port.loss({"features": torch.from_numpy(x),
                                "labels": torch.from_numpy(y)}))
    assert logits.shape == (4, cfg.num_classes)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=ATOL)
    assert abs(loss - ref_loss) <= ATOL


def test_parameters_keep_reference_layouts():
    cfg = ICU_WORKLOADS[2]
    ref, tree, port = _pair(cfg)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes == {
        "layers.0.wx": np.shape(tree["layers"][0]["wx"]),
        "layers.0.wh": np.shape(tree["layers"][0]["wh"]),
        "layers.0.b": np.shape(tree["layers"][0]["b"]),
        "head": np.shape(tree["head"]),
        "head_b": np.shape(tree["head_b"])}
    # dense_init draws std 1/sqrt(fan_in), as the reference does
    wx = port.layers[0]["wx"].detach().numpy()
    assert abs(wx.std() * np.sqrt(cfg.input_dim) - 1.0) < 0.1


def test_classifier_engine_on_cpu():
    cfg = ICU_WORKLOADS[1]
    ref, tree, port = _pair(cfg)
    engine = ClassifierEngine(port, device="cpu")
    x, _ = icu.generate(cfg, 8, seed=5)
    logits, seconds = engine.infer(x)
    assert logits.device.type == "cpu" and logits.shape == (8, 2)
    assert seconds > 0.0
    p = jax.tree_util.tree_map(jnp.asarray, tree)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(ref.forward(p, jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("entry", ["model", "engine", "serve"])
def test_entry_points_raise_without_cuda(entry, monkeypatch):
    """With no CUDA device and no explicit CPU request the entry points
    raise; they never drop quietly to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ICU_WORKLOADS[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "model":
            ICULSTM(cfg)
        elif entry == "engine":
            ClassifierEngine(ICULSTM(cfg, device="cpu"))
        else:
            serve.run(patients=2, verbose=False)
