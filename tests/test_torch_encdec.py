"""The port's seamless-m4t-large-v2 encoder-decoder on the CPU against the
JAX reference, reduced (`reduced(layers=2, d_model=128, vocab=256)`: two
non-causal encoder layers over 32 stub frames, two decoder layers of
(self-attention, cross-attention, MLP); tests/llm_parity.py). Tolerance
atol 1e-4; greedy tokens identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro.models import build_model as ref_build_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDecModel
from repro_torch.serving.engine import ServingEngine

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def pair():
    return lp.Pair(ARCH, seed=13)


def test_build_model_returns_the_encoder_decoder(pair):
    assert isinstance(pair.model, EncDecModel)
    assert pair.model.encoder.pattern == ("attn",)
    assert pair.model.decoder.pattern == ("attn", "cross")
    assert pair.model.encoder.num_groups == pair.cfg.encoder_layers == 2
    assert pair.model.decoder.num_groups == pair.cfg.num_layers == 2


def test_encode_matches_reference(pair):
    """The non-causal encoder stack over the stub frames, then enc_norm."""
    frames = pair.extra["frames"]
    want = pair.ref.encode(pair.ref_params, jnp.asarray(frames))
    with torch.inference_mode():
        got = pair.model.encode(pair.params, torch.as_tensor(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=lp.ATOL)
    # non-causal: the first frame's output depends on the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    with torch.inference_mode():
        got2 = pair.model.encode(pair.params, torch.as_tensor(moved))
    assert float((got2[:, 0] - got[:, 0]).abs().max()) > 1e-4


def test_prefill_logits_and_every_cache_leaf_match(pair):
    """Per decoder layer: the self-attention's k, v and the cross block's
    static K/V of the encoder output."""
    lp.check_prefill(pair, expect_leaves=8)


def test_decode_steps_match(pair):
    lp.check_decode_steps(pair)


def test_decode_matches_teacher_forcing(pair):
    lp.check_teacher_forcing(pair, prefix=pair.prompt - 3)


def test_generate_greedy_tokens_identical(pair):
    lp.check_generate(pair)


def test_vocab_padding_masked():
    """tests/test_models.py::test_vocab_padding_masked on both packages: a
    vocab of 250 pads to 256 and the pad logits sit at -1e30."""
    cfg = dataclasses.replace(lp.reduced(get_config, ARCH), vocab_size=250)
    ref_cfg = dataclasses.replace(lp.reduced(lp.ref_get_config, ARCH),
                                  vocab_size=250)
    ref = ref_build_model(ref_cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  ref.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 250, (1, 8)),
             "frames": rng.standard_normal((1, cfg.encoder_frames,
                                            cfg.d_model), dtype=np.float32)}
    want, _ = ref.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    model = build_model(cfg)
    with torch.inference_mode():
        got, _ = model.forward(convert.encdec_params_from_numpy(tree, cfg),
                               {k: torch.as_tensor(v)
                                for k, v in batch.items()})
    assert got.shape[-1] == 256
    assert float(got[..., 250:].max()) < -1e20
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=lp.ATOL)


def test_engine_serves_bf16_frames_and_init_cache():
    """A bfloat16 model from its own init, float32 frames through the
    engine; init_cache has the decoder's self and cross caches."""
    cfg = lp.reduced(get_config, ARCH, dtype="bfloat16")
    model = build_model(cfg)
    batch = make_batch(cfg, 2, 12, seed=2)
    batch["frames"] = batch["frames"].float()
    engine = ServingEngine(model, model.init(
        torch.Generator().manual_seed(0), device="cpu"), device="cpu")
    out = engine.generate(batch, 3)
    assert out.tokens.shape == (2, 15)
    assert int(out.tokens.max()) < cfg.vocab_size
    cache = model.init_cache(2, 20, device="cpu")
    want = ref_build_model(lp.reduced(lp.ref_get_config, ARCH,
                                      dtype="bfloat16")).init_cache(2, 20)
    flat = jax.tree_util.tree_flatten_with_path(want["groups"])[0]
    assert len(cache["groups"]) == cfg.num_layers
    for path, leaf in flat:
        t = cache["groups"][0]
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape[1:], path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
