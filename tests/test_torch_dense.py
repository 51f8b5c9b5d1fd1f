"""The port's dense decoder archs (ATTN, ATTN_LOCAL / ATTN_GLOBAL) on the
CPU against the JAX reference: gemma-2b (MQA, head dim 256 at full width,
GeGLU), qwen2-1.5b (qkv bias), gemma2-27b (local / global, attention and
final softcaps) and mistral-large-123b, each reduced as tests/
test_models.py reduces it (`reduced(layers=2, d_model=128, vocab=256)`),
float32, on the same noised parameters (tests/llm_parity.py). Tolerance
atol 1e-4; greedy tokens identical.
"""
import numpy as np
import pytest
import torch

import llm_parity as lp
from repro_torch.configs import get_config
from repro_torch.models import build_model

DENSE = ("gemma-2b", "qwen2-1.5b", "gemma2-27b", "mistral-large-123b")


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return lp.Pair(request.param)


def test_prefill_logits_and_every_cache_leaf_match(pair):
    # k and v of two attention blocks
    lp.check_prefill(pair, expect_leaves=4)


def test_decode_steps_match(pair):
    lp.check_decode_steps(pair)


def test_decode_matches_teacher_forcing(pair):
    lp.check_teacher_forcing(pair, prefix=pair.prompt - 3)


def test_generate_greedy_tokens_identical(pair):
    lp.check_generate(pair)


# a window of 8 (tests/test_models.py::test_sliding_window_decode_ring_
# buffer): gemma2's local layer, and plain ATTN under the explicit
# long-context window
RING = {"gemma2-local": ("gemma2-27b", dict(attn_window=8)),
        "qwen2-long-context": ("qwen2-1.5b", dict(long_context_window=8))}


@pytest.mark.parametrize("case", sorted(RING))
def test_ring_buffer_decode_past_the_window(case):
    """A 12-token prompt (the window bites in prefill) and 12 decode
    steps well past the window of 8: the cache is a ring of 8 slots, and
    every step matches the reference and the port's own windowed
    teacher-forced forward."""
    arch, replace = RING[case]
    pair = lp.Pair(arch, batch=1, prompt=12, steps=12, seed=3, **replace)
    _, cache = lp.check_prefill(pair, expect_leaves=4)
    assert cache["groups"][0]["b0_" + pair.cfg.group_pattern[0]][
        "attn"]["k"].shape[2] == 8
    lp.check_decode_steps(pair)
    lp.check_teacher_forcing(pair)


def test_dense_init_keeps_constant_leaves():
    """Norms and qkv biases start at 0, embeddings are tied (no
    unembed), and the weights have std 1/sqrt(fan-in), as the reference
    draws them."""
    cfg = get_config("qwen2-1.5b").reduced(layers=2, d_model=128, vocab=256)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    assert "unembed" not in params
    block = params["stack"]["groups"]["b0_attn"]
    for name in ("bq", "bk", "bv", "norm"):
        assert not block["attn"][name].any(), name
    assert not block["mlp"]["norm"].any()
    std = float(block["attn"]["wq"].std()) * np.sqrt(cfg.d_model)
    assert abs(std - 1.0) < 0.1
