"""The port's xlstm-350m serving path on the CPU against the JAX
reference, at a reduced size (`reduced(d_model=128, vocab=256)`: one group
of seven mLSTM blocks and one sLSTM block, float32, two mLSTM heads of
D = 128, four sLSTM heads of 32, chunk 64, tied embeddings).

Parameters come from the reference's `DecoderModel.init`, with seeded
numpy noise added to every leaf so that no leaf sits at its constant init
(norms, gate biases, conv biases), and cross over through
`repro_torch.convert`. Prompts of 64 tokens take the sequential mLSTM
oracle on the CPU, prompts of 256 the chunkwise form. Tolerance atol 1e-4
(float32 sums in another order through eight blocks); the sLSTM's
unnormalised cell and normaliser states, sums over the prompt that reach
~20 at these lengths, also get rtol 5e-5 (their drift is the blocks
upstream: the sLSTM block alone agrees to 5e-6). Greedy tokens must be
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serving.engine import ServingEngine as RefServingEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.decoder import padded_vocab
from repro_torch.serving.engine import ServingEngine

ATOL = 1e-4
SLSTM_SUM_RTOL = 5e-5
BATCH = 2
DECODE_STEPS = 4
ARCH = "xlstm-350m"


def _reduced(get):
    return get(ARCH).reduced(d_model=128, vocab=256)


@pytest.fixture(scope="module")
def tree():
    ref_model = ref_build_model(_reduced(ref_get_config))
    tree = jax.tree_util.tree_map(np.asarray,
                                  ref_model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    return ref_model, jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)


@pytest.fixture(scope="module", params=[64, 256], ids=["L64", "L256"])
def pair(request, tree):
    ref_model, tree = tree
    prompt = request.param
    cfg = _reduced(get_config)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               (BATCH, prompt))
    follow = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                               (BATCH, DECODE_STEPS))
    return dict(ref=ref_model,
                ref_params=jax.tree_util.tree_map(jnp.asarray, tree),
                model=build_model(cfg),
                params=convert.decoder_params_from_numpy(tree, cfg),
                tokens=tokens, follow=follow, prompt=prompt)


def _ref_prefill(pair):
    return pair["ref"].prefill(
        pair["ref_params"],
        {"tokens": jnp.asarray(pair["tokens"], jnp.int32)},
        max_len=pair["prompt"] + DECODE_STEPS)


def _port_prefill(pair):
    with torch.inference_mode():
        return pair["model"].prefill(
            pair["params"], {"tokens": torch.as_tensor(pair["tokens"])},
            max_len=pair["prompt"] + DECODE_STEPS)


def test_prefill_logits_and_every_cache_leaf_match(pair):
    ref_logits, ref_cache = _ref_prefill(pair)
    logits, cache = _port_prefill(pair)
    assert logits.shape == (BATCH, 256)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=ATOL)
    assert cache["pos"] == int(ref_cache["pos"]) == pair["prompt"]
    ref_groups = jax.tree_util.tree_map(np.asarray, ref_cache["groups"])
    checked = 0
    for g, group in enumerate(cache["groups"]):
        assert sorted(group) == sorted(ref_groups)
        for key, block in group.items():
            assert sorted(block) == sorted(ref_groups[key])
            for leaf, port in block.items():
                want = ref_groups[key][leaf][g]
                rtol = (SLSTM_SUM_RTOL if key.endswith("slstm")
                        and leaf in ("c", "n") else 1e-7)
                assert port.dtype == torch.float32
                np.testing.assert_allclose(port.numpy(), want, atol=ATOL,
                                           rtol=rtol,
                                           err_msg=f"{key}/{leaf}")
                checked += 1
    # conv, c, n, m per mLSTM block; conv, h, c, n, m for the sLSTM block
    assert checked == 7 * 4 + 5


def test_decode_steps_match(pair):
    _, ref_cache = _ref_prefill(pair)
    _, cache = _port_prefill(pair)
    for t in range(DECODE_STEPS):
        tok = pair["follow"][:, t]
        ref_logits, ref_cache = pair["ref"].decode_step(
            pair["ref_params"], jnp.asarray(tok, jnp.int32), ref_cache)
        with torch.inference_mode():
            logits, cache = pair["model"].decode_step(
                pair["params"], torch.as_tensor(tok), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=ATOL, err_msg=f"step {t}")
    assert cache["pos"] == pair["prompt"] + DECODE_STEPS


def test_generate_greedy_tokens_identical(pair):
    steps = DECODE_STEPS
    ref_out = RefServingEngine(pair["ref"], pair["ref_params"]).generate(
        {"tokens": jnp.asarray(pair["tokens"], jnp.int32)}, steps)
    engine = ServingEngine(pair["model"], pair["params"], device="cpu")
    out = engine.generate({"tokens": pair["tokens"]}, steps)
    assert out.tokens.shape == (BATCH, pair["prompt"] + steps)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(ref_out.tokens))
    assert out.prefill_seconds > 0 and out.decode_seconds > 0


def test_decode_matches_teacher_forcing(tree):
    """prefill + decode_step logits == full-sequence forward logits
    (tests/test_models.py::test_decode_matches_teacher_forcing)."""
    cfg = _reduced(get_config)
    model = build_model(cfg)
    params = convert.decoder_params_from_numpy(tree[1], cfg)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (BATCH, 44)))
    with torch.inference_mode():
        full, _ = model.forward(params, {"tokens": tokens})
        logits, cache = model.prefill(params, {"tokens": tokens[:, :40]},
                                      max_len=tokens.shape[1])
        np.testing.assert_allclose(logits.numpy(), full[:, 39].numpy(),
                                   atol=ATOL)
        for t in range(40, tokens.shape[1]):
            logits, cache = model.decode_step(params, tokens[:, t], cache)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       atol=ATOL)


def test_init_keeps_reference_tree_shapes_and_constants():
    cfg = _reduced(get_config)
    ref_shapes = jax.eval_shape(ref_build_model(_reduced(ref_get_config))
                                .init, jax.random.PRNGKey(0))
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(ref_shapes)[0]
    assert len(jax.tree_util.tree_leaves(params)) == len(flat)
    assert "unembed" not in params                 # tied embeddings
    for path, leaf in flat:
        t = params
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    groups = params["stack"]["groups"]
    h = cfg.ssm_num_heads
    for i in range(7):
        m = groups[f"b{i}_mlstm"]
        assert m["w_gates"].dtype == m["gate_bias"].dtype == torch.float32
        assert not m["gate_bias"][0, :h].any()
        assert bool((m["gate_bias"][0, h:] == 3.0).all())
        assert not m["norm"].any() and not m["norm_out"].any()
        assert not m["conv"]["b"].any()
        std = float(m["wq"].std()) * np.sqrt(cfg.ssm_expand * cfg.d_model)
        assert abs(std - 1.0) < 0.1
    s = groups["b7_slstm"]
    d = cfg.d_model
    bias = s["gate_bias"][0]
    assert not bias[:2 * d].any() and not bias[3 * d:].any()
    assert bool((bias[2 * d:3 * d] == 3.0).all())       # forget gate
    ph = d // cfg.num_heads
    assert abs(float(s["r_gates"].std()) * np.sqrt(ph) - 1.0) < 0.1
    assert not params["final_norm"].any()


def test_init_cache_matches_reference():
    cfg = _reduced(get_config)
    want = ref_build_model(_reduced(ref_get_config)).init_cache(3, 40)
    got = build_model(cfg).init_cache(3, 40, device="cpu")
    assert got["pos"] == int(want["pos"]) == 0
    assert len(got["groups"]) == cfg.num_groups
    flat = jax.tree_util.tree_flatten_with_path(want["groups"])[0]
    for g, group in enumerate(got["groups"]):
        for path, leaf in flat:
            t = group
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == leaf.shape[1:], path
            np.testing.assert_array_equal(t.numpy(), np.asarray(leaf)[g])


def test_build_model_builds_full_xlstm():
    """The full config builds (no parameters drawn here): 3 groups of 7
    mLSTM + 1 sLSTM blocks, D = 512 mLSTM heads, tied embeddings."""
    cfg = get_config(ARCH)
    model = build_model(cfg)
    assert model.stack.num_groups == 3
    assert cfg.group_pattern.count("mlstm") == 7
    assert cfg.ssm_expand * cfg.d_model // cfg.ssm_num_heads == 512
    assert padded_vocab(cfg.vocab_size) == 50432
