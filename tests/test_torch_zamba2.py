"""The port's zamba2 serving path on the CPU against the JAX reference, at
a reduced size (`reduced(d_model=128, vocab=256)`: one group of five
Mamba2 blocks and one shared attention block, float32, chunk 64).

Parameters come from the reference's `DecoderModel.init`, with seeded
numpy noise added to every leaf so that no leaf sits at its constant init
(lora_b, norms, dt_bias, a_log), and cross over through
`repro_torch.convert`. Tolerance atol 1e-4 (float32 sums in another order
through six blocks); greedy tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import pipeline as ref_pipeline
from repro.models import build_model as ref_build_model
from repro.serving.engine import ServingEngine as RefServingEngine
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data import pipeline
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine

ATOL = 1e-4
PROMPT = (2, 128)
DECODE_STEPS = 4
ARCH = "zamba2-2.7b"


def _reduced(get):
    return get(ARCH).reduced(d_model=128, vocab=256)


@pytest.fixture(scope="module")
def pair():
    ref_model = ref_build_model(_reduced(ref_get_config))
    tree = jax.tree_util.tree_map(np.asarray,
                                  ref_model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)
    cfg = _reduced(get_config)
    params = convert.decoder_params_from_numpy(tree, cfg)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, PROMPT + (1,))[..., 0]
    follow = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (PROMPT[0], DECODE_STEPS))
    return dict(ref=ref_model, tree=tree,
                ref_params=jax.tree_util.tree_map(jnp.asarray, tree),
                model=build_model(cfg), params=params, tokens=tokens,
                follow=follow)


def _ref_prefill(pair):
    return pair["ref"].prefill(
        pair["ref_params"],
        {"tokens": jnp.asarray(pair["tokens"], jnp.int32)},
        max_len=PROMPT[1] + DECODE_STEPS)


def _port_prefill(pair):
    with torch.inference_mode():
        return pair["model"].prefill(
            pair["params"], {"tokens": torch.as_tensor(pair["tokens"])},
            max_len=PROMPT[1] + DECODE_STEPS)


def test_prefill_logits_and_every_cache_leaf_match(pair):
    ref_logits, ref_cache = _ref_prefill(pair)
    logits, cache = _port_prefill(pair)
    assert logits.shape == (PROMPT[0], 256)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=ATOL)
    assert cache["pos"] == int(ref_cache["pos"])
    ref_groups = jax.tree_util.tree_map(np.asarray, ref_cache["groups"])
    checked = 0
    for g, group in enumerate(cache["groups"]):
        assert sorted(group) == sorted(ref_groups)
        for key, block in group.items():
            flat = jax.tree_util.tree_flatten_with_path(ref_groups[key])[0]
            for path, leaf in flat:
                port = block
                for p in path:
                    port = port[p.key]
                assert port.dtype == torch.float32
                np.testing.assert_allclose(port.numpy(), leaf[g], atol=ATOL,
                                           err_msg=f"{key}{path}")
                checked += 1
    assert checked == 5 * 2 + 2       # conv + ssm per Mamba2, k + v


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
    assert cache["pos"] == PROMPT[1] + DECODE_STEPS


def test_decode_matches_teacher_forcing(pair):
    """prefill + decode_step logits == full-sequence forward logits
    (tests/test_models.py::test_decode_matches_teacher_forcing)."""
    model, params = pair["model"], pair["params"]
    tokens = torch.as_tensor(np.concatenate(
        [pair["tokens"][:, :40], pair["follow"]], axis=1))
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


def test_generate_greedy_tokens_identical(pair):
    steps = 6
    ref_out = RefServingEngine(pair["ref"], pair["ref_params"]).generate(
        {"tokens": jnp.asarray(pair["tokens"], jnp.int32)}, steps)
    engine = ServingEngine(pair["model"], pair["params"], device="cpu")
    out = engine.generate({"tokens": pair["tokens"]}, steps)
    assert out.tokens.shape == (PROMPT[0], PROMPT[1] + steps)
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(ref_out.tokens))
    assert out.prefill_seconds > 0 and out.decode_seconds > 0


def test_init_keeps_reference_tree_shapes_and_constants():
    cfg = _reduced(get_config)
    ref_shapes = jax.eval_shape(ref_build_model(_reduced(ref_get_config))
                                .init, jax.random.PRNGKey(0))
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(ref_shapes)[0]
    n_port = len(jax.tree_util.tree_leaves(params))
    assert n_port == len(flat)
    for path, leaf in flat:
        t = params
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    groups = params["stack"]["groups"]
    for i in range(5):
        m = groups[f"b{i}_mamba"]
        assert not m["a_log"].any() and not m["dt_bias"].any()
        assert bool((m["d_skip"] == 1).all())
        assert not m["norm"].any() and not m["norm_gate"].any()
        assert not m["conv"]["b"].any()
        std = float(m["w_in"].std()) * np.sqrt(cfg.d_model)
        assert abs(std - 1.0) < 0.1
    assert not groups["b5_shared_attn"]["lora_b"].any()
    assert not params["final_norm"].any()


@pytest.mark.parametrize("arch", [ARCH, "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_make_batch_matches_reference(arch):
    """Tokens, and the vision / audio stubs where the arch has them."""
    want = ref_pipeline.make_batch(ref_get_config(arch).reduced(), 3, 17,
                                   seed=4)
    got = pipeline.make_batch(get_config(arch).reduced(), 3, 17, seed=4)
    assert sorted(got) == sorted(want)
    assert got["tokens"].dtype == torch.int64
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value))


def test_init_cache_matches_reference_shapes():
    cfg = _reduced(get_config)
    want = ref_build_model(_reduced(ref_get_config)).init_cache(3, 40)
    got = build_model(cfg).init_cache(3, 40, device="cpu")
    assert got["pos"] == int(want["pos"]) == 0
    assert len(got["groups"]) == cfg.num_groups
    for g, group in enumerate(got["groups"]):
        flat = jax.tree_util.tree_flatten_with_path(want["groups"])[0]
        for path, leaf in flat:
            t = group
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == leaf.shape[1:], path
            assert not t.any()


def test_int8_kv_cache_raises(pair):
    cfg = dataclasses.replace(_reduced(get_config), kv_cache_dtype="int8")
    model = build_model(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.prefill(pair["params"],
                      {"tokens": torch.as_tensor(pair["tokens"][:, :8])})


SERVED = (ARCH, "xlstm-350m")     # the archs the port builds


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES if n not in SERVED])
def test_build_model_refuses_unported_archs(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_config(name))


@pytest.mark.parametrize("entry", ["engine", "init"])
def test_entry_points_raise_without_cuda(entry, monkeypatch):
    """With no CUDA device and no explicit CPU request the entry points
    raise; they never drop quietly to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(_reduced(get_config))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "engine":
            ServingEngine(model)
        else:
            model.init()


def test_sampling_is_replayed_by_its_generator(pair):
    """Non-greedy decode draws from the torch.Generator it is given: the
    same seed gives the same tokens (torch cannot replay jax.random, so
    only greedy runs compare with the reference)."""
    engine = ServingEngine(pair["model"], pair["params"], device="cpu")
    runs = [engine.generate({"tokens": pair["tokens"][:, :16]}, 5,
                            greedy=False,
                            generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    torch.testing.assert_close(runs[0].tokens, runs[1].tokens, atol=0,
                               rtol=0)
    new = runs[0].tokens[:, 16:]
    assert new.shape == (PROMPT[0], 5)
    assert int(new.min()) >= 0 and int(new.max()) < 256
