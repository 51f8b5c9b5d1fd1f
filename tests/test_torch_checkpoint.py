"""The port's checkpointer and Markov dataset against the reference's
(tests/test_serving.py's test_checkpoint_roundtrip_and_errors and
test_markov_dataset_deterministic), and checkpoints crossing between the
two packages both ways, with bfloat16 leaves: the reference's bf16 leaves
are stored as numpy's raw `|V2` (through ml_dtypes) and the port reads
them as bf16 bits; the port stores bf16 as float32, which the reference's
restore casts to a bf16 template. Every value must come back bit-exact.
"""
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import MarkovTokenDataset as RefMarkov
from repro.models import build_model as ref_build_model
from repro_torch import convert
from repro_torch.checkpoint import checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import MarkovTokenDataset
from repro_torch.models import build_model
from repro_torch.training import optimizer


def _leaves(tree):
    return optimizer.tree_leaves(tree)


def test_checkpoint_roundtrip_and_errors():
    cfg = get_config("gemma-2b").reduced(layers=2, d_model=64, vocab=64)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    with tempfile.TemporaryDirectory() as d:
        checkpointer.save(d, 7, {"params": params})
        assert checkpointer.latest_step(d) == 7
        restored = checkpointer.restore(d, {"params": params})
        for a, b in zip(_leaves(restored), _leaves({"params": params})):
            assert a.dtype == b.dtype and torch.equal(a, b)
        # shape mismatch must raise
        bad = {"params": optimizer.tree_map(
            lambda a: torch.zeros(a.shape + (1,), dtype=a.dtype), params)}
        with pytest.raises(ValueError):
            checkpointer.restore(d, bad)
        # a leaf the checkpoint lacks must raise
        with pytest.raises(KeyError):
            checkpointer.restore(d, {"params": params,
                                     "extra": torch.zeros(2)})


def test_markov_dataset_deterministic():
    a = MarkovTokenDataset(64, 16, 4, seed=3)
    b = MarkovTokenDataset(64, 16, 4, seed=3)
    ba = next(iter(a.batches()))
    bb = next(iter(b.batches()))
    assert torch.equal(ba["tokens"], bb["tokens"])
    # tokens follow the bigram table
    tok = ba["tokens"].numpy()
    for row in tok:
        for t in range(1, len(row)):
            assert row[t] in a.table[row[t - 1]]


@pytest.mark.parametrize("seed", [0, 3])
def test_markov_batches_match_reference(seed):
    ref = RefMarkov(512, 32, 8, seed=seed)
    port = MarkovTokenDataset(512, 32, 8, seed=seed)
    np.testing.assert_array_equal(port.table, ref.table)
    for (pb, rb), _ in zip(zip(port.batches(), ref.batches()), range(3)):
        assert pb["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(pb["tokens"].numpy(),
                                      np.asarray(rb["tokens"]))
    assert port.entropy_floor == ref.entropy_floor


def _bf16_pair():
    """gemma-2b reduced, in bfloat16: the reference's params and the same
    values as the port's tree."""
    rcfg = dataclasses.replace(
        ref_get_config("gemma-2b").reduced(layers=2, d_model=64, vocab=64),
        dtype="bfloat16")
    rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(1))
    cfg = dataclasses.replace(
        get_config("gemma-2b").reduced(layers=2, d_model=64, vocab=64),
        dtype="bfloat16")
    params = convert.decoder_params_from_numpy(
        jax.tree.map(np.asarray, rparams), cfg)
    assert {a.dtype for a in _leaves(params)} == {torch.bfloat16}
    return rparams, params


def test_reference_checkpoint_restores_into_the_port():
    """Saved by the reference (bf16 leaves as |V2), restored by the port
    into a bf16 template and into a float32 one, bit for bit."""
    rparams, params = _bf16_pair()
    with tempfile.TemporaryDirectory() as d:
        fn = ref_ckpt.save(d, 3, {"params": rparams})
        with np.load(fn) as data:
            assert {data[k].dtype.str for k in data.files} == {"|V2"}
        back = checkpointer.restore(d, {"params": params})
        for a, b in zip(_leaves(back), _leaves({"params": params})):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        as_f32 = optimizer.tree_map(lambda t: t.float(), {"params": params})
        back32 = checkpointer.restore(d, as_f32)
        for a, b in zip(_leaves(back32), _leaves(as_f32)):
            assert a.dtype == torch.float32 and torch.equal(a, b)


def test_port_checkpoint_restores_into_the_reference():
    """Saved by the port, restored by the reference's own `restore` into
    its bf16 template, bit for bit, with the reference's leaf paths and
    latest.json."""
    rparams, params = _bf16_pair()
    with tempfile.TemporaryDirectory() as d:
        fn = checkpointer.save(d, 5, {"params": params})
        assert os.path.basename(fn) == "step_00000005.proc0.npz"
        ref_fn = os.path.join(d, "ref")
        ref_ckpt.save(ref_fn, 5, {"params": rparams})
        with np.load(fn) as mine, np.load(os.path.join(
                ref_fn, "step_00000005.proc0.npz")) as theirs:
            assert sorted(mine.files) == sorted(theirs.files)
        with open(os.path.join(d, "latest.json")) as f:
            assert json.load(f) == {"step": 5,
                                    "leaves": len(_leaves(params))}
        back = ref_ckpt.restore(d, {"params": rparams})
        for a, b in zip(jax.tree.leaves(back),
                        jax.tree.leaves({"params": rparams})):
            assert a.dtype == jnp.bfloat16
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))


def test_adamw_state_crosses_both_ways():
    """convert's AdamW state in both directions: the reference's state
    after one step becomes the port's and back, unchanged."""
    from repro.training import optimizer as ref_opt
    params = {"w": jnp.ones((3, 2)), "b": {"v": jnp.zeros(4)}}
    grads = {"w": jnp.full((3, 2), 0.3), "b": {"v": jnp.arange(4.0)}}
    _, state, _ = ref_opt.update(ref_opt.AdamWConfig(), grads,
                                 ref_opt.init(params), params)
    port = convert.adamw_state_from_numpy(
        np.asarray(state.step), jax.tree.map(np.asarray, state.m),
        jax.tree.map(np.asarray, state.v))
    assert port.step == 1
    step, m, v = convert.adamw_state_to_numpy(port)
    assert step == 1
    for a, b in zip(_leaves(m) + _leaves(v),
                    jax.tree.leaves(state.m) + jax.tree.leaves(state.v)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-350m"])
def test_adamw_state_of_scan_archs_crosses_both_ways(arch):
    """The reference's AdamW state after one step on reduced zamba2 and
    xlstm (the leaves the scans' backward kernels train: a_log, dt_bias,
    d_skip, the mLSTM's projections and gates) becomes the port's, in the
    port model's own leaf paths and shapes, and comes back unchanged."""
    from repro.training import optimizer as ref_opt
    rcfg = ref_get_config(arch).reduced(layers=2, d_model=128, vocab=256)
    rparams = ref_build_model(rcfg).init(jax.random.PRNGKey(2))
    keys = iter(jax.random.split(jax.random.PRNGKey(3),
                                 len(jax.tree.leaves(rparams))))
    grads = jax.tree.map(
        lambda a: jax.random.normal(next(keys), a.shape, jnp.float32),
        rparams)
    _, state, _ = ref_opt.update(ref_opt.AdamWConfig(), grads,
                                 ref_opt.init(rparams), rparams)
    port = convert.adamw_state_from_numpy(
        np.asarray(state.step), jax.tree.map(np.asarray, state.m),
        jax.tree.map(np.asarray, state.v))
    params = convert.decoder_params_from_numpy(
        jax.tree.map(np.asarray, rparams),
        get_config(arch).reduced(layers=2, d_model=128, vocab=256))
    want = [(name, t.shape) for name, t in optimizer.tree_items(params)]
    for moments in (port.m, port.v):
        assert [(name, t.shape)
                for name, t in optimizer.tree_items(moments)] == want
    step, m, v = convert.adamw_state_to_numpy(port)
    assert step == 1
    for a, b in zip(_leaves(m) + _leaves(v),
                    jax.tree.leaves(state.m) + jax.tree.leaves(state.v)):
        np.testing.assert_array_equal(a, np.asarray(b))
