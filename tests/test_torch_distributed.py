"""The port's distribution on 4 gloo CPU ranks against one device and
against the reference: sharded training of reduced qwen2 on a (2 data x
2 model) mesh, one step of mixtral (TP MoE, the LM head in chunks),
zamba2 (remat, residual replicated) and xlstm (dp-only cell), decode on
sharded caches (a batch of one on a (pod x data x model) mesh too),
decode with every weight multiplied where it lies (a batch of one on
the (2 x 2) mesh, and xlstm's batch on dp), the
expert-parallel MoE on a (1 x 4) mesh, the GQA head mapping, the ICU
LSTM's op on batch shards, and `launch.train --mesh host`.

The ranks run tests/torch_dist_cases.py in one spawn (each rank one
thread, the process group rendezvous through a file under the test's
temporary directory), under its own timeout; the reference's side runs
here (single-device losses) and in a subprocess with 4 forced host
devices and a mesh of `Auto` axes (its EP output: JAX 0.9's default
`Explicit` axes refuse the reference's sharding constraints).

Bars: the reference's (tests/test_distributed_parity.py: losses rtol and
atol 2e-4 over 5 steps, parameters 5e-3; tests/test_ep_moe.py: 2e-4 and
an aux above 0.5), and each family's single-device bars
(tests/test_torch_backward.py: loss 1e-5, every gradient 1e-3 of its
largest entry).
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import MarkovTokenDataset as RefMarkov
from repro.models import build_model as ref_build_model
from repro.training import optimizer as ref_opt
from repro.training import train_loop as ref_loop

import torch_dist_cases

WORLD = 4
# a guard against a hung rank, not a speed bar: the ranks take ~75 s
# alone and several times that beside a full parallel test run
SPAWN_TIMEOUT_S = 600
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REF_EP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig, MOE
from repro.models import blocks
from repro.sharding import policy

d = dict(np.load(sys.argv[1]))
cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=64,
                  num_heads=2, num_kv_heads=2, head_dim=32, d_ff=64,
                  vocab_size=64, group_pattern=(MOE,), num_experts=2,
                  num_experts_per_tok=2, moe_capacity_factor=4.0,
                  dtype="float32", moe_ep_shards=2)
p = {"moe_norm": jnp.asarray(d["moe_norm"]),
     "router": jnp.asarray(d["router"]),
     "experts": {k: jnp.asarray(d[k])
                 for k in ("ep_gate", "ep_up", "ep_down")}}
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
with mesh, policy.activation_policy(mesh):
    y, aux = jax.jit(lambda p, x: blocks._moe_ffn(p, x, cfg))(
        p, jnp.asarray(d["x"]))
np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
print("REF_EP_OK")
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _reference_qwen(workdir):
    """The reference's reduced qwen2 and initial weights, written for the
    ranks; returns (model, weights)."""
    rcfg = ref_get_config("qwen2-1.5b").reduced(layers=2, d_model=128,
                                                vocab=512)
    ref = ref_build_model(rcfg)
    rparams = ref.init(jax.random.PRNGKey(0))
    np.savez(os.path.join(workdir, "qwen.npz"),
             **dict(_flat(jax.tree.map(np.asarray, rparams))))
    return ref, rparams


def _reference_losses(ref, rparams):
    """The reference's single-device 5-step losses (its jitted step)."""
    step = ref_loop.make_train_step(
        ref, ref_opt.AdamWConfig(total_steps=torch_dist_cases.QWEN_STEPS,
                                 warmup_steps=1), jit=True)
    p, o, losses = rparams, ref_opt.init(rparams), []
    for b, _ in zip(RefMarkov(vocab_size=512, seq_len=32,
                              batch_size=8).batches(),
                    range(torch_dist_cases.QWEN_STEPS)):
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
    return losses


def _ep_inputs(workdir):
    """EP-major weights (2 experts x 2 shards, d 64, f 64) and (2, 16, 64)
    inputs, drawn with numpy."""
    rng = np.random.default_rng(0)
    e, r, d, f = 2, 2, 64, 64
    arrays = {"moe_norm": 0.1 * rng.standard_normal(d),
              "router": rng.standard_normal((d, e)) / 8,
              "ep_gate": rng.standard_normal((e * r, d, f // r)) / 8,
              "ep_up": rng.standard_normal((e * r, d, f // r)) / 8,
              "ep_down": rng.standard_normal((e * r, f // r, d)) / 8,
              "x": rng.standard_normal((2, 16, d))}
    path = os.path.join(workdir, "ep.npz")
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on 4 gloo ranks (one spawn), with the reference's
    losses and EP output beside them."""
    workdir = str(tmp_path_factory.mktemp("torch_dist"))
    ep_in = _ep_inputs(workdir)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    ref_ep = subprocess.Popen(
        [sys.executable, "-c", REF_EP, ep_in,
         os.path.join(workdir, "ref_ep.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ref, rparams = _reference_qwen(workdir)
        ctx = mp.start_processes(torch_dist_cases.run,
                                 args=(WORLD, workdir), nprocs=WORLD,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        ref_losses = _reference_losses(ref, rparams)
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail(f"the {WORLD} ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
        out, err = ref_ep.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if ref_ep.poll() is None:
            ref_ep.kill()
    assert "REF_EP_OK" in out, err[-3000:]
    with open(os.path.join(workdir, "results.json")) as f:
        results = json.load(f)
    return {"results": results, "ref_losses": ref_losses,
            "ref_ep": dict(np.load(os.path.join(workdir, "ref_ep.npz")))}


def _case(ranks, name):
    res = ranks["results"][name]
    assert "error" not in res, res.get("error")
    return res


def test_sharded_training_matches_single_device_and_reference(ranks):
    """Reduced qwen2, 5 AdamW steps on the (2 x 2) mesh: losses within
    rtol/atol 2e-4 of the port's single-device run and of the
    reference's, parameters within 5e-3."""
    res = _case(ranks, "qwen")
    np.testing.assert_allclose(res["sharded"], res["single"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(res["sharded"], ranks["ref_losses"],
                               rtol=2e-4, atol=2e-4)
    assert res["param_max_abs"] < 5e-3, res["param_max_abs"]
    assert res["sharded"][-1] < res["sharded"][0]


@pytest.mark.parametrize("arch", torch_dist_cases.ONE_STEP_ARCHS)
def test_sharded_loss_and_grads_match_single_device(ranks, arch):
    """One loss and every gradient on the (2 x 2) mesh against one
    device: loss within 1e-5, each gradient within 1e-3 of its largest
    entry. mixtral's experts run in the TP dispatch region of
    `_sharded_moe` (its train_4k and prefill_32k path), never in the
    decode step's region."""
    res = _case(ranks, f"one_step/{arch}")
    moe = arch.startswith("mixtral")
    assert res["moe_regions"]["where_they_lie"] == 0, res["moe_regions"]
    assert (res["moe_regions"]["tp"] > 0) == moe, res["moe_regions"]
    assert abs(res["loss_sharded"] - res["loss_single"]) <= 1e-5, res
    assert res["nonzero"]
    bad = {k: v for k, v in res["grad_rel"].items() if not v <= 1e-3}
    assert not bad, bad
    want = "seq" if arch.startswith("mixtral") else "replicated"
    assert res["residual"] == want


@pytest.mark.parametrize("window", torch_dist_cases.ROWS_SPLIT_WINDOWS)
def test_attention_rows_split_over_model_match_single_device(ranks, window):
    """Reduced qwen2 with 3 heads on the (2 x 2) mesh: the heads do not
    divide "model", so each model rank attends its half of the query
    rows (rank 0's from offset 0); loss within 1e-5 and each gradient
    within 1e-3 of its largest entry, as the other archs' step."""
    res = _case(ranks, f"rows_split/{window}")
    assert res["rows_split"] > 0 and res["offsets"] == [0], res
    assert abs(res["loss_sharded"] - res["loss_single"]) <= 1e-5, res
    assert res["nonzero"]
    bad = {k: v for k, v in res["grad_rel"].items() if not v <= 1e-3}
    assert not bad, bad


def test_sharded_encdec_step_matches_single_device(ranks):
    """The encoder-decoder's loss and every gradient on the (2 x 2) mesh
    with one head per model rank (the layout of seamless-m4t-large-v2 on
    16 x 16) against one device, at the bars of the other archs' step."""
    res = _case(ranks, "encdec")
    assert abs(res["loss_sharded"] - res["loss_single"]) <= 1e-5, res
    assert res["nonzero"]
    bad = {k: v for k, v in res["grad_rel"].items() if not v <= 1e-3}
    assert not bad, bad
    assert res["residual"] == "seq"


@pytest.mark.parametrize("arch,kv,mesh", torch_dist_cases.DECODE_CASES,
                         ids=["-".join(c) for c in
                              torch_dist_cases.DECODE_CASES])
def test_sharded_decode_matches_single_device(ranks, arch, kv, mesh):
    """Decode steps on DTensor parameters and a cache placed by
    `cache_specs`: kv heads on model (2 x 2), the slots on model (1 x 4,
    the flash-decode reduction) or, for a batch of one, on ("pod",
    "data") (2 x 2 x 1: on the placement mesh, one "data" dim of the 4
    ranks pod-major, the slot offset and the reduction over it), native
    and int8; logits within 1e-4 (tests/llm_parity.py's float32 bar)."""
    res = _case(ranks, f"decode/{arch}/{kv}/{mesh}")
    assert res["max_abs"] < 1e-4, res
    want = {"2x2": ("Shard(dim=1)", 1), "1x4": ("Shard(dim=2)", 1),
            "2x2x1": ("Shard(dim=2)", 1)}[mesh]
    assert res["cache_placements"].count(want[0]) == want[1], \
        res["cache_placements"]
    if mesh == "2x2x1":
        assert res["cache_mesh"] == "{'data': 4, 'model': 1}", res
        assert res["cache_placements"] == "(Shard(dim=2), Replicate())"


@pytest.mark.parametrize("arch,batch", torch_dist_cases.FSDP_DECODE,
                         ids=[f"{a}-b{b}" for a, b in
                              torch_dist_cases.FSDP_DECODE])
def test_decode_multiplies_weights_where_they_lie(ranks, arch, batch):
    """Decode steps on the (2 x 2) mesh with each FSDP weight multiplied
    where it lies (`policy.local_einsum`, the experts' and the mamba
    mixer's regions, the vocab-parallel lookup, the mLSTM step on C's
    shards): logits within 1e-4 of one device over DECODE_STEPS steps;
    at batch 1 (the token held whole by both dp ranks) a step's
    all-gathers, under CommDebugMode, carry fewer bytes than one layer's
    local weight shard, so no weight is gathered (the parent gathered
    each weight over dp: 1.9-3.6x a layer's shard)."""
    res = _case(ranks, f"decode_fsdp/{arch}/{batch}")
    assert res["max_abs"] < 1e-4, res
    if batch == 1:
        assert res["gather_bytes"] < res["layer_bytes"], res


def test_ep_moe_matches_tp_path_and_reference(ranks):
    """Expert-parallel MoE (2 experts x 2 shards, so both all-to-alls and
    the r-group sum run) against the TP path on one device and the
    reference's EP output, max abs 2e-4; the aux finite and above 0.5;
    under grad it raises."""
    res = _case(ranks, "ep")
    assert res["err_tp"] < 2e-4, res["err_tp"]
    ref = ranks["ref_ep"]
    err = float(np.abs(np.asarray(res["y_ep"]) - ref["y"]).max())
    assert err < 2e-4, err
    assert np.isfinite(res["aux_ep"]) and res["aux_ep"] > 0.5
    np.testing.assert_allclose(res["aux_ep"], float(ref["aux"]), rtol=1e-5)
    assert res["raises_under_grad"]


def test_gqa_ranks_take_the_kv_heads_their_q_heads_map_to(ranks):
    """12 q heads, 2 kv heads, heads on model 4: 3 local q heads of group
    6 per rank; output and gradients equal one device's."""
    res = _case(ranks, "gqa")
    assert "Shard(dim=1)" in res["placements"]
    assert res["y_err"] < 1e-5 and res["grad_err"] < 1e-5, res


def test_gqa_split_that_cannot_map_raises(ranks):
    """12 q heads over 3 kv heads on model 4 (3 local q heads of group 4)
    raises instead of computing silently wrong."""
    assert _case(ranks, "gqa")["unmappable_raises"]


def test_lstm_layer_on_batch_shards_matches_one_device(ranks):
    """The ICU LSTM's op with the batch on dp: outputs and gradients
    (the weights' summed over the shards) within 1e-5 of one device."""
    res = _case(ranks, "lstm")
    assert "Shard(dim=0)" in res["h_placements"]
    assert res["out_err"] < 1e-5 and res["grad_err"] < 1e-5, res


def test_train_launcher_mesh_host_matches_one_device(ranks):
    """`launch.train.run(mesh="host")` over the 4 ranks (a 4 x 1 mesh)
    gives the single-device losses."""
    res = _case(ranks, "launcher")
    assert res["mesh"] == "{'data': 4, 'model': 1}"
    np.testing.assert_allclose(res["meshed"], res["single"], rtol=2e-4,
                               atol=2e-4)
