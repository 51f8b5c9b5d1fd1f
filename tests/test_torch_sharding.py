"""The port's sharding policy against the reference's, with no devices: a
mesh of shape only (tests/test_sharding.py's FakeMesh). The parameter
specs of every arch at full size on both production meshes, leaf for
leaf; the cache and batch specs on the reference's own cases; `constrain`
without a policy; `to_placements`."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import dryrun as ref_dryrun
from repro.models import build_model as ref_build_model
from repro.sharding import policy as ref_policy
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.sharding import policy


class FakeMesh:
    """Just enough of a mesh for the spec rules (no devices)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.mesh_dim_names = tuple(shape)


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = [MESH1, MESH2]
MESH_IDS = ["16x16", "2x16x16"]


def _ref_specs(tree):
    """{path of keys: tuple(PartitionSpec)} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(spec) for path, spec in flat}


def _port_specs(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, prefix + (i,)))
        return out
    return {prefix: tree}


def _meta_tree(ref_tree):
    """A torch tree of meta tensors with the reference tree's shapes."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        ref_tree)


@pytest.fixture(scope="module")
def port_params():
    """Every arch's full-size parameter tree as fake tensors, drawn once."""
    return {arch: build_model(get_config(arch)).param_specs()
            for arch in ARCH_NAMES}


def test_arch_names_match():
    assert tuple(ARCH_NAMES) == tuple(REF_ARCH_NAMES)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference_for_full_configs(arch, mesh,
                                                      port_params):
    """The port's spec of every full-size parameter leaf is the
    reference's `policy.param_specs(model.param_specs(), mesh)`."""
    want = _ref_specs(ref_policy.param_specs(
        ref_build_model(ref_get_config(arch)).param_specs(), mesh))
    got = _port_specs(policy.param_specs(port_params[arch], mesh))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert got[path] == spec, (path, got[path], spec)


def test_qkv_rules():
    specs = policy.param_specs(
        {"wq": torch.empty((4096, 32, 128), device="meta"),
         "wk": torch.empty((4096, 12, 128), device="meta")}, MESH1)
    assert specs["wq"] == ("data", "model", None)
    # 12 heads don't divide 16 -> fall back to head_dim
    assert specs["wk"] == ("data", None, "model")


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_cache_specs_long_context_batch1(mesh):
    """Batch-1 long decode: KV slots go context-parallel on the dp axes
    (the reference's own case), on both meshes."""
    cache = {"groups": {"b0": {"attn": {
        "k": jax.ShapeDtypeStruct((46, 1, 16, 524288, 128),
                                  jax.numpy.bfloat16)}}}}
    want = _ref_specs(ref_policy.cache_specs(cache, mesh))
    got = _port_specs(policy.cache_specs(_meta_tree(cache), mesh))
    assert got == want
    s = got[("groups", "b0", "attn", "k")]
    assert s[0] is None and s[2] == "model"
    assert s[3] == ("data" if mesh is MESH1 else ("pod", "data"))


CACHE_CASES = [("qwen2-1.5b", "decode_32k"), ("qwen2-1.5b", "long_500k"),
               ("zamba2-2.7b", "decode_32k"), ("xlstm-350m", "long_500k"),
               ("mixtral-8x7b", "decode_32k"), ("gemma2-27b", "long_500k")]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch,shape", CACHE_CASES,
                         ids=[f"{a}-{s}" for a, s in CACHE_CASES])
def test_cache_specs_match_reference(arch, shape, mesh):
    """The decode cache of a dry-run case: the reference's stacked tree
    and the port's own (one dict a group, its leaves unstacked) take the
    reference's specs (the port's without the leading group axis)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    s = REF_SHAPES[shape]
    ref_cfg = ref_dryrun.variant_for_shape(ref_get_config(arch), s)
    ref_cache = jax.eval_shape(lambda: ref_build_model(ref_cfg).init_cache(
        s.global_batch, s.seq_len))
    want = _ref_specs(ref_policy.cache_specs(ref_cache, mesh))
    got = _port_specs(policy.cache_specs(_meta_tree(ref_cache), mesh))
    assert got == want
    cfg = dryrun.variant_for_shape(get_config(arch), s)
    with FakeTensorMode():
        port_cache = build_model(cfg).init_cache(s.global_batch, s.seq_len,
                                                 device="cpu")
    own = _port_specs(policy.cache_specs(port_cache, mesh))
    assert own.pop(("pos",)) == port_cache["pos"]
    assert cfg.num_groups == len(port_cache["groups"])
    for path, spec in own.items():
        assert path[:1] == ("groups",) and isinstance(path[1], int)
        assert spec == want[path[:1] + path[2:]][1:], (path, spec)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "llama-3.2-vision-11b",
                                  "seamless-m4t-large-v2"])
def test_batch_specs_match_reference(arch, mesh):
    """Every input of every shape (long_500k's batch of 1 stays
    replicated)."""
    cfg = ref_get_config(arch)
    for s in REF_SHAPES.values():
        batch = ref_dryrun.input_specs(cfg, s)
        want = _ref_specs(ref_policy.batch_specs(batch, mesh))
        got = _port_specs(policy.batch_specs(_meta_tree(batch), mesh))
        assert got == want, (s.name, got, want)


def test_constrain_noop_without_policy():
    x = torch.ones((4, 4))
    assert policy.constrain(x, (policy.DP, None)) is x
    assert policy.constrain_residual(x) is x
    assert policy.current_mesh() is None


def test_to_placements_splits_a_dim_over_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard
    assert policy.to_placements((("pod", "data"), None, "model"), MESH2) \
        == (Shard(0), Shard(0), Shard(2))
    assert policy.to_placements((None, "model"), MESH1) \
        == (Replicate(), Shard(1))
    assert policy.to_placements((), MESH1) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="shards two dims"):
        policy.to_placements(("model", "model"), MESH1)


def test_activation_policy_resolves_like_the_reference():
    """Dims that do not divide are dropped, as the reference's
    `constrain` drops them."""
    pol = policy.activation_policy(MESH2)
    assert pol.dp == ("pod", "data") and pol.dp_size == 32
    assert policy.resolve((64, 48, 7), (policy.DP, policy.TP, policy.TP),
                          pol) == (("pod", "data"), "model", None)
    assert policy.resolve((16, 1), (policy.DP, policy.TP), pol) \
        == (None, None)
    with pytest.raises(ValueError, match="residual"):
        policy.activation_policy(MESH1, residual="ring")


def test_residual_layout_by_family():
    assert policy.residual_for(get_config("zamba2-2.7b")) == "replicated"
    assert policy.residual_for(get_config("xlstm-350m")) == "replicated"
    assert policy.residual_for(get_config("qwen2-1.5b")) == "seq"
    assert np.all([policy.residual_for(get_config(a)) in ("seq",
                                                          "replicated")
                   for a in ARCH_NAMES])
