"""The port's dry-run (repro_torch.launch.dryrun) against the reference's
machinery: the production meshes on a fake process group, one real case
(qwen2-1.5b decode_32k on the fake 256-rank mesh, nothing allocated), the
collective-bytes summing, and the tables the reference's sweep is made
of. The fake process group is global state, so the mesh and the case run
in a subprocess; the reference's own multi-device dry-run test does not
run under JAX 0.9's default mesh axes and is not needed here."""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import dryrun as ref_dryrun
from repro.utils import flops as ref_flops
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.sharding import policy

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

CODE = r"""
import json
import torch.distributed as dist
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
rec = dryrun.run_case("qwen2-1.5b", "decode_32k", verbose=False)
m1 = make_production_mesh(device="cpu")
dist.destroy_process_group()
dryrun.fake_process_group(512)
m2 = make_production_mesh(multi_pod=True, device="cpu")
try:
    make_production_mesh(device="cpu")
    wrong = False
except ValueError:
    wrong = True
print(json.dumps({"record": rec,
                  "meshes": [str(dict(zip(m.mesh_dim_names, m.shape)))
                             for m in (m1, m2)],
                  "wrong_world_raises": wrong}))
"""


@pytest.fixture(scope="module")
def case():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_mesh_shapes_in_subprocess(case):
    assert case["meshes"] == ["{'data': 16, 'model': 16}",
                              "{'pod': 2, 'data': 16, 'model': 16}"]
    assert case["wrong_world_raises"]


def _expected_argument_bytes():
    """Each rank's bytes of the decode case's parameters, token batch and
    cache, from the specs and the mesh sizes alone: a leaf's size divided
    by the mesh axes its spec splits it over."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sizes = {"data": 16, "model": 16}

    class Mesh:
        shape = sizes
        mesh_dim_names = tuple(sizes)

    shape = INPUT_SHAPES["decode_32k"]
    cfg = dryrun.variant_for_shape(get_config("qwen2-1.5b"), shape)
    model = build_model(cfg)
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 device="cpu")
        batch = dryrun.input_specs(cfg, shape)

    def local(tree, specs):
        if isinstance(tree, dict):
            return sum(local(v, specs[k]) for k, v in tree.items())
        if isinstance(tree, list):
            return sum(local(v, specs[i]) for i, v in enumerate(tree))
        if not hasattr(tree, "shape"):
            return 0
        split = math.prod(sizes[a] for e in specs if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        return tree.numel() * tree.element_size() // split

    return {"params": local(params, policy.param_specs(params, Mesh)),
            "batch": local(batch, policy.batch_specs(batch, Mesh)),
            "cache": local(cache, policy.cache_specs(cache, Mesh))}


def test_single_case_dryrun_subprocess(case):
    """qwen2-1.5b decode_32k on the fake 16 x 16 mesh: 256 devices,
    collectives recorded, each rank's argument bytes exactly the local
    shards', the analytic fields the reference's."""
    rec = case["record"]
    assert rec["devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["arch"] == "qwen2-1.5b" and rec["shape"] == "decode_32k"
    assert rec["step_kind"] == "decode" and rec["residual"] == "seq"
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["collectives"]["total_bytes"] == sum(
        rec["collectives"]["bytes_by_op"].values())
    assert rec["flops"] > 0
    mem = rec["memory"]
    want = _expected_argument_bytes()
    assert mem["argument_bytes_by_tree"] == want
    assert mem["argument_size_in_bytes"] == sum(want.values()) > 0
    # the step's own tensors, by MemTracker under the fake tensors
    peak = mem["activation_peak_bytes"]
    assert peak["Total"] == sum(v for k, v in peak.items() if k != "Total")
    assert peak["Total"] > 0, mem["activation_peak_note"]
    cfg = ref_dryrun.variant_for_shape(ref_get_config("qwen2-1.5b"),
                                       REF_SHAPES["decode_32k"])
    assert rec["param_count"] == ref_flops.param_count(cfg)
    assert rec["active_param_count"] == ref_flops.active_param_count(cfg)
    assert rec["param_bytes"] == ref_flops.param_bytes(cfg)
    assert rec["analytic_step_flops"] == ref_flops.step_flops(
        cfg, REF_SHAPES["decode_32k"])
    assert rec["model_flops_6nd"] == ref_flops.model_flops_6nd(
        cfg, REF_SHAPES["decode_32k"])
    assert rec["long_context_variant"] is False
    assert rec["microbatches"] == 1 and rec["moe_ep"] is False


def test_collective_bytes_sums_records():
    """The counterpart of the reference's HLO parser test: result bytes
    by op name, counts, the total."""
    got = dryrun.collective_bytes([("all-gather", 8 * 128 * 2),
                                   ("all-reduce", 64),
                                   ("all-to-all", 16), ("all-to-all", 16)])
    assert got["bytes_by_op"]["all-gather"] == 8 * 128 * 2
    assert got["bytes_by_op"]["all-reduce"] == 64
    assert got["bytes_by_op"]["all-to-all"] == 32
    assert got["count_by_op"]["all-to-all"] == 2
    assert got["total_bytes"] == 8 * 128 * 2 + 64 + 32
    assert tuple(got["bytes_by_op"]) == ref_dryrun.COLLECTIVE_OPS


@pytest.mark.parametrize("op,name", [
    ("_c10d_functional.all_gather_into_tensor.default", "all-gather"),
    ("_c10d_functional.reduce_scatter_tensor.default", "reduce-scatter"),
    ("_c10d_functional.all_reduce.default", "all-reduce"),
    ("_c10d_functional.all_to_all_single.default", "all-to-all"),
    ("c10d.allreduce_.default", "all-reduce"),
    ("c10d.alltoall_base_.default", "all-to-all"),
    ("_c10d_functional.wait_tensor.default", None),
    ("aten.mm.default", None)])
def test_collective_names(op, name):
    assert dryrun.collective_name(op) == name


def test_variant_for_shape_and_microbatches_match_reference():
    assert tuple(ARCH_NAMES) == tuple(REF_ARCH_NAMES)
    assert dryrun.TRAIN_MICROBATCHES == ref_dryrun.TRAIN_MICROBATCHES
    for arch in ARCH_NAMES:
        for name, shape in INPUT_SHAPES.items():
            got = dryrun.variant_for_shape(get_config(arch), shape)
            want = ref_dryrun.variant_for_shape(ref_get_config(arch),
                                                REF_SHAPES[name])
            assert got.long_context_window == want.long_context_window
            assert (got == get_config(arch)) == (want == ref_get_config(
                arch))


def test_input_specs_match_reference():
    """The stand-ins' shapes are the reference's (tokens int64 here)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for arch in ("qwen2-1.5b", "llama-3.2-vision-11b",
                 "seamless-m4t-large-v2"):
        for name, shape in INPUT_SHAPES.items():
            want = ref_dryrun.input_specs(ref_get_config(arch),
                                          REF_SHAPES[name])
            with FakeTensorMode():
                got = dryrun.input_specs(get_config(arch), shape)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert tuple(got[k].shape) == v.shape, (arch, name, k)
