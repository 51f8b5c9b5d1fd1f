"""The port's dry-run (repro_torch.launch.dryrun) against the reference's
machinery: the production meshes on a fake process group, one real case
(qwen2-1.5b decode_32k on the fake 256-rank mesh, nothing allocated), the
collective-bytes summing, and the tables the reference's sweep is made
of. The fake process group is global state, so the mesh and the case run
in a subprocess.

The reference's own dry-run compiles here when its production mesh has
`Auto` axes (JAX 0.9's `jax.make_mesh` makes `Explicit` ones, which its
`with_sharding_constraint` refuses): tools/reference_dryrun.py rebinds
the mesh function in a process of its own and reads the compiled HLO
like for like with the port's records (dot FLOPs and collective bytes
scaled by loop trip counts). The oracle tests below hold the port's
records to it, on a real case and on reduced ones of the 2 x 16 x 16
mesh."""
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
TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")

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


# ------------------------------------------------- scaled against full
# one reduced-depth config of each family at full width: 4 groups (in
# each stack of the encoder-decoder; the longer patterns cut to one block
# of each kind, so that the full traces stay short), a train step of 3
# microbatches and prefill / decode of 8 tokens, traced in full and cut
# to 2 and 3 groups, 2 microbatches and 4 of the scans' 8 steps
FAMILIES = {"dense": "gemma2-27b", "moe": "mixtral-8x7b",
            "hybrid": "zamba2-2.7b", "ssm": "xlstm-350m",
            "vlm": "llama-3.2-vision-11b", "audio": "seamless-m4t-large-v2"}
FAMILY_CODE = r"""
import dataclasses, json, sys
from repro_torch.configs import base, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
arch = sys.argv[1]
if arch == "seamless-one-head-a-rank":
    # the train step that raised in DTensor's backward (the view of a
    # projection's gradient, a whole-microbatch partial sum):
    # seamless-m4t-large-v2 cut to one group a stack, one head a "model"
    # rank, 2 microbatches of 32
    cfg = dryrun.at_depth(get_config("seamless-m4t-large-v2"), 1)
    rec = dryrun.run_case(arch, "train", cfg=cfg, microbatches=2,
                          shape=ShapeConfig("train", 16, 64, "train"),
                          full=True, verbose=False)
    print(json.dumps(rec))
    sys.exit()
cfg = get_config(arch)
pattern = {"zamba2-2.7b": (base.MAMBA, base.SHARED_ATTN),
           "xlstm-350m": (base.MLSTM, base.SLSTM),
           "llama-3.2-vision-11b": (base.ATTN, base.CROSS)}.get(arch)
if pattern:
    cfg = dataclasses.replace(cfg, group_pattern=pattern, num_groups=0,
                              num_layers=len(pattern))
cfg = dryrun.at_depth(cfg, 4)
mb = 3
out = {}
for shape, m in ((ShapeConfig("train", 8, 16 * mb, "train"), mb),
                 (ShapeConfig("prefill", 8, 16, "prefill"), 1),
                 (ShapeConfig("decode", 8, 16, "decode"), 1)):
    out[shape.kind] = [dryrun.run_case(arch, shape.name, cfg=cfg,
                                       shape=shape, microbatches=m,
                                       verbose=False, **kw)
                       for kw in ({"full": True}, {})]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def families():
    """{family: {kind: (full record, scaled record)}} and the seamless
    reproduction's record, each family in a process of its own (the fake
    process group is global state), all at once."""
    env = dict(os.environ, PYTHONPATH=SRC)
    runs = dict(FAMILIES, seamless="seamless-one-head-a-rank")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", FAMILY_CODE, arch], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for name, arch in runs.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        assert proc.returncode == 0, (name, stderr[-3000:])
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", FAMILIES)
def test_scaled_trace_records_what_the_full_trace_records(families, family,
                                                          kind):
    """The cut trace's record against the full one's: FLOPs, collective
    bytes and counts by op and argument bytes exactly; the activation
    peak within 1% (the module's rule: a full trace's own peak moves by
    ~0.2% with what DTensor's and FakeTensor's caches already hold, which
    the traces before it in the process decide)."""
    full, scaled = families[family][kind]
    assert full["traced"] is None
    traced = scaled["traced"]
    assert traced["groups"] == [2, 3]
    assert traced["microbatches"] == (2 if kind == "train" else None)
    walks = family in ("hybrid", "ssm") and kind != "decode"
    assert traced["scan_steps"] == (4 if walks else None)
    assert scaled["flops"] == full["flops"] > 0
    assert scaled["collectives"] == full["collectives"]
    assert (scaled["memory"]["argument_bytes_by_tree"]
            == full["memory"]["argument_bytes_by_tree"])
    peak = scaled["memory"]["activation_peak_bytes"]
    want = full["memory"]["activation_peak_bytes"]
    assert abs(peak["Total"] - want["Total"]) <= 0.01 * want["Total"]
    assert peak["Total"] == sum(v for k, v in peak.items() if k != "Total")


def test_seamless_train_step_with_one_head_a_rank_traces(families):
    """seamless-m4t-large-v2's train step, one group a stack at its 16
    heads on the 16-wide "model" axis: the decoder's embedded tokens,
    split on d_model, made DTensor's einsum in `project_heads` a partial
    sum over the whole microbatch, whose gradient's view raised in the
    backward; the projections now run on local shards."""
    rec = families["seamless"]
    assert rec["traced"] is None and rec["step_kind"] == "train"
    assert rec["flops"] > 0 and rec["collectives"]["total_bytes"] > 0


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


# ---------------------------------------------------------------- cut walks
def _walk_trace(walk: str, mode: str, cut: bool) -> tuple:
    """(flops, activation peak, walks cut) of one plain scan on fake
    inputs, traced as the dry-run traces a step, its walk cut or run in
    full: under no_grad, under grad, or in a non-reentrant checkpoint
    (remat's two forwards)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels import ref
    from repro_torch.models import blocks
    steps, b = 20, 2
    tracker = dryrun.memory_tracker()
    rec = dryrun.CaseRecorder(tracker)
    # the scans' zero states are made outside the mode, as in a trace
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.randn(b, steps, 5, 64, requires_grad=True)
        dt = torch.rand(b, steps, 5, requires_grad=True)
        a, d = -torch.rand(5), torch.randn(5)
        bc = torch.randn(b, steps, 64, requires_grad=True)
        xg = torch.randn(b, steps, 4 * 256, requires_grad=True)
        r_gates = torch.randn(4, 4, 64, 64, requires_grad=True)
        bias = torch.randn(4 * 256, requires_grad=True)

    class Cfg:
        d_model, num_heads = 256, 4

    def loss(x, dt, bc, xg):
        if walk == "ssm":
            y = ref.ssm_scan_reference(x, dt, a, bc, bc * 2, d)[0]
        elif walk == "slstm":
            y = blocks._slstm_scan(Cfg, xg, r_gates, bias)[0]
        elif walk == "attention":
            q = x.permute(0, 2, 1, 3)
            y = ref.attention_blockwise(q, q * 2, q * 3, window=6,
                                        block_q=2)
        else:
            q = x[..., :16].reshape(b, steps, 2, 40)
            fn = (ref.mlstm_chunk_reference if walk == "mlstm_steps" else
                  lambda *g: ref.mlstm_chunk_torch(*g, chunk=2))
            y = fn(q, q * 2, q * 3, dt[..., :2], dt[..., 2:4])[0]
        return (y ** 2).sum()

    args = (x, dt, bc, xg)
    with dryrun._traced(rec, cut) as walker, tracker, rec:
        if mode == "no_grad":
            with torch.no_grad():
                loss(*args)
        else:
            out = (loss(*args) if mode == "grad" else
                   checkpoint(loss, *args, use_reentrant=False))
            torch.autograd.grad(out, args, allow_unused=True)
    peak = dryrun._peak_by_type(tracker)
    return rec.flops, peak["Total"], walker.cut


@pytest.mark.parametrize("mode", ["no_grad", "grad", "checkpoint"])
@pytest.mark.parametrize("walk", ["ssm", "slstm", "mlstm_steps",
                                  "mlstm_chunks", "attention"])
def test_cut_walk_records_what_the_full_walk_records(walk, mode):
    """A walk of 20 steps (10 chunks or blocks for the chunked mLSTM
    and the attention) cut to 4: the
    FLOPs exactly the full walk's, forward and backward, remat's second
    forward included; the activation peak the full walk's, but for the
    cut walk's one-byte token."""
    from repro_torch.kernels import ref
    plain = ref.walk
    full = _walk_trace(walk, mode, cut=False)
    cut = _walk_trace(walk, mode, cut=True)
    assert ref.walk is plain
    assert full[2] == 0 and cut[2] == (2 if mode == "checkpoint" else 1)
    assert cut[0] == full[0] > 0
    assert 0 <= cut[1] - full[1] <= 1, (full, cut)


# ------------------------------------------------- the reference's oracle
# prefill_32k's (seq_len, batch), the mistral-large-123b prefill case below
PREFILL = (32768, 32)
# the reference's compiles in three processes (tools/reference_dryrun.py
# forces 512 host devices and rebinds the mesh to Auto axes there; argv 3
# picks the part): qwen2-1.5b
# decode_32k read scaled and unrolled; a reduced zamba2 train step whose
# SSM token scans run inside the group scan inside the microbatch scan,
# scaled and unrolled; the three reduced cases the port traces below, on
# the meshes named; and (argv 3 "batch1") the batch-1 decode cases on
# both meshes
ORACLE_CODE = f"PREFILL = ('prefill', *{PREFILL}, 'prefill')\n" + r"""
import dataclasses, json, sys
sys.path.insert(0, sys.argv[1])
import reference_dryrun as rd
ref = rd.reference()
from repro.configs import base, get_config
from repro.configs.base import ShapeConfig
out = {}
if sys.argv[3] == "unrolled":
    out["qwen"] = [rd.run_case("qwen2-1.5b", "decode_32k", unrolled=u)
                   for u in (False, True)]
    cfg = get_config("zamba2-2.7b").reduced(d_model=128, vocab=256)
    cfg = dataclasses.replace(cfg, num_groups=2, num_layers=4,
                              group_pattern=(base.MAMBA, base.SHARED_ATTN))
    out["nested"] = [rd.compile_case(ref, cfg, ShapeConfig("train", 4, 32,
                                                           "train"),
                                     microbatches=2, unrolled=u)
                     for u in (False, True)]
    print(json.dumps(out))
    sys.exit()
if sys.argv[3] == "batch1":
    kw = json.loads(sys.argv[2])
    for arch in kw["archs"]:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, num_groups=1,
                                  num_layers=len(cfg.group_pattern))
        out[arch] = [rd.compile_case(ref, cfg, ShapeConfig(
            "decode", kw["cache"], 1, "decode"), multi_pod=mp)
            for mp in (False, True)]
    print(json.dumps(out))
    sys.exit()
kw = json.loads(sys.argv[2])
kw["group_pattern"] = tuple(kw["group_pattern"])
out["zamba2_decode"] = rd.compile_case(
    ref, dataclasses.replace(get_config("zamba2-2.7b"), **kw),
    ShapeConfig("decode", 64, 1, "decode"), multi_pod=True)
gemma = get_config("gemma-2b")
gemma = dataclasses.replace(gemma, num_groups=1,
                            num_layers=len(gemma.group_pattern))
out["train"] = [rd.compile_case(ref, gemma, ShapeConfig("train", 512, 256,
                                                        "train"),
                                microbatches=2, multi_pod=mp)
                for mp in (False, True)]
mistral = get_config("mistral-large-123b")
mistral = dataclasses.replace(mistral, num_groups=1,
                              num_layers=len(mistral.group_pattern))
out["prefill"] = rd.compile_case(ref, mistral, ShapeConfig(*PREFILL))
print(json.dumps(out))
"""
# batch-1 decode (long_500k's batch) of a dense and an MoE arch at full
# width, cut to one group and a cache of BATCH1_CACHE slots: on the parent
# every dp rank gathered each FSDP weight and repeated the product
# (mixtral's experts: 14.6x the oracle's FLOPs on 16 x 16) and the
# embedding table (all of each arch's collective bytes but ~1%)
BATCH1_ARCHS = ("qwen2-1.5b", "mixtral-8x7b")
BATCH1_CACHE = 64
# zamba2-2.7b at full width cut to one group of one mamba and the shared
# block, a small vocabulary: a decode step at batch 1 on 2 x 16 x 16. Under
# the parent's 3-D placements its d_inner, split over all three mesh dims,
# made DTensor raise on the step's reshape to heads (_StridedShard,
# split_factor=80); widths of 256-1536 do not reproduce that error
ZAMBA2_DECODE = {"group_pattern": ["mamba", "shared_attn"], "num_groups": 1,
                 "num_layers": 2, "vocab_size": 512}
PORT_CODE = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
what, multi_pod = sys.argv[1], sys.argv[2] == "2x16x16"
if what == "batch1":
    rec = {}
    for arch in json.loads(sys.argv[3]):
        cfg = get_config(arch)
        rec[arch] = dryrun.run_case(
            arch, "decode", cfg=dryrun.at_depth(cfg, 1),
            shape=ShapeConfig("decode", int(sys.argv[4]), 1, "decode"),
            multi_pod=multi_pod, verbose=False)
elif what == "zamba2_decode":
    kw = json.loads(sys.argv[3])
    kw["group_pattern"] = tuple(kw["group_pattern"])
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), **kw)
    rec = dryrun.run_case("zamba2-2.7b", "decode", cfg=cfg,
                          shape=ShapeConfig("decode", 64, 1, "decode"),
                          multi_pod=multi_pod, verbose=False)
elif what == "prefill":
    seq, batch = json.loads(sys.argv[3])
    rec = dryrun.run_case(
        "mistral-large-123b", "prefill",
        cfg=dryrun.at_depth(get_config("mistral-large-123b"), 1),
        shape=ShapeConfig("prefill", seq, batch, "prefill"),
        multi_pod=multi_pod, verbose=False)
else:
    rec = dryrun.run_case("gemma-2b", "train",
                          cfg=dryrun.at_depth(get_config("gemma-2b"), 1),
                          shape=ShapeConfig("train", 512, 256, "train"),
                          microbatches=2, multi_pod=multi_pod, verbose=False)
print(json.dumps(rec))
"""


@pytest.fixture(scope="module")
def oracle():
    """{"oracle": the reference's records, run: the port's record}: the
    oracle's processes and the port's traces at once."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs = {f"oracle/{part}": subprocess.Popen(
        [sys.executable, "-c", ORACLE_CODE, TOOLS,
         json.dumps({"archs": BATCH1_ARCHS, "cache": BATCH1_CACHE}
                    if part == "batch1" else ZAMBA2_DECODE),
         part], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for part in ("unrolled", "cases", "batch1")}
    for what, mesh in (("zamba2_decode", "2x16x16"), ("train", "16x16"),
                       ("train", "2x16x16"), ("batch1", "16x16"),
                       ("batch1", "2x16x16"), ("prefill", "16x16")):
        arg = {"batch1": BATCH1_ARCHS,
               "prefill": PREFILL}.get(what, ZAMBA2_DECODE)
        procs[f"{what}/{mesh}"] = subprocess.Popen(
            [sys.executable, "-c", PORT_CODE, what, mesh, json.dumps(arg),
             str(BATCH1_CACHE)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
    out = {"oracle": {}}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, stderr[-3000:])
        got = json.loads(stdout.strip().splitlines()[-1])
        if name.startswith("oracle/"):
            out["oracle"].update(got)
        else:
            out[name] = got
    return out


def test_reference_oracle_reads_decode_as_the_port(case, oracle):
    """qwen2-1.5b decode_32k, 16 x 16: the reference's dot FLOPs read
    scaled by the layer loop's trip count and read unrolled agree, and
    both equal the port's FLOPs (4.362338304 GFLOPs per device); the
    argument bytes agree within 64 B (the port's int64 token against the
    reference's int32, less the reference's int32 cache position)."""
    scaled, unrolled = oracle["oracle"]["qwen"]
    port = case["record"]
    assert scaled["read"] == "scaled" and unrolled["read"] == "unrolled"
    assert [w["trip_count"] for w in scaled["while_loops"]] == [28]
    assert unrolled["while_loops"] == []
    assert scaled["dot_flops"] == unrolled["dot_flops"] == 4362338304
    assert abs(port["flops"] - scaled["dot_flops"]) \
        <= 1e-9 * scaled["dot_flops"]
    assert abs(port["memory"]["argument_size_in_bytes"]
               - scaled["memory"]["argument_size_in_bytes"]) <= 64


def test_reference_oracle_scales_nested_loops_as_unrolled(oracle):
    """A reduced zamba2 train step (2 microbatches of 2 groups, each with
    a 4-token SSM scan in the forward, remat's second forward and the
    backward): the dot FLOPs scaled through three nested loops equal the
    unrolled compile's exactly; the collective bytes within 1% (unrolling
    changes XLA's plan: 1,451,192 B both ways here, split a little
    differently between all-gather, all-reduce and collective-permute)."""
    scaled, unrolled = oracle["oracle"]["nested"]
    runs = {(w["trip_count"], w["runs"]) for w in scaled["while_loops"]}
    assert (4, 4) in runs and (2, 2) in runs      # tokens in groups in mbs
    assert unrolled["while_loops"] == []
    assert scaled["dot_flops"] == unrolled["dot_flops"] > 0
    a = scaled["collectives"]["total_bytes"]
    b = unrolled["collectives"]["total_bytes"]
    assert abs(a - b) <= 0.01 * b


def test_multipod_zamba2_decode_at_batch_one_traces(oracle):
    """zamba2's decode step at batch 1 on 2 x 16 x 16 (ZAMBA2_DECODE):
    the parent raised in DTensor's propagation of the reshape to heads;
    it traces, its FLOPs within 10% of the oracle's (the bar above which
    a case is listed in ROADMAP queue 3)."""
    rec = oracle["zamba2_decode/2x16x16"]
    want = oracle["oracle"]["zamba2_decode"]
    assert rec["devices"] == 512 and rec["mesh"] == "2x16x16"
    assert want["devices"] == 512
    assert abs(rec["flops"] / want["dot_flops"] - 1) <= 0.10, (
        rec["flops"], want["dot_flops"])


def test_multipod_train_step_is_no_further_from_the_oracle(oracle):
    """gemma-2b's train step cut to one group (2 microbatches of 128 x
    512 tokens), traced on both meshes: on 2 x 16 x 16 (pod x data placed
    as one dp dim of 32) its FLOPs over the oracle's are no worse than
    on 16 x 16. Under the parent's 3-D placements this trace was the
    slow one (CHANGES.md gives both trace times)."""
    ref16, ref32 = oracle["oracle"]["train"]
    port16 = oracle["train/16x16"]
    port32 = oracle["train/2x16x16"]
    assert port32["devices"] == ref32["devices"] == 512
    assert port16["devices"] == ref16["devices"] == 256
    r16 = port16["flops"] / ref16["dot_flops"]
    r32 = port32["flops"] / ref32["dot_flops"]
    assert r32 <= r16 * (1 + 1e-9), (r16, r32)


def test_prefill_gathers_the_sequence_once_a_layer(oracle):
    """mistral-large-123b's prefill at prefill_32k's 32 x 32768 tokens,
    one group at full width, on 16 x 16, against the reference's compile
    of the same case: FLOPs per device within 10% of the oracle's and
    collective bytes at most 2x its. The tokens, split on the sequence
    over "model" by the seq residual, are gathered once for the q, k and
    v projections (`attention._sequence_whole`); DTensor's einsum
    gathered them for each, 4.96x the oracle's bytes."""
    rec = oracle["prefill/16x16"]
    want = oracle["oracle"]["prefill"]
    assert rec["devices"] == want["devices"] == 256
    assert abs(rec["flops"] / want["dot_flops"] - 1) <= 0.10, (
        rec["flops"], want["dot_flops"])
    got = rec["collectives"]["total_bytes"]
    assert got <= 2.0 * want["collectives"]["total_bytes"], (
        got, want["collectives"])


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", BATCH1_ARCHS)
def test_batch1_decode_multiplies_weights_where_they_lie(oracle, arch,
                                                         mesh):
    """A batch-1 decode step (one group at full width, BATCH1_CACHE
    slots) against the reference's compile of the same case: the port's
    FLOPs per device within 10% of the oracle's dot FLOPs and its
    collective bytes at most 2x the oracle's. Each dp rank multiplies its
    shard of every FSDP weight where it lies and sums a token-sized
    partial result (policy.local_einsum, the experts' region, the
    vocab-parallel lookup), as the reference's compiled plan does; the
    parent gathered the weights and the embedding table over dp."""
    rec = oracle[f"batch1/{mesh}"][arch]
    want = oracle["oracle"][arch][mesh == "2x16x16"]
    assert rec["devices"] == want["devices"] == (512 if mesh == "2x16x16"
                                                 else 256)
    assert abs(rec["flops"] / want["dot_flops"] - 1) <= 0.10, (
        rec["flops"], want["dot_flops"])
    got = rec["collectives"]["total_bytes"]
    assert got <= 2.0 * want["collectives"]["total_bytes"], (
        got, want["collectives"])
