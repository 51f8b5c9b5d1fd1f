"""The cases of tests/test_torch_distributed.py, run on every rank of a
gloo process group of 4 CPU ranks (one thread each). Imports torch and
the port only: the test file computes the reference's side in its own
process and hands it over as numpy files.

`run(rank, world, workdir)` runs every case on this rank and, on rank 0,
writes {case: result} to workdir/results.json; a case that raises records
its traceback there instead, so the others still run.
"""
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

QWEN_STEPS = 5
# arch -> (remat, loss_chunk): mixtral's LM head in chunks of 16 tokens
# (slicing its sequence-sharded residual), zamba2 built with remat (each
# group recomputed in the backward)
ONE_STEP_ARCHS = {"mixtral-8x7b": (False, 16), "zamba2-2.7b": (True, 512),
                  "xlstm-350m": (False, 512)}
NOISE = 0.05


def _nest(flat: dict) -> dict:
    """{"a/b/c": array} -> {"a": {"b": {"c": array}}}."""
    tree = {}
    for key, v in flat.items():
        node = tree
        *parts, last = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _full(t):
    from repro_torch.sharding.policy import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def qwen_training(workdir, mesh):
    """Reduced qwen2 from the reference's numpy weights: 5 AdamW steps on
    the mesh and on one device, on the same batches."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovTokenDataset, shard_batch
    from repro_torch.models import build_model
    from repro_torch.sharding import policy
    from repro_torch.training import optimizer, train_loop
    cfg = get_config("qwen2-1.5b").reduced(layers=2, d_model=128, vocab=512)
    model = build_model(cfg)
    tree = _nest(dict(np.load(os.path.join(workdir, "qwen.npz"))))
    opt_cfg = optimizer.AdamWConfig(total_steps=QWEN_STEPS, warmup_steps=1)
    batches = [b for b, _ in zip(MarkovTokenDataset(
        vocab_size=512, seq_len=32, batch_size=8).batches(),
        range(QWEN_STEPS))]
    step = train_loop.make_train_step(model, opt_cfg)
    out = {}
    for sharded in (False, True):
        p = convert.decoder_params_from_numpy(tree, cfg)
        if sharded:
            p = policy.distribute(p, policy.param_specs(p, mesh), mesh)
        o = optimizer.init(p)
        losses = []
        for b in batches:
            if sharded:
                with policy.activation_policy(mesh):
                    p, o, m = step(p, o, shard_batch(b, mesh))
            else:
                p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        out["sharded" if sharded else "single"] = (
            losses, {k: _full(v) for k, v in _flat(p)})
    single, sharded = out["single"], out["sharded"]
    return {"single": single[0], "sharded": sharded[0],
            "param_max_abs": max(float((sharded[1][k] - v).abs().max())
                                 for k, v in single[1].items())}


def one_step(arch, mesh):
    """Loss and every gradient of a reduced arch on noised weights, on
    the mesh (under the family's residual layout) and on one device, both
    built and chunked as ONE_STEP_ARCHS says."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.reduced(layers=2 if len(cfg.group_pattern) <= 2 else None,
                      d_model=128, vocab=256)
    return _step_case(cfg, *ONE_STEP_ARCHS[arch], mesh)


def encdec_step(mesh):
    """`one_step` of the encoder-decoder (seamless-m4t-large-v2 reduced,
    two groups a stack, remat) with as many heads as the mesh's model
    axis: one head a rank, the layout whose attention projections'
    backward the fake 16 x 16 mesh could not trace."""
    from repro_torch.configs import get_config
    heads = mesh.size(mesh.mesh_dim_names.index("model"))
    cfg = get_config("seamless-m4t-large-v2").reduced(
        layers=2, d_model=128, vocab=256)
    cfg = dataclasses.replace(cfg, num_heads=heads, num_kv_heads=heads,
                              head_dim=128 // heads)
    return _step_case(cfg, True, 512, mesh)


# attention whose heads do not divide "model" (qwen2-1.5b's 12 and
# gemma-2b's 8 on 16 ranks): reduced qwen2 with 3 heads and one kv head on
# the (2 x 2) mesh, each "model" rank its half of the query rows; with no
# window, and with a window of 8 of the 32 positions
ROWS_SPLIT_WINDOWS = (None, 8)


def rows_split_step(mesh, window):
    """`one_step` of reduced qwen2 with 3 heads (and `window`), and the
    number of attention calls this rank ran on its query rows from an
    offset (`ops._attention_local`'s `q_offset`)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    cfg = get_config("qwen2-1.5b").reduced(layers=2, d_model=128, vocab=256)
    cfg = dataclasses.replace(cfg, num_heads=3, num_kv_heads=1, head_dim=32,
                              attn_window=window)
    local, rows = ops._attention_local, []

    def spy(*a, q_offset=None, **kw):
        rows.append(q_offset)
        return local(*a, q_offset=q_offset, **kw)

    ops._attention_local = spy
    try:
        res = _step_case(cfg, False, 512, mesh)
    finally:
        ops._attention_local = local
    return dict(res, rows_split=sum(o is not None for o in rows),
                offsets=sorted({o for o in rows if o is not None}))


def _step_case(cfg, remat, chunk, mesh):
    from repro_torch.data.pipeline import make_batch, shard_batch
    from repro_torch.models import build_model
    from repro_torch.sharding import policy
    model = build_model(cfg, remat=remat)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    for _, t in _flat(p):
        t.add_((NOISE * torch.randn(t.shape, generator=g)).to(t.dtype))
    batch = make_batch(cfg, 4, 32, seed=2)

    def loss_and_grads(params, b):
        leaves = [t for _, t in _flat(params)]
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, b, loss_chunk=chunk)
        return _full(loss.detach()), [_full(x) for x in
                                      torch.autograd.grad(loss, leaves)]

    loss0, grads0 = loss_and_grads(p, batch)
    dp = policy.distribute({k: v for k, v in p.items()},
                           policy.param_specs(p, mesh), mesh)
    residual = policy.residual_for(cfg)
    with policy.activation_policy(mesh, residual=residual), \
            _moe_regions() as regions:
        loss1, grads1 = loss_and_grads(dp, shard_batch(batch, mesh))
    names = [k for k, _ in _flat(p)]
    worst = {n: float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-6)
             for n, a, b in zip(names, grads1, grads0)}
    return {"loss_single": float(loss0), "loss_sharded": float(loss1),
            "residual": residual, "moe_regions": regions, "grad_rel": worst,
            "nonzero": all(float(b.abs().max()) > 0 for b in grads0)}


@contextlib.contextmanager
def _moe_regions():
    """Counts the MoE dispatches of DTensor tokens by region while it is
    open: "tp" (the dispatch on each rank's batch shard with the experts'
    d_ff on "model", `blocks._sharded_moe`) and "where_they_lie"
    (`blocks._experts_where_they_lie`, a decode step's)."""
    from repro_torch.models import blocks
    counts = {"tp": 0, "where_they_lie": 0}
    moe, lie = blocks._sharded_moe, blocks._experts_where_they_lie

    def sharded(*a, **kw):
        counts["tp"] += 1
        return moe(*a, **kw)

    def where_they_lie(*a, **kw):
        counts["tp"] -= 1
        counts["where_they_lie"] += 1
        return lie(*a, **kw)

    blocks._sharded_moe = sharded
    blocks._experts_where_they_lie = where_they_lie
    try:
        yield counts
    finally:
        blocks._sharded_moe, blocks._experts_where_they_lie = moe, lie


# decode cases: (arch, kv cache dtype, mesh): kv heads on model (2 x 2),
# and slots on model (1 x 4: 2 kv heads do not divide 4), int8 too;
# gemma2's local layers on a ring of 8 slots that wraps; a batch of one
# on (pod 2 x data 2 x model 1), its slots on ("pod", "data"), as
# long_500k's on the multi-pod mesh: one dim of 4 ranks, pod-major, of
# the placement mesh
DECODE_CASES = (("qwen2-1.5b", "native", "2x2"), ("qwen2-1.5b", "int8", "1x4"),
                ("gemma2-27b", "native", "1x4"),
                ("qwen2-1.5b", "native", "2x2x1"),
                ("gemma2-27b", "int8", "2x2x1"))
DECODE_BATCH = {"2x2": 4, "1x4": 4, "2x2x1": 1}
DECODE_STEPS = 10


def decode(arch, kv, mesh, batch):
    """`decode_step` from an empty cache on DTensor parameters and a
    cache placed by `cache_specs` (written and read on each rank's shard,
    flash-decode where the slots are split) against one device."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    cfg = cfg.reduced(layers=2, d_model=128, vocab=256)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv, num_kv_heads=2,
                              attn_window=8 if cfg.attn_window else None)
    res = _decode_steps(cfg, mesh, batch)
    res.pop("params")
    first = res.pop("cache")["groups"][0]["b0_" + cfg.group_pattern[0]]
    first = first["attn"]["k"]
    return dict(res, cache_placements=str(first.placements),
                cache_mesh=str(dict(zip(first.device_mesh.mesh_dim_names,
                                        first.device_mesh.shape))))


# decode on the (2 x 2) mesh with every weight multiplied where it lies
# (arch, batch): at batch 1 the token is held whole by both dp ranks: a
# dense MLP and GQA projections (qwen2), TP experts (mixtral), a tied
# head and one kv head, the cache's slots on "model" and the output's
# head_dim split over dp (gemma-2b), the mamba mixer's decode region
# (zamba2, with as many SSM heads as head_dim so that, as at full width,
# the SSM state's heads are the dim "model" splits), the xLSTM cells'
# dp-only weights with their work split over "model" and the mLSTM step
# on C's shards (xlstm cut to one mLSTM and one sLSTM block, with 3
# mLSTM heads, which, as at full width, the cache rules do not split);
# at batch 4, the batch on dp: the experts
# where they lie, each rank's rows brought to them (mixtral), and the
# xLSTM
FSDP_DECODE = (("qwen2-1.5b", 1), ("mixtral-8x7b", 1), ("gemma-2b", 1),
               ("zamba2-2.7b", 1), ("xlstm-350m", 1), ("mixtral-8x7b", 4),
               ("xlstm-350m", 4))


def decode_fsdp(arch, mesh, batch):
    """`_decode_steps` of the reduced arch (its own kv heads), with the
    result bytes of every all-gather of a step and the local bytes of one
    layer's weights on this rank."""
    from repro_torch.configs import get_config
    from repro_torch.sharding import policy
    cfg = get_config(arch)
    cfg = cfg.reduced(layers=2, d_model=192 if cfg.family == "ssm" else 128,
                      vocab=256)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, ssm_num_heads=16, ssm_head_dim=16)
    elif cfg.ssm_num_heads:
        cfg = dataclasses.replace(cfg, ssm_num_heads=3, ssm_head_dim=128,
                                  group_pattern=("mlstm", "slstm"),
                                  num_layers=2)
    res = _decode_steps(cfg, mesh, batch)
    layer = policy.local_bytes(res.pop("params")["stack"]) / cfg.num_layers
    res.pop("cache")
    return dict(res, layer_bytes=layer)


class _GatherBytes:
    """`torch.distributed.tensor.debug.CommDebugMode` that also sums the
    result bytes of the all-gathers it sees."""

    def __new__(cls):
        from torch.distributed.tensor.debug import CommDebugMode

        class Mode(CommDebugMode):
            def __init__(self):
                super().__init__()
                self.gather_bytes = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = super().__torch_dispatch__(func, types, args, kwargs)
                name = str(func)
                if out is not NotImplemented and (
                        "all_gather" in name or "allgather" in name):
                    self.gather_bytes += sum(
                        t.numel() * t.element_size()
                        for t in torch.utils._pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor))
                return out

        return Mode()


def _decode_steps(cfg, mesh, batch):
    """DECODE_STEPS decode steps from an empty cache on one device and on
    DTensor parameters with a cache placed by `cache_specs`: the largest
    logit difference, the most all-gather bytes of a meshed step, and the
    meshed parameters and cache."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.models import build_model
    from repro_torch.sharding import policy
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (DECODE_STEPS, batch),
                         generator=torch.Generator().manual_seed(1))
    worst, gathered = 0.0, 0
    with torch.no_grad():
        c0 = model.init_cache(batch, 16, device="cpu")
        dp = policy.distribute(p, policy.param_specs(p, mesh), mesh)
        c1 = model.init_cache(batch, 16, device="cpu")
        c1 = policy.distribute(c1, policy.cache_specs(c1, mesh), mesh)
        for t in toks:
            l0, c0 = model.decode_step(p, t, c0)
            with policy.activation_policy(mesh), _GatherBytes() as comm:
                l1, c1 = model.decode_step(
                    dp, shard_batch({"t": t}, mesh)["t"], c1)
            gathered = max(gathered, comm.gather_bytes)
            worst = max(worst, float((_full(l1) - l0).abs().max()))
    return {"max_abs": worst, "gather_bytes": gathered, "params": dp,
            "cache": c1}


def ep_moe(workdir, mesh_1x4):
    """The EP MoE (2 experts x 2 shards on model 4) against the TP path
    on one device, on the reference's numpy weights and inputs."""
    from repro_torch.configs.base import MOE, ModelConfig
    from repro_torch.models import blocks
    from repro_torch.sharding import policy
    data = dict(np.load(os.path.join(workdir, "ep.npz")))
    cfg_tp = ModelConfig(name="t", family="moe", num_layers=1, d_model=64,
                         num_heads=2, num_kv_heads=2, head_dim=32, d_ff=64,
                         vocab_size=64, group_pattern=(MOE,), num_experts=2,
                         num_experts_per_tok=2, moe_capacity_factor=4.0,
                         dtype="float32")
    cfg_ep = dataclasses.replace(cfg_tp, moe_ep_shards=2)
    p_ep = {"moe_norm": torch.from_numpy(data["moe_norm"]),
            "router": torch.from_numpy(data["router"]),
            "experts": {k: torch.from_numpy(data[k])
                        for k in ("ep_gate", "ep_up", "ep_down")}}
    p_tp = dict(p_ep, experts=blocks._logical_experts(p_ep["experts"],
                                                      cfg_ep))
    x = torch.from_numpy(data["x"])
    with torch.no_grad():
        y_tp, aux_tp = blocks._moe_ffn(p_tp, x, cfg_tp)
        placed = policy.distribute(p_ep, policy.param_specs(p_ep, mesh_1x4),
                                   mesh_1x4)
        with policy.activation_policy(mesh_1x4):
            y_ep, aux_ep = blocks._moe_ffn(placed, x, cfg_ep)
        y_ep, aux_ep = _full(y_ep), _full(aux_ep)
    raised = False
    with policy.activation_policy(mesh_1x4):
        try:
            xg = x.clone().requires_grad_(True)
            blocks._moe_ffn(placed, xg, cfg_ep)
        except RuntimeError as e:
            raised = "inference layout" in str(e)
    return {"y_ep": y_ep.tolist(), "err_tp": float((y_ep - y_tp).abs().max()),
            "aux_tp": float(aux_tp), "aux_ep": float(aux_ep),
            "raises_under_grad": raised}


def gqa(mesh_1x4):
    """qwen2's 12 q heads and 2 kv heads with heads on model 4: each rank
    takes the kv head its 3 local q heads map to; output and gradients
    equal the single-device attention. 12 q heads over 3 kv heads on
    model 4 cannot map and raises."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.sharding import policy
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 12, 16, 8, generator=g)
    k = torch.randn(2, 2, 16, 8, generator=g)
    v = torch.randn(2, 2, 16, 8, generator=g)
    dy = torch.randn(2, 12, 16, 8, generator=g)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    y0 = ops.attention(*ts, causal=True)
    g0 = torch.autograd.grad(y0, ts, dy)
    rep = [Replicate(), Replicate()]
    dq = distribute_tensor(q, mesh_1x4, [Replicate(), Shard(1)])
    dk = distribute_tensor(k, mesh_1x4, rep)
    dv = distribute_tensor(v, mesh_1x4, rep)
    dts = [t.detach().requires_grad_(True) for t in (dq, dk, dv)]
    with policy.activation_policy(mesh_1x4):
        y1 = ops.attention(*dts, causal=True)
        g1 = torch.autograd.grad(
            y1, dts, distribute_tensor(dy, mesh_1x4, [Replicate(), Shard(1)]))
    out = {"placements": str(y1.placements),
           "y_err": float((_full(y1) - y0).abs().max()),
           "grad_err": max(float((_full(a) - b).abs().max())
                           for a, b in zip(g1, g0))}
    k3 = distribute_tensor(torch.randn(2, 3, 16, 8, generator=g), mesh_1x4,
                           rep)
    try:
        with policy.activation_policy(mesh_1x4):
            ops.attention(dq.detach(), k3, k3, causal=True)
        out["unmappable_raises"] = False
    except ValueError as e:
        out["unmappable_raises"] = "GQA" in str(e)
    return out


def lstm_layer(mesh):
    """`ops.lstm_layer` (the ICU LSTM's op) on a batch split over dp, its
    replicated weights' gradients summed over the batch shards: h_T, c_T,
    the hidden sequence and every gradient against one device."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.sharding import policy
    g = torch.Generator().manual_seed(4)
    xs, wx = torch.randn(6, 4, 5, generator=g), torch.randn(5, 4, 8,
                                                             generator=g)
    wh, b = torch.randn(8, 4, 8, generator=g), torch.randn(4, 8, generator=g)
    leaves = [t.clone().requires_grad_(True) for t in (xs, wx, wh, b)]
    h0, c0, hs0 = ops.lstm_layer(*leaves, return_sequence=True)
    g0 = torch.autograd.grad((h0.sum(), c0.sum(), hs0.square().sum()),
                             leaves)
    rep = [Replicate(), Replicate()]
    placed = [distribute_tensor(xs, mesh, [Shard(1), Replicate()])] + [
        distribute_tensor(t, mesh, rep) for t in (wx, wh, b)]
    dleaves = [t.requires_grad_(True) for t in placed]
    with policy.activation_policy(mesh):
        h1, c1, hs1 = ops.lstm_layer(*dleaves, return_sequence=True)
        g1 = torch.autograd.grad((h1.sum(), c1.sum(), hs1.square().sum()),
                                 dleaves)
    return {"out_err": max(float((_full(a) - b).abs().max())
                           for a, b in ((h1, h0), (c1, c0), (hs1, hs0))),
            "grad_err": max(float((_full(a) - b).abs().max())
                            for a, b in zip(g1, g0)),
            "h_placements": str(h1.placements)}


def launcher(mesh_name):
    """`launch.train.run(..., mesh="host")` on the 4 ranks (a 4 x 1 mesh)
    against the same run on one device."""
    from repro_torch.launch import train
    kw = dict(reduced=True, steps=2, batch=8, seq=16, device="cpu",
              log_fn=lambda *_: None)
    meshed = train.run("qwen2-1.5b", mesh=mesh_name, **kw)
    single = train.run("qwen2-1.5b", **kw)
    from repro_torch.training import optimizer
    return {"meshed": meshed.losses, "single": single.losses,
            "mesh": str(dict(zip(
                optimizer.tree_leaves(meshed.params)[0].device_mesh
                .mesh_dim_names,
                optimizer.tree_leaves(meshed.params)[0].device_mesh.shape)))}


def run(rank, world, workdir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'pg')}",
        rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    mesh_1x4 = init_device_mesh("cpu", (1, 4),
                                mesh_dim_names=("data", "model"))
    meshes = {"2x2": mesh, "1x4": mesh_1x4,
              "2x2x1": init_device_mesh(
                  "cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))}
    cases = {"qwen": lambda: qwen_training(workdir, mesh),
             **{f"one_step/{a}": (lambda a=a: one_step(a, mesh))
                for a in ONE_STEP_ARCHS},
             "encdec": lambda: encdec_step(mesh),
             **{f"rows_split/{w}": (lambda w=w: rows_split_step(mesh, w))
                for w in ROWS_SPLIT_WINDOWS},
             **{f"decode/{a}/{kv}/{m}": (
                 lambda a=a, kv=kv, m=m: decode(a, kv, meshes[m],
                                                DECODE_BATCH[m]))
                for a, kv, m in DECODE_CASES},
             **{f"decode_fsdp/{a}/{b}": (
                 lambda a=a, b=b: decode_fsdp(a, mesh, b))
                for a, b in FSDP_DECODE},
             "ep": lambda: ep_moe(workdir, mesh_1x4),
             "gqa": lambda: gqa(mesh_1x4),
             "lstm": lambda: lstm_layer(mesh),
             "launcher": lambda: launcher("host")}
    results = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        try:
            results[name] = case()
        except Exception:  # noqa: BLE001 -- recorded for the test to show
            results[name] = {"error": traceback.format_exc()}
        results[name]["seconds"] = time.perf_counter() - t0
    if rank == 0:
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()
