"""Multi-pod dry-run: trace every (arch x shape) case of the reference's
sweep (src/repro/launch/dryrun.py) on the production mesh, on the CPU,
with nothing allocated.

The bootstrap: a fake process group of 256 ranks (512 with --multi-pod)
in this one process (`torch.distributed`'s "fake" backend: collectives
return without communicating), the production mesh on it, and the
parameters, optimizer state, batch and cache as FakeTensorMode stand-ins
(shapes and dtypes, no storage) distributed by the sharding policy. The
step is then traced once, as rank 0 runs it, under a dispatch mode that
records, per device:

  * `flops`: the operations FlopCounterMode's formulas give each local op
    (matrix products, attention, convolutions), where the reference reads
    `compiled.cost_analysis()`;
  * `collectives`: the bytes of each functional collective's result, by
    the reference's op names (all-gather, all-reduce, reduce-scatter,
    all-to-all, collective-permute), where the reference sums the result
    shapes of the partitioned HLO (`collective_bytes` takes the records);
  * `memory["argument_size_in_bytes"]`: the local-shard bytes of the
    parameters, optimizer state, batch and cache, exactly; beside it
    `activation_peak_bytes`, MemTracker's peak of the tensors the step
    makes, by reference type (MemTracker follows the fake tensors in the
    same trace; `activation_peak_note` says what it counts).

The trace replaces lowering and compiling: `trace_seconds` replaces
`lower_seconds` / `compile_seconds` (MemTracker's bookkeeping included).
Nothing here is a measurement of any device. The analytic fields come
from `utils.flops`, as in the reference.

Usage (run it as its own process: the fake process group is global
state):
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.sharding import policy
from repro_torch.training import optimizer, train_loop
from repro_torch.utils import flops as flops_util

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# substrings of c10d / functional-collective op names -> the reference's
# HLO op names (first match wins)
_OP_NAMES = (("reduce_scatter", "reduce-scatter"),
             ("all_gather", "all-gather"), ("allgather", "all-gather"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
             ("permute", "collective-permute"), ("send", "collective-permute"))


def variant_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k on pure full-attention archs runs the explicit
    sliding-window variant (DESIGN.md §4). Native-SWA / recurrent / hybrid
    archs run unmodified."""
    if shape.name == "long_500k" and cfg.has_quadratic_prefill:
        return dataclasses.replace(cfg, long_context_window=4096)
    return cfg


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Stand-ins for every model input of this shape (call under a
    FakeTensorMode: nothing is allocated). Tokens are int64, the port's
    index type."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": torch.empty((b, s), dtype=torch.int64)}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.empty(
                (b, cfg.cross_attn_states, cfg.vision_dim), dtype=dt)
        if cfg.is_encdec:
            batch["frames"] = torch.empty(
                (b, cfg.encoder_frames, cfg.d_model), dtype=dt)
        return batch
    # decode: one new token + a seq_len-deep cache
    return {"token": torch.empty((b,), dtype=torch.int64)}


def fake_process_group(world_size: int) -> None:
    """The default process group as `world_size` fake ranks in this
    process (this process is rank 0), unless one exists already."""
    import torch.distributed as dist
    # registers the "fake" backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks exists; the dry-run needs "
                               f"{world_size}")
        return
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)


def _place(tree, specs, mesh):
    """DTensors of fake leaves, each rank taking its own shard (no
    collective)."""
    return policy.distribute(tree, specs, mesh, src_data_rank=None)


def build_case(cfg: ModelConfig, shape: ShapeConfig, mesh,
               microbatches: int = 1):
    """Returns (fn, args tuple, {argument name: placed tree}); call under
    the FakeTensorMode the stand-ins are made in."""
    model = build_model(cfg, remat=(shape.kind == "train"))
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    params = _place(p, policy.param_specs(p, mesh), mesh)
    batch = input_specs(cfg, shape)
    batch = _place(batch, policy.batch_specs(batch, mesh), mesh)

    if shape.kind == "train":
        opt_state = optimizer.init(params)
        fn = train_loop.make_train_step(model, optimizer.AdamWConfig(),
                                        microbatches=microbatches)
        return fn, (params, opt_state, batch), {
            "params": params, "opt_state": [opt_state.m, opt_state.v],
            "batch": batch}

    if shape.kind == "prefill":
        def fn(prm, b):
            return model.prefill(prm, b, max_len=shape.seq_len)
        return fn, (params, batch), {"params": params, "batch": batch}

    # decode: serve_step = one token against a seq_len cache
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="cpu")
    cache = _place(cache, policy.cache_specs(cache, mesh), mesh)

    def fn(prm, token, c):
        with torch.no_grad():
            return model.decode_step(prm, token, c)

    return fn, (params, batch["token"], cache), {
        "params": params, "batch": batch, "cache": cache}


class CaseRecorder:
    """A dispatch mode that sees each rank-local op (DTensor ops pass
    through to their local ops) and sums, per device, the operations
    FlopCounterMode's formulas count and each collective's result bytes
    by op name."""

    def __new__(cls):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import FlopCounterMode

        class Recorder(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.registry = FlopCounterMode().flop_registry
                self.records = []       # (op name, result bytes)

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                packet = func._overloadpacket
                if packet in self.registry:
                    self.flops += int(self.registry[packet](
                        *args, **kwargs, out_val=out))
                op = collective_name(str(func))
                if op is not None:
                    self.records.append((op, _result_bytes(out)))
                return out

        return Recorder()


def collective_name(op: str):
    """The reference's HLO name of a collective op (None if `op` is not
    one)."""
    if "c10d" not in op:
        return None
    for key, name in _OP_NAMES:
        if key in op:
            return name
    return None


def _result_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_result_bytes(o) for o in out)
    return 0


def collective_bytes(records):
    """Sum the result bytes of collective records, (op name, bytes)
    pairs, by the reference's op names."""
    per_op = {op: 0 for op in COLLECTIVE_OPS}
    count = {op: 0 for op in COLLECTIVE_OPS}
    for op, nbytes in records:
        per_op[op] += int(nbytes)
        count[op] += 1
    return {"bytes_by_op": per_op, "count_by_op": count,
            "total_bytes": sum(per_op.values())}


# train_4k gradient-accumulation factors: chosen so the per-device
# activation high-water fits HBM (recorded per-case in the dry-run JSON)
TRAIN_MICROBATCHES = {
    "xlstm-350m": 8, "gemma2-27b": 8, "llama-3.2-vision-11b": 4,
    "zamba2-2.7b": 8, "mixtral-8x7b": 4, "mixtral-8x22b": 8,
    "seamless-m4t-large-v2": 2, "qwen2-1.5b": 2, "mistral-large-123b": 8,
    "gemma-2b": 2,
}


ACTIVATION_PEAK_NOTE = ("MemTracker's peak of the fake tensors the step "
                        "makes (its outputs and temporaries; the "
                        "arguments are counted apart), by reference type")


def _peak_by_type(tracker) -> dict:
    """MemTracker's peak bytes, summed over devices, by reference type."""
    peak = {}
    for per_type in tracker.get_tracker_snapshot("peak").values():
        for kind, nbytes in per_type.items():
            name = str(getattr(kind, "value", kind))
            peak[name] = peak.get(name, 0) + int(nbytes)
    return peak


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, microbatches: int | None = None,
             moe_ep: bool = False, kv_int8: bool = False):
    """One case traced on the fake production mesh; the reference's
    record keys wherever torch has a counterpart."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = INPUT_SHAPES[shape_name]
    cfg = variant_for_shape(get_config(arch), shape)
    if kv_int8:
        if shape.kind != "decode":
            raise ValueError(f"int8 KV is a decode-cache layout, got "
                             f"{shape.kind!r}")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if moe_ep:
        if not cfg.num_experts or shape.kind == "train":
            raise ValueError("EP MoE is an inference layout "
                             "(dp-replicated expert storage); needs "
                             "num_experts > 0 and a non-train shape")
        model_axis = 16
        if model_axis % cfg.num_experts:
            raise ValueError(f"model axis {model_axis} not a multiple "
                             f"of num_experts {cfg.num_experts}")
        cfg = dataclasses.replace(
            cfg, moe_ep_shards=model_axis // cfg.num_experts)
    if microbatches is None:
        microbatches = TRAIN_MICROBATCHES.get(arch, 1) \
            if shape.kind == "train" else 1
    fake_process_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    residual = policy.residual_for(cfg)
    # the stand-ins are made under the mode; the step runs outside it, so
    # that DTensor's own bookkeeping (shard offsets) runs on real tensors
    # while every op on a stand-in goes to its fake mode
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, placed = build_case(cfg, shape, mesh, microbatches)
    arg_bytes = {k: policy.local_bytes(v) for k, v in placed.items()}
    from torch.distributed._tools.mem_tracker import MemTracker
    recorder, tracker = CaseRecorder(), MemTracker()
    t0 = time.perf_counter()
    with policy.activation_policy(mesh, residual=residual), tracker, \
            recorder:
        fn(*args)
    trace_s = time.perf_counter() - t0
    coll = collective_bytes(recorder.records)
    memory = {"argument_size_in_bytes": sum(arg_bytes.values()),
              "argument_bytes_by_tree": arg_bytes,
              "activation_peak_bytes": _peak_by_type(tracker),
              "activation_peak_note": ACTIVATION_PEAK_NOTE}
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": mesh.size(),
        "step_kind": shape.kind,
        "trace_seconds": round(trace_s, 2),
        "flops": float(recorder.flops),
        "memory": memory,
        "collectives": coll,
        "param_count": flops_util.param_count(cfg),
        "active_param_count": flops_util.active_param_count(cfg),
        "param_bytes": flops_util.param_bytes(cfg),
        "analytic_step_flops": flops_util.step_flops(cfg, shape),
        "model_flops_6nd": flops_util.model_flops_6nd(cfg, shape),
        "long_context_variant": cfg.long_context_window is not None,
        "microbatches": microbatches,
        "moe_ep": bool(cfg.moe_ep_shards),
        "kv_cache_dtype": cfg.kv_cache_dtype,
        "residual": residual,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {record['mesh']}: "
              f"trace {record['trace_seconds']}s "
              f"GFLOPs/device {record['flops'] / 1e9:.1f} "
              f"collective_MB/device {coll['total_bytes'] / 1e6:.1f} "
              f"argument_MB/device "
              f"{memory['argument_size_in_bytes'] / 1e6:.1f}")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE layout (inference shapes)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cases = ([(args.arch, args.shape)] if not args.all else
             [(a, s) for a in ARCH_NAMES for s in INPUT_SHAPES])
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cases:
        tag = f"{arch}_{shape}_{'2x16x16' if args.multi_pod else '16x16'}"
        try:
            rec = run_case(arch, shape, multi_pod=args.multi_pod,
                           moe_ep=args.moe_ep)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
        except Exception as e:  # noqa: BLE001 -- report and continue
            failures.append((tag, repr(e)))
            print(f"[dryrun] FAIL {tag}: {e!r}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print(f"[dryrun] all {len(cases)} cases traced OK")


if __name__ == "__main__":
    main()
