"""Multi-pod dry-run: trace every (arch x shape) case of the reference's
sweep (src/repro/launch/dryrun.py) on the production mesh, on the CPU,
with nothing allocated.

The bootstrap: a fake process group of 256 ranks (512 with --multi-pod)
in this one process (`torch.distributed`'s "fake" backend: collectives
return without communicating), the production mesh on it, and the
parameters, optimizer state, batch and cache as FakeTensorMode stand-ins
(shapes and dtypes, no storage) distributed by the sharding policy. The
step is then traced, as rank 0 runs it, under a dispatch mode that
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

**Repeated bodies are traced a few times and extended** (XLA lowers the
reference's `lax.scan` bodies once; an eager trace walks every
repetition, at ~1 ms an op). `run_case(..., full=True)` (`--full`)
traces every repetition; otherwise the record's `traced` field says what
was cut, and:

  * *depth*: a model of more than 3 groups (both stacks of an
    encoder-decoder alike) is traced at 2 and at 3 groups, and every sum
    is extended by the difference, X(G) = X(3) + (G - 3)(X(3) - X(2)):
    flops, and collective bytes and counts by op;
  * *microbatches*: a train step of more than 2 microbatches traces 2 of
    them (the batch cut to their rows, each the full step's microbatch);
    the first microbatch's part of every sum, from its loss call to the
    next, is added once for each one left out. The optimizer runs once,
    as in the full step;
  * *scan steps*: every per-step or per-block loop of the plain scans
    runs through `kernels.ref.walk`, which the trace replaces (`_Walker`):
    a walk of more than 4 steps runs 4 of them, and the sums of one
    step, forward and (under grad) backward, are added for each step
    left out. Remat's second forward runs the walk again, and is
    extended again. The output keeps its full shape.

The activation peak is not a sum. Its rule:

  * *microbatches* add nothing: each microbatch repeats the same
    allocations on top of the same accumulators, so the traced ones
    reach the full step's peak;
  * a cut *walk* allocates, before its last traced steps, what its
    left-out steps would hold then (a step's growth of live bytes,
    measured on a traced step: the part its output makes is freed at the
    join, the part autograd saves lives until the walk's backward has
    run), so the trace holds what a full walk holds at its peak;
  * *depth*: the two traces keep each op's live bytes by segment (a
    group's ops, the ops between two groups, the rest; forward and
    backward). Every op of a segment both traces share (the rest by
    position; a group as the first group or the last; a gap as the first
    or the last between two groups, or the one after the last group) is
    extended as the sums are, and the peak is that op's whose extended
    total is largest, by type as MemTracker breaks it down. A middle
    group's ops lie between the first's and the last's (the live bytes
    an op sees are linear in its group's place), so the two bound them;
    two groups are the fewest with a first, a last and a gap between.
    The whole step's peak extended linearly, or the 3 groups' peak plus
    what each group leaves live, misses by up to 91% where a constant
    branch leads at 2 and 3 groups or gradients grow with depth
    (`tools/dryrun_sweep.py peak-rules` compares the three).

The peak counts fake tensors only (`memory_tracker`): DTensor's
bookkeeping on real tensors and its propagation on meta ones are no
rank's memory.

Usage (run it as its own process: the fake process group is global
state):
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k --full
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --all --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import ref
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


def _first_rows(tree, part: int, whole: int):
    """Each DTensor leaf cut, on every rank, to the first `part` of
    `whole` equal parts of its local rows: a view of the same local
    storage (so the memory tracker sees the whole batch's bytes, as in
    the full step), placed as before."""
    from torch.distributed.tensor import DTensor

    def cut(v):
        local = v.to_local()
        if local.shape[0] % whole:
            raise ValueError(f"batch {local.shape[0]} does not split into "
                             f"{whole} microbatches")
        rows = local.shape[0] // whole * part
        return DTensor.from_local(local[:rows], v.device_mesh, v.placements,
                                  run_check=False)

    return {k: cut(v) for k, v in tree.items()}


class _MarkedModel:
    """A model whose `loss` calls `mark()` first: the train step calls it
    once per microbatch, so the marks cut the step's records at the
    microbatches' starts."""

    def __init__(self, model, mark):
        self.model, self.mark = model, mark

    def loss(self, params, batch):
        self.mark()
        return self.model.loss(params, batch)


def build_case(cfg: ModelConfig, shape: ShapeConfig, mesh,
               microbatches: int = 1, *, traced_microbatches=None,
               on_loss=None):
    """Returns (fn, args tuple, {argument name: placed tree}); call under
    the FakeTensorMode the stand-ins are made in. A train step with
    `traced_microbatches` runs that many of its `microbatches` (the
    batch's first rows); `on_loss` is called at each microbatch's loss."""
    model = build_model(cfg, remat=(shape.kind == "train"))
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    params = _place(p, policy.param_specs(p, mesh), mesh)
    batch = input_specs(cfg, shape)
    batch = _place(batch, policy.batch_specs(batch, mesh), mesh)

    if shape.kind == "train":
        opt_state = optimizer.init(params)
        step_batch, runs = batch, microbatches
        if traced_microbatches:
            step_batch = _first_rows(batch, traced_microbatches,
                                     microbatches)
            runs = traced_microbatches
        fn = train_loop.make_train_step(
            _MarkedModel(model, on_loss) if on_loss else model,
            optimizer.AdamWConfig(), microbatches=runs)
        return fn, (params, opt_state, step_batch), {
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
    by op name. The ops DTensor's sharding propagation runs on global
    shapes under its own fake mode, and its bookkeeping on real tensors,
    are not a rank's work and are skipped (as `memory_tracker` skips
    them). With `tracker` it reads live bytes, and with `timeline` it
    keeps each op's (the tracker's, after the op) by segment label, for
    the depth rule of the peak."""

    def __new__(cls, tracker=None, timeline: bool = False):
        from torch._guards import active_fake_mode
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils import _pytree as pytree
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import FlopCounterMode

        class Recorder(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.flops = 0
                self.registry = FlopCounterMode().flop_registry
                self.records = []       # (op name, result bytes)
                self.marks = []         # (flops, len(records)) at marks
                self.tracker = tracker
                # label -> [live bytes after each op]
                self.timeline = {} if timeline else None
                self.label = ("out", 0)
                self.outs = 0
                self.entry_mode = active_fake_mode()
                self.types = ()
                if tracker is not None:
                    from torch.distributed._tools.mem_tracker import (
                        _MemRefType)
                    self.types = tuple(_MemRefType) + ("Total",)

            def mark(self):
                self.marks.append((self.flops, len(self.records)))
                self.outs += 1
                self.label = ("out", self.outs)

            def live(self) -> int:
                return self.live_by_type()[-1]

            def live_by_type(self) -> tuple:
                """Live bytes summed over devices, by reference type in
                the order of `types`, the total last."""
                snap = self.tracker.get_tracker_snapshot("current")
                return tuple(sum(int(v.get(t, 0)) for v in snap.values())
                             for t in self.types)

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if active_fake_mode() is not self.entry_mode or not any(
                        isinstance(t, FakeTensor)
                        for t in pytree.tree_leaves(out)):
                    return out
                packet = func._overloadpacket
                if packet in self.registry:
                    self.flops += int(self.registry[packet](
                        *args, **kwargs, out_val=out))
                op = collective_name(str(func))
                if op is not None:
                    self.records.append((op, _result_bytes(out)))
                if self.timeline is not None:
                    self.timeline.setdefault(self.label, []).append(
                        self.live_by_type())
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


def memory_tracker():
    """A MemTracker of the fake tensors only: DTensor's own bookkeeping
    runs real ops (shard sizes and offsets) and its sharding propagation
    meta ones, neither a rank's memory, and both depend on what its
    caches already hold."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed._tools.mem_tracker import MemTracker

    class FakeMemTracker(MemTracker):
        def _track(self, reftype, t):
            if isinstance(t, FakeTensor):
                super()._track(reftype, t)

    return FakeMemTracker()


def _peak_by_type(tracker) -> dict:
    """MemTracker's peak bytes, summed over devices, by reference type."""
    peak = {}
    for per_type in tracker.get_tracker_snapshot("peak").values():
        for kind, nbytes in per_type.items():
            name = str(getattr(kind, "value", kind))
            peak[name] = peak.get(name, 0) + int(nbytes)
    return peak


def _depth(cfg: ModelConfig) -> Optional[int]:
    """The model's group count (both stacks of an encoder-decoder, when
    they have as many), or None."""
    if cfg.is_encdec and cfg.encoder_layers != cfg.num_groups:
        return None
    return cfg.num_groups


def at_depth(cfg: ModelConfig, groups: int) -> ModelConfig:
    """`cfg` with `groups` groups (in each stack of an encoder-decoder)."""
    if cfg.is_encdec:
        return dataclasses.replace(cfg, num_layers=groups, num_groups=groups,
                                   encoder_layers=groups)
    return dataclasses.replace(cfg, num_groups=groups,
                               num_layers=groups * len(cfg.group_pattern))


def _saving() -> bool:
    """Whether autograd keeps what it saves here: not in the first
    forward of a non-reentrant `torch.utils.checkpoint`, whose hooks drop
    it (its second forward, in the backward, keeps it)."""
    hooks = torch._C._autograd._top_saved_tensors_default_hooks(False)
    return not (hooks and "_checkpoint_hook" in
                getattr(hooks[0], "__qualname__", ""))


def _tensors(carry) -> list:
    parts = carry if isinstance(carry, (tuple, list)) else (carry,)
    return [c for c in parts if isinstance(c, torch.Tensor)]


def _at_backward(outputs, run, tag) -> None:
    """`run.at(tag)` when the backward of the step that made `outputs`
    begins: a pre-hook on the node, of those that made them, that was
    made last (the backward runs nodes made later first)."""
    nodes = [t.grad_fn for t in outputs
             if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    if nodes:
        last = max(nodes, key=lambda node: node._sequence_nr())
        last.register_prehook(lambda grads: run.at(tag))


class _WalkEnd(torch.autograd.Function):
    """Identity on a walk's output that saves `token` for the backward,
    as the walk's steps save theirs (a checkpoint's second forward hands
    the token it saved to this node); its backward runs first of the
    walk's."""

    @staticmethod
    def forward(ctx, out, token, run):
        ctx.run = run
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(token)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        (token,) = ctx.saved_tensors
        if getattr(token, "kept", None) is not None:
            ctx.run.kept.append(token.kept)
        return grad, None, None


class _WalkRun:
    """One cut walk's backward bookkeeping. The sums of step 1's backward
    (from its start to step 0's: neither the first step, whose state
    needs no gradient, nor the last, whose state may get none) are added
    once for each left-out step; the bytes the left-out steps would save
    are held until step 0's backward (by then a full walk has freed
    theirs)."""

    def __init__(self, recorder, left: int):
        self.recorder, self.left = recorder, left
        self.kept, self.marks = [], {}

    def at(self, tag):
        rec = self.recorder
        self.marks[tag] = (rec.flops, len(rec.records))
        if tag == "step 0":
            if "step 1" in self.marks:
                (f1, r1), (f0, r0) = self.marks["step 1"], (rec.flops,
                                                            len(rec.records))
                rec.flops += (f0 - f1) * self.left
                rec.records.extend(rec.records[r1:r0] * self.left)
            self.kept.clear()


class _Walker:
    """Stands in for `kernels.ref.walk` during a trace: a walk of more
    than 4 steps runs 4 of them (step 0; step 1, whose sums and growth
    of live bytes are one step's; the rest beside the stand-ins below, as
    a full walk's last steps run: two of them, so that the traced
    backward reaches the pattern of a full walk's middle steps) and
    stands in for the left-out ones:

      * sums: one step's forward added per left-out step now; its
        backward per left-out step when the walk's backward has run
        (`_WalkRun`);
      * output: the traced steps' outputs joined with a stand-in of the
        left-out steps' (real bytes if a step's output is freed at the
        join, else none), the full shape;
      * live bytes: the left-out steps' growth, allocated before the
        last traced steps: the part their outputs make freed with the
        stand-in, the rest (what they save, when autograd keeps it)
        handed to `_WalkEnd`'s token, so that it lives while saved
        tensors live (dropped by a checkpoint's first forward, held by
        its second until the traced steps' backward).
    """

    def __init__(self, plain, recorder):
        self.plain, self.recorder = plain, recorder
        self.cut = 0      # walks cut

    def __call__(self, step, n, carry, inputs=(), *, dim=1,
                 join=torch.stack):
        k = 4
        if n <= k:
            return self.plain(step, n, carry, inputs, dim=dim, join=join)
        self.cut += 1
        rec, left = self.recorder, n - k
        grad = torch.is_grad_enabled() and any(
            x.requires_grad for x in inputs)
        run = _WalkRun(rec, left)
        ys = []
        carry, y = step(0, carry, *inputs)
        ys.append(y)
        if grad:
            _at_backward(_tensors(carry) + [y], run, "step 0")
        live, flops, n_rec = rec.live(), rec.flops, len(rec.records)
        carry, y = step(1, carry, *inputs)
        ys.append(y)
        grow = rec.live() - live
        rec.flops += (rec.flops - flops) * left
        rec.records.extend(rec.records[n_rec:] * left)
        if grad:
            _at_backward(_tensors(carry) + [y], run, "step 1")
        saving = grad and _saving()
        # a step's output is freed at the join unless the next step saves
        # it (it is the carry, under grad)
        freed = (0 if saving and any(y is c for c in _tensors(carry)) else
                 y.numel() * y.element_size())
        if join is torch.stack:
            shape = y.shape[:dim] + (left,) + y.shape[dim:]
        else:
            shape = y.shape[:dim] + (y.shape[dim] * left,) + y.shape[dim + 1:]
        rest = (y.new_empty(shape) if freed else
                y.new_empty(()).expand(shape))
        # stand-ins are made like the step's tensors (fake in a trace)
        token = y.new_empty((1,), dtype=torch.uint8)
        if saving and grow > freed:
            token.kept = y.new_empty((left * (grow - freed),),
                                     dtype=torch.uint8)
        # the last steps run beside what the left-out ones hold
        for i in range(2, k):
            carry, y = step(i, carry, *inputs)
            ys.append(y)
        outs = ([t.unsqueeze(dim) for t in ys] if join is torch.stack
                else list(ys))
        out = torch.cat(outs + [rest], dim=dim)
        del ys, outs, rest
        if grad:
            out = _WalkEnd.apply(out, token, run)
        return carry, out


class _Mark(torch.autograd.Function):
    """Identity whose backward sets the recorder's segment label."""

    @staticmethod
    def forward(ctx, x, recorder, label):
        ctx.recorder, ctx.label = recorder, label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.recorder.label = ctx.label
        return grad, None, None


@contextlib.contextmanager
def _traced(recorder, cut: bool):
    """While tracing: `kernels.ref.walk` is a `_Walker` if `cut`, and,
    when the recorder keeps a timeline, each group a `TransformerStack`
    runs labels the recorder's segments: ("grp", call, phase, g) for group g of
    the call-th stack call, forward or backward, and ("gap", call, phase,
    g) for the ops after it up to the next label (a remat's second
    forward belongs to its group's backward). Yields the walker."""
    from repro_torch.models.decoder import TransformerStack
    walker = _Walker(ref.walk, recorder)
    apply0, group0 = TransformerStack.apply, TransformerStack._group
    calls = itertools.count()

    def apply(self, *args, **kwargs):
        self.dryrun_call = [next(calls), 0]
        return apply0(self, *args, **kwargs)

    def group(self, gp, x, ctx, gcache, mode):
        if torch._C._current_autograd_node() is not None:
            return group0(self, gp, x, ctx, gcache, mode)
        call, g = self.dryrun_call
        self.dryrun_call[1] += 1
        # marks only where a backward will run: a mark's view would keep
        # the group's input alive past its last use (a prefill's peak
        # +2 MiB)
        grad = torch.is_grad_enabled() and x.requires_grad
        recorder.label = ("grp", call, "fwd", g)
        if grad:
            x = _Mark.apply(x, recorder, ("gap", call, "bwd", g))
        x, out, aux = group0(self, gp, x, ctx, gcache, mode)
        if grad:
            x = _Mark.apply(x, recorder, ("grp", call, "bwd", g))
        recorder.label = ("gap", call, "fwd", g)
        return x, out, aux

    stand_ins = [(ref, "walk", walker)] if cut else []
    if recorder.timeline is not None:
        stand_ins += [(TransformerStack, "apply", apply),
                      (TransformerStack, "_group", group)]
    kept = [(obj, name, getattr(obj, name)) for obj, name, _ in stand_ins]
    for obj, name, value in stand_ins:
        setattr(obj, name, value)
    try:
        yield walker
    finally:
        for obj, name, value in kept:
            setattr(obj, name, value)


def _roles(label, groups: int) -> list:
    """The identities of a segment that a trace of any depth shares: an
    "out" segment is its own; a group's ops are the first group's or the
    last's; a gap lies between two groups (g and g + 1 forward, g - 1 and
    g backward), the first such pair's or the last's, or after the last
    group the stack runs."""
    if label[0] == "out":
        return [label]
    kind, call, phase, g = label
    if kind == "grp":
        return [(kind, call, phase, r) for r, at in (("first", 0),
                                                     ("last", groups - 1))
                if g == at]
    pair = g if phase == "fwd" else g - 1
    if pair in (-1, groups - 1):
        return [(kind, call, phase, "tail")]
    return [(kind, call, phase, r) for r, at in (("first", 0),
                                                 ("last", groups - 2))
            if pair == at]


def _extended_peak(a: dict, b: dict, ka: int, kb: int, n: int,
                   types: tuple) -> dict:
    """The activation peak of n groups, by type, from the timelines of
    traces of ka and kb = ka + 1 groups: every op of a segment that both
    traces share (`_roles`) extended as the sums, the breakdown of the op
    whose total is largest taken. A middle group's op lies between the
    first's and the last's, its live bytes linear in its place. A segment
    whose op count grows with the depth (DTensor's unbind of a stacked
    leaf: one view per group) extends its op of largest total."""
    def by_role(timeline, k):
        return {role: vals for label, vals in timeline.items()
                for role in _roles(label, k)}

    ra, rb = by_role(a, ka), by_role(b, kb)
    peak = (0,) * len(types)
    for role, vb in rb.items():
        va = ra.get(role)
        if va is None:
            raise RuntimeError(f"segment {role} of {kb} groups is not in "
                               f"the trace of {ka}")
        if len(va) != len(vb):
            va, vb = [max(va, key=_total)], [max(vb, key=_total)]
        for x, y in zip(va, vb):
            op = tuple(_extend(i, j, kb, n) for i, j in zip(x, y))
            if _total(op) > _total(peak):
                peak = op
    return dict(zip(types, peak))


def _total(live: tuple) -> int:
    return live[-1]


def _extend(a: int, b: int, kb: int, n: int) -> int:
    """X(n) from X(kb - 1) = a and X(kb) = b, X linear."""
    return b + (n - kb) * (b - a)


def _trace(cfg, shape, mesh, microbatches, residual, cut: bool,
           timeline: bool = False) -> dict:
    """One trace of the step, its microbatches and scan walks cut if
    `cut`; its sums (the left-out microbatches' and walk steps' added),
    its activation peak by type, its live bytes by segment (`timeline`),
    its seconds and what it cut."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tracker = memory_tracker()
    recorder = CaseRecorder(tracker if timeline or cut else None,
                            timeline=timeline)
    traced_mb = (2 if cut and shape.kind == "train" and microbatches > 2
                 else None)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, _ = build_case(cfg, shape, mesh, microbatches,
                                 traced_microbatches=traced_mb,
                                 on_loss=recorder.mark)
    t0 = time.perf_counter()
    with _traced(recorder, cut) as walker, \
            policy.activation_policy(mesh, residual=residual), tracker, \
            recorder:
        fn(*args)
    seconds = time.perf_counter() - t0
    if traced_mb:
        (f0, r0), (f1, r1) = recorder.marks[:2]
        left = microbatches - traced_mb
        recorder.flops += (f1 - f0) * left
        recorder.records.extend(recorder.records[r0:r1] * left)
    return {"flops": recorder.flops,
            "collectives": collective_bytes(recorder.records),
            "peak": _peak_by_type(tracker), "timeline": recorder.timeline,
            "types": recorder.types, "seconds": seconds,
            "microbatches": traced_mb, "walks_cut": walker.cut}


def run_case(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, microbatches: int | None = None,
             moe_ep: bool = False, kv_int8: bool = False,
             full: bool = False, cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None):
    """One case traced on the fake production mesh; the reference's
    record keys wherever torch has a counterpart. `full` traces every
    group, microbatch and scan step; otherwise the module docstring's
    cuts apply, and the record's `traced` field says which (null for a
    full trace). `cfg` and `shape` stand in for
    the named arch and shape (reduced configurations, short shapes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = shape or INPUT_SHAPES[shape_name]
    cfg = variant_for_shape(cfg or get_config(arch), shape)
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
        _, _, placed = build_case(cfg, shape, mesh, microbatches)
    arg_bytes = {k: policy.local_bytes(v) for k, v in placed.items()}
    del placed
    depth = _depth(cfg)
    groups = (2, 3) if not full and depth and depth > 3 else None
    if groups:
        k1, k2 = groups
        a, b = (_trace(at_depth(cfg, k), shape, mesh, microbatches,
                       residual, True, timeline=True) for k in groups)
        ext = functools.partial(_extend, kb=k2, n=depth)
        ca, cb = a["collectives"], b["collectives"]
        coll = {"bytes_by_op": {op: ext(ca["bytes_by_op"][op],
                                        cb["bytes_by_op"][op])
                                for op in COLLECTIVE_OPS},
                "count_by_op": {op: ext(ca["count_by_op"][op],
                                        cb["count_by_op"][op])
                                for op in COLLECTIVE_OPS}}
        coll["total_bytes"] = sum(coll["bytes_by_op"].values())
        peak = _extended_peak(a["timeline"], b["timeline"], k1, k2, depth,
                              b["types"])
        got = {"flops": ext(a["flops"], b["flops"]), "collectives": coll,
               "peak": {str(getattr(t, "value", t)): v
                        for t, v in peak.items()},
               "seconds": a["seconds"] + b["seconds"],
               "microbatches": b["microbatches"],
               "walks_cut": b["walks_cut"]}
    else:
        got = _trace(cfg, shape, mesh, microbatches, residual, not full)
    traced = {"groups": list(groups) if groups else None,
              "microbatches": got["microbatches"],
              "scan_steps": 4 if got["walks_cut"] else None}
    coll = got["collectives"]
    memory = {"argument_size_in_bytes": sum(arg_bytes.values()),
              "argument_bytes_by_tree": arg_bytes,
              "activation_peak_bytes": got["peak"],
              "activation_peak_note": ACTIVATION_PEAK_NOTE}
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": mesh.size(),
        "step_kind": shape.kind,
        "trace_seconds": round(got["seconds"], 2),
        "traced": None if all(v is None for v in traced.values())
        else traced,
        "flops": float(got["flops"]),
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
        print(f"[dryrun] {arch} x {shape.name} on {record['mesh']}: "
              f"trace {record['trace_seconds']}s "
              f"({'full' if record['traced'] is None else record['traced']})"
              f" GFLOPs/device {record['flops'] / 1e9:.1f} "
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
    ap.add_argument("--full", action="store_true",
                    help="trace every group, microbatch and scan step")
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
                           moe_ep=args.moe_ep, full=args.full)
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
