"""FSDP x TP sharding policy over the ("pod",) "data", "model" mesh, as the
reference's (src/repro/sharding/policy.py), on DTensor.

Two mechanisms, as there:

1. **Name-aware parameter rules** (Megatron-style): every parameter leaf
   name of the model zoo has a spec, leaf for leaf the reference's: qkv
   column-parallel on heads, output projections row-parallel, d_ff
   column/row pairs, vocab-parallel embeddings, stacked MoE experts TP on
   d_ff, FSDP (("pod", "data") or "data") on the matching input dim, each
   dim sharded only where it divides. A spec is a tuple with one entry per
   tensor dim: None, a mesh-axis name, or ("pod", "data"); it equals
   `tuple(PartitionSpec)` of the reference. `to_placements` turns it into
   the DTensor placements per mesh dim (`Shard(i)` or `Replicate()`), and
   `distribute` places a whole tree by its specs. Optimizer state mirrors
   the parameter tree and takes the same specs by leaf name.

2. **Activation constraints**: the models call `constrain(x, (DP, None,
   TP))` at block boundaries, on q/k/v, on the logits and on the mLSTM
   cell inputs. Under an active `activation_policy` (set by launch code) a
   DTensor is redistributed to the spec (the counterpart of
   `with_sharding_constraint`); with no policy active `constrain` returns
   its argument itself, so single-device code never sees a mesh. A plain
   tensor is never touched: under a policy it is a replicated value.

While a policy is active, DTensor's `implicit_replication` is on too: the
plain tensors the models make (rope frequencies, masks, zero states) mix
with DTensors as replicated values.

A decode step's products run on the shards where the weights lie
(`local_einsum`, `local_lookup`): for a token that every dp rank holds
whole (a batch that does not divide dp) each rank multiplies its FSDP
shard and the token-sized partial result is summed, as the reference's
compiled plan does; a batch split on dp brings its few rows to the weight
rather than gathering the weight. DTensor's own plans of these products
gather the weights over dp and repeat the work there.

On a mesh with a "pod" axis, DTensors live on its `placement_mesh`: the
same ranks as a 2-D ("data", "model") mesh whose "data" is pod x data,
pod-major. "pod" is never named without "data" (`fsdp_axes`, the DP
specs), so every layout of the 3-D mesh is one of the 2-D arrangement, and
a dim split over ("pod", "data") is one `Shard` there, where the 3-D mesh
takes a `Shard` on each of two mesh dims, whose views DTensor can only
describe as `_StridedShard`s and whose redistributions it plans by
searching a graph of layouts, op by op.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch

DP = "dp"   # logical data-parallel axes (("pod", "data") or ("data",))
TP = "tp"   # logical tensor-parallel axis ("model")

_policy = threading.local()


def fsdp_axes(mesh_axis_names) -> tuple:
    return ("pod", "data") if "pod" in mesh_axis_names else ("data",)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, or of any object with a dict
    `shape` (a mesh of shape only, as the tests' FakeMesh)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class activation_policy:
    """Context manager enabling activation sharding constraints on `mesh`.

    residual: "seq" shards the block-boundary residual stream on the
    sequence dim over the model axis (Megatron sequence parallelism);
    "replicated" keeps it model-replicated, which the scans (ssm, mlstm)
    need: they take the whole sequence locally."""

    def __init__(self, mesh, residual: str = "seq"):
        sizes = axis_sizes(mesh)
        self.dp = fsdp_axes(tuple(sizes))
        self.tp = ("model",) if "model" in sizes else ()
        self.dp_size = math.prod(sizes[a] for a in self.dp)
        self.tp_size = math.prod(sizes[a] for a in self.tp) if self.tp else 1
        if residual not in ("seq", "replicated"):
            raise ValueError(f"residual must be 'seq' or 'replicated', "
                             f"got {residual!r}")
        self.residual = residual
        self.mesh = mesh
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self):
        from torch.distributed.tensor.experimental import implicit_replication
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(implicit_replication())
        _policy.current = self
        return self

    def __exit__(self, *exc):
        _policy.current = None
        self._stack.close()
        self._stack = None


def residual_for(cfg) -> str:
    """The residual layout of a family: sequence-sharded (Megatron SP) for
    the attention families, replicated for the recurrent ones (ssm,
    hybrid), whose scans take the whole sequence locally, as the
    reference's dry-run chooses."""
    return "replicated" if cfg.family in ("ssm", "hybrid") else "seq"


def current_policy() -> Optional[activation_policy]:
    return getattr(_policy, "current", None)


def current_mesh():
    """The placement mesh of the active policy's mesh, or None."""
    pol = current_policy()
    return None if pol is None else placement_mesh(pol.mesh)


# a mesh with a "pod" axis -> (the mesh, its placement mesh)
_PLACEMENT = {}


def placement_mesh(mesh):
    """The DeviceMesh that DTensors of `mesh`'s layouts are placed on:
    `mesh` itself, or, for a mesh with a "pod" axis, the ("data", "model")
    mesh of the same ranks in pod-major order (its "data" of size pod x
    data, as the reference's PartitionSpec splits ("pod", "data")); made
    once per mesh."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    flat = _PLACEMENT.get(id(mesh))
    if flat is None or flat[0] is not mesh:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.device_mesh import DeviceMesh
        order = [names.index(a) for a in ("pod", "data", "model")]
        with unset_fake_temporarily():     # the rank grid is real
            ranks = mesh.mesh.permute(order)
            ranks = ranks.reshape(ranks.shape[0] * ranks.shape[1],
                                  ranks.shape[2])
            flat = (mesh, DeviceMesh(mesh.device_type, ranks,
                                     mesh_dim_names=("data", "model")))
        _PLACEMENT[id(mesh)] = flat
    return flat[1]


def resolve(shape, spec: Sequence, pol: activation_policy) -> tuple:
    """A logical spec (None | DP | TP per dim) as a mesh spec for `shape`
    under `pol`: dims that do not divide are dropped (None)."""
    parts = []
    for dim, s in zip(shape, spec):
        if s == DP and dim % pol.dp_size == 0 and dim >= pol.dp_size:
            parts.append(pol.dp if len(pol.dp) > 1 else pol.dp[0])
        elif s == TP and pol.tp and dim % pol.tp_size == 0 \
                and dim >= pol.tp_size:
            parts.append(pol.tp[0])
        else:
            parts.append(None)
    return tuple(parts) + (None,) * (len(shape) - len(parts))


def constrain(x, spec: Sequence):
    """spec entries: None | DP | TP. Dims that don't divide are dropped.
    Without a policy, or for a plain tensor, returns `x` itself."""
    pol = current_policy()
    if pol is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    placements = to_placements(resolve(x.shape, spec, pol), mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def constrain_residual(x):
    """Block-boundary residual stream (B, S, d)."""
    pol = current_policy()
    if pol is None:
        return x
    spec = (DP, TP, None) if pol.residual == "seq" else (DP, None, None)
    return constrain(x, spec)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placed_like(x, ref):
    """DTensor `x` redistributed to the placements of DTensor `ref` (a
    gradient to its parameter's, a new state to its cache's)."""
    if is_dtensor(x) and tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def split_on_model(w, dim: int) -> bool:
    """DTensor `w` split on its dim `dim` over a "model" mesh dim."""
    if not is_dtensor(w):
        return False
    from torch.distributed.tensor import Shard
    return any(name == "model" and pl == Shard(dim)
               for name, pl in zip(w.device_mesh.mesh_dim_names,
                                   w.placements))


def gathered(w):
    """DTensor weight `w` with its FSDP split (on the dp mesh dims)
    gathered and its "model" split kept, as FSDP gathers a weight before
    its use; the backward reduce-scatters its gradient back. A plain
    tensor, or a weight split on no dp dim, is returned as it is. Given a
    weight still split on dp, DTensor's plan of a product may gather the
    activations or their gradient over dp instead, and repeat the product
    on every dp rank (the LM head's backward in zamba2-2.7b's train step,
    16 x 16)."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    dp = fsdp_axes(tuple(mesh.mesh_dim_names))
    placements = tuple(Replicate() if name in dp else pl for name, pl in
                       zip(mesh.mesh_dim_names, w.placements))
    if placements == tuple(w.placements):
        return w
    return w.redistribute(mesh, placements)


def replicated(x, mesh):
    """`x` as a DTensor on `mesh`: a plain tensor (a replicated value, the
    same on every rank) is wrapped as `Replicate()` on every mesh dim."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _GroupSum(torch.autograd.Function):
    """all_reduce(SUM) over a process group in the forward and the
    identity in the backward: the sum's result is replicated over the
    group and each rank's gradient of it is the whole gradient (Megatron's
    reduce from the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SummedGrad(torch.autograd.Function):
    """The identity; its backward redistributes a DTensor gradient to the
    input's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if is_dtensor(grad) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def summed_grad(x):
    """DTensor `x` whose gradient is placed as `x` is, a partial sum (what
    a `run_local` region gives an input it reads whole on a mesh dim its
    work is split over) summed where it enters the graph before the
    region: DTensor's backward of a norm given a partial gradient gathers
    the batch over dp (Megatron's all-reduce of the activations'
    gradient, here). A plain tensor is returned as it is."""
    return _SummedGrad.apply(x) if is_dtensor(x) else x


def group_sum(x, group):
    """`x` summed over the ranks of `group`, differentiable (identity
    backward: the result is the same on every rank of the group)."""
    return _GroupSum.apply(x, group)


# ------------------------------------------------------------- param rules
def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0 and n >= k


def _param_rule(name: str, shape, model: int, fsdp: int, dp_axes) -> tuple:
    """Spec for one (unstacked) parameter leaf by name."""
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    nd = len(shape)

    def d(i):  # dp if divisible
        return dp if _div(shape[i], fsdp) else None

    def m(i):  # model if divisible
        return "model" if _div(shape[i], model) else None

    if nd <= 1:
        return ()
    if name in ("wq", "wk", "wv"):
        if nd == 2:                           # xLSTM: (d_inner, d_inner)
            return (d(0), m(1))
        if m(1):                              # (d, H, hd) column-parallel
            return (d(0), "model", None)
        return (d(0), None, m(2))
    if name == "wo":                          # (H, hd, d) row-parallel
        if m(0):
            return ("model", None, d(2))
        return (None, m(1), d(2))
    if name in ("bq", "bk", "bv"):            # (H, hd) follow qkv
        return ("model", None) if m(0) else (None, m(1))
    if name in ("w_up", "w_gate", "w_in", "w_gates"):   # (d, out) column
        return (d(0), m(1))
    if name in ("w_down", "w_out"):           # (in, d) row-parallel
        return (m(0), d(1))
    if name == "embed":                       # (V, d) vocab-parallel
        return (m(0), d(1))
    if name == "unembed":                     # (d, V)
        return (d(0), m(1))
    if name == "router":
        return ()
    if name == "lora_a":
        return (d(0), None)
    if name == "lora_b":
        return (None, d(1))
    if name == "vision_proj":                 # (vision_dim, d)
        return (d(0), m(1))
    if name in ("wx", "wh"):                  # ICU LSTM (I, 4, H): tiny
        return ()
    if name.startswith("ep_"):                # EP-major experts (E*r, d, f/r)
        # leading dim on "model" (one expert slice per shard);
        # dp-replicated by design: an inference layout (sharding/ep_moe.py)
        return ("model" if _div(shape[0], model) else None, None, None)
    # fallback: model on the last divisible dim, fsdp on the first
    spec = [None] * nd
    for i in range(nd - 1, 0, -1):
        if _div(shape[i], model):
            spec[i] = "model"
            break
    if spec[0] is None and _div(shape[0], fsdp):
        spec[0] = dp
    return tuple(spec)


def _expert_rule(name: str, shape, model: int, fsdp: int, dp_axes) -> tuple:
    """Stacked MoE expert weights (E, d, f) / (E, f, d): TP on d_ff."""
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    if name.startswith("ep_"):   # EP-major (E*r, d, f/r): expert on model
        return ("model" if _div(shape[0], model) else None, None, None)
    if name in ("w_up", "w_gate"):
        return (None, dp if _div(shape[1], fsdp) else None,
                "model" if _div(shape[2], model) else None)
    if name == "w_down":
        return (None, "model" if _div(shape[1], model) else None,
                dp if _div(shape[2], fsdp) else None)
    return ()


def _mesh_sizes(mesh):
    sizes = axis_sizes(mesh)
    dp_axes = fsdp_axes(tuple(sizes))
    fsdp = math.prod(sizes[a] for a in dp_axes)
    return sizes.get("model", 1), fsdp, dp_axes


def _map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` over a tree of dicts and lists; a path is the
    tuple of dict keys and list indices down to the leaf. Leaves without
    a shape (the cache's host position) are kept as they are."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in
                enumerate(tree)]
    if not hasattr(tree, "shape"):
        return tree
    return fn(path, tree)


def _stacked(keys) -> bool:
    """A leaf under "groups" is stacked on a leading group axis, unless
    the groups are a list (the port's decode caches: one dict a group)."""
    if "groups" not in keys:
        return False
    i = keys.index("groups")
    return not (i + 1 < len(keys) and isinstance(keys[i + 1], int))


def param_specs(tree, mesh):
    """The spec of every leaf of a parameter (or optimizer-moment) tree."""
    model, fsdp, dp_axes = _mesh_sizes(mesh)

    def one(path, leaf):
        keys = [str(k) for k in path]
        name = keys[-1] if keys else ""
        stacked = "groups" in keys
        in_experts = "experts" in keys
        # xLSTM cell blocks: dp-only (no TP): the matrix-memory cell needs
        # d_inner replicated. The model axis still serves the vocab-
        # parallel embedding.
        dp_only = any(k.endswith(("_mlstm", "_slstm")) for k in keys)
        eff_model = 1 << 62 if dp_only else model
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        if len(shape) <= 1:
            return ()
        if in_experts:
            spec = _expert_rule(name, shape, model, fsdp, dp_axes)
        else:
            spec = _param_rule(name, shape, eff_model, fsdp, dp_axes)
        return (None, *spec) if stacked else spec

    return _map_with_path(one, tree)


def cache_specs(tree, mesh):
    """Decode caches: KV (B, Hkv, S, hd) -- batch on dp when divisible,
    else sequence/slots on dp (context parallel for batch-1 long decode);
    kv-heads on model when divisible, else the slots (never head_dim, the
    q.k contraction dim). Recurrent states: model on the largest remaining
    dim. Stacked leaves (a dict under "groups") take a leading None."""
    model, fsdp, dp_axes = _mesh_sizes(mesh)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def one(path, leaf):
        name = str(path[-1]) if path else ""
        stacked = _stacked(list(path))
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd >= 2:
            used_dp = False
            if _div(shape[0], fsdp):            # batch
                spec[0] = dp
                used_dp = True
            if name in ("k_scale", "v_scale") and nd == 3:  # (B, Hkv, S)
                if _div(shape[1], model):
                    spec[1] = "model"
                elif _div(shape[2], model):
                    spec[2] = "model"
            elif name in ("k", "v") and nd == 4:  # (B, Hkv, S, hd)
                if _div(shape[1], model):
                    spec[1] = "model"
                elif _div(shape[2], model):
                    spec[2] = "model"
                if not used_dp and _div(shape[2], fsdp) and spec[2] is None:
                    spec[2] = dp                # context-parallel slots
            else:
                order = sorted(range(1, nd), key=lambda i: -shape[i])
                for i in order:
                    if _div(shape[i], model):
                        spec[i] = "model"
                        break
                if not used_dp:
                    for i in order:
                        if spec[i] is None and _div(shape[i], fsdp):
                            spec[i] = dp
                            break
        if stacked:
            spec = [None] + spec
        return tuple(spec)

    return _map_with_path(one, tree)


def batch_specs(tree, mesh):
    """Model inputs: batch on dp when divisible, the rest replicated."""
    _, fsdp, dp_axes = _mesh_sizes(mesh)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def one(_, leaf):
        if not leaf.shape:
            return ()
        first = dp if _div(leaf.shape[0], fsdp) else None
        return (first, *([None] * (len(leaf.shape) - 1)))

    return _map_with_path(one, tree)


# ---------------------------------------------------------------- DTensor
def to_placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements (one per mesh dim) of a spec: `Shard(i)` on
    every mesh dim that tensor dim i is split over (a dim on ("pod",
    "data") takes `Shard(i)` on both, pod-major as the reference's
    PartitionSpec splits it, or on the one "data" dim of a mesh without
    "pod", a `placement_mesh`), `Replicate()` on the others. A mesh dim
    of size 1 splits nothing: it takes `Replicate()`, the same layout,
    which spares DTensor's planner the views of one-way splits."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    taken = set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if "pod" in axes and "pod" not in names:     # a placement mesh
            if axes != ("pod", "data"):
                raise ValueError(f"{entry} on a mesh without \"pod\"")
            axes = ("data",)
        for name in axes:
            j = names.index(name)
            if j in taken:
                raise ValueError(f"mesh axis {name!r} shards two dims of "
                                 f"spec {spec}")
            taken.add(j)
            if sizes[name] > 1:
                out[j] = Shard(i)
    return tuple(out)


def layout(mesh, batch, heads_dim=None) -> tuple:
    """Placements per mesh dim of a local region's operand: dim 0 (the
    batch, of size `batch`) on the dp mesh dims where it divides them,
    `heads_dim` on "model", the rest (and every mesh dim of size 1)
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    dp = fsdp_axes(tuple(sizes))
    dp_size = math.prod(sizes.get(a, 1) for a in dp)
    on_dp = batch is not None and _div(batch, dp_size)
    out = []
    for name, size in sizes.items():
        if size > 1 and name in dp and on_dp:
            out.append(Shard(0))
        elif size > 1 and name == "model" and heads_dim is not None:
            out.append(Shard(heads_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def dp_idle(x) -> bool:
    """DTensor `x` whose batch (dim 0) does not divide its mesh's dp mesh
    dims, of more than one rank: every dp rank holds all of `x` (a
    batch-1 decode), and work on it is repeated there unless something
    splits it."""
    if not is_dtensor(x):
        return False
    sizes = axis_sizes(x.device_mesh)
    dp_size = math.prod(sizes.get(a, 1) for a in fsdp_axes(tuple(sizes)))
    return dp_size > 1 and not _div(x.shape[0], dp_size)


def split_on_dp(w) -> bool:
    """DTensor `w` split on one of its mesh's dp mesh dims (FSDP)."""
    if not is_dtensor(w):
        return False
    from torch.distributed.tensor import Shard
    dp = fsdp_axes(tuple(w.device_mesh.mesh_dim_names))
    return any(name in dp and isinstance(pl, Shard)
               for name, pl in zip(w.device_mesh.mesh_dim_names,
                                   w.placements))


def fsdp_local(x, w) -> bool:
    """The product of activation `x` and weight `w` runs where `w` lies
    (`local_einsum`): `x` held whole on every dp rank (`dp_idle`) and `w`
    split on dp. DTensor's own plan of such a product gathers `w` over dp
    and repeats the product on every dp rank."""
    return dp_idle(x) and split_on_dp(w)


def moves_rows(x, w) -> bool:
    """A decode step (`_decode_step`) whose DTensor `x` has its batch (dim
    0) split on the same dp mesh dim as DTensor `w`, and this rank's rows
    of `x` are fewer elements than its shard of `w`: the rows, not the
    weight, should move."""
    if not (_decode_step(x) and is_dtensor(w)):
        return False
    from torch.distributed.tensor import Shard
    dp = fsdp_axes(tuple(w.device_mesh.mesh_dim_names))
    return any(name in dp and xp == Shard(0) and isinstance(wp, Shard)
               for name, xp, wp in zip(w.device_mesh.mesh_dim_names,
                                       x.placements, w.placements)) \
        and _local_numel(x) < _local_numel(w)


def _decode_step(x) -> bool:
    """DTensor `x` is a decode step's activation: one position (its dim
    -2), no gradient taken, on a mesh of more than one rank."""
    return (is_dtensor(x) and x.ndim >= 2 and x.shape[-2] == 1
            and not torch.is_grad_enabled() and x.device_mesh.size() > 1)


def decode_local(x, w) -> bool:
    """The product of a decode step's activation `x` (`_decode_step`) and
    DTensor weight `w` runs on the shards where they lie
    (`local_einsum`). DTensor's own plans of a decode step's attention
    projections repeat them on every "model" rank (where head_dim is
    split) or on every rank of a 32-wide dp dim."""
    return _decode_step(x) and is_dtensor(w)


def dp_group(mesh):
    """The process group of `mesh`'s dp mesh dim (a placement mesh has
    one: "data", pod-major over ("pod", "data"))."""
    (name,) = [n for n in mesh.mesh_dim_names
               if n in fsdp_axes(tuple(mesh.mesh_dim_names))]
    return mesh.get_group(name)


def settle(y, placements):
    """DTensor `y` redistributed to `placements` one mesh dim at a time,
    its partial sums first: each reduced on the shards as they lie, before
    any gather makes them larger."""
    from torch.distributed.tensor import Partial
    mesh = y.device_mesh
    for j in sorted(range(mesh.ndim),
                    key=lambda j: not isinstance(y.placements[j], Partial)):
        if y.placements[j] != placements[j]:
            y = y.redistribute(mesh, tuple(
                placements[j] if i == j else pl
                for i, pl in enumerate(y.placements)))
    return y


def _settled(mesh, placements) -> tuple:
    """The placements of activations around a local product's output
    placed by `placements`: every `Partial` reduced, every split of a dim
    other than the batch (dim 0) on a dp mesh dim gathered; a batch split
    on dp and the splits on "model" kept."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dp = fsdp_axes(tuple(mesh.mesh_dim_names))
    return tuple(Replicate() if isinstance(pl, Partial) or (
        name in dp and pl != Shard(0)) else pl
        for name, pl in zip(mesh.mesh_dim_names, placements))


def summed(y):
    """DTensor `y` placed as the activations around it (`_settled`)."""
    return settle(y, _settled(y.device_mesh, y.placements))


def _local_numel(t) -> int:
    return (t.to_local() if is_dtensor(t) else t).numel()


def _einsum_placements(spec: str, x, w) -> tuple:
    """(x's, w's, the output's placements in the region, the output's
    placements after it) for `torch.einsum(spec, x, w)` on each rank's
    shards, mesh dim by mesh dim:

      * `x` split on a letter only it and the output have (its batch):
        where `w` is split too, the smaller of the two moves: `w`
        gathered (FSDP's gather), or `x`'s rows brought together and
        split as `w` is (an all-to-all, or a gather where `w`'s letter is
        not `x`'s), the output taken back to the batch's split after the
        region (a reduce-scatter or an all-to-all); else `x` kept, the
        output split alike;
      * `w` split on a letter, or `x` split on a letter `w` has and is
        split on nowhere else: `w` where it lies (or sliced alike, free),
        `x` split on the same letter (a free slice where `x` is
        replicated), the output split on it, or `Partial` where the
        letter is contracted;
      * else, on a mesh dim of more than one rank, the work split there
        rather than repeated: `w` sliced (free) on the first letter it is
        split on nowhere else whose size the mesh dim divides, one only it
        and the output have (the output split alike), or else one it
        contracts with `x` (`x` sliced alike, the output `Partial`);
      * else everything replicated (`x` gathered).

    After the region every `Partial` is reduced and every split of a dim
    other than the batch on a dp mesh dim gathered (`summed`)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ins, out = spec.split("->")
    xs, ws = ins.split(",")
    mesh = w.device_mesh
    x_pl = (tuple(x.placements) if is_dtensor(x)
            else (Replicate(),) * mesh.ndim)
    taken = {ws[pl.dim] for pl in w.placements if isinstance(pl, Shard)}
    move_rows = _local_numel(x) < _local_numel(w)
    xp, wp, op, back = [], [], [], {}
    for j, (cur, wcur) in enumerate(zip(x_pl, w.placements)):
        xc = xs[cur.dim] if isinstance(cur, Shard) else None
        if xc is not None and xc in out and xc not in ws:
            if not (isinstance(wcur, Shard) and move_rows):
                xp.append(cur)
                wp.append(Replicate())
                op.append(Shard(out.index(xc)))
                continue
            back[j] = Shard(out.index(xc))
            xc = None
        c = (ws[wcur.dim] if isinstance(wcur, Shard) else
             xc if xc is not None and xc in ws and xc not in taken
             else None)
        if c is None and mesh.size(j) > 1:
            free = [a for i, a in enumerate(ws) if a not in taken
                    and w.shape[i] % mesh.size(j) == 0]
            c = next((a for a in free if a in out and a not in xs),
                     next((a for a in free if a in xs and a not in out),
                          None))
            if c is not None:
                taken.add(c)
        if c is None:
            xp.append(Replicate())
            wp.append(Replicate())
            op.append(Replicate())
            continue
        xp.append(Shard(xs.index(c)) if c in xs else Replicate())
        wp.append(Shard(ws.index(c)))
        op.append(Shard(out.index(c)) if c in out else Partial())
    after = tuple(back.get(j, pl) for j, pl in
                  enumerate(_settled(mesh, op)))
    return tuple(xp), tuple(wp), tuple(op), after


def local_einsum(spec: str, x, w):
    """`torch.einsum(spec, x, w)` with DTensor weight `w` multiplied where
    it lies, in a `run_local` region (`_einsum_placements`): `w` at its
    own placements where it is split, sliced (free) where a mesh dim
    would otherwise repeat the work, gathered only where `x`'s batch is
    split and `w` is the smaller (after the slices: the gather carries
    this rank's columns alone); `x` sliced to the part each shard of `w`
    contracts; the output partial over the mesh dims that split a
    contracted dim, then reduced, mesh dim by mesh dim, the partial sums
    first: a collective of the activations' size, never of the
    weight's, but for the FSDP gather. For a token held whole by every
    dp rank (`fsdp_local`), a column-parallel weight (d_model on dp, the
    output dim on "model") gives the output split on "model", a
    row-parallel one (the contraction dim on "model", d_model on dp)
    gives it whole."""
    from torch.distributed.tensor import Replicate
    xp, wp, op, after = _einsum_placements(spec, x, w)
    mesh = w.device_mesh
    sliced = tuple(t if t != Replicate() else pl
                   for pl, t in zip(w.placements, wp))
    for placements in (sliced, wp):
        if placements != tuple(w.placements):
            w = w.redistribute(mesh, placements)
    y = run_local(lambda a, b: torch.einsum(spec, a, b), mesh, (x, w),
                  (xp, wp), op)
    return settle(y, after)


def local_matmul(x, w):
    """`x @ w` of a (B, L, k) activation and a (k, n) weight, multiplied
    where `w` lies (`local_einsum`)."""
    return local_einsum("blk,kn->bln", x, w)


def exchange_columns(t, have, need, rank: int, group):
    """Inside a `run_local` region: the columns `need[rank]` ((lo, hi)
    ranges, in order) of a tensor whose last dim is cut over the ranks of
    `group`, rank q holding the columns `have[q]` = (lo, hi) and this rank
    `t`: one all-to-all that carries each rank only the columns it needs
    from each other (where a gather would carry all of them)."""
    from torch.distributed._functional_collectives import all_to_all_single

    def cols(src, dst):
        lo, hi = have[src]
        return [c for a, b in need[dst] for c in range(max(a, lo),
                                                        min(b, hi))]

    send = [cols(rank, q) for q in range(len(have))]
    recv = [cols(q, rank) for q in range(len(have))]
    idx = [c - have[rank][0] for s in send for c in s]
    flat = t.movedim(-1, 0)[torch.tensor(idx, device=t.device)]
    got = all_to_all_single(flat.contiguous(), [len(r) for r in recv],
                            [len(s) for s in send], group)
    pos = {c: i for i, c in enumerate(c for r in recv for c in r)}
    want = [pos[c] for a, b in need[rank] for c in range(a, b)]
    return got[torch.tensor(want, device=t.device)].movedim(0, -1)


def local_lookup(table, ids):
    """`table[ids]` of a DTensor table split on its rows (the vocabulary,
    on "model") and its columns (d_model, on dp), for ids held whole on
    every dp rank (`dp_idle`), where the table lies: each rank takes the
    rows of its shard that the ids name (zeros for the others) at its
    columns, and the result is `summed` (vocab-parallel). DTensor's own
    plan of the index gathers the table over dp."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    offset = 0
    out = []
    for j, pl in enumerate(table.placements):
        if pl == Shard(0):
            offset = mesh.get_local_rank(j) * (table.shape[0]
                                               // mesh.size(j))
            out.append(Partial())
        elif pl == Shard(1):
            out.append(Shard(ids.ndim))
        else:
            out.append(Replicate())

    def body(tl, il):
        rows = tl.shape[0]
        hit = (il >= offset) & (il < offset + rows)
        got = tl[torch.where(hit, il - offset, 0)]
        return torch.where(hit[..., None], got, torch.zeros_like(got))

    rep = (Replicate(),) * mesh.ndim
    return summed(run_local(body, mesh, (table, ids),
                            (tuple(table.placements), rep), tuple(out)))


def run_local(fn, mesh, args, in_placements, out_placements):
    """`fn` on each rank's local shards of `args` (redistributed to
    `in_placements` first; plain tensors taken as replicated) in a
    `local_map` region, its outputs wrapped as DTensors placed by
    `out_placements` (one placement tuple, or a tuple of them for several
    outputs). An input replicated over a mesh dim that the outputs are
    split over (sharded or partial there) gets a `Partial` gradient
    there: each rank's local gradient covers its own part of the work. So
    a region either splits its work over a mesh dim or repeats all of it
    there."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    several = isinstance(out_placements[0], tuple)
    outs = out_placements if several else (out_placements,)
    split = [any(isinstance(o[j], (Shard, Partial)) for o in outs)
             for j in range(mesh.ndim)]
    grads = tuple(tuple(Partial() if split[j] and pl == Replicate() else pl
                        for j, pl in enumerate(ins))
                  for ins in in_placements)
    out_arg = tuple(list(o) for o in outs) if several else list(outs[0])
    return local_map(fn, out_placements=out_arg,
                     in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(
        *(replicated(x, mesh) for x in args))


def is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def distribute(tree, specs, mesh, src_data_rank: Optional[int] = 0):
    """Every tensor leaf of `tree` as a DTensor on `mesh` (on its
    `placement_mesh`), placed by the spec at the same path in `specs`
    (`param_specs`, `batch_specs`, `cache_specs`). Each rank must hold the
    same full leaf: the shards come from rank `src_data_rank`'s (None:
    each rank cuts its own shard from its own leaf, with no
    collective)."""
    from torch.distributed.tensor import distribute_tensor
    mesh = placement_mesh(mesh)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, s[i]) for i, v in enumerate(t)]
        if not hasattr(t, "shape"):
            return t
        return distribute_tensor(t, mesh, to_placements(s, mesh),
                                 src_data_rank=src_data_rank)

    return walk(tree, specs)


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor leaf (the whole tensor
    for a plain one): what one rank holds of the tree."""
    sizes = []

    def one(_, t):
        local = t.to_local() if is_dtensor(t) else t
        sizes.append(local.numel() * local.element_size())

    _map_with_path(one, tree)
    return sum(sizes)
