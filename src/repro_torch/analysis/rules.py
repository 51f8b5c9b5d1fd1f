"""Reprolint rules R001–R006 (DESIGN.md §14).

Each rule codifies a bug class this repo has already fixed by hand —
the catalogue, rationale and suppression policy live in DESIGN.md §14.
Rules are static and conservative by design: they flag syntactic
patterns without data-flow analysis, so a hazard smuggled through an
alias (``t = time.time; t()``) escapes them. That trade keeps the pass
dependency-free and fast enough to run on every push.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.linter import (FileContext, Finding, Rule,
                                         dotted_name, import_aliases,
                                         resolve)

# ------------------------------------------------------------------ R001


class BareAssertRule(Rule):
    """``assert`` in runtime code vanishes under ``python -O`` — every
    guard that protects an invariant must raise ValueError/TypeError
    instead (DESIGN.md §7)."""
    id = "R001"
    title = "bare assert in runtime path (stripped by python -O)"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assert):
                yield ctx.finding(
                    self.id, node,
                    "bare assert is stripped by `python -O`; raise "
                    "ValueError/TypeError so the guard survives")


# ------------------------------------------------------------------ R002

_WALL_CLOCK = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.thread_time", "time.clock",
    "time.time_ns", "time.perf_counter_ns", "time.monotonic_ns",
}
# any `<x>.now()` / `<x>.utcnow()` / `<x>.today()` where the chain ends
# in a datetime-ish name
_DATETIME_HEADS = {"datetime", "date"}
_DATETIME_CALLS = {"now", "utcnow", "today"}


class WallClockRule(Rule):
    """Wall-clock reads inside simulation logic (``metro/``, ``core/``)
    make event timing a function of the host instead of the seed and
    break the ``--check-determinism`` CRC contract. Simulation time is
    an explicit variable (`now`, event times); bench-timing blocks that
    only measure wall-clock throughput carry a per-line suppression."""
    id = "R002"
    title = "wall-clock read inside simulation logic"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.in_dir("metro", "core"):
            return
        aliases = import_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve(node.func, aliases)
            if name is None:
                continue
            if name in _WALL_CLOCK:
                yield ctx.finding(
                    self.id, node,
                    f"`{name}` inside simulation logic: event timing "
                    f"must be a function of the seed, not the host "
                    f"clock (suppress only for bench-timing blocks)")
                continue
            parts = name.split(".")
            if parts[-1] in _DATETIME_CALLS and \
                    any(p in _DATETIME_HEADS for p in parts[:-1]):
                yield ctx.finding(
                    self.id, node,
                    f"`{name}` reads the wall clock inside simulation "
                    f"logic; thread simulated time instead")


# ------------------------------------------------------------------ R003

# numpy.random module-level constructors that ARE the seeded path
_NP_SEEDED = {"default_rng", "Generator", "SeedSequence", "PCG64",
              "PCG64DXSM", "Philox", "SFC64", "MT19937", "BitGenerator",
              "RandomState"}
# stdlib random functions that sample/mutate the hidden global state
_PY_RANDOM_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "lognormvariate",
    "expovariate", "betavariate", "gammavariate", "paretovariate",
    "weibullvariate", "vonmisesvariate", "triangular", "seed",
    "getrandbits", "randbytes", "binomialvariate",
}


class UnseededRNGRule(Rule):
    """Module-level RNG calls (``np.random.*`` legacy functions,
    stdlib ``random.*``) draw from hidden global state that any import
    or earlier call can perturb — results stop being a function of the
    passed seed. Thread a `np.random.default_rng(seed)` Generator or a
    `jax.random.PRNGKey` instead (DESIGN.md §6)."""
    id = "R003"
    title = "unseeded / global-state RNG call"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        aliases = import_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve(node.func, aliases)
            if name is None:
                continue
            parts = name.split(".")
            # numpy.random.<fn>(...): legacy global-state samplers
            if len(parts) >= 3 and parts[0] == "numpy" \
                    and parts[1] == "random" \
                    and parts[2] not in _NP_SEEDED:
                yield ctx.finding(
                    self.id, node,
                    f"`{name}` samples numpy's hidden global RNG; "
                    f"thread a seeded `np.random.default_rng` "
                    f"Generator instead")
                continue
            # numpy.random.default_rng() / RandomState() with no seed
            if len(parts) == 3 and parts[0] == "numpy" \
                    and parts[1] == "random" \
                    and parts[2] in ("default_rng", "RandomState") \
                    and not node.args and not node.keywords:
                yield ctx.finding(
                    self.id, node,
                    f"`{name}()` without a seed draws OS entropy — "
                    f"results are not reproducible; pass a seed")
                continue
            # stdlib random.<fn>(...) incl. `from random import choice`
            if parts[0] == "random" and len(parts) == 2 \
                    and parts[1] in _PY_RANDOM_FNS:
                yield ctx.finding(
                    self.id, node,
                    f"`{name}` uses the stdlib global RNG; thread a "
                    f"seeded `random.Random(seed)` (or better, a numpy "
                    f"Generator) instead")
                continue
            if parts[0] == "random" and len(parts) == 2 \
                    and parts[1] == "Random" \
                    and not node.args and not node.keywords:
                yield ctx.finding(
                    self.id, node,
                    "`random.Random()` without a seed is "
                    "OS-entropy-seeded; pass a seed")


# ------------------------------------------------------------------ R004

# consumers whose result does NOT depend on iteration order
_ORDER_FREE = {"sorted", "min", "max", "sum", "len", "any", "all",
               "set", "frozenset"}
# consumers that reveal iteration order
_ORDER_SENSITIVE = {"list", "tuple", "enumerate", "iter"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = dotted_name(node.func)
        if fn in ("set", "frozenset"):
            return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


class SetIterationRule(Rule):
    """Iterating a `set` reveals hash order, which for str keys varies
    with PYTHONHASHSEED across processes — if the order feeds event
    sequencing (heap pushes, appends, tie-prone sorts) the run is no
    longer a function of the seed. Wrap the set in `sorted(...)` or
    keep an insertion-ordered dict/list. Order-insensitive reductions
    (`min`/`max`/`sum`/`len`/`any`/`all`/membership) are exempt."""
    id = "R004"
    title = "order-revealing iteration over a set"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        msg = ("iteration order of a set is hash order "
               "(PYTHONHASHSEED-dependent for str); wrap in "
               "`sorted(...)` before it feeds event ordering")
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.AsyncFor)) \
                    and _is_set_expr(node.iter):
                yield ctx.finding(self.id, node.iter, msg)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                                   ast.DictComp)):
                for gen in node.generators:
                    if _is_set_expr(gen.iter):
                        yield ctx.finding(self.id, gen.iter, msg)
            elif isinstance(node, ast.Call):
                fn = dotted_name(node.func)
                if fn in _ORDER_SENSITIVE and node.args \
                        and _is_set_expr(node.args[0]):
                    yield ctx.finding(
                        self.id, node.args[0],
                        f"`{fn}(<set>)` materialises hash order; " + msg)


# ------------------------------------------------------------------ R005

_SAFE_ATTRS = {"shape", "dtype", "ndim", "size", "sharding", "aval"}
_HOST_CALLBACKS = ("pure_callback", "io_callback", "host_callback",
                   "call_tf")


def _jit_static_names(dec: ast.AST,
                      aliases: Dict[str, str]) -> Optional[Set[str]]:
    """If `dec` is a jax.jit decorator (bare or functools.partial),
    return its static_argnames as a set; else None."""
    if resolve(dec, aliases) == "jax.jit":
        return set()
    if isinstance(dec, ast.Call):
        fn = resolve(dec.func, aliases)
        if fn == "jax.jit":
            return _static_from_call(dec)
        if fn == "functools.partial" and dec.args \
                and resolve(dec.args[0], aliases) == "jax.jit":
            return _static_from_call(dec)
    return None


def _static_from_call(call: ast.Call) -> Set[str]:
    names: Set[str] = set()
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            for n in ast.walk(kw.value):
                if isinstance(n, ast.Constant) and isinstance(n.value,
                                                              str):
                    names.add(n.value)
    return names


def _param_names(fn: ast.FunctionDef) -> List[str]:
    a = fn.args
    params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        params.append(a.vararg.arg)
    if a.kwarg:
        params.append(a.kwarg.arg)
    return params


def _traced_refs(expr: ast.AST, traced: Set[str]) -> List[ast.Name]:
    """Name nodes in `expr` referring to traced params, EXCLUDING
    references that only touch static metadata (`x.shape`, `x.dtype`,
    `len(x)`, `isinstance(x, ...)`) — those are concrete Python values
    even on tracers."""
    out: List[ast.Name] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.Attribute) and \
                node.attr in _SAFE_ATTRS and \
                isinstance(node.value, ast.Name):
            return                       # x.shape et al: static metadata
        if isinstance(node, ast.Call):
            fn = dotted_name(node.func)
            if fn in ("len", "isinstance", "type"):
                return
        if isinstance(node, ast.Name) and node.id in traced:
            out.append(node)
            return
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return out


class TracedPythonLeakRule(Rule):
    """Inside a `@jax.jit` function or a Pallas kernel body, Python
    control flow on a traced argument, `.item()`/`float()`/`int()`
    coercion of a traced value, or a host callback either fails at
    trace time or silently bakes one traced value into the compiled
    graph. Branch on static args (static_argnames) or use `lax.cond`/
    `jnp.where`; read metadata via `.shape`/`.dtype` (always safe)."""
    id = "R005"
    title = "Python leaking into traced jit/pallas code"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        aliases = import_aliases(ctx.tree)
        defs: Dict[str, ast.FunctionDef] = {
            n.name: n for n in ast.walk(ctx.tree)
            if isinstance(n, ast.FunctionDef)}
        seen: Set[str] = set()
        # (a) decorated `@jax.jit` / `@functools.partial(jax.jit, ...)`
        for fn in defs.values():
            for dec in fn.decorator_list:
                statics = _jit_static_names(dec, aliases)
                if statics is not None:
                    seen.add(fn.name)
                    yield from self._check_fn(ctx, fn, statics)
                    break
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = resolve(node.func, aliases)
            # (b) `jax.jit(f, ...)` applied to a local def
            if name == "jax.jit" and node.args and \
                    isinstance(node.args[0], ast.Name):
                target = defs.get(node.args[0].id)
                if target is not None and target.name not in seen:
                    seen.add(target.name)
                    yield from self._check_fn(
                        ctx, target, _static_from_call(node))
            # (c) kernel body handed to pl.pallas_call — every param is
            # a traced Ref except those bound via functools.partial
            if name is not None and name.endswith("pallas_call") \
                    and node.args:
                kernel = node.args[0]
                bound: Set[str] = set()
                if isinstance(kernel, ast.Call) and \
                        resolve(kernel.func, aliases) == \
                        "functools.partial" and kernel.args:
                    bound = {kw.arg for kw in kernel.keywords if kw.arg}
                    kernel = kernel.args[0]
                if isinstance(kernel, ast.Name):
                    target = defs.get(kernel.id)
                    if target is not None and target.name not in seen:
                        seen.add(target.name)
                        yield from self._check_fn(ctx, target, bound)

    def _check_fn(self, ctx: FileContext, fn: ast.FunctionDef,
                  statics: Set[str]) -> Iterable[Finding]:
        traced = {p for p in _param_names(fn) if p not in statics}
        aliases = import_aliases(ctx.tree)
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                refs = _traced_refs(node.test, traced)
                if refs:
                    yield ctx.finding(
                        self.id, node,
                        f"Python `{type(node).__name__.lower()}` on "
                        f"traced value `{refs[0].id}` inside "
                        f"`{fn.name}`: branches must be static or go "
                        f"through lax.cond/jnp.where")
            elif isinstance(node, ast.Call):
                name = resolve(node.func, aliases)
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "item":
                    yield ctx.finding(
                        self.id, node,
                        f"`.item()` inside traced `{fn.name}` forces a "
                        f"host sync / fails under jit")
                elif name in ("float", "int", "bool") and node.args \
                        and _traced_refs(node.args[0], traced):
                    yield ctx.finding(
                        self.id, node,
                        f"`{name}()` coerces traced value inside "
                        f"`{fn.name}`; keep it as an array or make the "
                        f"arg static")
                elif name is not None and \
                        name.split(".")[-1] in _HOST_CALLBACKS:
                    yield ctx.finding(
                        self.id, node,
                        f"host callback `{name}` inside traced "
                        f"`{fn.name}` breaks pure compiled dispatch")


# ------------------------------------------------------------------ R006

_CACHED_DISPATCH = ("tabu_search_jax", "tabu_search_batched")
_DISPATCH_HOME = ("core/scheduler.py", "core/scheduler_jax.py")
_AOT_ATTRS = {"lower", "trace", "eval_shape"}


class JitDispatchBypassRule(Rule):
    """`jax.jit(f)(x)` builds a FRESH jit wrapper per call — every
    invocation retraces and recompiles. Hoist the jitted callable to a
    module/instance attribute. Likewise, calling the raw jitted
    scheduler kernels (`tabu_search_jax`/`tabu_search_batched`)
    anywhere but `scheduler.search`'s dispatcher bypasses the
    `_COMPILED_SHAPES` bucketed compile cache (DESIGN.md §3.3/§12) —
    shapes stop being bucketed and the retrace cost comes back.
    AOT use (`jax.jit(f).lower(...)`) is exempt: lowering is an
    explicit one-shot compile."""
    id = "R006"
    title = "jit dispatch bypassing the bucketed compile cache"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        aliases = import_aliases(ctx.tree)
        aot: Set[ast.Call] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) and \
                    node.attr in _AOT_ATTRS and \
                    isinstance(node.value, ast.Call) and \
                    resolve(node.value.func, aliases) == "jax.jit":
                aot.add(node.value)
        in_home = any(ctx.path.endswith(h) for h in _DISPATCH_HOME)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            # (a) immediately-invoked jax.jit(f)(...)
            if isinstance(node.func, ast.Call) and \
                    resolve(node.func.func, aliases) == "jax.jit" and \
                    node.func not in aot:
                yield ctx.finding(
                    self.id, node,
                    "`jax.jit(f)(...)` builds a fresh wrapper per call "
                    "and retraces every time; hoist the jitted "
                    "callable")
            # (b) raw scheduler-kernel calls outside the dispatcher
            name = resolve(node.func, aliases)
            if name is not None and not in_home and \
                    name.split(".")[-1] in _CACHED_DISPATCH:
                yield ctx.finding(
                    self.id, node,
                    f"direct `{name.split('.')[-1]}` call bypasses "
                    f"scheduler.search's _COMPILED_SHAPES bucketed "
                    f"dispatch (retrace hazard); route through "
                    f"scheduler.search/search_batched")


ALL_RULES: Tuple[Rule, ...] = (
    BareAssertRule(), WallClockRule(), UnseededRNGRule(),
    SetIterationRule(), TracedPythonLeakRule(), JitDispatchBypassRule())

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}
