"""Codebase-tuned JAX/NumPy lint rules over Python ASTs.

Rule catalog (ids are stable; severities feed the CLI exit code):

========  ========  ==================================================
id        severity  checks
========  ========  ==================================================
RNG001    error     legacy module-level ``np.random.*`` draws in
                    library/benchmark code (untracked global stream)
RNG002    error     ``jax.random`` key reuse: one key value flowing to
                    two consumers without an intervening ``split`` /
                    ``fold_in``, or consumed inside a loop/
                    comprehension without per-iteration derivation
RNG003    warning   hard-coded ``PRNGKey(<literal>)`` in library code
JIT001    error     ``jax.jit`` / ``jax.pmap`` invoked inside a loop
                    body (fresh wrapper + retrace risk per iteration)
JIT002    error     immediately-invoked ``jax.jit(f)(...)`` (wrapper
                    rebuilt per call; defeats the C++ dispatch path)
JIT003    error     ``static_argnums``/``static_argnames`` binding a
                    parameter with an unhashable (list/dict/set)
                    default, or passing a list/dict/set literal at a
                    static position of a module-local jitted function
DON001    error     read of a buffer after it was passed in a
                    ``donate_argnums`` position (use-after-donate)
HOST001   warning   ``.item()`` / ``float()`` / ``np.asarray()`` on a
                    non-trivial value inside a round/step loop (hidden
                    device->host sync every iteration)
OBS001    error     ``repro.obs`` Tracer/Metrics call inside a
                    jit-decorated (or module-level-jitted) function —
                    runs at trace time, not per execution
SHARD001  error     ``jax.lax`` collective (``psum``/``pmean``/...)
                    with a literal axis name in a function never wired
                    into a ``shard_map``/``pmap`` mesh context in its
                    module (unbound axis at trace time)
RES001    warning   bare ``assert`` in library code (stripped under
                    ``python -O``; resilience paths must fail loudly —
                    raise ``ValueError`` or use
                    ``repro.analysis.contracts``)
TIME001   warning   ``time.time()`` in library/benchmark/example code:
                    wall-clock is NTP-adjustable and coarse — use
                    ``time.perf_counter()`` for durations or the
                    engine's simulated clock for simulated time
========  ========  ==================================================

All rules resolve import aliases (``import numpy as np``, ``from jax
import random as jr``, ...) rather than matching bare attribute text.
Path-sensitivity is deliberately simple: statements are walked in
order, ``if``/``else`` branches analyzed on copies and merged, and
nested function bodies get fresh scopes — tuned to this repository's
idioms, preferring missed corner cases over false positives.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .findings import ERROR, WARNING

LIBRARY, BENCH, TEST, EXAMPLE = "library", "bench", "test", "example"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str
    kinds: Tuple[str, ...]     # file kinds the rule applies to
    summary: str
    check: Callable            # (FileContext) -> Iterator[(node, message)]


RULES: Dict[str, Rule] = {}


def register(id: str, name: str, severity: str, kinds: Sequence[str],
             summary: str):
    def deco(fn):
        RULES[id] = Rule(id=id, name=name, severity=severity,
                         kinds=tuple(kinds), summary=summary, check=fn)
        return fn
    return deco


@dataclasses.dataclass
class FileContext:
    """Everything a rule needs to know about one source file."""
    path: str                  # display path (posix, relative)
    kind: str                  # library | bench | test | example
    tree: ast.Module
    imports: Dict[str, str]    # local alias -> dotted origin
    donors: Dict[str, Tuple[int, ...]]   # project-wide donating callables


# ---------------------------------------------------------------------------
# Alias resolution
# ---------------------------------------------------------------------------
def build_import_table(tree: ast.Module) -> Dict[str, str]:
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                table[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                table[a.asname or a.name] = f"{node.module}.{a.name}"
    return table


def resolve(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Dotted origin of a Name/Attribute chain, or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = imports.get(node.id)
    if base is None:
        return None
    return ".".join([base] + list(reversed(parts)))


def _resolve_call(node: ast.Call, imports) -> Optional[str]:
    return resolve(node.func, imports)


def _is_jit_name(origin: Optional[str]) -> bool:
    return origin in ("jax.jit", "jax.pmap")


def _jit_callable_of(node: ast.Call, imports) -> Optional[ast.Call]:
    """Return ``node`` if it is a (possibly partial-wrapped) jit call."""
    origin = _resolve_call(node, imports)
    if _is_jit_name(origin):
        return node
    if origin == "functools.partial" and node.args:
        inner = node.args[0]
        if _is_jit_name(resolve(inner, imports)):
            return node
    return None


def _kwarg(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _const_ints(node: Optional[ast.expr]) -> Optional[Tuple[int, ...]]:
    """Literal int tuple/list value of an argnums expression."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, int)):
                return None
            vals.append(e.value)
        return tuple(vals)
    return None


def _const_strs(node: Optional[ast.expr]) -> Optional[Tuple[str, ...]]:
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            vals.append(e.value)
        return tuple(vals)
    return None


def iter_loops(tree: ast.AST):
    """(loop_node, body_statements) for every for/while loop, at any depth."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            yield node, list(node.body) + list(node.orelse)


def _walk_skip_defs(stmts: Sequence[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function bodies
    (their execution time is unrelated to the enclosing loop's)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# RNG001 — legacy global numpy RNG
# ---------------------------------------------------------------------------
_NPR_ALLOWED = {
    "default_rng", "Generator", "BitGenerator", "SeedSequence",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
}


@register("RNG001", "numpy-global-rng", ERROR, (LIBRARY, BENCH, EXAMPLE),
          "legacy np.random.* draw from the untracked global stream")
def check_rng001(ctx: FileContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        origin = _resolve_call(node, ctx.imports)
        if origin is None or not origin.startswith("numpy.random."):
            continue
        fn = origin.split(".")[2] if origin.count(".") >= 2 else ""
        if origin.count(".") == 2 and fn not in _NPR_ALLOWED:
            yield (node,
                   f"legacy global-stream call np.random.{fn}(...): thread "
                   f"an explicit np.random.Generator (default_rng) so seeds "
                   f"stay reproducible across call-order changes")


# ---------------------------------------------------------------------------
# RNG002 — jax PRNG key reuse
# ---------------------------------------------------------------------------
_KEY_MAKERS = {"PRNGKey", "key", "split", "fold_in", "clone"}
_KEY_NONCONSUMING = {"fold_in", "clone", "key_data", "PRNGKey", "key"}
_SAFE_CALLS = {"len", "print", "repr", "str", "id", "type", "isinstance",
               "list", "tuple", "hash"}


@dataclasses.dataclass
class _KeyInfo:
    uses: int = 0
    first_use: Optional[ast.AST] = None


def _param_key_kind(arg: ast.arg, imports) -> Optional[str]:
    """Is this parameter a PRNG key ("n"), a key stack ("a"), or neither?

    Named on the repo's conventions: anything containing "key" is a key;
    bare "rng" is ambiguous (numpy Generators share the name) and is only
    treated as a key when the annotation says so.
    """
    ann = resolve(arg.annotation, imports) if arg.annotation else None
    if ann and ("PRNGKey" in ann or "KeyArray" in ann):
        return "n"
    low = arg.arg.lower()
    if low in ("key", "subkey", "prngkey") or low.endswith("_key"):
        return "n"
    if low in ("keys", "subkeys") or low.endswith("_keys"):
        return "a"
    return None


class _KeyReuseScope:
    """Statement-order key tracking for one function (or module) body."""

    def __init__(self, ctx: FileContext, report):
        self.ctx = ctx
        self.report = report

    # -- key-expression identity -------------------------------------------
    def _key_id(self, node: ast.expr, state) -> Optional[Tuple]:
        if isinstance(node, ast.Name):
            for kind in ("n", "a"):
                if (kind, node.id) in state:
                    return (kind, node.id)
            return None
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, int)
                and ("a", node.value.id) in state):
            # per-index view into a split() stack; tracked lazily
            return ("s", node.value.id, node.slice.value)
        return None

    def _is_key_maker(self, node: ast.expr) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        origin = _resolve_call(node, self.ctx.imports)
        if origin and origin.startswith("jax.random."):
            fn = origin.rsplit(".", 1)[1]
            if fn in _KEY_MAKERS:
                return fn
        return None

    # -- state: dict key-id -> _KeyInfo ------------------------------------
    def run(self, body: Sequence[ast.stmt],
            fn: Optional[ast.AST] = None):
        state: Dict[Tuple, _KeyInfo] = {}
        if fn is not None:
            params = (list(getattr(fn.args, "posonlyargs", []))
                      + list(fn.args.args) + list(fn.args.kwonlyargs))
            for a in params:
                kind = _param_key_kind(a, self.ctx.imports)
                if kind is not None:
                    state[(kind, a.arg)] = _KeyInfo()
        self._walk(body, state, frozen=frozenset())

    def _walk(self, stmts, state, frozen):
        for stmt in stmts:
            self._stmt(stmt, state, frozen)

    def _clear_name(self, name, state):
        for k in [k for k in state
                  if k[1] == name or (k[0] == "s" and k[1] == name)]:
            del state[k]
        state.pop(("a", name), None)

    def _bind(self, target, value, state):
        maker = self._is_key_maker(value)
        if isinstance(target, ast.Name):
            self._clear_name(target.id, state)
            if maker in ("PRNGKey", "key", "fold_in", "clone"):
                state[("n", target.id)] = _KeyInfo()
            elif maker == "split":
                # one name holding a stack of keys: track per-index
                state[("a", target.id)] = _KeyInfo()
        elif isinstance(target, (ast.Tuple, ast.List)):
            if maker == "split":
                for el in target.elts:
                    if isinstance(el, ast.Name):
                        self._clear_name(el.id, state)
                        state[("n", el.id)] = _KeyInfo()
            else:
                for el in target.elts:
                    if isinstance(el, ast.Name):
                        self._clear_name(el.id, state)

    def _use(self, key_id, node, state, frozen):
        base = key_id[1]
        if base in frozen:
            self.report(node,
                        f"PRNG key '{base}' consumed inside a loop but "
                        f"derived outside it — every iteration reuses the "
                        f"same key value; split/fold_in per iteration")
            return
        info = state.get(key_id)
        if info is None:
            if key_id[0] != "s":
                return
            info = state.setdefault(key_id, _KeyInfo())
        info.uses += 1
        if info.uses == 1:
            info.first_use = node
        elif info.uses == 2:
            first = getattr(info.first_use, "lineno", "?")
            self.report(node,
                        f"PRNG key '{base}' reused (first consumed at line "
                        f"{first}) without an intervening split/fold_in — "
                        f"both consumers draw identical randomness")

    # -- expressions --------------------------------------------------------
    def _expr(self, node, state, frozen):
        if node is None:
            return
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            # comprehension == loop: outer keys consumed per element
            rebound = set()
            for gen in node.generators:
                for t in ast.walk(gen.target):
                    if isinstance(t, ast.Name):
                        rebound.add(t.id)
                self._expr(gen.iter, state, frozen)
            inner_frozen = (frozenset(k[1] for k in state) - rebound) | frozen
            elts = ([node.key, node.value] if isinstance(node, ast.DictComp)
                    else [node.elt])
            for e in elts:
                self._expr(e, state, inner_frozen)
            return
        if isinstance(node, ast.Call):
            origin = _resolve_call(node, self.ctx.imports)
            consuming = True
            if origin and origin.startswith("jax.random."):
                fn = origin.rsplit(".", 1)[1]
                consuming = fn not in _KEY_NONCONSUMING
            elif origin in _SAFE_CALLS or (
                    isinstance(node.func, ast.Name)
                    and node.func.id in _SAFE_CALLS):
                consuming = False
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                key_id = self._key_id(arg, state)
                if key_id is not None and consuming:
                    self._use(key_id, arg, state, frozen)
                else:
                    self._expr(arg, state, frozen)
            self._expr(node.func, state, frozen)
            return
        for child in ast.iter_child_nodes(node):
            self._expr(child, state, frozen)

    # -- statements ---------------------------------------------------------
    def _branch(self, bodies, state, frozen):
        """Analyze exclusive branches on copies; merge use counts by max."""
        snapshots = []
        for body in bodies:
            branch_state = {k: dataclasses.replace(v)
                            for k, v in state.items()}
            self._walk(body, branch_state, frozen)
            snapshots.append(branch_state)
        merged_keys = set()
        for snap in snapshots:
            merged_keys |= set(snap)
        state.clear()
        for k in merged_keys:
            infos = [snap[k] for snap in snapshots if k in snap]
            best = max(infos, key=lambda i: i.uses)
            state[k] = best

    def _loop_rebound(self, body) -> Set[str]:
        rebound = set()
        for node in _walk_skip_defs(body):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            rebound.add(n.id)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        rebound.add(n.id)
        return rebound

    def _stmt(self, stmt, state, frozen):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _KeyReuseScope(self.ctx, self.report).run(stmt.body, fn=stmt)
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value, state, frozen)
            for t in stmt.targets:
                self._bind(t, stmt.value, state)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._expr(stmt.value, state, frozen)
            self._bind(stmt.target, stmt.value, state)
            return
        if isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, state, frozen)
            if isinstance(stmt.target, ast.Name):
                self._clear_name(stmt.target.id, state)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, state, frozen)
            rebound = self._loop_rebound(stmt.body)
            for n in ast.walk(stmt.target):
                if isinstance(n, ast.Name):
                    rebound.add(n.id)
            inner_frozen = ((frozenset(k[1] for k in state) - rebound)
                            | frozen)
            self._branch([stmt.body], state, inner_frozen)
            self._walk(stmt.orelse, state, frozen)
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, state, frozen)
            rebound = self._loop_rebound(stmt.body)
            inner_frozen = ((frozenset(k[1] for k in state) - rebound)
                            | frozen)
            self._branch([stmt.body], state, inner_frozen)
            self._walk(stmt.orelse, state, frozen)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, state, frozen)
            self._branch([stmt.body, stmt.orelse], state, frozen)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr, state, frozen)
            self._walk(stmt.body, state, frozen)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, state, frozen)
            for h in stmt.handlers:
                self._walk(h.body, state, frozen)
            self._walk(stmt.orelse, state, frozen)
            self._walk(stmt.finalbody, state, frozen)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            self._expr(stmt.value, state, frozen)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, state, frozen)
            elif isinstance(child, ast.stmt):
                self._stmt(child, state, frozen)


@register("RNG002", "jax-key-reuse", ERROR, (LIBRARY, BENCH),
          "one jax.random key value flowing to two consumers")
def check_rng002(ctx: FileContext):
    found: List[Tuple[ast.AST, str]] = []
    scope = _KeyReuseScope(ctx, lambda node, msg: found.append((node, msg)))
    scope.run(ctx.tree.body)
    yield from found


# ---------------------------------------------------------------------------
# RNG003 — hard-coded PRNGKey literal in library code
# ---------------------------------------------------------------------------
@register("RNG003", "hardcoded-prngkey", WARNING, (LIBRARY,),
          "hard-coded PRNGKey(<literal>) in library code")
def check_rng003(ctx: FileContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        origin = _resolve_call(node, ctx.imports)
        if origin not in ("jax.random.PRNGKey", "jax.random.key"):
            continue
        if (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, int)):
            yield (node,
                   f"hard-coded {origin.rsplit('.', 1)[1]}"
                   f"({node.args[0].value}) in library code — thread the "
                   f"seed from config so callers control reproducibility")


# ---------------------------------------------------------------------------
# JIT001 — jit/pmap invoked inside a loop body
# ---------------------------------------------------------------------------
@register("JIT001", "jit-in-loop", ERROR, (LIBRARY, BENCH, EXAMPLE),
          "jax.jit / jax.pmap constructed inside a loop body")
def check_jit001(ctx: FileContext):
    seen: Set[int] = set()
    for loop, body in iter_loops(ctx.tree):
        for node in _walk_skip_defs(body):
            if (isinstance(node, ast.Call) and id(node) not in seen
                    and _jit_callable_of(node, ctx.imports) is not None):
                seen.add(id(node))
                yield (node,
                       "jax.jit constructed inside a loop: a fresh wrapper "
                       "is built (and its trace cache keyed) every "
                       "iteration — hoist the jit out of the loop")


# ---------------------------------------------------------------------------
# JIT002 — immediately-invoked jit
# ---------------------------------------------------------------------------
@register("JIT002", "jit-immediately-invoked", ERROR,
          (LIBRARY, BENCH, EXAMPLE),
          "jax.jit(f)(...) rebuilt at every call site execution")
def check_jit002(ctx: FileContext):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        inner = node.func
        if (isinstance(inner, ast.Call)
                and _is_jit_name(_resolve_call(inner, ctx.imports))):
            yield (node,
                   "immediately-invoked jax.jit(f)(...): the wrapper is "
                   "rebuilt on every execution of this line, defeating the "
                   "C++ dispatch fast path — bind the jitted function once "
                   "and call the bound name")


# ---------------------------------------------------------------------------
# JIT003 — unhashable static args
# ---------------------------------------------------------------------------
_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                     ast.SetComp)


def _jit_static_spec(call: ast.Call, imports):
    """(argnums, argnames) literals of a jit/partial-jit call, else None."""
    if _jit_callable_of(call, imports) is None:
        return None
    return (_const_ints(_kwarg(call, "static_argnums")),
            _const_strs(_kwarg(call, "static_argnames")))


def _module_jitted_statics(tree: ast.Module, imports) -> Dict[str, Tuple]:
    """name -> static argnums for module-level ``F = jax.jit(g, ...)``."""
    out = {}
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)):
            spec = _jit_static_spec(stmt.value, imports)
            if spec and spec[0]:
                out[stmt.targets[0].id] = spec[0]
    return out


@register("JIT003", "unhashable-static-arg", ERROR, (LIBRARY, BENCH),
          "static jit argument bound to an unhashable value")
def check_jit003(ctx: FileContext):
    # (a) decorated defs whose static parameter has a mutable default
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for deco in node.decorator_list:
            if not isinstance(deco, ast.Call):
                continue
            spec = _jit_static_spec(deco, ctx.imports)
            if spec is None:
                continue
            argnums, argnames = spec
            params = node.args.args
            defaults = node.args.defaults
            # defaults align with the TAIL of the positional params
            offset = len(params) - len(defaults)
            static_idx = set(argnums or ())
            for name in argnames or ():
                for i, p in enumerate(params):
                    if p.arg == name:
                        static_idx.add(i)
            for i in static_idx:
                di = i - offset
                if 0 <= di < len(defaults) and isinstance(
                        defaults[di], _MUTABLE_LITERALS):
                    yield (defaults[di],
                           f"static argument '{params[i].arg}' of jitted "
                           f"'{node.name}' defaults to an unhashable "
                           f"literal — static args are hashed into the "
                           f"compilation-cache key; use a tuple or None")
    # (b) list/dict/set literal passed at a static position of a
    #     module-local jitted callable
    statics = _module_jitted_statics(ctx.tree, ctx.imports)
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in statics):
            for i in statics[node.func.id]:
                if i < len(node.args) and isinstance(node.args[i],
                                                     _MUTABLE_LITERALS):
                    yield (node.args[i],
                           f"unhashable literal at static position {i} of "
                           f"jitted '{node.func.id}' — raises TypeError at "
                           f"trace time (or silently recompiles if "
                           f"converted); pass a hashable value")


# ---------------------------------------------------------------------------
# DON001 — use-after-donate
# ---------------------------------------------------------------------------
def collect_donors(tree: ast.Module, imports) -> Dict[str, Tuple[int, ...]]:
    """Donating callables defined in this module.

    * ``F = jax.jit(g, donate_argnums=(k,))`` at module level
    * ``@partial(jax.jit, donate_argnums=(k,))`` / ``@jax.jit(...)`` defs
    """
    donors: Dict[str, Tuple[int, ...]] = {}
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Call)
                and _jit_callable_of(stmt.value, imports) is not None):
            nums = _const_ints(_kwarg(stmt.value, "donate_argnums"))
            if nums:
                donors[stmt.targets[0].id] = nums
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for deco in node.decorator_list:
            if (isinstance(deco, ast.Call)
                    and _jit_callable_of(deco, imports) is not None):
                nums = _const_ints(_kwarg(deco, "donate_argnums"))
                if nums:
                    donors[node.name] = nums
    return donors


class _DonationScope:
    """Statement-order use-after-donate tracking for one function body."""

    def __init__(self, ctx: FileContext, report):
        self.ctx = ctx
        self.report = report

    def run(self, body):
        self._walk(body, {})

    def _walk(self, stmts, consumed: Dict[str, ast.AST]):
        for stmt in stmts:
            self._stmt(stmt, consumed)

    def _donated_positions(self, call: ast.Call) -> Tuple[int, ...]:
        if isinstance(call.func, ast.Name):
            return self.ctx.donors.get(call.func.id, ())
        if isinstance(call.func, ast.Attribute):
            # method-style or imported-module access: match on the attr
            return self.ctx.donors.get(call.func.attr, ())
        if isinstance(call.func, ast.Call):
            # inline jax.jit(g, donate_argnums=...)(args)
            if _jit_callable_of(call.func, self.ctx.imports) is not None:
                nums = _const_ints(_kwarg(call.func, "donate_argnums"))
                return nums or ()
        return ()

    def _expr(self, node, consumed, reading=True):
        """Walk an expression: report reads of consumed names, then apply
        any donations the expression performs (post-order, so
        ``params = f(params)`` reads before it consumes)."""
        if node is None or isinstance(node, (ast.Lambda, ast.FunctionDef)):
            return
        for sub in ast.walk(node):
            if (reading and isinstance(sub, ast.Name)
                    and isinstance(sub.ctx, ast.Load)
                    and sub.id in consumed):
                don = consumed[sub.id]
                self.report(sub,
                            f"'{sub.id}' read after being donated at line "
                            f"{getattr(don, 'lineno', '?')} — the buffer "
                            f"was consumed by a donate_argnums position "
                            f"and may alias the output; copy before "
                            f"donating or use the returned value")
                del consumed[sub.id]     # one report per donation
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                for pos in self._donated_positions(sub):
                    if pos < len(sub.args) and isinstance(sub.args[pos],
                                                          ast.Name):
                        consumed[sub.args[pos].id] = sub

    def _stmt(self, stmt, consumed):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _DonationScope(self.ctx, self.report).run(stmt.body)
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value, consumed)
            for t in stmt.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        consumed.pop(n.id, None)
            return
        if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            self._expr(stmt.value, consumed)
            if isinstance(stmt.target, ast.Name):
                consumed.pop(stmt.target.id, None)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, consumed)
            merged: Dict[str, ast.AST] = {}
            for body in (stmt.body, stmt.orelse):
                branch = dict(consumed)
                self._walk(body, branch)
                merged.update(branch)
            consumed.clear()
            consumed.update(merged)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, consumed)
            self._walk(stmt.body, consumed)
            self._walk(stmt.orelse, consumed)
            return
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, consumed)
            self._walk(stmt.body, consumed)
            self._walk(stmt.orelse, consumed)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr, consumed)
            self._walk(stmt.body, consumed)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, consumed)
            for h in stmt.handlers:
                self._walk(h.body, consumed)
            self._walk(stmt.orelse, consumed)
            self._walk(stmt.finalbody, consumed)
            return
        if isinstance(stmt, ast.Return):
            self._expr(stmt.value, consumed)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, consumed)
            elif isinstance(child, ast.stmt):
                self._stmt(child, consumed)


@register("DON001", "use-after-donate", ERROR, (LIBRARY, BENCH),
          "buffer read after being passed in a donate_argnums position")
def check_don001(ctx: FileContext):
    found: List[Tuple[ast.AST, str]] = []
    scope = _DonationScope(ctx, lambda node, msg: found.append((node, msg)))
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope.run(node.body)
    yield from found


# ---------------------------------------------------------------------------
# HOST001 — host sync inside round/step loops
# ---------------------------------------------------------------------------
_ROUND_NAMES = {"r", "rnd", "round", "round_index", "step", "epoch", "t",
                "i_round", "n_round"}
_ROUND_HINTS = ("round", "step", "epoch")


def _is_round_loop(loop) -> bool:
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        names = {n.id for n in ast.walk(loop.target)
                 if isinstance(n, ast.Name)}
        if names & _ROUND_NAMES:
            return True
        src_names = {getattr(n, "attr", getattr(n, "id", ""))
                     for n in ast.walk(loop.iter)}
    else:
        src_names = {getattr(n, "attr", getattr(n, "id", ""))
                     for n in ast.walk(loop.test)}
    return any(h in (name or "").lower()
               for name in src_names for h in _ROUND_HINTS)


_HOST_SYNC_CASTS = {"float", "int", "bool", "complex"}


@register("HOST001", "host-sync-in-loop", WARNING, (LIBRARY,),
          "device->host sync every iteration of a round/step loop")
def check_host001(ctx: FileContext):
    seen: Set[int] = set()
    for loop, body in iter_loops(ctx.tree):
        if not _is_round_loop(loop):
            continue
        for node in _walk_skip_defs(body):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            msg = None
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "item" and not node.args):
                msg = ".item() inside a round/step loop"
            elif (isinstance(node.func, ast.Name)
                    and node.func.id in _HOST_SYNC_CASTS
                    and len(node.args) == 1
                    and isinstance(node.args[0],
                                   (ast.Name, ast.Attribute, ast.Subscript))):
                msg = (f"{node.func.id}(...) on a computed value inside a "
                       f"round/step loop")
            else:
                origin = _resolve_call(node, ctx.imports)
                if origin in ("numpy.asarray", "numpy.array",
                              "jax.device_get") and node.args:
                    msg = (f"{origin.replace('numpy', 'np')}(...) inside a "
                           f"round/step loop")
            if msg:
                seen.add(id(node))
                yield (node,
                       f"{msg}: forces a device->host transfer and blocks "
                       f"dispatch every iteration — accumulate on device "
                       f"and read out after the loop")


# ---------------------------------------------------------------------------
# OBS001 — tracer/metrics call inside a jitted function
# ---------------------------------------------------------------------------
_OBS_METHODS = {"span", "event", "set_context", "flush", "counter", "gauge",
                "histogram", "inc", "set", "observe", "wall_now", "phase"}
_OBS_RECEIVERS = ("tracer", "metrics")


def _is_obs_call(node: ast.Call, imports) -> bool:
    """A call into ``repro.obs`` or ``repro_torch.obs`` (resolved import)
    or a method call whose receiver chain names a tracer/metrics object
    (``tracer.span(...)``, ``self.tracer.event(...)``,
    ``m.counter("x").inc()``)."""
    origin = _resolve_call(node, imports)
    if origin is not None and any(
            origin.startswith(pkg + ".") or origin == pkg
            for pkg in ("repro.obs", "repro_torch.obs")):
        return True
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr in _OBS_METHODS):
        return False
    for sub in ast.walk(f.value):
        ident = None
        if isinstance(sub, ast.Name):
            ident = sub.id
        elif isinstance(sub, ast.Attribute):
            ident = sub.attr
        if ident is not None:
            low = ident.lower()
            if any(low == r or low.endswith("_" + r) or low == "_" + r
                   for r in _OBS_RECEIVERS):
                return True
    return False


def _jitted_function_defs(tree: ast.Module, imports):
    """Function defs whose body runs under tracing: jit-decorated defs,
    plus defs bound by module-level ``F = jax.jit(g)``."""
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    seen: Set[int] = set()
    for node in defs.values():
        for deco in node.decorator_list:
            jitted = (_is_jit_name(resolve(deco, imports))
                      or (isinstance(deco, ast.Call)
                          and _jit_callable_of(deco, imports) is not None))
            if jitted and id(node) not in seen:
                seen.add(id(node))
                yield node
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)
                and _jit_callable_of(stmt.value, imports) is not None):
            args = stmt.value.args
            # jax.jit(g, ...) and partial(jax.jit, ...)(g) both put the
            # traced callable in the first positional argument
            target = args[0] if args else None
            if (_resolve_call(stmt.value, imports) == "functools.partial"
                    and len(args) >= 2):
                target = args[1]
            if (isinstance(target, ast.Name) and target.id in defs
                    and id(defs[target.id]) not in seen):
                seen.add(id(defs[target.id]))
                yield defs[target.id]


@register("OBS001", "obs-call-in-jit", ERROR, (LIBRARY, BENCH),
          "repro.obs Tracer/Metrics call inside a jitted function")
def check_obs001(ctx: FileContext):
    for fn in _jitted_function_defs(ctx.tree, ctx.imports):
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and _is_obs_call(node, ctx.imports)):
                continue
            # chained instrument calls (metrics.counter("x").inc()) match
            # twice; report only the innermost of the chain
            if (isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Call)
                    and _is_obs_call(node.func.value, ctx.imports)):
                continue
            yield (node,
                       f"tracer/metrics call inside jitted '{fn.name}': "
                       f"the Python call runs once at TRACE time (and "
                       f"again per retrace), not per execution — spans/"
                       f"metrics recorded here are wrong and a host "
                       f"callback would break async dispatch; hoist the "
                       f"instrumentation outside the compiled function")


# ---------------------------------------------------------------------------
# SHARD001: collective with a literal axis name outside shard_map context
# ---------------------------------------------------------------------------
_COLLECTIVES = {"psum", "pmean", "pmax", "pmin", "all_gather",
                "psum_scatter"}


def _is_shard_map_origin(origin: Optional[str]) -> bool:
    return origin is not None and (origin == "shard_map"
                                   or origin.endswith(".shard_map"))


def _collective_axis_arg(node: ast.Call) -> Optional[ast.expr]:
    """The axis-name argument of a ``jax.lax`` collective call (second
    positional, or the ``axis_name`` keyword)."""
    for kw in node.keywords:
        if kw.arg == "axis_name":
            return kw.value
    if len(node.args) >= 2:
        return node.args[1]
    return None


def _literal_axis_names(node: Optional[ast.expr]) -> Optional[List[str]]:
    """String-literal axis names of a collective call, or None when the
    axis flows in through a variable (helpers like
    ``hierarchical_weighted_psum`` take the axes as a parameter and are
    exercised under a caller's mesh — out of static reach, skipped)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        names = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            names.append(elt.value)
        return names or None
    return None


# ---------------------------------------------------------------------------
# RES001 — bare assert in library code
# ---------------------------------------------------------------------------
@register("RES001", "assert-in-library", WARNING, (LIBRARY,),
          "bare assert in library code vanishes under python -O")
def check_res001(ctx: FileContext):
    """``assert`` compiles to nothing under ``python -O``, so a guard
    written as one silently stops guarding in optimized runs — the
    opposite of what the resilience subsystem needs (faults must fail
    LOUDLY so recovery paths can engage).  Library code should raise
    ``ValueError``/``TypeError`` or route through
    ``repro.analysis.contracts``; ``assert`` stays fine in tests (where
    pytest rewrites it) and scratch/bench code."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assert):
            yield (node,
                   "bare assert in library code — stripped under "
                   "python -O, so the guard silently disappears; raise "
                   "ValueError (or use repro.analysis.contracts) so "
                   "invalid state fails loudly in every mode")


@register("SHARD001", "collective-outside-shard-map", ERROR,
          (LIBRARY, BENCH, EXAMPLE),
          "jax.lax collective with a literal axis name outside any "
          "shard_map context")
def check_shard001(ctx: FileContext):
    """``jax.lax.psum``/``pmean``/... with a LITERAL axis name is only
    meaningful inside a manual-mesh program: the axis must be bound by a
    ``shard_map`` (or ``pmap``) enclosing the traced function.  A
    collective whose enclosing function is never wired into one fails at
    runtime with an unbound-axis error — or worse, gets copy-pasted into
    a single-device path where it silently never reduces.

    A function counts as shard_map context when (in this module) it is
    passed to ``shard_map``/``pmap`` by name, or it lexically contains a
    ``shard_map``/``pmap`` call (the closure-factory idiom of
    ``CohortEngine._make_sharded_step``/``make_replica_agg_step``).
    Axis names arriving through parameters are skipped — preferring
    missed corner cases over false positives, per the module docstring.
    """
    imports = ctx.imports

    def _is_binder(origin: Optional[str]) -> bool:
        return _is_shard_map_origin(origin) or origin in (
            "jax.pmap", "jax.experimental.maps.xmap")

    # functions passed to shard_map/pmap by name anywhere in the module
    wired: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and _is_binder(
                _resolve_call(node, imports)):
            if node.args and isinstance(node.args[0], ast.Name):
                wired.add(node.args[0].id)

    def _contains_binder(fn: ast.AST) -> bool:
        return any(isinstance(n, ast.Call)
                   and _is_binder(_resolve_call(n, imports))
                   for n in ast.walk(fn))

    fn_types = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

    def visit(node: ast.AST, covered: bool):
        if isinstance(node, fn_types):
            name = getattr(node, "name", None)
            covered = (covered or name in wired
                       or _contains_binder(node))
        for child in ast.iter_child_nodes(node):
            yield from visit(child, covered)
        if not (isinstance(node, ast.Call) and not covered):
            return
        origin = _resolve_call(node, imports)
        if origin is None or not origin.startswith("jax.lax."):
            return
        op = origin.rsplit(".", 1)[1]
        if op not in _COLLECTIVES:
            return
        names = _literal_axis_names(_collective_axis_arg(node))
        if not names:
            return
        yield (node,
               f"jax.lax.{op} over axis {names!r} outside any shard_map/"
               f"pmap context: no enclosing function is wired into a "
               f"mesh here, so the axis name is unbound at trace time; "
               f"dispatch through shard_map (repro.compat.shard_map) or "
               f"take the axis names as a parameter like "
               f"repro.fl.aggregation.hierarchical_weighted_psum")

    yield from visit(ctx.tree, False)


# ---------------------------------------------------------------------------
# TIME001 — wall-clock used where a measurement is implied
# ---------------------------------------------------------------------------
@register("TIME001", "wall-clock-for-durations", WARNING,
          (LIBRARY, BENCH, EXAMPLE),
          "time.time() in measurement code (non-monotonic, coarse)")
def check_time001(ctx: FileContext):
    """Every ``time.time()`` call in library/bench/example code.

    ``time.time()`` is adjustable wall-clock (NTP slew, DST, manual
    resets) with platform-dependent resolution — a duration measured
    with it can come out negative.  This stack measures two kinds of
    time and has a right answer for both: ``time.perf_counter()`` for
    wall durations (the ``benchmarks.common.timeit_min`` / gateway
    ``wall_infer`` discipline) and the simulated clock
    (``trainer.wall_clock`` / span ``t_sim``) for simulated time.
    Genuine epoch timestamps are rare enough to baseline explicitly.
    """
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Call)
                and _resolve_call(node, ctx.imports) == "time.time"):
            yield (node,
                   "time.time() is non-monotonic wall-clock (NTP slew "
                   "can run it backwards) with coarse resolution: use "
                   "time.perf_counter() for durations, or the simulated "
                   "clock (trainer.wall_clock / span t_sim) for "
                   "simulated time; baseline the rare real timestamp")
