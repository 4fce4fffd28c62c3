"""The lint rules of the port (tier 1), in torch's spellings (PyTorch
port of ``analysis/rules.py``).

Every rule is a small, conservative AST check: it flags only patterns it
can see locally and resolves names through the module's imports, so the
false-positive rate stays near zero at the cost of missing exotic
constructions.  Each rule documents its exact trigger in ``doc`` and has a
minimal positive + negative fixture under ``tests/fixtures/lint_torch/``.

Four of the JAX package's eight rules carry a meaning in torch and are
here, each with the JAX rule's reach:

- ``key-reuse`` over ``utils/random.py``'s threefry keys (the port's
  ``jax.random``);
- ``unfenced-blocking-read``: ``torch.cuda.synchronize()``, stream and
  event ``.synchronize()``, bare future joins, and host conversions of a
  ``.predict*()`` result or a random draw, outside a timed fence;
- ``f64-upcast``: ``torch.float64``/``torch.double``, ``.double()``,
  ``torch.set_default_dtype(torch.float64)``;
- ``unclosed-span``, which has no framework in it and is unchanged.

Four do not port, because the port traces nothing: ``traced-branch``
(Python branching on a tracer: torch runs Python eagerly, a branch on a
tensor is a host read, which ``unfenced-blocking-read`` and the
contracts' host-read budget cover), ``static-args`` (non-hashable
``static_argnums``: there is no jit cache key), ``jit-mutable-closure``
(a jitted closure freezing mutable state at trace time: nothing is
traced, so a closure reads its state live) and ``host-call-in-jit``
(host calls baked in at trace time: every call runs at call time).

Shared machinery: :class:`ImportMap` resolves dotted names through the
module's imports (``rnd.split`` ->
``spark_ensemble_tpu_torch.utils.random.split``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from spark_ensemble_tpu_torch.analysis.lint import (
    FileContext,
    Finding,
    LintRule,
    register_rule,
)


class ImportMap:
    """Resolve AST name/attribute chains to canonical dotted paths."""

    def __init__(self, tree: ast.Module):
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:  # relative imports stay package-local
                    continue
                for a in node.names:
                    self.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}"
                    )

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path for a Name/Attribute chain with the import alias
        expanded, or None for non-name expressions."""
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        head = self.aliases.get(cur.id, cur.id)
        return ".".join([head] + list(reversed(parts)))



def _call_path(ctx: FileContext, node: ast.AST) -> Optional[str]:
    return ctx.imports.resolve(node)


def _walk_scope(fn_node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body WITHOUT descending into nested defs/lambdas
    (they are separate scopes)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# rule: key-reuse
# ---------------------------------------------------------------------------

#: the port's random module (``jax.random``'s threefry draws, bit for bit)
_RANDOM = "spark_ensemble_tpu_torch.utils.random"

#: ``utils/random.py`` functions that CONSUME a key (same key in -> same
#: draw out); ``split`` is included — splitting the same key twice yields
#: identical children.  ``fold_in`` derives and is exempt unless folded
#: with the same literal twice.
_KEY_CONSUMERS = {
    "bernoulli", "bootstrap_weights", "permutation", "poisson", "randint",
    "random_bits", "split", "subspace_mask", "uniform",
}

#: calls whose results are keys
_KEY_MAKERS = ("PRNGKey", "split", "fold_in", "member_keys")

_KEY_PARAM_HINT = ("key", "keys", "rng", "prng")


def _is_key_name(name: str) -> bool:
    low = name.lower()
    return low in _KEY_PARAM_HINT or low.endswith("_key") or low.endswith("_rng")


@register_rule
class KeyReuseRule(LintRule):
    id = "key-reuse"
    doc = (
        "A PRNG key variable is consumed by two `utils/random.py` draws "
        "(`split`, `uniform`, `bernoulli`, `randint`, `poisson`, "
        "`permutation`, `random_bits`, `bootstrap_weights`, "
        "`subspace_mask`) without being re-derived in between — the "
        "second draw repeats the first's randomness bit-for-bit.  Thread "
        "keys with `key, sub = split(key)` or derive with "
        "`fold_in(key, step)`; `fold_in` with distinct data is exempt, "
        "folding the same literal twice is flagged."
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        fns: List[ast.AST] = [ctx.tree]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.append(node)
        for fn in fns:
            yield from self._check_scope(ctx, fn)

    def _key_vars(self, ctx, fn) -> Set[str]:
        """Names that plausibly hold PRNG keys in this scope: parameters
        with key-ish names plus assignment targets of PRNGKey/split/
        fold_in/member_keys results."""
        names: Set[str] = set()
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = fn.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                if _is_key_name(arg.arg):
                    names.add(arg.arg)
        for node in _walk_scope(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not isinstance(node.value, ast.Call):
                continue
            path = _call_path(ctx, node.value.func) or ""
            if path in tuple(f"{_RANDOM}.{m}" for m in _KEY_MAKERS):
                for target in node.targets:
                    elts = (
                        target.elts
                        if isinstance(target, (ast.Tuple, ast.List))
                        else [target]
                    )
                    for e in elts:
                        if isinstance(e, ast.Name):
                            names.add(e.id)
        return names

    def _check_scope(self, ctx, fn) -> Iterator[Finding]:
        key_vars = self._key_vars(ctx, fn)
        if not key_vars:
            return
        # statement-ordered linear scan: consumption marks the var dirty,
        # any reassignment of the var resets it
        consumed: Dict[str, int] = {}
        fold_literals: Dict[Tuple[str, object], int] = {}

        class _V(ast.NodeVisitor):
            def __init__(self, outer):
                self.findings: List[Finding] = []
                self.outer = outer

            def visit_FunctionDef(self, node):  # separate scope
                return

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(self, node):
                return

            def visit_Call(self, node):
                path = _call_path(ctx, node.func) or ""
                if path.startswith(_RANDOM + ".") and node.args:
                    arg0 = node.args[0]
                    op = path.rsplit(".", 1)[1]
                    if isinstance(arg0, ast.Name) and arg0.id in key_vars:
                        if op in _KEY_CONSUMERS:
                            prev = consumed.get(arg0.id)
                            if prev is not None:
                                self.findings.append(
                                    self.outer.finding(
                                        ctx, node,
                                        f"PRNG key `{arg0.id}` consumed "
                                        f"again by random.{op} (first "
                                        f"consumed on line {prev}) without "
                                        "re-derivation: identical randomness",
                                    )
                                )
                            else:
                                consumed[arg0.id] = node.lineno
                        elif op == "fold_in" and len(node.args) > 1:
                            try:
                                lit = ast.literal_eval(node.args[1])
                            except (ValueError, SyntaxError):
                                lit = None
                            if lit is not None:
                                k = (arg0.id, lit)
                                prev = fold_literals.get(k)
                                if prev is not None:
                                    self.findings.append(
                                        self.outer.finding(
                                            ctx, node,
                                            f"`fold_in({arg0.id}, {lit!r})` "
                                            f"repeats line {prev}: both "
                                            "derive the SAME child key",
                                        )
                                    )
                                else:
                                    fold_literals[k] = node.lineno
                self.generic_visit(node)

            def visit_Assign(self, node):
                self.visit(node.value)  # RHS reads before LHS rebinds
                for target in node.targets:
                    elts = (
                        target.elts
                        if isinstance(target, (ast.Tuple, ast.List))
                        else [target]
                    )
                    for e in elts:
                        if isinstance(e, ast.Name):
                            consumed.pop(e.id, None)
                            for k in [
                                fk for fk in fold_literals if fk[0] == e.id
                            ]:
                                fold_literals.pop(k, None)

            def visit_If(self, node):
                # branches are mutually exclusive draws, not reuse: run each
                # with its own state and merge only the fall-through paths
                self.visit(node.test)
                base = (dict(consumed), dict(fold_literals))
                taken = []
                for branch in (node.body, node.orelse):
                    consumed.clear()
                    consumed.update(base[0])
                    fold_literals.clear()
                    fold_literals.update(base[1])
                    for stmt in branch:
                        self.visit(stmt)
                    if not _terminates(branch):
                        taken.append(
                            (dict(consumed), dict(fold_literals))
                        )
                consumed.clear()
                fold_literals.clear()
                if taken:
                    # a key counts as consumed after the If only if EVERY
                    # fall-through branch consumed it
                    for name in set.intersection(
                        *[set(c) for c, _ in taken]
                    ):
                        consumed[name] = min(c[name] for c, _ in taken)
                    for k in set.intersection(
                        *[set(f) for _, f in taken]
                    ):
                        fold_literals[k] = min(f[k] for _, f in taken)

        def _terminates(branch) -> bool:
            return bool(branch) and isinstance(
                branch[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
            )

        visitor = _V(self)
        body = fn.body if hasattr(fn, "body") else []
        for stmt in body:
            visitor.visit(stmt)
        yield from visitor.findings


# ---------------------------------------------------------------------------
# rule: unfenced-blocking-read
# ---------------------------------------------------------------------------

#: modules that ARE the fence implementation: reads there are the
#: measurement, not a hazard
_FENCE_MODULES = (
    "spark_ensemble_tpu_torch/telemetry/",
    "spark_ensemble_tpu_torch/utils/instrumentation.py",
    "spark_ensemble_tpu_torch/utils/profiling.py",
)

#: calls whose results live on the device — converting them to host
#: values is a synchronous device->host fetch
_DEVICE_PRODUCERS = ("predict", "predict_proba", "predict_raw")

#: host conversions: functions around a device value, and tensor methods
#: on one
_HOST_FUNCS = ("numpy.asarray", "numpy.array", "float", "int", "bool")
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")


@register_rule
class UnfencedBlockingReadRule(LintRule):
    id = "unfenced-blocking-read"
    doc = (
        "A blocking device read — `torch.cuda.synchronize()`, a stream "
        "or event `.synchronize()`, a bare concurrent-futures "
        "`.result()` join (the data plane's shard waits), or "
        "`.item()`/`.tolist()`/`.cpu()`/`.numpy()`/`np.asarray`/"
        "`float`/`int`/`bool` taken directly of a `.predict*()` result "
        "or a `utils/random.py` draw — outside a timed fence.  Unfenced "
        "reads serialize the host against the device inside the "
        "dispatch window, the stall the lookahead pipeline "
        "(execution.py) exists to hide, and unmeasured ones corrupt the "
        "`host_blocked_us` accounting.  A read is fenced when it sits "
        "between a `t = time.perf_counter()` assignment and a "
        "`time.perf_counter() - t` readout in the same function, inside "
        "a `with telem.span(...)` block, or is charged via "
        "`FitTelemetry.blocking_read`/`host_blocked`.  The telemetry and "
        "instrumentation modules (the fence implementation) are exempt."
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        rel = ctx.relpath.replace("\\", "/")
        if any(rel.startswith(m) or rel == m for m in _FENCE_MODULES):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            desc = self._blocking_desc(ctx, node)
            if desc is None:
                continue
            if self._is_fenced(ctx, node):
                continue
            yield self.finding(
                ctx, node,
                f"unfenced blocking device read ({desc}): wrap in a "
                "perf_counter fence / telem.span, charge it via "
                "FitTelemetry.blocking_read, or suppress with a reason",
            )

    def _device_value(self, ctx, node) -> Optional[str]:
        """What device value ``node`` is, when it is a call that produces
        one: a ``.predict*()`` result or a random draw."""
        if not isinstance(node, ast.Call):
            return None
        if isinstance(node.func, ast.Attribute) and node.func.attr in _DEVICE_PRODUCERS:
            return f"`.{node.func.attr}()`"
        path = _call_path(ctx, node.func) or ""
        if path.startswith(_RANDOM + ".") and path.rsplit(".", 1)[1] in _KEY_CONSUMERS:
            return f"`{path.rsplit('.', 1)[1]}` draw"
        return None

    def _blocking_desc(self, ctx, node: ast.Call) -> Optional[str]:
        path = _call_path(ctx, node.func)
        if path == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "synchronize" and not node.args:
                return "stream/event .synchronize()"
            # a bare concurrent-futures join: `<fut>.result()` with no
            # timeout parks the host exactly like a device read (the
            # prefetcher's shard waits, data/prefetch.py); timeout-bounded
            # joins are outside the dispatch-window hazard
            if attr == "result" and not node.args and not node.keywords:
                return ".result() future join"
            # a tensor method taken directly of a device value
            if attr in _HOST_METHODS and not node.args:
                what = self._device_value(ctx, node.func.value)
                if what:
                    return f"`.{attr}()` of {what}"
        # a host conversion wrapped DIRECTLY around a device value
        if path in _HOST_FUNCS and node.args:
            what = self._device_value(ctx, node.args[0])
            if what:
                return f"host conversion of {what}"
        return None

    def _is_fenced(self, ctx, node) -> bool:
        fn = ctx.enclosing_function(node)
        if fn is None:
            return False
        # inside `with <x>.span(...)` / `with <x>.blocking_read(...)`
        cur = ctx.parents.get(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    e = item.context_expr
                    if (
                        isinstance(e, ast.Call)
                        and isinstance(e.func, ast.Attribute)
                        and e.func.attr in ("span", "blocking_read")
                    ):
                        return True
            cur = ctx.parents.get(cur)
        # timed fence: a perf_counter assignment at-or-above the read and
        # a `perf_counter() - t` readout at-or-below it
        line = node.lineno
        starts: List[int] = []
        ends: List[int] = []
        charges: List[int] = []
        for sub in _walk_scope(fn):
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Call
            ):
                if _call_path(ctx, sub.value.func) == "time.perf_counter":
                    starts.append(sub.lineno)
            elif isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Sub):
                if (
                    isinstance(sub.left, ast.Call)
                    and _call_path(ctx, sub.left.func) == "time.perf_counter"
                ):
                    ends.append(sub.lineno)
            elif isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute
            ):
                # a telem.blocking_read/host_blocked/round_chunk(fence=...)
                # call: the wait is charged there, so reads BELOW it touch
                # already-fenced arrays and do not block
                if sub.func.attr in (
                    "blocking_read", "host_blocked", "round_chunk"
                ):
                    charges.append(sub.lineno)
        if any(c <= line for c in charges):
            return True
        return any(s <= line for s in starts) and any(
            e >= line for e in ends
        )


# ---------------------------------------------------------------------------
# rule: f64-upcast
# ---------------------------------------------------------------------------

_TORCH_F64 = ("torch.float64", "torch.double")


@register_rule
class F64UpcastRule(LintRule):
    id = "f64-upcast"
    doc = (
        "An explicit float64 on the device path — `torch.float64` or "
        "`torch.double` (as a `dtype=`, a `.to(...)` target or any other "
        "use), a `.double()` call, or "
        "`torch.set_default_dtype(torch.float64)` — violating the "
        "package's f32 dtype policy (every kernel, packed model and "
        "histogram is f32; a float64 tensor doubles bandwidth and runs "
        "at a small fraction of the card's f32 rate).  Host-side "
        "`np.float64` accounting is exempt; a deliberate emulation of "
        "the reference's arithmetic takes a justified suppression."
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                cpath = _call_path(ctx, node.func) or ""
                if (
                    cpath == "torch.set_default_dtype"
                    and node.args
                    and _call_path(ctx, node.args[0]) in _TORCH_F64
                ):
                    yield self.finding(
                        ctx, node,
                        "torch.set_default_dtype(float64) flips every "
                        "default dtype to f64: forbidden by the f32 policy",
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "double"
                    and not node.args
                    and cpath != "torch.double"
                ):
                    yield self.finding(
                        ctx, node,
                        "`.double()` on the device path: f32 policy "
                        "violation",
                    )
                continue
            if not isinstance(node, ast.Attribute):
                continue
            path = _call_path(ctx, node)
            if path not in _TORCH_F64:
                continue
            parent = ctx.parents.get(node)
            if (
                isinstance(parent, ast.Call)
                and _call_path(ctx, parent.func) == "torch.set_default_dtype"
            ):
                continue  # reported once, as the call
            if isinstance(parent, ast.Attribute):
                continue  # `torch.float64.itemsize`-style metadata reads
            yield self.finding(
                ctx, parent if parent is not None else node,
                f"`{path}` violates the f32 dtype policy: device "
                "tensors are f32 end-to-end",
            )


# ---------------------------------------------------------------------------
# rule: unclosed-span
# ---------------------------------------------------------------------------

#: call names that start a telemetry span (telemetry/trace.py)
_SPAN_STARTERS = ("begin_span", "start_span", "trace_span")


@register_rule
class UnclosedSpanRule(LintRule):
    id = "unclosed-span"
    doc = (
        "A telemetry span is started (`begin_span`/`start_span`/"
        "`trace_span`) but its end is not syntactically guaranteed: the "
        "result is discarded as a bare statement, or bound to a local "
        "name that is neither entered as `with <name>:` nor `.end()`-ed "
        "inside a `try/finally` in the same function.  A span that can "
        "skip its `end()` on an exception path never emits — the trace "
        "silently loses the exact unit of work that failed "
        "(docs/tracing.md).  Handing the span to another call, returning "
        "it, storing it in a container/attribute, or using the `with` "
        "form are all fine — ownership moved somewhere that ends it."
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            elif isinstance(node.func, ast.Name):
                fname = node.func.id
            else:
                continue
            if fname not in _SPAN_STARTERS:
                continue
            msg = self._classify(ctx, node)
            if msg is not None:
                yield self.finding(ctx, node, msg)

    def _classify(self, ctx, call: ast.Call) -> Optional[str]:
        """None == the span's end is guaranteed (or ownership moved);
        a message == flag it.  Conservative: only the two provably-leaky
        shapes (dropped result, local bind with no with/finally end) are
        flagged."""
        cur: ast.AST = call
        parent = ctx.parents.get(cur)
        while parent is not None:
            if isinstance(parent, ast.withitem):
                return None  # `with ...begin_span(...):` — exit guaranteed
            if isinstance(parent, ast.Call) and cur is not parent.func:
                return None  # handed to another call (append, ctor, ...)
            if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom)):
                return None  # ownership transferred to the caller
            if isinstance(parent, ast.Expr):
                return (
                    "span started and immediately discarded: nothing can "
                    "ever end it (use `with`, or bind it and end in a "
                    "finally)"
                )
            if isinstance(parent, ast.Assign):
                return self._check_assign(ctx, parent, call)
            if isinstance(
                parent,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                 ast.Module),
            ):
                return None
            cur, parent = parent, ctx.parents.get(parent)
        return None

    def _check_assign(self, ctx, assign: ast.Assign, call) -> Optional[str]:
        names: List[str] = []
        for t in assign.targets:
            if isinstance(t, ast.Name):
                names.append(t.id)
            else:
                # attribute/subscript/tuple target: the span lives in a
                # structure whose owner is responsible for ending it
                return None
        fn = ctx.enclosing_function(call) or ctx.tree
        for name in names:
            if self._end_guaranteed(fn, name):
                return None
        name = names[0] if names else "?"
        return (
            f"span bound to `{name}` with no guaranteed end in this "
            f"function: enter it (`with {name}:`) or call `{name}.end()` "
            "inside a try/finally"
        )

    @staticmethod
    def _end_guaranteed(fn, name: str) -> bool:
        for sub in _walk_scope(fn):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    e = item.context_expr
                    if isinstance(e, ast.Name) and e.id == name:
                        return True
            elif isinstance(sub, ast.Try):
                for stmt in sub.finalbody:
                    for n in ast.walk(stmt):
                        if (
                            isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Attribute)
                            and n.func.attr in ("end", "__exit__")
                            and isinstance(n.func.value, ast.Name)
                            and n.func.value.id == name
                        ):
                            return True
        return False
