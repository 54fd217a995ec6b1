"""Checker 13: capture purity (SA013), the rule of
``spfft_tpu/analysis/purity.py`` (jit purity) for the port's fused path.

On the fused path a direction runs as one CUDA graph: its stage bodies run
for real once, at capture, and every later call REPLAYS the recorded kernels
without running a line of Python. A side effect inside captured code is the
hazard of one inside ``jax.jit``-traced code — it happens once, at capture,
and silently freezes: a metric counter bumped inside a ``_st_*`` stage body
increments once per capture (the dispatch counts lie forever after), a
``time.*`` read becomes a constant, an ``os.environ`` / ``knobs`` read pins
the knob's capture-time value into the graph (the runtime knob appears to
work until the program is cached), and a flight-recorder event records
captures instead of executions.

Captured scopes are found statically, name-based and conservative:

* every function or method named ``_st_*`` — the stage bodies the IR lowers
  into fused programs (``ir/lower.py``),
* the body of every ``with torch.cuda.graph(...)`` statement, and every
  same-file function or method called by name there (resolved through one
  level, the JAX checker's resolution of a function passed to ``jit``).

Host-side orchestration around the replay (``_Program.__call__``,
``EngineIr._run``) stays free to count and trace — that is exactly where
those effects belong.
"""
from __future__ import annotations

import ast

from .core import PACKAGE_DIRS, Tree, checker

STAGE_PREFIX = "_st_"

# receivers whose method calls are impure inside a capture
TRACE_EMITTERS = ("event", "span", "operation")
METRIC_MUTATORS = ("inc", "observe")
INSTRUMENT_FACTORIES = ("counter", "gauge", "histogram")


def _call_name(call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _root_name(expr):
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _impurity(call) -> str | None:
    """A description when ``call`` is an effect that must not be captured."""
    fn = call.func
    if isinstance(fn, ast.Name):
        if fn.id == "getenv":
            return "os.getenv(...) read (frozen at capture)"
        return None
    if not isinstance(fn, ast.Attribute):
        # call-of-call (`partial(f, a)(*args)`) / subscripted callables: no
        # attribute chain to inspect — not one of the effect shapes above
        return None
    root = _root_name(fn)
    if root == "time":
        return f"time.{fn.attr}(...) (a capture-time constant)"
    if root == "os" and fn.attr in ("getenv",):
        return "os.getenv(...) read (frozen at capture)"
    if root == "knobs" or (
        isinstance(fn.value, ast.Attribute) and fn.value.attr == "knobs"
    ):
        return f"knobs.{fn.attr}(...) read (frozen at capture)"
    if fn.attr in TRACE_EMITTERS and root in ("trace", "obs"):
        return f"trace.{fn.attr}(...) emission (records captures, " \
            "not executions)"
    if fn.attr in METRIC_MUTATORS:
        return f".{fn.attr}() metric mutation (bumps once per capture)"
    if fn.attr in INSTRUMENT_FACTORIES and root == "obs":
        return f"obs.{fn.attr}(...) instrument creation"
    return None


def _has_environ(node) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "environ"
        and isinstance(node.value, ast.Name)
        and node.value.id == "os"
    )


def _is_capture(item) -> bool:
    """Whether a with-item opens a CUDA-graph capture
    (``torch.cuda.graph(...)`` / ``cuda.graph(...)``)."""
    expr = item.context_expr
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "graph"
        and _root_name(expr.func) in ("torch", "cuda")
    )


def _captured_scopes(mod) -> list:
    """(node, why) scopes of one module that run at capture:
    ``_st_*`` bodies, the bodies of ``with torch.cuda.graph(...)``
    statements, and the same-file functions called by name in them."""
    by_name: dict = {}
    for node in ast.walk(mod):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, node)
    out = []
    seen: set = set()

    def note(node, why):
        if id(node) not in seen:
            seen.add(id(node))
            out.append((node, why))

    for node in ast.walk(mod):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.startswith(STAGE_PREFIX):
                note(node, f"stage body {node.name}")
        if not (
            isinstance(node, (ast.With, ast.AsyncWith))
            and any(_is_capture(item) for item in node.items)
        ):
            continue
        note(node, "under torch.cuda.graph capture")
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                name = _call_name(sub)
                if name in by_name:
                    note(
                        by_name[name],
                        f"{name} called under torch.cuda.graph capture",
                    )
    return out


@checker(
    "jit-purity",
    code="SA013",
    doc="Capture purity: no metric increments, trace events, time.* reads, "
    "os.environ/knobs reads, or instrument creation inside a _st_* stage "
    "body, the body of a torch.cuda.graph(...) capture, or a same-file "
    "function called there — on the fused path such code runs once, at "
    "capture, and never at replay, so its side effects silently freeze "
    "(a counter that lies, a knob that stops responding). Captured scopes "
    "are resolved name-based within one file; host-side orchestration "
    "around the replay is exempt by construction.",
)
def check_jit_purity(tree: Tree):
    findings = []
    for rel in tree.py_files(PACKAGE_DIRS):
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue
        for scope, why in _captured_scopes(mod):
            nodes = []
            for stmt in scope.body:
                nodes.extend(ast.walk(stmt))
            for node in nodes:
                if isinstance(node, ast.Call):
                    desc = _impurity(node)
                    if desc:
                        findings.append(
                            check_jit_purity.finding(
                                rel, node.lineno,
                                f"impure {desc} inside captured code "
                                f"({why}) — hoist it to the host-side "
                                "caller",
                            )
                        )
                elif _has_environ(node):
                    findings.append(
                        check_jit_purity.finding(
                            rel, node.lineno,
                            f"os.environ read inside captured code ({why}) — "
                            "resolve the knob before the capture and close "
                            "over the value",
                        )
                    )
    return findings
