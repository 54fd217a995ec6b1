"""Checker 19: blocking while traced (SA019), the rule of
``spfft_tpu/analysis/tracedblock.py`` over the port's package code, with the
port's third traced scope: ``timing.trace_annotation`` ranges (the
``torch.profiler`` ranges of the staged path and the tuning trials).

``timing.scoped`` phases double as flight-recorder ``phase`` spans and as
the host timing tree's nodes; ``trace.span``/``trace.operation`` scopes
are the execution trace's duration slices. Their whole value is that a
span measures THE OPERATION IT NAMES — a ``dispatch`` span that also
waits on a lock, or a retry span that sleeps its backoff inside the
scope, reports contention and backoff as if they were dispatch time:
the perf attribution and every Chrome-trace reading of the span are
silently wrong, exactly the class of lie the observability layers exist
to prevent.

Rule: inside the body of a ``with timing.scoped(...)`` /
``timing.trace_annotation(...)`` / ``trace.span(...)`` /
``trace.operation(...)`` statement, no

* ``time.sleep(...)`` call (backoffs belong OUTSIDE the span, the
  supervisor/wisdom retry rule),
* lock acquisition — a ``with <lock>`` item or a ``.acquire()`` call on a
  lock this file can resolve (module-level, ``self.<attr>``, or local
  ``threading.X()`` bindings, the SA011 resolution).

Direct statements only, conservatively: calls into other functions that
acquire locks are the lock checker's transitive territory (SA011 flags a
lock held across sleeps/waits from the other side), and nested function
bodies execute outside the span. The runtime lockdep layer observes the
dynamic cases at real acquisitions.
"""
from __future__ import annotations

import ast

from .core import Tree, checker
from .locks import LockIndex, _stmt_lists

TIMING_SPAN_ATTRS = ("scoped", "trace_annotation")
TRACE_SPAN_ATTRS = ("span", "operation")


def _span_desc(item) -> str | None:
    """A description when a with-item opens a timing/trace span."""
    expr = item.context_expr
    if not (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute)):
        return None
    fn = expr.func
    recv = fn.value
    recv_name = None
    if isinstance(recv, ast.Name):
        recv_name = recv.id
    elif isinstance(recv, ast.Attribute):
        recv_name = recv.attr
    if fn.attr in TIMING_SPAN_ATTRS and recv_name == "timing":
        label = ""
        if expr.args and isinstance(expr.args[0], ast.Constant):
            label = f" {expr.args[0].value!r}"
        return f"timing.{fn.attr}{label}"
    if fn.attr in TRACE_SPAN_ATTRS and recv_name == "trace":
        label = ""
        if expr.args and isinstance(expr.args[0], ast.Constant):
            label = f" {expr.args[0].value!r}"
        return f"trace.{fn.attr}{label}"
    return None


def _is_sleep(call) -> bool:
    fn = call.func
    return (
        isinstance(fn, ast.Attribute)
        and fn.attr == "sleep"
        and isinstance(fn.value, ast.Name)
        and fn.value.id == "time"
    )


@checker(
    "traced-blocking",
    code="SA019",
    doc="No time.sleep and no lock acquisition (a `with <lock>` item or a "
    "resolvable .acquire() call) directly inside the body of a "
    "timing.scoped / timing.trace_annotation / trace.span / trace.operation "
    "scope — a span that "
    "sleeps or waits on a lock attributes backoff and contention to the "
    "operation it names, so the timing tree, the perf attribution, and "
    "every trace reading lie. Direct statements only; transitive callees "
    "are SA011's territory and the runtime lockdep layer's.",
)
def check_traced_blocking(tree: Tree):
    findings = []
    index = LockIndex(tree)

    def scan_body(m, class_name, local_locks, stmts, span_desc):
        for stmt in stmts:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue  # executes outside the span
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    got = index.resolve_lock(
                        m, class_name, local_locks, item.context_expr
                    )
                    if got:
                        findings.append(
                            check_traced_blocking.finding(
                                m.rel, stmt.lineno,
                                f"lock {got[0]} acquired inside {span_desc} "
                                "— contention is attributed to the span; "
                                "acquire outside the scope",
                            )
                        )
                scan_body(m, class_name, local_locks, stmt.body, span_desc)
                continue
            # ast.walk cannot be pruned: pre-collect everything under a
            # nested def/lambda anywhere in the statement — those bodies
            # execute outside the span
            skip: set = set()
            for node in ast.walk(stmt):
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    for sub in ast.walk(node):
                        if sub is not node:
                            skip.add(id(sub))
            for node in ast.walk(stmt):
                if id(node) in skip:
                    continue
                if not isinstance(node, ast.Call):
                    continue
                if _is_sleep(node):
                    findings.append(
                        check_traced_blocking.finding(
                            m.rel, node.lineno,
                            f"time.sleep(...) inside {span_desc} — the "
                            "backoff is billed to the span; sleep outside "
                            "the scope",
                        )
                    )
                elif isinstance(node.func, ast.Attribute) and (
                    node.func.attr == "acquire"
                ):
                    got = index.resolve_lock(
                        m, class_name, local_locks, node.func.value
                    )
                    if got:
                        findings.append(
                            check_traced_blocking.finding(
                                m.rel, node.lineno,
                                f"lock {got[0]} .acquire()d inside "
                                f"{span_desc} — contention is attributed "
                                "to the span; acquire outside the scope",
                            )
                        )

    def walk(m, class_name, qual, local_locks, stmts):
        for stmt in stmts:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                descs = [d for d in map(_span_desc, stmt.items) if d]
                if descs:
                    scan_body(
                        m, class_name, local_locks, stmt.body, descs[0]
                    )
                walk(m, class_name, qual, local_locks, stmt.body)
                continue
            for sub in _stmt_lists(stmt):
                walk(m, class_name, qual, local_locks, sub)

    for m in index.modules.values():
        for qual, fn_node in m.functions.items():
            class_name = qual.split(".")[0] if "." in qual else None
            local_locks = index._local_locks(m.rel, qual, fn_node)
            walk(m, class_name, qual, local_locks, fn_node.body)
    return findings
