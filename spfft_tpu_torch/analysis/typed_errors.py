"""Checker 10: typed-error discipline (SA010), the rule of
``spfft_tpu/analysis/typed_errors.py`` over the port's package code.

The reliability posture: a plan must never be *silently* wrong — every
failure surfaces as a member of the ``spfft_tpu_torch.errors`` taxonomy so
the C shim, the retry/demote ladder, and callers can react mechanically.
Two rules enforce it:

* **Every ``raise`` constructs taxonomy.** A raise in package code must
  construct a :class:`GenericError` subclass (or one of the documented
  fault-model ``RuntimeError`` subclasses below — they exist precisely so
  the ladder's production ``except`` arms catch injected/timeout failures),
  re-raise bare, or re-raise a stored exception object. ``raise
  ValueError(...)`` and friends leak untyped contracts.
* **``except Exception`` must convert and count.** A blanket handler is
  allowed when it re-raises bare (cleanup handlers swallow nothing), or
  when it (a) bumps a counter (``.inc()`` / ``self._count*``) and (b)
  converts to typed (``as_typed`` or a taxonomy construction) — the
  serving layer's no-silent-exit catch-alls. Anything else swallows
  failures invisibly.

Known-deliberate builtin raises (e.g. ``Ticket.result``'s documented
builtin ``TimeoutError`` contract) and the cross-thread re-raise pattern
(``except BaseException as e: err.append(e)`` with the caller re-raising)
carry ``# noqa: SA010`` at the site.
"""
from __future__ import annotations

import ast

from .core import PACKAGE_DIRS, Tree, checker

ERRORS_FILE = "spfft_tpu_torch/errors.py"

# Deliberate RuntimeError subclasses of the failure model: each is
# documented ("a RuntimeError subclass on purpose") so the production
# ``except`` arms that catch real backend failures catch these too, and the
# surrounding typed_execution scopes convert them. A NEW RuntimeError
# subclass must either join this list (with the same documented rationale)
# or subclass the taxonomy.
DELIBERATE_RUNTIME_CLASSES = (
    "InjectedFault",        # faults.plane — chaos failures use real handlers
    "FenceTimeout",         # sync — converted by faults.typed_execution
    "TrialTimeout",         # tuning.runner — member of TRIAL_ERRORS
    "TrialDegradedError",   # tuning.runner — isolation-scope signal
    "GroupFailure",         # verify.checks — a check over a process group
                            # that some process could not complete, raised
                            # on every process for the supervisor's ladder
)

# Factory functions returning a taxonomy class (``raise execution_error(
# platform)(...)`` is the dual-error-surface idiom).
TYPED_FACTORIES = ("execution_error",)

# The import-free tooling layer (spfft_tpu_torch/analysis) cannot import the
# taxonomy without pulling torch; its AnalysisError marks internal tool
# failures (bad tree, malformed baseline) — distinct from findings, and
# never part of the production error surface.
TOOLING_CLASSES = ("AnalysisError",)

BUILTIN_EXCEPTIONS = {
    "ArithmeticError", "AssertionError", "AttributeError", "BaseException",
    "BufferError", "EOFError", "Exception", "FloatingPointError",
    "ImportError", "IndexError", "KeyError", "KeyboardInterrupt",
    "LookupError", "MemoryError", "ModuleNotFoundError", "NameError",
    "NotImplementedError", "OSError", "OverflowError", "RecursionError",
    "ReferenceError", "RuntimeError", "StopIteration", "SystemError",
    "SystemExit", "TimeoutError", "TypeError", "UnboundLocalError",
    "UnicodeError", "ValueError", "ZeroDivisionError",
}


def taxonomy_classes(tree: Tree) -> set:
    """Names of every package-defined GenericError subclass, computed
    transitively over all package class definitions (import-free)."""
    bases: dict = {}
    for rel in tree.py_files(PACKAGE_DIRS):
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue
        for node in ast.walk(mod):
            if isinstance(node, ast.ClassDef):
                names = []
                for b in node.bases:
                    if isinstance(b, ast.Name):
                        names.append(b.id)
                    elif isinstance(b, ast.Attribute):
                        names.append(b.attr)
                bases.setdefault(node.name, set()).update(names)
    typed = {"GenericError"}
    changed = True
    while changed:
        changed = False
        for name, parents in bases.items():
            if name not in typed and parents & typed:
                typed.add(name)
                changed = True
    return typed


def _constructor_name(exc) -> tuple:
    """(kind, name) of a raise's value expression.

    kind: "call" (Class(...)), "factory" (factory(...)(...)), "name"
    (bare class/object reference), "other" (stored exception, subscripts,
    attribute reads — re-raises of objects, always allowed)."""
    if isinstance(exc, ast.Call):
        fn = exc.func
        if isinstance(fn, ast.Name):
            return "call", fn.id
        if isinstance(fn, ast.Attribute):
            return "call", fn.attr
        if isinstance(fn, ast.Call):
            inner = fn.func
            if isinstance(inner, ast.Name):
                return "factory", inner.id
            if isinstance(inner, ast.Attribute):
                return "factory", inner.attr
        return "call", None
    if isinstance(exc, ast.Name):
        return "name", exc.id
    return "other", None


def _bumps_counter(handler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in (
                "inc", "_count", "_count_only", "observe",
            ):
                return True
            if isinstance(fn, ast.Name) and fn.id in ("_count", "_count_only"):
                return True
    return False


def _reraises_bare(handler) -> bool:
    """A bare ``raise`` anywhere in the handler: nothing is swallowed, so
    the handler is a cleanup scope, not a conversion site."""
    return any(
        isinstance(node, ast.Raise) and node.exc is None
        for node in ast.walk(handler)
    )


def _converts_or_reraises(handler, typed: set) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True  # bare re-raise
            kind, name = _constructor_name(node.exc)
            if kind == "call" and name in typed:
                return True
            if kind == "factory" and name in TYPED_FACTORIES:
                return True
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if name == "as_typed":
                return True
    return False


def _caught_names(mod) -> set:
    """Names bound by ``except ... as e`` anywhere in the module (re-raising
    a caught name is a re-raise, not a construction)."""
    out = set()
    for node in ast.walk(mod):
        if isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
    return out


def _is_broad(handler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Attribute):
        names = [t.attr]
    elif isinstance(t, ast.Tuple):
        for el in t.elts:
            if isinstance(el, ast.Name):
                names.append(el.id)
            elif isinstance(el, ast.Attribute):
                names.append(el.attr)
    return any(n in ("Exception", "BaseException") for n in names)


@checker(
    "typed-error",
    code="SA010",
    doc="Every raise in the spfft_tpu_torch package constructs a taxonomy GenericError "
    "subclass (or a documented fault-model RuntimeError subclass), "
    "re-raises bare, or re-raises a stored exception; every `except "
    "Exception` must re-raise bare (a cleanup scope) or bump a counter "
    "AND convert to typed (as_typed / taxonomy raise). Deliberate builtin "
    "contracts carry `# noqa: SA010` at the site.",
)
def check_typed_errors(tree: Tree):
    findings = []
    typed = taxonomy_classes(tree)
    typed |= set(DELIBERATE_RUNTIME_CLASSES)
    typed |= set(TOOLING_CLASSES)
    for rel in tree.py_files(PACKAGE_DIRS):
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue
        caught = _caught_names(mod)
        for node in ast.walk(mod):
            if isinstance(node, ast.Raise):
                if node.exc is None:
                    continue
                kind, name = _constructor_name(node.exc)
                if kind == "other":
                    continue  # re-raise of a stored exception object
                if kind == "name":
                    if name in BUILTIN_EXCEPTIONS and name not in typed:
                        findings.append(
                            check_typed_errors.finding(
                                rel, node.lineno,
                                f"raise of builtin {name} — construct a "
                                "spfft_tpu_torch.errors taxonomy class instead",
                            )
                        )
                    continue  # re-raise of a caught/stored name
                if kind == "factory":
                    if name not in TYPED_FACTORIES:
                        findings.append(
                            check_typed_errors.finding(
                                rel, node.lineno,
                                f"raise through unknown factory {name}() — "
                                "only typed factories "
                                f"({', '.join(TYPED_FACTORIES)}) are "
                                "statically checkable",
                            )
                        )
                    continue
                # kind == "call"
                if name is None or name in typed or name in caught:
                    continue
                findings.append(
                    check_typed_errors.finding(
                        rel, node.lineno,
                        f"raise {name}(...) is not a spfft_tpu_torch.errors "
                        "taxonomy class (typed-error discipline: every "
                        "failure surfaces as a GenericError subclass)",
                    )
                )
            elif isinstance(node, ast.ExceptHandler) and _is_broad(node):
                if _reraises_bare(node):
                    continue  # cleanup scope: nothing swallowed
                if _bumps_counter(node) and _converts_or_reraises(node, typed):
                    continue
                findings.append(
                    check_typed_errors.finding(
                        rel, node.lineno,
                        "broad `except Exception` without counter + typed "
                        "conversion — narrow it to a typed tuple, or count "
                        "and convert (as_typed / taxonomy raise / bare "
                        "re-raise)",
                    )
                )
    return findings
