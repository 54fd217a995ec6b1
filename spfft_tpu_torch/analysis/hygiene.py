"""Checkers 1–2: import hygiene, the rules of ``spfft_tpu/analysis/hygiene.py``.

1. ``duplicate-import`` (SA001) — the same module/name imported more than
   once in one scope,
2. ``unused-import`` (SA002) — an imported name never referenced in the
   file (``# noqa: F401`` on the import line exempts re-exports — the
   legacy lint exemption, preserved verbatim: any ``noqa`` substring on the
   import line exempts it from BOTH import checks).
"""
from __future__ import annotations

import ast

from .core import Tree, checker


def _import_forms(node):
    """Canonical (form, bound-name) pairs for an import statement."""
    out = []
    if isinstance(node, ast.Import):
        for a in node.names:
            form = f"import {a.name}" + (f" as {a.asname}" if a.asname else "")
            out.append((form, (a.asname or a.name).split(".")[0]))
    elif isinstance(node, ast.ImportFrom):
        if node.module == "__future__":
            return []
        mod = "." * node.level + (node.module or "")
        for a in node.names:
            if a.name == "*":
                continue
            form = f"from {mod} import {a.name}" + (
                f" as {a.asname}" if a.asname else ""
            )
            out.append((form, a.asname or a.name))
    return out


def _walk_scope(body):
    """Statements of one scope, not descending into nested function/class
    bodies (lazy function-scope imports are a deliberate pattern here —
    duplicates only count within a single scope)."""
    for stmt in body:
        yield stmt
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        for field in ("body", "orelse", "finalbody", "handlers"):
            sub = getattr(stmt, field, None)
            if not sub:
                continue
            for child in sub:
                if isinstance(child, ast.ExceptHandler):
                    yield from _walk_scope(child.body)
                else:
                    yield from _walk_scope([child])


def _parsed(fn, tree: Tree, rel: str):
    """(ast, findings) with a syntax error reported as a finding."""
    try:
        return tree.parse(rel), []
    except SyntaxError as e:
        return None, [
            fn.finding(rel, e.lineno or 0, f"syntax error: {e.msg}")
        ]


def _legacy_exempt(lines, node) -> bool:
    line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
    return "noqa" in line


@checker(
    "duplicate-import",
    code="SA001",
    doc="The same module or name imported more than once within a single "
    "scope (module body, one class body, or one function). Lazy "
    "function-scope imports are deliberate here, so duplicates only count "
    "within one scope; any `noqa` on the line exempts it (legacy lint "
    "contract).",
)
def check_duplicate_imports(tree: Tree):
    findings = []
    for rel in tree.py_files():
        mod, errs = _parsed(check_duplicate_imports, tree, rel)
        findings += errs
        if mod is None:
            continue
        lines = tree.lines(rel)
        scopes = [mod.body]
        for node in ast.walk(mod):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                scopes.append(node.body)
        for body in scopes:
            seen: dict = {}
            for stmt in _walk_scope(body):
                if not isinstance(stmt, (ast.Import, ast.ImportFrom)):
                    continue
                for form, _name in _import_forms(stmt):
                    if form in seen and not _legacy_exempt(lines, stmt):
                        findings.append(
                            check_duplicate_imports.finding(
                                rel, stmt.lineno, f"duplicate {form!r}"
                            )
                        )
                    seen.setdefault(form, stmt.lineno)
    return findings


@checker(
    "unused-import",
    code="SA002",
    doc="A module-scope import whose bound name is never referenced in the "
    "file. `# noqa: F401` (or any `noqa`) on the import line exempts "
    "re-export surfaces; `__all__` strings count as uses.",
)
def check_unused_imports(tree: Tree):
    findings = []
    for rel in tree.py_files():
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue  # SA001 already reported it
        lines = tree.lines(rel)
        bound = []
        for stmt in _walk_scope(mod.body):
            if isinstance(stmt, (ast.Import, ast.ImportFrom)) and not (
                _legacy_exempt(lines, stmt)
            ):
                bound.extend(
                    (name, stmt.lineno) for _form, name in _import_forms(stmt)
                )
        used = set()
        for node in ast.walk(mod):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Assign):
                # __all__ strings count as uses (re-export surface)
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == "__all__":
                        for el in ast.walk(node.value):
                            if isinstance(el, ast.Constant) and isinstance(
                                el.value, str
                            ):
                                used.add(el.value)
        for name, lineno in bound:
            if name not in used and name != "_":
                findings.append(
                    check_unused_imports.finding(
                        rel, lineno, f"unused import {name!r}"
                    )
                )
    return findings
