"""Checker 16: metrics-vocabulary discipline (SA016), the rule of
``spfft_tpu/analysis/metricsvocab.py`` over the port's vocabulary.

The run-metrics registry hands out instruments by NAME — a typo'd name or
a divergent label set silently creates a new time series that no dashboard,
snapshot assertion, or Prometheus join ever finds. The canonical
vocabulary lives in ``spfft_tpu_torch/obs/metrics.py`` (``METRICS``: one
``(name, kind, label_keys, doc)`` row per instrument, pure literal), and
this checker holds it in sync three ways, the SA003/SA005 contract shape:

* every ``obs.counter/gauge/histogram/phase_timer`` call in the package
  names a declared row, with the declared kind and EXACTLY the declared
  label keys (``phase_timer`` feeds a histogram),
* every declared row is emitted by at least one package call site (no
  dead declarations),
* the docs table in ``docs/torch/details.md`` (between the
  ``metric-table`` markers, regenerated by
  ``spfft_tpu_torch/programs/gen_api_docs.py``) lists exactly the declared
  names, both ways.

Label resolution is static and conservative: literal keyword arguments,
``**{...}`` dict literals, and ``**name`` where ``name`` is assigned a
dict literal in the same module are compared; anything else skips the
label comparison for that call (the name/kind checks still apply). A
dynamic metric NAME is always a finding — the vocabulary cannot cover
what it cannot read.
"""
from __future__ import annotations

import ast
import re

from .core import DOCS_PATH, GEN_DOCS, PACKAGE_DIRS, Tree, checker, missing_anchor

METRICS_FILE = "spfft_tpu_torch/obs/metrics.py"
REGISTRY_FILE = "spfft_tpu_torch/obs/registry.py"

FACTORIES = {
    "counter": "counter",
    "gauge": "gauge",
    "histogram": "histogram",
    "phase_timer": "histogram",
}

METRIC_TABLE_BEGIN = "<!-- metric-table:begin"
METRIC_TABLE_END = "<!-- metric-table:end -->"

_TABLE_NAME_RE = re.compile(r"^\|\s*`([a-z0-9_]+)`")


def metrics_vocab(tree: Tree) -> list:
    """The literal METRICS rows as ``(name, kind, labels, lineno)``."""
    out = []
    for node in tree.parse(METRICS_FILE).body:
        if not (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "METRICS"
                for t in node.targets
            )
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            continue
        for row in node.value.elts:
            if not (
                isinstance(row, (ast.Tuple, ast.List)) and len(row.elts) >= 3
            ):
                continue
            name = row.elts[0]
            kind = row.elts[1]
            labels = row.elts[2]
            if not (
                isinstance(name, ast.Constant) and isinstance(kind, ast.Constant)
            ):
                continue
            keys = tuple(
                el.value
                for el in getattr(labels, "elts", ())
                if isinstance(el, ast.Constant)
            )
            out.append((name.value, kind.value, keys, row.lineno))
    return out


def _factory_call(node, imported: set):
    """The factory slug when ``node`` is a metric-instrument call, else
    None — ``obs.counter(...)`` / ``registry.gauge(...)`` attribute style,
    or a bare name imported from the registry."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in FACTORIES and (
            isinstance(fn.value, ast.Name)
            and fn.value.id in ("obs", "registry")
        ):
            return fn.attr
        return None
    if isinstance(fn, ast.Name) and fn.id in FACTORIES and fn.id in imported:
        return fn.id
    return None


def _registry_imports(mod) -> set:
    """Factory names a module imports straight off the registry/obs
    modules (``from .registry import gauge, histogram``)."""
    out: set = set()
    for node in ast.walk(mod):
        if not isinstance(node, ast.ImportFrom):
            continue
        module = node.module or ""
        if not (module.endswith("registry") or module.endswith("obs")):
            continue
        for a in node.names:
            if a.name in FACTORIES:
                out.add(a.asname or a.name)
    return out


def _dict_literal_keys(expr):
    """Constant string keys of a dict literal, or None when not one."""
    if not isinstance(expr, ast.Dict):
        return None
    keys = []
    for k in expr.keys:
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        keys.append(k.value)
    return keys


def _module_dict_assigns(mod) -> dict:
    """``name -> key tuple`` for every ``name = {literal dict}`` assignment
    in the module (the ``**labels`` resolution path)."""
    out: dict = {}
    for node in ast.walk(mod):
        if not isinstance(node, ast.Assign):
            continue
        keys = _dict_literal_keys(node.value)
        if keys is None:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out.setdefault(t.id, tuple(keys))
    return out


def _call_labels(call, dict_assigns):
    """(label key set, resolvable) of a factory call's keyword surface."""
    keys: set = set()
    for kw in call.keywords:
        if kw.arg is not None:
            keys.add(kw.arg)
            continue
        lit = _dict_literal_keys(kw.value)
        if lit is not None:
            keys.update(lit)
            continue
        if isinstance(kw.value, ast.Name) and kw.value.id in dict_assigns:
            keys.update(dict_assigns[kw.value.id])
            continue
        return keys, False
    return keys, True


@checker(
    "metrics-vocab",
    code="SA016",
    doc="Every obs.counter/gauge/histogram/phase_timer call in the package "
    "names an instrument declared once in the spfft_tpu_torch/obs/metrics.py "
    "METRICS vocabulary, with the declared kind and exactly the declared "
    "label keys (phase_timer feeds a histogram); every declared instrument "
    "is emitted by at least one call site; and the docs/torch/details.md metric "
    "table (regenerated from the vocabulary like the knob table) lists "
    "exactly the declared names both ways. Dynamic metric names are "
    "findings; unresolvable **label expansions skip only the label "
    "comparison.",
)
def check_metrics_vocab(tree: Tree):
    skip, findings = missing_anchor(check_metrics_vocab, tree, METRICS_FILE)
    if skip:
        return findings
    vocab = metrics_vocab(tree)
    by_name: dict = {}
    for name, kind, labels, lineno in vocab:
        if name in by_name:
            findings.append(
                check_metrics_vocab.finding(
                    METRICS_FILE, lineno,
                    f"metric {name!r} declared twice in METRICS",
                )
            )
            continue
        by_name[name] = (kind, labels, lineno)

    used: dict = {}
    for rel in tree.py_files(PACKAGE_DIRS):
        if rel in (METRICS_FILE, REGISTRY_FILE):
            continue
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue
        imported = _registry_imports(mod)
        dict_assigns = _module_dict_assigns(mod)
        for node in ast.walk(mod):
            slug = _factory_call(node, imported)
            if slug is None:
                continue
            if not (
                node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                findings.append(
                    check_metrics_vocab.finding(
                        rel, node.lineno,
                        f"obs.{slug}(...) must take a literal metric name "
                        "(the vocabulary cannot cover a dynamic name)",
                    )
                )
                continue
            name = node.args[0].value
            used.setdefault(name, (rel, node.lineno))
            declared = by_name.get(name)
            if declared is None:
                findings.append(
                    check_metrics_vocab.finding(
                        rel, node.lineno,
                        f"metric {name!r} is not declared in the canonical "
                        f"vocabulary ({METRICS_FILE} METRICS)",
                    )
                )
                continue
            kind, labels, _lineno = declared
            if FACTORIES[slug] != kind:
                findings.append(
                    check_metrics_vocab.finding(
                        rel, node.lineno,
                        f"metric {name!r} is declared a {kind} but emitted "
                        f"via obs.{slug}(...)",
                    )
                )
            got, resolvable = _call_labels(node, dict_assigns)
            if resolvable and got != set(labels):
                findings.append(
                    check_metrics_vocab.finding(
                        rel, node.lineno,
                        f"metric {name!r} emitted with label keys "
                        f"{sorted(got)} but the vocabulary declares "
                        f"{sorted(labels)} — divergent label sets split "
                        "the series",
                    )
                )

    for name, (kind, labels, lineno) in sorted(by_name.items()):
        if name not in used:
            findings.append(
                check_metrics_vocab.finding(
                    METRICS_FILE, lineno,
                    f"metric {name!r} is declared but emitted by no package "
                    "code path (dead declaration)",
                )
            )

    # ---- the docs table regenerates from the vocabulary ---------------------
    if tree.exists(DOCS_PATH):
        text = tree.source(DOCS_PATH)
        begin = text.find(METRIC_TABLE_BEGIN)
        end = text.find(METRIC_TABLE_END)
        if begin < 0 or end < 0:
            if not tree.partial:
                findings.append(
                    check_metrics_vocab.finding(
                        DOCS_PATH, 0,
                        "metric-table markers are missing — regenerate the "
                        f"docs (python {GEN_DOCS})",
                    )
                )
        else:
            in_table = set()
            for line in text[begin:end].splitlines():
                m = _TABLE_NAME_RE.match(line.strip())
                if m:
                    in_table.add(m.group(1))
            for name in sorted(set(by_name) - in_table):
                findings.append(
                    check_metrics_vocab.finding(
                        DOCS_PATH, 0,
                        f"metric {name!r} is declared but missing from the "
                        "docs metric table (regenerate: python "
                        f"{GEN_DOCS})",
                    )
                )
            for name in sorted(in_table - set(by_name)):
                findings.append(
                    check_metrics_vocab.finding(
                        DOCS_PATH, 0,
                        f"docs metric table lists {name!r} but it is no "
                        "longer declared in METRICS (dead doc row)",
                    )
                )
    elif not tree.partial:
        findings.append(
            check_metrics_vocab.finding(
                DOCS_PATH, 0, f"{DOCS_PATH} is missing"
            )
        )
    return findings
