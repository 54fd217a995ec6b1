"""Checker 18: fault-site chaos coverage (SA018), the rule of
``spfft_tpu/analysis/faultcov.py`` over the port's sites and tests.

``faults.SITES`` is the chaos plane's vocabulary: SA005 already pins every
``faults.site(...)`` call to a registered name and every registered name to
a real call site. What SA005 cannot see is whether anybody ever FIRES a
site: the arm-every-site sweeps iterate ``faults.SITES`` dynamically, so a
new site is swept — but the sweep only asserts the generic
typed-error-or-parity invariant. Every site also needs a TARGETED chaos
test pinning its specific ladder response (which rung, which degradation
event, which fallback), and that test necessarily names the site
literally. Two directions:

* every registered site is referenced by at least one literal arming in
  ``tests/test_torch_*.py`` — an ``inject("site=kind")`` / ``arm(...)`` spec string, an
  ``arm({...})`` table key, or a ``SPFFT_TPU_FAULTS``-style spec constant,
* every site-shaped token armed in a test spec is a registered site — a
  typo'd site would raise typed at runtime, but a site REMOVED from the
  vocabulary while its targeted test still arms it should fail the gate,
  not the suite.

Literal detection is string-based and anchored on the fault-kind grammar
(``<site>=<raise|nan|corrupt|delay>``), so env-knob spec strings count
exactly like ``inject`` arguments; f-string sweeps are dynamic and
deliberately do not count as targeted coverage.
"""
from __future__ import annotations

import ast
import re

from .core import TESTS_DIRS, Tree, checker, missing_anchor

FAULTS_PLANE_FILE = "spfft_tpu_torch/faults/plane.py"

# a literal arming token: site=kind with the canonical kind grammar — the
# anchor that keeps random "a.b=c" strings from matching
_SPEC_RE = re.compile(
    r"([a-z_][a-z0-9_]*\.[a-z_][a-z0-9_]*)=(?:raise|nan|corrupt|delay)\b"
)


def _armed_dict_keys(call) -> list:
    """Literal site keys of an ``arm({...})`` / ``inject({...})`` table."""
    out = []
    for arg in call.args:
        if isinstance(arg, ast.Dict):
            out.extend(
                (k.value, k.lineno)
                for k in arg.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)
            )
    return out


@checker(
    "fault-coverage",
    code="SA018",
    doc="Every faults.SITES entry is armed by at least one LITERAL chaos "
    "reference in tests/test_torch_*.py (an inject/arm spec string or table key, or a "
    "SPFFT_TPU_FAULTS-style spec constant — the site=kind grammar), and "
    "every literal site token armed in tests is a registered site. The "
    "dynamic arm-every-site sweep proves the generic invariant; the "
    "targeted literal test pins each site's specific ladder response, and "
    "a site without one has an untested failure path.",
)
def check_fault_coverage(tree: Tree):
    skip, findings = missing_anchor(
        check_fault_coverage, tree, FAULTS_PLANE_FILE
    )
    if skip:
        return findings
    sites = tuple(tree.literal_assign(FAULTS_PLANE_FILE, "SITES") or ())
    referenced: dict = {}  # site -> first (file, line)
    for rel in tree.py_files(TESTS_DIRS):
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue
        for node in ast.walk(mod):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                for name in _SPEC_RE.findall(node.value):
                    referenced.setdefault(name, (rel, node.lineno))
            elif isinstance(node, ast.Call):
                fn = node.func
                attr = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None
                )
                if attr in ("inject", "arm"):
                    for name, lineno in _armed_dict_keys(node):
                        referenced.setdefault(name, (rel, lineno))
    for name in sites:
        if name not in referenced:
            findings.append(
                check_fault_coverage.finding(
                    FAULTS_PLANE_FILE, 0,
                    f"site {name!r} has no targeted chaos test: no literal "
                    "inject/arm reference in tests/ pins its ladder "
                    "response (the dynamic sweep alone is not coverage)",
                )
            )
    for name, (rel, lineno) in sorted(referenced.items()):
        if name not in sites:
            findings.append(
                check_fault_coverage.finding(
                    rel, lineno,
                    f"chaos test arms {name!r}, which is not a registered "
                    f"fault site ({FAULTS_PLANE_FILE} SITES) — the arming "
                    "would raise typed at runtime",
                )
            )
    return findings
