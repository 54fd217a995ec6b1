"""Checker 14: knob-registry read path (SA014), the rule of
``spfft_tpu/analysis/knobreads.py`` over the port's package code.

``spfft_tpu_torch.knobs`` is the single allowed read path for the package's
``SPFFT_TPU_*`` env surface: the typed getters raise
:class:`~spfft_tpu_torch.errors.InvalidParameterError` on malformed values, the
docs table regenerates from the registry, and the ``env-knob-docs`` checker
(SA003) holds the surface in sync — none of which works if a module keeps
its own ``os.environ`` parsing on the side. This checker flags every
``os.environ`` / ``os.getenv`` access in package code outside ``knobs.py``:

* an access whose key is a literal ``SPFFT_TPU_*`` string is a bypass of
  the registry — migrate it to a typed getter;
* an access whose key is *not statically resolvable* (a variable) might be
  one, so it is flagged too, conservative — a deliberate raw path (the
  tuning trial isolation scope saves/restores arbitrary ambient values
  verbatim) documents itself with ``# noqa: SA014`` at the site;
* an access with a non-``SPFFT_TPU_*`` literal key (``CUDA_VISIBLE_DEVICES``,
  ``PATH``) is someone else's vocabulary and allowed.

Harness code (``spfft_tpu_torch/programs/``, ``examples/``, ``native/`` and
the tests) sets knobs from the outside and is
out of scope here; SA003 still checks that every knob it touches is
registered.
"""
from __future__ import annotations

import ast

from .core import PACKAGE_DIRS, Tree, checker

KNOBS_FILE = "spfft_tpu_torch/knobs.py"
PREFIX = "SPFFT_TPU_"


def _is_environ(expr) -> bool:
    return (
        isinstance(expr, ast.Attribute)
        and expr.attr == "environ"
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "os"
    )


def _key_expr(node):
    """The key expression of an ``os.environ``/``os.getenv`` access, or
    ``False`` when ``node`` is not one. ``None`` means keyless/dynamic
    (e.g. ``os.environ.update(...)``, iteration)."""
    if isinstance(node, ast.Subscript) and _is_environ(node.value):
        return node.slice
    if isinstance(node, ast.Call):
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and _is_environ(fn.value)
            and fn.attr in ("get", "pop", "setdefault")
        ):
            return node.args[0] if node.args else None
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "os"
            and fn.attr == "getenv"
        ) or (isinstance(fn, ast.Name) and fn.id == "getenv"):
            return node.args[0] if node.args else None
    return False


@checker(
    "knob-registry",
    code="SA014",
    doc="Every SPFFT_TPU_* env read in package code goes through the "
    "spfft_tpu_torch.knobs typed registry — raw os.environ/os.getenv accesses "
    "outside knobs.py are flagged when their key is a SPFFT_TPU_* literal "
    "or not statically resolvable (conservative; deliberate raw paths "
    "carry `# noqa: SA014`). Non-SPFFT_TPU_* literal keys "
    "(CUDA_VISIBLE_DEVICES, PATH) are someone else's vocabulary and allowed.",
)
def check_knob_reads(tree: Tree):
    findings = []
    for rel in tree.py_files(PACKAGE_DIRS):
        if rel == KNOBS_FILE:
            continue
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue
        for node in ast.walk(mod):
            key = _key_expr(node)
            if key is False:
                continue
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                if not key.value.startswith(PREFIX):
                    continue
                findings.append(
                    check_knob_reads.finding(
                        rel, node.lineno,
                        f"raw os.environ access of {key.value} bypasses "
                        "the spfft_tpu_torch.knobs registry — use the typed "
                        "getter (knobs.get_*)",
                    )
                )
            else:
                findings.append(
                    check_knob_reads.finding(
                        rel, node.lineno,
                        "os.environ access with a non-literal key may "
                        "bypass the spfft_tpu_torch.knobs registry — resolve "
                        "through knobs.get_*, or mark a deliberate raw "
                        "path with `# noqa: SA014`",
                    )
                )
    return findings
