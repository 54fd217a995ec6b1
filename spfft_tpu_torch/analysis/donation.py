"""Checker 12: donation safety (SA012), the rules of
``spfft_tpu/analysis/donation.py`` over the port's IR.

The JAX package's fused path donates the packed value buffers of the
consuming local backward (``jax.jit(fn, donate_argnums=...)``): XLA may
overwrite a donated buffer the moment its consuming node runs. PyTorch has
no input donation, and the port's fused program (``ir/compile.py``) keeps
its own static input buffers, fresh copies that every replay refills; its
card's donation map is empty. The rules stay, so that a donation the port
adds later is held to them, and so that the card keeps telling the truth:

* **No use after donate.** In every local-builder backward graph of
  ``ir/lower.py``, each donated input edge — the positions a local
  ``_ir_spec`` declares in its ``"donate"`` tuple (the JAX form), or the
  backward edges the card's donation map names (``EngineIr.describe``) —
  is consumed by at most one node and never escapes via ``set_outputs``.
* **The card tells the truth.** The plan card's donation map must be what
  the program actually does: with ``donate_argnums`` (the JAX form) the
  map must derive from the same spec key; in the port's form, an empty map
  requires the capture (``_capture``) to copy the caller's inputs into its
  static buffers (a capture that kept the caller's tensors would overwrite
  them at every replay: a donation the card does not report), and a
  non-empty map requires a capture that donates.

Graphs are reconstructed statically from the literal ``add_input``/``add``/
``set_outputs`` calls (string-constant propagation over simple local
assignments like ``cur = "sticks"``); nodes whose edge tuples are not
statically resolvable are skipped — conservative, like the lock analysis.
"""
from __future__ import annotations

import ast

from .core import PACKAGE_DIRS, Tree, checker, missing_anchor

IR_LOWER_FILE = "spfft_tpu_torch/ir/lower.py"
IR_COMPILE_FILE = "spfft_tpu_torch/ir/compile.py"

# calls that make a fresh buffer of a caller's input (the capture's copies)
COPY_CALLS = ("clone", "copy", "empty", "empty_like", "zeros", "zeros_like")

LOCAL_BUILDER_PREFIX = "_lower_local"


def donated_positions(tree: Tree) -> set:
    """Input positions any ``kind == "local"`` ``_ir_spec`` declares
    donatable (the union of the literal ``"donate"`` tuples)."""
    out: set = set()
    for rel in tree.py_files(PACKAGE_DIRS):
        try:
            mod = tree.parse(rel)
        except SyntaxError:
            continue
        for node in ast.walk(mod):
            if not (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == "_ir_spec"
            ):
                continue
            for ret in ast.walk(node):
                if not (
                    isinstance(ret, ast.Return)
                    and isinstance(ret.value, ast.Dict)
                ):
                    continue
                keys = {
                    k.value: v
                    for k, v in zip(ret.value.keys, ret.value.values)
                    if isinstance(k, ast.Constant)
                }
                kind = keys.get("kind")
                if not (
                    isinstance(kind, ast.Constant) and kind.value == "local"
                ):
                    continue
                donate = keys.get("donate")
                if isinstance(donate, (ast.Tuple, ast.List)):
                    for el in donate.elts:
                        if isinstance(el, ast.Constant) and isinstance(
                            el.value, int
                        ):
                            out.add(el.value)
    return out


def _string_values(expr, consts: dict) -> set:
    """Possible string values of a tuple/list element: a literal, or every
    literal ever assigned to that local name (``cur = "sticks"``)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {expr.value}
    if isinstance(expr, ast.Name):
        return consts.get(expr.id, set())
    return set()


class _Graph:
    """One statically reconstructed StageGraph build."""

    def __init__(self, direction, lineno):
        self.direction = direction
        self.lineno = lineno
        self.inputs: list = []          # ordered add_input names
        self.consumers: list = []       # (possible input-edge names, lineno)
        self.outputs: set = set()
        self.batch: set = set()         # declared batch_inputs edge names


def _reconstruct(fn_node) -> list:
    """Graphs built inside one function body (nested defs included)."""
    graphs: dict = {}  # var name -> _Graph (latest binding wins)
    consts: dict = {}  # local str-constant propagation
    out: list = []
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign):
            v = node.value
            if (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Name)
                and v.func.id == "StageGraph"
                and v.args
                and isinstance(v.args[0], ast.Constant)
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        g = _Graph(v.args[0].value, node.lineno)
                        graphs[t.id] = g
                        out.append(g)
            elif isinstance(v, ast.Constant) and isinstance(v.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        consts.setdefault(t.id, set()).add(v.value)
            # g.batch_inputs = ("values_re", ...) — the declared per-request
            # edges (an IfExp of literal tuples contributes the union)
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == "batch_inputs"
                    and isinstance(t.value, ast.Name)
                    and t.value.id in graphs
                ):
                    graphs[t.value.id].batch |= {
                        sub.value
                        for sub in ast.walk(v)
                        if isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)
                    }
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in graphs
        ):
            continue
        g = graphs[node.func.value.id]
        meth = node.func.attr
        if meth == "add_input" and node.args and isinstance(
            node.args[0], ast.Constant
        ):
            g.inputs.append(node.args[0].value)
        elif meth == "add" and len(node.args) >= 3:
            ins = node.args[2]
            if isinstance(ins, (ast.Tuple, ast.List)):
                possible: set = set()
                for el in ins.elts:
                    possible |= _string_values(el, consts)
                g.consumers.append((possible, node.lineno))
            # non-literal edge tuples: skipped (conservative)
        elif meth == "set_outputs" and node.args and isinstance(
            node.args[0], (ast.Tuple, ast.List)
        ):
            for el in node.args[0].elts:
                g.outputs |= _string_values(el, consts)
    return out


def _spec_keys(scope, receiver_names=("spec",)) -> set:
    """String keys read off a spec receiver (``spec["k"]`` /
    ``spec.get("k")`` / ``self.spec[...]``) anywhere under ``scope``."""

    def is_spec(expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in receiver_names
        return isinstance(expr, ast.Attribute) and expr.attr in receiver_names
    keys: set = set()
    for node in ast.walk(scope):
        if (
            isinstance(node, ast.Subscript)
            and is_spec(node.value)
            and isinstance(node.slice, ast.Constant)
        ):
            keys.add(node.slice.value)
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and is_spec(node.func.value)
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            keys.add(node.args[0].value)
    return keys


def card_donation(compile_mod):
    """``(literal, edges)`` of the card's donation map: the value of the
    ``"donation"`` key of a dict built in ``describe``. ``literal`` is
    whether there is one and it is a dict literal of edge-name lists (the
    port's form); ``edges`` the backward edge names it lists."""
    for node in ast.walk(compile_mod):
        if not (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "describe"
        ):
            continue
        for d in ast.walk(node):
            if not isinstance(d, ast.Dict):
                continue
            for k, v in zip(d.keys, d.values):
                if not (isinstance(k, ast.Constant) and k.value == "donation"):
                    continue
                if not isinstance(v, ast.Dict):
                    return False, set()
                edges: set = set()
                for dk, dv in zip(v.keys, v.values):
                    if not isinstance(dv, (ast.List, ast.Tuple)):
                        return False, set()
                    if isinstance(dk, ast.Constant) and dk.value == "backward":
                        edges |= {
                            el.value for el in dv.elts
                            if isinstance(el, ast.Constant)
                        }
                return True, edges
    return False, set()


def capture_copies(compile_mod):
    """Whether the fused program's capture (``_capture``) builds its static
    inputs as fresh buffers; None when there is no such capture."""
    for node in ast.walk(compile_mod):
        if not (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "_capture"
        ):
            continue
        for stmt in ast.walk(node):
            if not (
                isinstance(stmt, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and "static_in" in t.id
                    for t in stmt.targets
                )
            ):
                continue
            return any(
                isinstance(c, ast.Call)
                and isinstance(c.func, (ast.Attribute, ast.Name))
                and (getattr(c.func, "attr", None) or getattr(c.func, "id", None))
                in COPY_CALLS
                for c in ast.walk(stmt.value)
            )
    return None


def donated_edges(g, positions, card_edges) -> list:
    """``(edge, why)`` of the donated input edges of one backward graph."""
    out = []
    for i in sorted(positions):
        if i < len(g.inputs):
            out.append((g.inputs[i], f"donate position {i}"))
    for edge in sorted(card_edges):
        if edge in g.inputs and edge not in [e for e, _ in out]:
            out.append((edge, "the card's donation map"))
    return out


@checker(
    "donation-safety",
    code="SA012",
    doc="In the lowered local backward graphs (ir/lower.py), every "
    "donated input edge (the positions local _ir_spec methods declare "
    "under \"donate\", or the backward edges the card's donation map "
    "names) is consumed by at most one node and never escapes via "
    "set_outputs — a donated buffer may be overwritten at its consuming "
    "node, so any later reference computes with freed memory. In "
    "ir/compile.py, the plan card's donation map (EngineIr.describe) must "
    "be what the program does: derived from the spec key build_fused "
    "passes to donate_argnums, or, with no donate_argnums, empty exactly "
    "when the CUDA-graph capture copies the caller's inputs into its "
    "static buffers. Graphs are reconstructed from literal add_input/add/"
    "set_outputs calls; non-literal nodes are skipped (conservative).",
)
def check_donation_safety(tree: Tree):
    findings = []
    for anchor in (IR_LOWER_FILE, IR_COMPILE_FILE):
        skip, f = missing_anchor(check_donation_safety, tree, anchor)
        if skip:
            return findings + f
        findings += f
    positions = donated_positions(tree)
    compile_mod = tree.parse(IR_COMPILE_FILE)
    card_literal, card_edges = card_donation(compile_mod)

    # ---- rule 1: no use after donate in local backward graphs ---------------
    lower_mod = tree.parse(IR_LOWER_FILE)
    for builder in lower_mod.body:
        if not (
            isinstance(builder, (ast.FunctionDef, ast.AsyncFunctionDef))
            and builder.name.startswith(LOCAL_BUILDER_PREFIX)
        ):
            continue
        for g in _reconstruct(builder):
            if g.direction != "backward":
                continue
            for edge, why in donated_edges(g, positions, card_edges):
                uses = [
                    (possible, lineno)
                    for possible, lineno in g.consumers
                    if edge in possible
                ]
                for _possible, lineno in uses[1:]:
                    findings.append(
                        check_donation_safety.finding(
                            IR_LOWER_FILE, lineno,
                            f"donated input edge {edge!r} ({why}) "
                            f"referenced after its consuming node in a "
                            f"{builder.name} backward graph — the fused "
                            "consuming program may have freed it",
                        )
                    )
                if edge in g.outputs:
                    findings.append(
                        check_donation_safety.finding(
                            IR_LOWER_FILE, g.lineno,
                            f"donated input edge {edge!r} escapes as a graph "
                            f"output of a {builder.name} backward graph",
                        )
                    )

    # ---- rule 2: the card's donation map is what the program does -----------
    build_keys: set = set()
    applied = False
    describe_keys: set = set()
    for node in ast.walk(compile_mod):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name == "build_fused":
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                for kw in call.keywords:
                    if kw.arg != "donate_argnums":
                        continue
                    applied = True
                    # keys feeding the donate expression: the names it
                    # references, resolved through their assignments
                    names = {
                        n.id for n in ast.walk(kw.value)
                        if isinstance(n, ast.Name)
                    }
                    for stmt in ast.walk(node):
                        if isinstance(stmt, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id in names
                            for t in stmt.targets
                        ):
                            build_keys |= _spec_keys(stmt.value)
                    build_keys |= _spec_keys(kw.value)
        elif node.name == "describe":
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id in ("donated", "donation")
                    for t in stmt.targets
                ):
                    describe_keys |= _spec_keys(stmt.value)
    copies = capture_copies(compile_mod)
    if card_literal and not applied and copies is not None:
        if copies and card_edges:
            findings.append(
                check_donation_safety.finding(
                    IR_COMPILE_FILE, 0,
                    f"the card's donation map names {sorted(card_edges)} but "
                    "no program donates: the capture copies the caller's "
                    "inputs and no jit passes donate_argnums — the declared "
                    "donation is never applied",
                )
            )
        elif not copies and not card_edges:
            findings.append(
                check_donation_safety.finding(
                    IR_COMPILE_FILE, 0,
                    "the card's donation map is empty but _capture keeps the "
                    "caller's input tensors as the graph's static inputs — "
                    "every replay overwrites them, a donation the plan card "
                    "does not report",
                )
            )
    if positions and not applied:
        findings.append(
            check_donation_safety.finding(
                IR_COMPILE_FILE, 0,
                "local _ir_spec declares donatable inputs but no jit in "
                f"{IR_COMPILE_FILE} passes donate_argnums — the declared "
                "donation is never applied",
            )
        )
    if applied and not describe_keys:
        findings.append(
            check_donation_safety.finding(
                IR_COMPILE_FILE, 0,
                "build_fused donates buffers but EngineIr.describe derives "
                "no donation map from the spec — the plan card cannot "
                "report what was donated",
            )
        )
    if build_keys and describe_keys and build_keys != describe_keys:
        findings.append(
            check_donation_safety.finding(
                IR_COMPILE_FILE, 0,
                f"the card's donation map reads spec key(s) "
                f"{sorted(describe_keys)} but build_fused donates from "
                f"{sorted(build_keys)} — the provenance section would lie "
                "about the applied donate_argnums",
            )
        )
    return findings
