"""Checkers 3–9: the both-ways vocabulary contracts, the rules of
``spfft_tpu/analysis/vocab.py`` over the port's vocabularies.

Each enforces one canonical vocabulary in both directions — everything used
is declared, everything declared is used — because a one-way check lets the
vocabulary silently rot into either an unchecked free-for-all or a pile of
dead names:

3. ``env-knob-docs`` (SA003) — the ``spfft_tpu_torch.knobs`` registry is the
   knob surface: every ``SPFFT_TPU_*`` string in the package is a registered
   knob, every non-internal registered knob is documented in
   ``docs/torch/details.md`` AND referenced by package code, and every knob
   the docs mention still exists. The port writes its registry as one
   literal ``REGISTRY = {k.name: k for k in (Knob(...), ...)}``; the
   ``Knob(...)`` rows are read via ast, as are the JAX package's
   ``register(...)`` calls.
4. ``stage-scope`` (SA004) — the engines' stage labels vs ``obs.STAGES``:
   the ``timing.trace_annotation(...)`` ranges (the port's
   ``jax.named_scope``) and the stage-graph labels the lowering gives each
   node (``g.add("<stage>", ...)`` in ``ir/lower.py``, f-string labels
   resolved through the literal arguments of the helper that builds them).
5. ``fault-site`` (SA005) — ``faults.site(...)`` names vs ``faults.SITES``
   (+ docs).
6. ``trace-event`` (SA006) — ``trace.event/span/operation`` names vs
   ``trace.EVENTS``.
7. ``verify-check`` (SA007) — ``verify.CHECKS`` vs the ``CHECK_FNS``
   implementation registry (+ docs).
8. ``perf-stage`` (SA008) — ``perf.MODELED_STAGES`` vs the engine-pipeline
   subset of ``obs.STAGES``.
9. ``ir-node`` (SA009) — ``ir.NODES`` vs STAGES and MODELED_STAGES, plus
   the ``IR_KEYS``/``IR_SECTION_KEYS`` and ``BATCH_KEYS``/
   ``BATCH_SECTION_KEYS`` plan-card mirrors.
"""
from __future__ import annotations

import ast
import re

from .core import (
    DOCS_PATH,
    GEN_DOCS,
    HARNESS_DIRS,
    PACKAGE_DIRS,
    Tree,
    checker,
    missing_anchor,
)

KNOBS_FILE = "spfft_tpu_torch/knobs.py"
STAGES_FILE = "spfft_tpu_torch/obs/stages.py"
FAULTS_PLANE_FILE = "spfft_tpu_torch/faults/plane.py"
TRACE_FILE = "spfft_tpu_torch/obs/trace.py"
VERIFY_CHECKS_FILE = "spfft_tpu_torch/verify/checks.py"
PERF_FILE = "spfft_tpu_torch/obs/perf.py"
IR_GRAPH_FILE = "spfft_tpu_torch/ir/graph.py"
IR_COMPILE_FILE = "spfft_tpu_torch/ir/compile.py"
PLANCARD_FILE = "spfft_tpu_torch/obs/plancard.py"

# The engine pipeline modules: every stage label inside them must come from
# obs.STAGES, and every STAGES entry must appear in at least one. The port's
# engines hold the stage bodies; the lowering names their nodes.
IR_LOWER_FILE = "spfft_tpu_torch/ir/lower.py"
ENGINE_FILES = (
    "spfft_tpu_torch/execution.py",
    "spfft_tpu_torch/execution_mxu.py",
    "spfft_tpu_torch/parallel/execution.py",
    "spfft_tpu_torch/parallel/execution_mxu.py",
    "spfft_tpu_torch/parallel/pencil2.py",
    "spfft_tpu_torch/parallel/pencil2_mxu.py",
    IR_LOWER_FILE,
)
# The autotuner's trial runner labels its phases from the same canonical
# vocabulary, under the same both-ways rule as the engines.
TUNING_FILES = ("spfft_tpu_torch/tuning/runner.py",)

KNOB_RE = re.compile(r"SPFFT_TPU_[A-Z0-9_]+")
KNOB_ROW_CALLS = ("register", "Knob")


def package_files(tree: Tree) -> list:
    return tree.py_files(PACKAGE_DIRS)


# =============================================================================
# SA003 env-knob-docs
# =============================================================================


def registry_knobs(tree: Tree) -> dict:
    """``{name: {"internal": bool}}`` parsed from the literal ``Knob(...)``
    rows (or ``register(...)`` calls) in ``spfft_tpu_torch/knobs.py``
    (import-free)."""
    out: dict = {}
    for node in ast.walk(tree.parse(KNOBS_FILE)):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in KNOB_ROW_CALLS
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            continue
        internal = any(
            kw.arg == "internal"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in node.keywords
        )
        out[node.args[0].value] = {"internal": internal, "line": node.lineno}
    return out


@checker(
    "env-knob-docs",
    code="SA003",
    doc="Three-way contract over the env-knob surface: every SPFFT_TPU_* "
    "string in the package is registered in spfft_tpu_torch.knobs, every "
    "non-internal registered knob is documented in docs/torch/details.md "
    "and referenced by package code, and every knob the docs mention is "
    "still registered. The registry (its Knob(...) rows, read via ast) is "
    "the single source; internal=True rows are the registry-level docs "
    "exemptions.",
)
def check_env_knob_docs(tree: Tree):
    skip, findings = missing_anchor(check_env_knob_docs, tree, KNOBS_FILE)
    if skip:
        return findings
    registered = registry_knobs(tree)
    in_package: dict = {}  # knob -> first (file, line)
    for rel in package_files(tree):
        if rel == KNOBS_FILE:
            continue
        for i, line in enumerate(tree.lines(rel), 1):
            for knob in KNOB_RE.findall(line):
                in_package.setdefault(knob, (rel, i))
    in_harness: dict = {}  # env reads in the harness and the tests
    for rel in tree.py_files(HARNESS_DIRS):
        for i, line in enumerate(tree.lines(rel), 1):
            if "environ" in line or "getenv" in line or "knobs." in line:
                for knob in KNOB_RE.findall(line):
                    in_harness.setdefault(knob, (rel, i))
    for knob, (rel, lineno) in sorted({**in_harness, **in_package}.items()):
        if knob not in registered:
            findings.append(
                check_env_knob_docs.finding(
                    rel, lineno,
                    f"env knob {knob} is not registered in spfft_tpu_torch.knobs "
                    "(the registry is the single allowed knob surface)",
                )
            )
    doc_knobs: set = set()
    if tree.exists(DOCS_PATH):
        doc_knobs = set(KNOB_RE.findall(tree.source(DOCS_PATH)))
        for knob in sorted(doc_knobs):
            if knob not in registered:
                findings.append(
                    check_env_knob_docs.finding(
                        DOCS_PATH, 0,
                        f"env knob {knob} is documented but no longer "
                        "registered in spfft_tpu_torch.knobs (dead doc)",
                    )
                )
    elif not tree.partial:
        findings.append(
            check_env_knob_docs.finding(
                DOCS_PATH, 0, f"{DOCS_PATH} is missing"
            )
        )
        return findings
    for knob, info in sorted(registered.items()):
        if info["internal"]:
            continue
        if not tree.partial and knob not in doc_knobs:
            findings.append(
                check_env_knob_docs.finding(
                    KNOBS_FILE, info["line"],
                    f"env knob {knob} is registered but not documented in "
                    f"{DOCS_PATH} (regenerate the knob table: "
                    f"python {GEN_DOCS})",
                )
            )
        if knob not in in_package:
            findings.append(
                check_env_knob_docs.finding(
                    KNOBS_FILE, info["line"],
                    f"env knob {knob} is registered but referenced by no "
                    "package code (dead knob — delete the registration or "
                    "mark it internal)",
                )
            )
    return findings


# =============================================================================
# SA004 stage-scope
# =============================================================================


def _call_literals(scope, name: str) -> list:
    """The positional arguments of every call of ``name`` by plain name
    under ``scope``, the string literals kept (else None)."""
    return [
        [
            a.value if isinstance(a, ast.Constant) and isinstance(a.value, str)
            else None
            for a in node.args
        ]
        for node in ast.walk(scope)
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == name
    ]


def _fstring_labels(mod) -> dict:
    """``{id(JoinedStr): {label, ...}}`` for the f-strings whose every
    placeholder is a parameter of the enclosing function that every call of
    it in the scope defining it passes as a string literal
    (``exchange(g, "A", ...)`` with ``f"pack {tag}"`` inside): the stage
    labels such a helper builds."""
    out: dict = {}
    for parent in ast.walk(mod):
        body = getattr(parent, "body", None)
        for fn in body if isinstance(body, list) else ():
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            params = [a.arg for a in fn.args.args]
            calls = _call_literals(parent, fn.name)
            for node in ast.walk(fn):
                if not isinstance(node, ast.JoinedStr):
                    continue
                labels = [""]
                for part in node.values:
                    if isinstance(part, ast.Constant):
                        labels = [p + str(part.value) for p in labels]
                        continue
                    value = getattr(part, "value", None)
                    if not (
                        isinstance(value, ast.Name)
                        and value.id in params
                        and getattr(part, "conversion", -1) == -1
                        and getattr(part, "format_spec", None) is None
                    ):
                        labels = []
                        break
                    i = params.index(value.id)
                    args = [c[i] if i < len(c) else None for c in calls]
                    if not args or None in args:
                        labels = []
                        break
                    labels = [p + a for p in labels for a in sorted(set(args))]
                if labels:
                    out[id(node)] = set(labels)
    return out


def _pipeline_strings(mod) -> set:
    """String constants of an engine/tuning file (and the labels its
    f-string helpers build), EXCLUDING those inside the
    ``stage_accounting`` perf hooks: the hooks restate every stage name for
    the flop/byte model, so counting them would let the coverage directions
    satisfy themselves."""
    skip: set = set()
    for node in ast.walk(mod):
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "stage_accounting"
        ):
            for sub in ast.walk(node):
                skip.add(id(sub))
    out = {
        node.value
        for node in ast.walk(mod)
        if isinstance(node, ast.Constant)
        and isinstance(node.value, str)
        and id(node) not in skip
    }
    for key, labels in _fstring_labels(mod).items():
        if key not in skip:
            out |= labels
    return out


def _stage_labels(mod):
    """``(kind, label, lineno)`` of every stage label in a pipeline file:
    the literal argument of a ``timing.trace_annotation(...)`` range, and
    the first argument of a stage-graph ``<graph>.add(...)`` node (a
    literal, or an f-string resolved by :func:`_fstring_labels`)."""
    fstrings = _fstring_labels(mod)
    for node in ast.walk(mod):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if not node.args:
            continue
        arg = node.args[0]
        if node.func.attr == "trace_annotation":
            if isinstance(arg, ast.Constant):
                yield "trace_annotation", arg.value, arg.lineno
        elif (
            node.func.attr == "add"
            and isinstance(node.func.value, ast.Name)
            and len(node.args) >= 3
        ):
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield "stage label", arg.value, arg.lineno
            elif id(arg) in fstrings:
                for label in sorted(fstrings[id(arg)]):
                    yield "stage label", label, arg.lineno


@checker(
    "stage-scope",
    code="SA004",
    doc="Every stage label in an engine or tuning pipeline — a "
    "timing.trace_annotation range (the port's jax.named_scope) or a "
    "stage-graph node label in ir/lower.py — comes from the canonical "
    "obs.STAGES list, and every listed stage appears in at least one "
    "pipeline: profiler traces stay attributable against one vocabulary.",
)
def check_stage_scopes(tree: Tree):
    skip, findings = missing_anchor(check_stage_scopes, tree, STAGES_FILE)
    if skip:
        return findings
    stages = tuple(tree.literal_assign(STAGES_FILE, "STAGES") or ())
    if len(set(stages)) != len(stages):
        findings.append(
            check_stage_scopes.finding(
                STAGES_FILE, 0, "duplicate entries in STAGES"
            )
        )
    strings: set = set()
    used: dict = {}
    for rel in ENGINE_FILES + TUNING_FILES:
        if not tree.exists(rel):
            if not tree.partial:
                findings.append(
                    check_stage_scopes.finding(
                        rel, 0, "engine/tuning pipeline file is missing"
                    )
                )
            continue
        mod = tree.parse(rel)
        strings |= _pipeline_strings(mod)
        for kind, label, lineno in _stage_labels(mod):
            used.setdefault(label, (kind, rel, lineno))
    for label, (kind, rel, lineno) in sorted(used.items()):
        if label not in stages:
            findings.append(
                check_stage_scopes.finding(
                    rel, lineno,
                    f"{kind} {label!r} is not in the canonical stage "
                    f"list ({STAGES_FILE})",
                )
            )
    for stage in stages:
        if stage not in strings:
            findings.append(
                check_stage_scopes.finding(
                    STAGES_FILE, 0,
                    f"stage {stage!r} appears in no engine or tuning "
                    "pipeline",
                )
            )
    return findings


# =============================================================================
# SA005 fault-site
# =============================================================================


@checker(
    "fault-site",
    code="SA005",
    doc="Every faults.site(...) call names a site registered in the "
    "canonical faults.SITES vocabulary, every registered site is threaded "
    "through the package at least once, and every site is documented — the "
    "chaos suite's arm-every-site sweep is only exhaustive if the "
    "vocabulary is.",
)
def check_fault_sites(tree: Tree):
    skip, findings = missing_anchor(check_fault_sites, tree, FAULTS_PLANE_FILE)
    if skip:
        return findings
    sites = tuple(tree.literal_assign(FAULTS_PLANE_FILE, "SITES") or ())
    if len(set(sites)) != len(sites):
        findings.append(
            check_fault_sites.finding(
                FAULTS_PLANE_FILE, 0, "duplicate entries in SITES"
            )
        )
    used: dict = {}
    for rel in package_files(tree):
        if rel == FAULTS_PLANE_FILE:
            continue  # the registry itself is not a threading site
        mod = tree.parse(rel)
        for node in ast.walk(mod):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "site"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "faults"
            ):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)):
                findings.append(
                    check_fault_sites.finding(
                        rel, node.lineno,
                        "faults.site(...) must take a literal site name "
                        "(static analysis cannot check dynamic names)",
                    )
                )
                continue
            name = node.args[0].value
            if name not in sites:
                findings.append(
                    check_fault_sites.finding(
                        rel, node.lineno,
                        f"fault site {name!r} is not registered in the "
                        f"canonical vocabulary ({FAULTS_PLANE_FILE})",
                    )
                )
            used.setdefault(name, (rel, node.lineno))
    for name in sites:
        if name not in used:
            findings.append(
                check_fault_sites.finding(
                    FAULTS_PLANE_FILE, 0,
                    f"site {name!r} is registered but threaded through no "
                    "package code path",
                )
            )
    if tree.exists(DOCS_PATH):
        docs_text = tree.source(DOCS_PATH)
        for name in sites:
            if name not in docs_text:
                findings.append(
                    check_fault_sites.finding(
                        DOCS_PATH, 0,
                        f"fault site {name!r} is not documented",
                    )
                )
    return findings


# =============================================================================
# SA006 trace-event
# =============================================================================

TRACE_EMITTERS = ("event", "span", "operation")


def _is_trace_receiver(value) -> bool:
    """Whether a call receiver is the trace module (``trace.x`` after a
    ``from .obs import trace``, or a dotted ``obs.trace.x``)."""
    if isinstance(value, ast.Name):
        return value.id == "trace"
    return isinstance(value, ast.Attribute) and value.attr == "trace"


@checker(
    "trace-event",
    code="SA006",
    doc="Every trace.event/span/operation(...) call in the package names an "
    "event registered in the canonical trace.EVENTS vocabulary, and every "
    "registered event is emitted by at least one package call site — "
    "flight-recorder streams and their consumers stay on one vocabulary.",
)
def check_trace_events(tree: Tree):
    skip, findings = missing_anchor(check_trace_events, tree, TRACE_FILE)
    if skip:
        return findings
    events = tuple(tree.literal_assign(TRACE_FILE, "EVENTS") or ())
    if len(set(events)) != len(events):
        findings.append(
            check_trace_events.finding(
                TRACE_FILE, 0, "duplicate entries in EVENTS"
            )
        )
    used: dict = {}
    for rel in package_files(tree):
        if rel == TRACE_FILE:
            continue  # the recorder itself is not an emission site
        for node in ast.walk(tree.parse(rel)):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in TRACE_EMITTERS
                and _is_trace_receiver(node.func.value)
            ):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)):
                findings.append(
                    check_trace_events.finding(
                        rel, node.lineno,
                        f"trace.{node.func.attr}(...) must take a literal "
                        "event name (static analysis cannot check dynamic "
                        "names)",
                    )
                )
                continue
            name = node.args[0].value
            if name not in events:
                findings.append(
                    check_trace_events.finding(
                        rel, node.lineno,
                        f"trace event {name!r} is not registered in the "
                        f"canonical vocabulary ({TRACE_FILE})",
                    )
                )
            used.setdefault(name, (rel, node.lineno))
    for name in events:
        if name not in used:
            findings.append(
                check_trace_events.finding(
                    TRACE_FILE, 0,
                    f"event {name!r} is registered but emitted by no "
                    "package code path",
                )
            )
    return findings


# =============================================================================
# SA007 verify-check
# =============================================================================


@checker(
    "verify-check",
    code="SA007",
    doc="The canonical verify.CHECKS vocabulary matches the CHECK_FNS "
    "implementation registry exactly both ways, and every check is "
    "documented — the ABFT layer's instance of the both-ways contract.",
)
def check_verify_checks(tree: Tree):
    skip, findings = missing_anchor(
        check_verify_checks, tree, VERIFY_CHECKS_FILE
    )
    if skip:
        return findings
    checks = tuple(tree.literal_assign(VERIFY_CHECKS_FILE, "CHECKS") or ())
    fns: tuple = ()
    for node in tree.parse(VERIFY_CHECKS_FILE).body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "CHECK_FNS"
            for t in node.targets
        ):
            if not isinstance(node.value, ast.Dict):
                findings.append(
                    check_verify_checks.finding(
                        VERIFY_CHECKS_FILE, node.lineno,
                        "CHECK_FNS must be a dict literal",
                    )
                )
                return findings
            fns = tuple(
                k.value for k in node.value.keys if isinstance(k, ast.Constant)
            )
    if len(set(checks)) != len(checks):
        findings.append(
            check_verify_checks.finding(
                VERIFY_CHECKS_FILE, 0, "duplicate entries in CHECKS"
            )
        )
    for name in checks:
        if name not in fns:
            findings.append(
                check_verify_checks.finding(
                    VERIFY_CHECKS_FILE, 0,
                    f"check {name!r} is registered in CHECKS but has no "
                    "CHECK_FNS implementation",
                )
            )
    for name in fns:
        if name not in checks:
            findings.append(
                check_verify_checks.finding(
                    VERIFY_CHECKS_FILE, 0,
                    f"CHECK_FNS implements {name!r} but it is not "
                    "registered in CHECKS",
                )
            )
    if tree.exists(DOCS_PATH):
        docs_text = tree.source(DOCS_PATH)
        for name in checks:
            if name not in docs_text:
                findings.append(
                    check_verify_checks.finding(
                        DOCS_PATH, 0,
                        f"verify check {name!r} is not documented",
                    )
                )
    return findings


# =============================================================================
# SA008 perf-stage
# =============================================================================


@checker(
    "perf-stage",
    code="SA008",
    doc="perf.MODELED_STAGES equals the engine-pipeline subset of "
    "obs.STAGES exactly both ways: every modeled stage is canonical and "
    "appears in an engine pipeline, every engine-pipeline stage carries a "
    "flop/byte model (tuning-only trial phases are harness stages, exempt).",
)
def check_perf_stages(tree: Tree):
    for anchor in (PERF_FILE, STAGES_FILE):
        skip, findings = missing_anchor(check_perf_stages, tree, anchor)
        if skip:
            return findings
    stages = tuple(tree.literal_assign(STAGES_FILE, "STAGES") or ())
    modeled = tuple(tree.literal_assign(PERF_FILE, "MODELED_STAGES") or ())
    findings = []
    if len(set(modeled)) != len(modeled):
        findings.append(
            check_perf_stages.finding(
                PERF_FILE, 0, "duplicate entries in MODELED_STAGES"
            )
        )
    engine_strings: set = set()
    for rel in ENGINE_FILES:
        if tree.exists(rel):
            # accounting hooks excluded (_pipeline_strings): membership here
            # must mean "the compiled pipeline tags this stage", not "the
            # perf model mentions it"
            engine_strings |= _pipeline_strings(tree.parse(rel))
    engine_stages = [s for s in stages if s in engine_strings]
    for name in modeled:
        if name not in stages:
            findings.append(
                check_perf_stages.finding(
                    PERF_FILE, 0,
                    f"modeled stage {name!r} is not in the canonical stage "
                    f"list ({STAGES_FILE})",
                )
            )
        elif name not in engine_stages:
            findings.append(
                check_perf_stages.finding(
                    PERF_FILE, 0,
                    f"modeled stage {name!r} appears in no engine pipeline",
                )
            )
    for name in engine_stages:
        if name not in modeled:
            findings.append(
                check_perf_stages.finding(
                    STAGES_FILE, 0,
                    f"engine stage {name!r} carries no flop/byte model in "
                    f"{PERF_FILE} (MODELED_STAGES)",
                )
            )
    return findings


# =============================================================================
# SA009 ir-node (+ plan-card IR_KEYS mirror)
# =============================================================================


@checker(
    "ir-node",
    code="SA009",
    doc="The stage-graph IR's NODES vocabulary matches obs.STAGES and "
    "perf.MODELED_STAGES both ways (an IR stage can never escape profiler "
    "attribution or perf accounting), and the plan card's IR_SECTION_KEYS "
    "mirror of ir.compile.IR_KEYS is identical (cards missing a new ir key "
    "must not pass schema validation).",
)
def check_ir_nodes(tree: Tree):
    for anchor in (IR_GRAPH_FILE, STAGES_FILE, PERF_FILE):
        skip, findings = missing_anchor(check_ir_nodes, tree, anchor)
        if skip:
            return findings
    stages = tuple(tree.literal_assign(STAGES_FILE, "STAGES") or ())
    modeled = tuple(tree.literal_assign(PERF_FILE, "MODELED_STAGES") or ())
    nodes = tuple(tree.literal_assign(IR_GRAPH_FILE, "NODES") or ())
    findings = []
    if len(set(nodes)) != len(nodes):
        findings.append(
            check_ir_nodes.finding(
                IR_GRAPH_FILE, 0, "duplicate entries in NODES"
            )
        )
    for name in nodes:
        if name not in stages:
            findings.append(
                check_ir_nodes.finding(
                    IR_GRAPH_FILE, 0,
                    f"IR node {name!r} is not in the canonical stage list "
                    f"({STAGES_FILE})",
                )
            )
        if name not in modeled:
            findings.append(
                check_ir_nodes.finding(
                    IR_GRAPH_FILE, 0,
                    f"IR node {name!r} carries no flop/byte model in "
                    f"{PERF_FILE} (MODELED_STAGES)",
                )
            )
    for name in modeled:
        if name not in nodes:
            findings.append(
                check_ir_nodes.finding(
                    PERF_FILE, 0,
                    f"modeled stage {name!r} is not an IR node "
                    f"({IR_GRAPH_FILE} NODES) — the stage graph cannot "
                    "express it",
                )
            )
    # the plan-card mirror: IR_SECTION_KEYS (plancard stays import-free)
    # must equal the source-of-truth IR_KEYS literal in ir/compile.py
    if tree.exists(IR_COMPILE_FILE) and tree.exists(PLANCARD_FILE):
        ir_keys = tree.literal_assign(IR_COMPILE_FILE, "IR_KEYS")
        card_keys = tree.literal_assign(PLANCARD_FILE, "IR_SECTION_KEYS")
        if tuple(ir_keys or ()) != tuple(card_keys or ()):
            findings.append(
                check_ir_nodes.finding(
                    PLANCARD_FILE, 0,
                    f"IR_SECTION_KEYS {tuple(card_keys or ())!r} does not "
                    f"match {IR_COMPILE_FILE} IR_KEYS "
                    f"{tuple(ir_keys or ())!r} — the card validator would "
                    "accept cards missing (or carrying stale) ir keys",
                )
            )
        # the batch-section mirror follows the same contract
        batch_keys = tree.literal_assign(IR_COMPILE_FILE, "BATCH_KEYS")
        card_batch = tree.literal_assign(PLANCARD_FILE, "BATCH_SECTION_KEYS")
        if tuple(batch_keys or ()) != tuple(card_batch or ()):
            findings.append(
                check_ir_nodes.finding(
                    PLANCARD_FILE, 0,
                    f"BATCH_SECTION_KEYS {tuple(card_batch or ())!r} does "
                    f"not match {IR_COMPILE_FILE} BATCH_KEYS "
                    f"{tuple(batch_keys or ())!r} — the card validator "
                    "would accept cards missing (or carrying stale) batch "
                    "keys",
                )
            )
    elif not tree.partial:
        findings.append(
            check_ir_nodes.finding(
                IR_COMPILE_FILE, 0,
                "ir/compile.py or obs/plancard.py is missing — the IR_KEYS "
                "mirror check cannot run",
            )
        )
    return findings
