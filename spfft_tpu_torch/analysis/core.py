"""Framework core of the port's static-analysis engine.

The port of ``spfft_tpu/analysis/core.py``: the same pieces, the same
semantics, over the port's scan roots.

* :class:`Finding` — one defect record (``file:line``, checker code, a
  line-number-free message so baselines survive unrelated edits).
* :class:`Checker` + :func:`checker` — the registry: every checker declares
  a stable short code (``SA001``...), a slug name (``duplicate-import``),
  a severity, and a one-paragraph doc (the catalog in
  ``docs/torch/api/analysis.md`` renders from these).
* :class:`Tree` — the source under analysis: the real repository (rooted)
  or an in-memory ``{relpath: source}`` map (test fixtures). Parses are
  cached so the checkers share one ``ast`` per file.
* :func:`run` — execute (a subset of) the registry over a tree, dropping
  findings suppressed by ``# noqa: <CODE>`` comments.
* Baseline machinery — :func:`load_baseline` / :func:`apply_baseline` /
  :func:`baseline_doc`: accepted findings (keyed ``CODE:file:message``)
  don't block the gate, NEW findings fail with exit 3, and a baseline entry
  whose finding was fixed is *stale* and fails too.
* :func:`report_doc` — the ``spfft_tpu_torch.analysis/1`` JSON report.

Scan roots. *Package* code is ``spfft_tpu_torch/`` without its harness
folders; *harness* code is ``spfft_tpu_torch/programs/``, ``examples/`` and
``native/`` (the JAX package keeps the same code in the top-level
``programs/``, ``examples/`` and ``native/``); *tests* are
``tests/test_torch_*.py`` (the JAX package's tests are its own gate's).
Checkers that hold package code to a rule scan the package; the vocabulary
checkers also read the harness and the tests, as the JAX ones read
``programs/`` and ``tests/``.

Import discipline: this package must be loadable WITHOUT importing
``spfft_tpu_torch`` itself (which pulls ``torch``) —
``spfft_tpu_torch/programs/analyze.py`` loads it standalone. Stdlib only,
and nothing of ``spfft_tpu/``: sibling knowledge (the knob registry,
vocabulary tuples) is read via ``ast``, never imported.
"""
from __future__ import annotations

import ast
import fnmatch
import io
import json
import re
import tokenize
from pathlib import Path

SCHEMA = "spfft_tpu_torch.analysis/1"
BASELINE_SCHEMA = "spfft_tpu_torch.analysis.baseline/1"

PACKAGE = "spfft_tpu_torch"
HARNESS_SUBDIRS = ("programs", "examples", "native")
TESTS_DIR = "tests"
TESTS_GLOB = "test_torch_*.py"

# scope names for Tree.py_files
PACKAGE_DIRS = ("package",)
HARNESS_DIRS = ("harness", "tests")
TESTS_DIRS = ("tests",)
SCAN_DIRS = ("package", "harness", "tests")

DOCS_PATH = "docs/torch/details.md"
GEN_DOCS = f"{PACKAGE}/programs/gen_api_docs.py"

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<codes>[A-Za-z0-9, ]+))?")


def scope_of(rel: str):
    """``"package"``, ``"harness"``, ``"tests"`` or None for a relpath."""
    parts = rel.split("/")
    if parts[0] == PACKAGE and len(parts) > 1:
        return "harness" if len(parts) > 2 and parts[1] in HARNESS_SUBDIRS else "package"
    if len(parts) == 2 and parts[0] == TESTS_DIR and fnmatch.fnmatch(parts[1], TESTS_GLOB):
        return "tests"
    return None


class AnalysisError(Exception):
    """Internal analysis failure (bad tree, malformed baseline) — distinct
    from findings, which are results, not errors."""


class Finding:
    """One defect record. ``message`` must not embed line numbers: the
    baseline key is ``CODE:file:message`` so accepted findings survive
    unrelated edits that shift lines."""

    __slots__ = ("code", "checker", "severity", "file", "line", "message")

    def __init__(self, code, checker, severity, file, line, message):
        self.code = code
        self.checker = checker
        self.severity = severity
        self.file = str(file)
        self.line = int(line)
        self.message = str(message)

    def key(self) -> str:
        return f"{self.code}:{self.file}:{self.message}"

    def render(self) -> str:
        where = f"{self.file}:{self.line}" if self.line else self.file
        return f"{where}: [{self.code}] {self.message}"

    def to_json(self) -> dict:
        return {
            "code": self.code,
            "checker": self.checker,
            "severity": self.severity,
            "file": self.file,
            "line": self.line,
            "message": self.message,
            "key": self.key(),
        }


class Checker:
    """One registered checker: stable code, slug name, severity, doc, fn.

    ``fn(tree)`` returns a list of :class:`Finding`; it must emit findings
    with ``code=self.code`` (the :func:`checker` decorator binds a
    convenience constructor onto the wrapper for that)."""

    __slots__ = ("code", "name", "severity", "doc", "fn")

    def __init__(self, code, name, severity, doc, fn):
        self.code = code
        self.name = name
        self.severity = severity
        self.doc = doc
        self.fn = fn

    def describe(self) -> dict:
        return {
            "code": self.code,
            "name": self.name,
            "severity": self.severity,
            "doc": self.doc,
        }


CHECKERS: dict = {}  # name -> Checker, insertion-ordered (SA001..SA019)
_BY_CODE: dict = {}


def checker(name: str, *, code: str, severity: str = "error", doc: str):
    """Register a checker function. The decorated function gains a
    ``finding(file, line, message)`` attribute pre-bound to its code."""

    def decorate(fn):
        if name in CHECKERS or code in _BY_CODE:
            raise AnalysisError(f"checker {name}/{code} registered twice")

        def finding(file, line, message):
            return Finding(code, name, severity, file, line, message)

        fn.finding = finding
        entry = Checker(code, name, severity, doc, fn)
        CHECKERS[name] = entry
        _BY_CODE[code] = entry
        return fn

    return decorate


class Tree:
    """The source under analysis.

    Rooted mode (``Tree(root=...)``) walks the real repository; in-memory
    mode (``Tree(files={relpath: source})``) serves test fixtures without a
    filesystem. ``partial`` is True for in-memory trees: checkers anchored
    on specific repo files (vocabulary registries, ``docs/torch/details.md``)
    no-op when their anchor is absent from a *partial* tree, but report a
    missing anchor loudly on a rooted one — a renamed anchor file must
    never silently disable its checker."""

    def __init__(self, root=None, files=None):
        if (root is None) == (files is None):
            raise AnalysisError("Tree needs exactly one of root=/files=")
        self.root = Path(root) if root is not None else None
        self.partial = files is not None
        self._files = dict(files) if files is not None else None
        self._sources: dict = {}
        self._trees: dict = {}

    def py_files(self, dirs=SCAN_DIRS) -> list:
        """Sorted relpaths of every ``.py`` file in the scopes ``dirs``
        (``"package"``, ``"harness"``, ``"tests"``: :func:`scope_of`)."""
        if self._files is not None:
            rels = [rel for rel in self._files if rel.endswith(".py")]
        else:
            rels = []
            base = self.root / PACKAGE
            if base.is_dir():
                rels += [
                    p.relative_to(self.root).as_posix()
                    for p in base.rglob("*.py")
                    if "__pycache__" not in p.parts
                ]
            tests = self.root / TESTS_DIR
            if tests.is_dir():
                rels += [
                    p.relative_to(self.root).as_posix()
                    for p in tests.glob(TESTS_GLOB)
                ]
        return sorted(rel for rel in rels if scope_of(rel) in dirs)

    def exists(self, rel: str) -> bool:
        if self._files is not None:
            return rel in self._files
        return (self.root / rel).is_file()

    def source(self, rel: str) -> str:
        if rel not in self._sources:
            if self._files is not None:
                try:
                    self._sources[rel] = self._files[rel]
                except KeyError:
                    raise AnalysisError(f"no such file in tree: {rel}") from None
            else:
                self._sources[rel] = (self.root / rel).read_text()
        return self._sources[rel]

    def lines(self, rel: str) -> list:
        return self.source(rel).splitlines()

    def parse(self, rel: str):
        """Cached ``ast`` parse; a syntax error is reported by the caller
        as a finding (raised here as :class:`SyntaxError`)."""
        if rel not in self._trees:
            self._trees[rel] = ast.parse(self.source(rel), filename=rel)
        return self._trees[rel]

    def literal_assign(self, rel: str, name: str):
        """A module-level literal assignment ``name = <literal>`` evaluated
        via ``ast.literal_eval`` (the import-free vocabulary-read idiom), or
        ``None`` when absent."""
        for node in self.parse(rel).body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets
            ):
                return ast.literal_eval(node.value)
        return None


def missing_anchor(fn, tree: Tree, rel: str):
    """Anchored-checker preamble: ``(skip, findings)`` for an anchor file.

    Partial (fixture) trees skip silently; a rooted tree missing its anchor
    gets a loud finding — the checker must never evaporate with the file."""
    if tree.exists(rel):
        return False, []
    if tree.partial:
        return True, []
    return True, [
        fn.finding(
            rel, 0,
            "anchor file is missing: this checker's vocabulary source moved "
            "or was deleted — update spfft_tpu_torch/analysis or restore the "
            "file",
        )
    ]


def suppressed(tree: Tree, finding: Finding) -> bool:
    """Whether the finding's source line carries a matching ``# noqa``.

    ``# noqa`` (bare) suppresses any checker on that line; ``# noqa: SA010``
    suppresses the named codes only. Foreign codes (``# noqa: F401`` /
    ``BLE001`` conventions used for editors) do not suppress analysis
    findings."""
    if not finding.line or not tree.exists(finding.file):
        return False
    lines = tree.lines(finding.file)
    if finding.line > len(lines):
        return False
    m = _NOQA_RE.search(lines[finding.line - 1])
    if not m:
        return False
    codes = m.group("codes")
    if codes is None:
        return True
    wanted = {c.strip().upper() for c in codes.split(",")}
    return finding.code.upper() in wanted


def run(tree: Tree, only=None, *, suppress=True, jobs=None) -> list:
    """Run (a subset of) the registered checkers; returns surviving
    findings, sorted (code, file, line, message).

    ``suppress=False`` returns the RAW findings including ``# noqa``-covered
    ones — the orphaned-suppression audit needs to know what would fire
    without the comments.

    ``jobs`` > 1 runs the checkers on a thread pool after pre-parsing every
    scanned file concurrently (checkers are pure functions of the parsed
    tree; a racing double-parse is harmless last-write-wins). The final
    sort makes the result identical to a serial run."""
    names = list(CHECKERS)
    if only:
        only = [only] if isinstance(only, str) else list(only)
        unknown = [n for n in only if n not in CHECKERS and n not in _BY_CODE]
        if unknown:
            raise AnalysisError(
                f"unknown checker(s) {unknown}: expected names "
                f"{sorted(CHECKERS)} or codes {sorted(_BY_CODE)}"
            )
        names = [
            n for n in names
            if n in only or CHECKERS[n].code in only
        ]
    if jobs is not None and jobs > 1 and len(names) > 1:
        from concurrent.futures import ThreadPoolExecutor

        def parse_quiet(rel):
            try:
                tree.parse(rel)
            except SyntaxError:
                pass  # each checker reports/skips syntax errors itself

        with ThreadPoolExecutor(max_workers=jobs) as pool:
            list(pool.map(parse_quiet, tree.py_files()))
            per_checker = list(
                pool.map(lambda name: CHECKERS[name].fn(tree), names)
            )
        raw = [f for batch in per_checker for f in batch]
    else:
        raw = []
        for name in names:
            raw.extend(CHECKERS[name].fn(tree))
    findings = [
        f for f in raw if not suppress or not suppressed(tree, f)
    ]
    findings.sort(key=lambda f: (f.code, f.file, f.line, f.message))
    return findings


def list_noqa(tree: Tree) -> list:
    """Every ``# noqa: SA*`` suppression comment in the scanned tree, as
    ``{"file", "line", "codes"}`` rows (real COMMENT tokens only — prose in
    docstrings that *mentions* a noqa is not a suppression). Bare
    ``# noqa`` and foreign codes (``F401``) are editor vocabulary, skipped.
    The ``--list-noqa`` audit joins these against a ``suppress=False`` run
    to flag ORPHANED suppressions."""
    out = []
    for rel in tree.py_files():
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(tree.source(rel)).readline
            )
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _NOQA_RE.search(tok.string)
                if not m or m.group("codes") is None:
                    continue
                sa_codes = [
                    c.strip().upper()
                    for c in m.group("codes").split(",")
                    if c.strip().upper().startswith("SA")
                ]
                if sa_codes:
                    out.append(
                        {"file": rel, "line": tok.start[0], "codes": sa_codes}
                    )
        except (tokenize.TokenError, SyntaxError, IndentationError):
            continue
    return out


# ---- baseline ----------------------------------------------------------------


def load_baseline(path) -> set:
    """Accepted finding keys from a committed baseline file; an absent file
    is an empty baseline."""
    path = Path(path)
    if not path.is_file():
        return set()
    doc = json.loads(path.read_text())
    if doc.get("schema") != BASELINE_SCHEMA:
        raise AnalysisError(
            f"{path}: unexpected baseline schema {doc.get('schema')!r} "
            f"(expected {BASELINE_SCHEMA})"
        )
    entries = doc.get("entries")
    if not isinstance(entries, list) or not all(
        isinstance(e, str) for e in entries
    ):
        raise AnalysisError(f"{path}: baseline entries must be a string list")
    return set(entries)


def apply_baseline(findings: list, accepted: set) -> dict:
    """Split findings against the accepted set.

    ``new`` fail the gate (exit 3); ``baselined`` are reported but pass;
    ``stale`` are accepted keys no current finding matches — a fixed
    finding must leave the baseline (also exit 3, or the baseline would
    silently rot into a blanket waiver)."""
    current = {f.key() for f in findings}
    return {
        "new": [f for f in findings if f.key() not in accepted],
        "baselined": [f for f in findings if f.key() in accepted],
        "stale": sorted(accepted - current),
    }


def baseline_doc(findings: list) -> dict:
    """The committed-baseline document accepting every given finding."""
    return {
        "schema": BASELINE_SCHEMA,
        "generated_by": f"{PACKAGE}/programs/analyze.py --write-baseline",
        "entries": sorted({f.key() for f in findings}),
    }


# ---- report ------------------------------------------------------------------


def report_doc(findings: list, split: dict, *, root: str, baseline_path: str) -> dict:
    """The ``spfft_tpu_torch.analysis/1`` JSON report."""
    baselined_keys = {f.key() for f in split["baselined"]}
    rows = []
    for f in findings:
        row = f.to_json()
        row["baselined"] = f.key() in baselined_keys
        rows.append(row)
    return {
        "schema": SCHEMA,
        "root": str(root),
        "checkers": [CHECKERS[n].describe() for n in CHECKERS],
        "findings": rows,
        "counts": {
            "total": len(findings),
            "new": len(split["new"]),
            "baselined": len(split["baselined"]),
            "stale_baseline": len(split["stale"]),
        },
        "baseline": {
            "path": str(baseline_path),
            "stale_entries": split["stale"],
        },
    }


REPORT_KEYS = ("schema", "root", "checkers", "findings", "counts", "baseline")
FINDING_KEYS = (
    "code", "checker", "severity", "file", "line", "message", "key",
    "baselined",
)


def validate_report(doc: dict) -> list:
    """Missing-key list for a report document (schema floor; empty =
    valid)."""
    missing = [k for k in REPORT_KEYS if k not in doc]
    if doc.get("schema") != SCHEMA:
        missing.append(f"schema=={SCHEMA}")
    for i, row in enumerate(doc.get("findings", [])):
        for k in FINDING_KEYS:
            if k not in row:
                missing.append(f"findings[{i}].{k}")
    for k in ("total", "new", "baselined", "stale_baseline"):
        if k not in doc.get("counts", {}):
            missing.append(f"counts.{k}")
    return missing
