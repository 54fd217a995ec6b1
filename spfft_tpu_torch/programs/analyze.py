"""Static-analysis CLI: run the ``spfft_tpu_torch.analysis`` checkers as a gate.

The port's copy of the JAX package's ``programs/analyze.py``, over the
port's tree and its own baseline (``analysis_baseline_torch.json``). Run it
by its path, so that neither ``spfft_tpu_torch/__init__`` nor ``torch`` is
imported:

    python spfft_tpu_torch/programs/analyze.py                 # full gate
    python spfft_tpu_torch/programs/analyze.py --json -        # the JSON report
    python spfft_tpu_torch/programs/analyze.py --only SA011    # one checker
    python spfft_tpu_torch/programs/analyze.py --write-baseline  # accept findings
    python spfft_tpu_torch/programs/analyze.py --list          # the catalog
    python spfft_tpu_torch/programs/analyze.py --list-noqa     # suppression audit
    python spfft_tpu_torch/programs/analyze.py --lockdep-check R.json  # runtime graph

Exit status: 0 green (every finding baselined, no stale baseline entries),
3 when the gate trips — a NEW finding, a STALE baseline entry (a fixed
finding must leave the baseline, or the baseline rots into a blanket
waiver), an ORPHANED ``# noqa`` suppression under ``--list-noqa``, or an
unexplained runtime lock edge under ``--lockdep-check`` — and 2 on usage
errors. The distinct exit 3 is the same convention as
``perf_gate``: a tripped gate, not a crashed tool.

Checkers run on a thread pool by default (``--jobs``, pure functions of
the parsed tree; ``--jobs 1`` for the serial reference — the test suite
asserts identical findings both ways).

The analysis package is loaded standalone (no ``spfft_tpu_torch`` import,
no ``torch``, nothing of ``spfft_tpu``), so the gate runs in about a second
on a host with no accelerator stack.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
# run by its path, this folder heads sys.path: its trace.py and profile.py
# must not stand in for the standard library's modules of those names
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]

PACKAGE = "spfft_tpu_torch"
BASELINE_FILE = "analysis_baseline_torch.json"
_PKG_NAME = "spfft_tpu_torch_analysis_standalone"


def load_analysis(root: Path = ROOT):
    """Load ``spfft_tpu_torch/analysis`` as a standalone package (relative
    imports intact, ``spfft_tpu_torch/__init__`` — and therefore torch —
    never executed)."""
    if _PKG_NAME in sys.modules:
        return sys.modules[_PKG_NAME]
    pkg_dir = root / PACKAGE / "analysis"
    spec = importlib.util.spec_from_file_location(
        _PKG_NAME,
        pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)],
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_PKG_NAME] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[_PKG_NAME]
        raise
    return mod


def _ran_codes(analysis, only) -> set:
    """Codes of the checkers a ``--only`` selection actually runs."""
    wanted = set(only)
    return {
        c.code for c in analysis.CHECKERS.values()
        if c.name in wanted or c.code in wanted
    }


# The import-hygiene checkers honor the legacy "any noqa on the line"
# contract INSIDE the checker, so a raw run cannot distinguish their live
# suppressions from orphans — the audit counts them live.
SELF_EXEMPT_CODES = ("SA001", "SA002")


def run_list_noqa(analysis, *, root: Path, quiet=False) -> int:
    """The suppression audit: every in-tree ``# noqa: SA*`` with its
    checker doc, ORPHANED ones (the code no longer fires on that line)
    exit 3 — a dead suppression hides the next real regression there."""
    tree = analysis.Tree(root=root)
    suppressions = analysis.list_noqa(tree)
    raw = analysis.run(tree, suppress=False)
    fired = {(f.code, f.file, f.line) for f in raw}
    by_code = {c.code: c for c in analysis.CHECKERS.values()}
    orphans = 0
    for row in suppressions:
        for code in row["codes"]:
            entry = by_code.get(code)
            live = (
                code in SELF_EXEMPT_CODES
                or (code, row["file"], row["line"]) in fired
            )
            status = "live" if live else "ORPHANED"
            if not live:
                orphans += 1
            if not quiet or not live:
                name = entry.name if entry else "unknown checker"
                print(f"{row['file']}:{row['line']}: {code} ({name}) — {status}")
                if entry and not live:
                    print(f"    {entry.doc}")
    if orphans:
        print(
            f"noqa audit TRIPPED: {orphans} orphaned suppression(s) — the "
            "code no longer fires there; delete the noqa (or it will hide "
            "the next real finding on that line)"
        )
        return 3
    if not quiet:
        print(f"noqa audit ok: {len(suppressions)} suppression(s), all live")
    return 0


def run_lockdep_check(analysis, *, root: Path, report_paths) -> int:
    """Cross-check runtime lockdep report(s) against the SA011 static
    graph: unexplained runtime edges (the static model is stale), observed
    cycles, and blocking waits exit 3. Multiple reports (one per worker
    host of a multi-host run) merge into one site-keyed graph first
    (:func:`spfft_tpu_torch.analysis.lockdep.merge_reports`)."""
    if isinstance(report_paths, (str, Path)):
        report_paths = [report_paths]
    docs = []
    for report_path in report_paths:
        try:
            one = json.loads(Path(report_path).read_text())
        except OSError as e:
            print(f"cannot read lockdep report: {e}", file=sys.stderr)
            return 2
        except json.JSONDecodeError as e:
            print(
                f"malformed lockdep report {report_path}: {e}",
                file=sys.stderr,
            )
            return 2
        missing = analysis.lockdep.validate_report(one)
        if missing:
            print(
                f"lockdep report {report_path} schema incomplete: {missing}",
                file=sys.stderr,
            )
            return 2
        docs.append(one)
    doc = docs[0] if len(docs) == 1 else analysis.lockdep.merge_reports(docs)
    static = analysis.locks.static_graph(analysis.Tree(root=root))
    chk = analysis.lockdep.crosscheck(doc, static)
    for f in chk["findings"]:
        print(f"{f['where']}: [lockdep:{f['kind']}] {f['message']}")
    n_static = len(chk["explained"]["static"])
    n_dynamic = len(chk["explained"]["dynamic"])
    print(
        f"lockdep cross-check ({len(docs)} report(s)): "
        f"{doc['counts']['locks']} lock(s), "
        f"{doc['counts']['edges']} edge(s) — {n_static} matched the static "
        f"graph, {n_dynamic} on dynamic (statically untracked) locks, "
        f"{len(chk['findings'])} finding(s)"
    )
    return 3 if chk["findings"] else 0


def run_gate(
    analysis,
    *,
    root: Path,
    baseline_path: Path,
    only=None,
    json_out=None,
    write_baseline=False,
    quiet=False,
    jobs=None,
) -> int:
    """The gate body (``lint.py`` reuses it for checkers 1-9)."""
    tree = analysis.Tree(root=root)
    findings = analysis.run(tree, only=only, jobs=jobs)

    if write_baseline:
        doc = analysis.baseline_doc(findings)
        if only:
            # a subset write replaces only the ran checkers' entries — the
            # other checkers' accepted findings must survive the rewrite
            ran = _ran_codes(analysis, only)
            kept = {
                k for k in analysis.load_baseline(baseline_path)
                if k.split(":", 1)[0] not in ran
            }
            doc["entries"] = sorted(set(doc["entries"]) | kept)
        baseline_path.write_text(json.dumps(doc, indent=2) + "\n")
        print(
            f"wrote {baseline_path} ({len(doc['entries'])} accepted "
            f"finding(s))"
        )
        return 0

    accepted = analysis.load_baseline(baseline_path)
    if only:
        # a subset run must not call the other checkers' baseline entries
        # stale: restrict staleness to the codes that actually ran
        accepted = {
            k for k in accepted
            if k.split(":", 1)[0] in _ran_codes(analysis, only)
        }
    split = analysis.apply_baseline(findings, accepted)

    if json_out is not None:
        doc = analysis.report_doc(
            findings, split, root=str(root), baseline_path=str(baseline_path)
        )
        text = json.dumps(doc, indent=2) + "\n"
        if json_out == "-":
            sys.stdout.write(text)
        else:
            Path(json_out).write_text(text)

    if not quiet and json_out != "-":
        for f in split["new"]:
            print(f.render())
        if split["baselined"]:
            print(
                f"{len(split['baselined'])} baselined finding(s) "
                f"(accepted in {baseline_path.name})"
            )
        for key in split["stale"]:
            print(
                f"stale baseline entry (the finding was fixed — remove it "
                f"or rerun --write-baseline): {key}"
            )
    if split["new"] or split["stale"]:
        if not quiet and json_out != "-":
            print(
                f"analysis gate TRIPPED: {len(split['new'])} new finding(s), "
                f"{len(split['stale'])} stale baseline entr(ies)"
            )
        return 3
    if not quiet and json_out != "-":
        names = only or list(analysis.CHECKERS)
        print(
            f"analysis ok: {len(names)} checker(s), "
            f"{len(findings)} finding(s), all baselined"
        )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--json", metavar="PATH",
        help="write the spfft_tpu_torch.analysis/1 JSON report (- for stdout)",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="accept every current finding into the baseline file and exit 0",
    )
    p.add_argument(
        "--only", action="append", metavar="CHECKER",
        help="run one checker (code SA0NN or slug name); repeatable",
    )
    p.add_argument(
        "--root", default=str(ROOT), metavar="DIR",
        help="tree to analyze (default: this checkout)",
    )
    p.add_argument(
        "--baseline", metavar="PATH",
        help=f"baseline file (default: <root>/{BASELINE_FILE})",
    )
    p.add_argument(
        "--list", action="store_true", help="print the checker catalog"
    )
    p.add_argument(
        "--list-noqa", action="store_true",
        help="audit every in-tree `# noqa: SA*` suppression; orphaned "
        "suppressions (the code no longer fires on that line) exit 3",
    )
    p.add_argument(
        "--lockdep-check", metavar="REPORT", nargs="+",
        help="cross-check runtime lockdep report(s) "
        "(spfft_tpu_torch.analysis.lockdep/1 JSON) against the SA011 static "
        "graph; multiple reports — e.g. one per worker host of a "
        "multi-host run — are merged (lockdep.merge_reports) and checked "
        "as one graph; unexplained edges/cycles/blocking exit 3",
    )
    p.add_argument(
        "--jobs", type=int, default=None, metavar="N",
        help="checker thread-pool width (default: one per CPU, capped 8; "
        "1 = serial)",
    )
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)

    root = Path(args.root).resolve()
    analysis = load_analysis(root if (root / PACKAGE / "analysis").is_dir() else ROOT)

    if args.list:
        for entry in analysis.CHECKERS.values():
            print(f"{entry.code}  {entry.severity:5s}  {entry.name}")
        return 0

    try:
        if args.list_noqa:
            return run_list_noqa(analysis, root=root, quiet=args.quiet)
        if args.lockdep_check:
            return run_lockdep_check(
                analysis, root=root, report_paths=args.lockdep_check
            )
        jobs = args.jobs
        if jobs is None:
            import os

            jobs = min(8, os.cpu_count() or 1)
        baseline_path = Path(
            args.baseline if args.baseline else root / BASELINE_FILE
        )
        return run_gate(
            analysis,
            root=root,
            baseline_path=baseline_path,
            only=args.only,
            json_out=args.json,
            write_baseline=args.write_baseline,
            quiet=args.quiet,
            jobs=jobs,
        )
    except analysis.AnalysisError as e:
        print(f"analysis error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
