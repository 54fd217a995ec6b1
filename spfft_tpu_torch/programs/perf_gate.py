"""Performance regression gate: compare a dbench run against a baseline.

The port's copy of the JAX package's ``programs/perf_gate.py`` (it imports
neither package). Every row of a ``dbench`` scaling document (or a
``discipline_compare --matrix`` document, or ``fbench``'s: anything whose
rows carry ``key``/``gflops``/``seconds_noise``) is matched by scenario key
against the baseline and fails the gate when its GFLOP/s fell below

    baseline_gflops * (1 - max(--tolerance, noise_current + noise_baseline))

a **noise-aware threshold**: each row's recorded best-of-R repeat spread
(``seconds_noise``) widens the allowance, capped at ``NOISE_CAP``, so a
transiently busy host cannot fake a regression, while a real slide still
trips. Rows present on only one side are reported but never fail the gate;
``--require-matches`` guards against gating an empty intersection.

Exit status: 0 clean, 1 usage/validation error, 3 regression. The
``bench_results/*_cpu*.json`` baselines are the JAX package's; gate the
port's documents against a baseline the port wrote (``--write-baseline``).

    python -m spfft_tpu_torch.programs.perf_gate current.json baseline.json
    python -m spfft_tpu_torch.programs.perf_gate current.json baseline.json --tolerance 0.6
    python -m spfft_tpu_torch.programs.perf_gate current.json --write-baseline baseline.json
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

DEFAULT_TOLERANCE = 0.35
# ceiling on how far recorded repeat noise may widen a row's allowance: past
# this the gate would stop being a gate (a floor at or below zero passes any
# slowdown), so pathological spreads saturate here instead
NOISE_CAP = 0.55


def load_rows(path: str) -> dict:
    """{key: row} from a dbench/matrix JSON document (validated)."""
    doc = json.loads(Path(path).read_text())
    rows = doc.get("rows", [])
    table = {}
    for i, row in enumerate(rows):
        key = row.get("key")
        if not key:
            raise ValueError(f"{path}: rows[{i}] has no scenario key")
        if "gflops" not in row:
            raise ValueError(f"{path}: rows[{i}] ({key}) has no gflops")
        table[key] = row
    return table


def gate(current: dict, baseline: dict, tolerance: float) -> tuple:
    """(regressions, improvements, unmatched) row comparisons."""
    regressions, lines, unmatched = [], [], []
    for key, row in sorted(current.items()):
        base = baseline.get(key)
        if base is None:
            unmatched.append(f"new row (no baseline): {key}")
            continue
        noise = float(row.get("seconds_noise", 0.0)) + float(
            base.get("seconds_noise", 0.0)
        )
        allowed = max(tolerance, min(noise, NOISE_CAP))
        floor = base["gflops"] * (1.0 - allowed)
        ratio = row["gflops"] / base["gflops"] if base["gflops"] else 1.0
        verdict = "REGRESSION" if row["gflops"] < floor else "ok"
        lines.append(
            f"{verdict:10s} {key}: {row['gflops']:.3f} vs {base['gflops']:.3f} "
            f"GFLOP/s (x{ratio:.2f}, floor x{1 - allowed:.2f})"
        )
        if verdict != "ok":
            regressions.append(lines[-1])
    for key in sorted(set(baseline) - set(current)):
        unmatched.append(f"baseline row not measured: {key}")
    return regressions, lines, unmatched


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("current", help="freshly measured dbench/matrix JSON")
    ap.add_argument("baseline", nargs="?", default=None,
                    help="committed baseline JSON to gate against")
    ap.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE,
                    help="minimum allowed fractional slowdown before the row "
                    "fails (widened per-row by recorded repeat noise); CPU "
                    "meshes want a generous value")
    ap.add_argument("--require-matches", type=int, default=1,
                    help="fail unless at least this many rows matched keys "
                    "(guards against vacuously green gates)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="copy the current document to PATH (baseline "
                    "refresh) instead of gating")
    args = ap.parse_args(argv)

    if args.write_baseline:
        doc = json.loads(Path(args.current).read_text())
        Path(args.write_baseline).write_text(json.dumps(doc, indent=2) + "\n")
        print(f"baseline written to {args.write_baseline} "
              f"({len(doc.get('rows', []))} rows)")
        return 0
    if not args.baseline:
        ap.error("baseline required unless --write-baseline is given")

    try:
        current = load_rows(args.current)
        baseline = load_rows(args.baseline)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"perf_gate: {e}", file=sys.stderr)
        return 1

    regressions, lines, unmatched = gate(current, baseline, args.tolerance)
    for line in lines:
        print(line)
    for note in unmatched:
        print(f"note       {note}")
    matched = len(lines)
    if matched < args.require_matches:
        print(
            f"perf_gate: only {matched} row(s) matched the baseline "
            f"(need {args.require_matches}) — wrong baseline file?",
            file=sys.stderr,
        )
        return 1
    if regressions:
        print(
            f"perf_gate: {len(regressions)} regression(s) past the "
            f"noise-aware threshold",
            file=sys.stderr,
        )
        return 3
    print(f"perf gate clean ({matched} matched rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
