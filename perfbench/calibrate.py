"""The readings the check's limits are set from, in one process on the card.

    python3 perfbench/calibrate.py --workload c2c-256-s15.bands-ahead \\
        --seeds 1 2 3 --control-seeds 4 5 6 --seconds 2

Each seed is one run of the cell through the harness's own path
(:func:`perfbench.run.execute`: set-up, warm-up sweep, a ``--seconds``
window, the check and its verdict by :func:`perfbench.check.judge`), each
with its own plan; a cell over ranks makes them all in one set of workers
(:func:`perfbench.ranks.execute_runs`). ``--seeds`` runs the port as the
configuration states it (the lower readings: sound runs);
``--control-seeds`` runs the control, the port's own path one precision
step down (:data:`CONTROL`), which the check must find not correct (the
upper readings). One JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() not in (ROOT, ROOT / "perfbench")]

# The control's precision: bf16x3 in place of the configurations' 3xTF32
# ("highest"), the step a faster plan would take.
CONTROL = "high"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import ranks, spec
    from perfbench.run import execute

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, CONTROL) for s in args.control_seeds]
    if "ranks" in cell.config:  # one set of workers makes every run, each its own plan
        outs = ranks.execute_runs(cell, [(seed, precision) for _, seed, precision in runs],
                                  args.seconds, False, "cuda")
    else:
        outs = (execute(cell, seed, args.seconds, False, "cuda", precision=precision)
                for _, seed, precision in runs)
    for (side, seed, precision), out in zip(runs, outs):
        row = {"workload": args.workload, "side": side, "seed": seed,
               "precision": precision or cell.config["precision"], "correct": out["correct"],
               "failed": out["failed"], "attempted": out["attempted"],
               **{name: s["value"] for name, s in out["check"].items()}}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
