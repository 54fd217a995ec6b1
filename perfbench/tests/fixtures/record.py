"""Records ``trace_c2c-256-s15_4pairs.json``, the trace that
``test_perfbench_trace.py`` reads, on the card:

    python3 perfbench/tests/fixtures/record.py

Four pairs of ``c2c-256-s15``'s plan (four bands resident), fenced every
two, under ``torch.profiler`` with the harness's ranges, as a traced run
takes its stretch (:func:`perfbench.trace.record_stretch`).
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

from perfbench import drive, inputs, spec, trace  # noqa: E402
from perfbench.run import build  # noqa: E402

PAIRS = 4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("record: needs a CUDA device", file=sys.stderr)
        return 2
    cfg = dict(spec.cell("c2c-256-s15.bands-ahead").config, bands=PAIRS)
    device = torch.device("cuda")
    plan, trip = build(cfg, device)
    values = inputs.band_values(cfg, trip, 1, device)
    potential = inputs.potential(cfg, plan.space_domain_layout, 1, device)
    sweep = drive.Sweep(plan, values, {"fence_every": 2}, potential, [], device)
    sweep.sweep()
    sweep.fence()
    trace.warm()
    events, pairs = trace.record_stretch(sweep, PAIRS)
    assert pairs == PAIRS
    out = Path(__file__).resolve().parent / f"trace_c2c-256-s15_{PAIRS}pairs.json"
    out.write_text(json.dumps({"traceEvents": events}, separators=(",", ":")))
    print(f"record: {len(events)} events to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
