"""Run a traced round trip and export the flight recorder.

The port of the JAX package's ``programs/trace.py``: arms the flight
recorder, builds a plan, runs one backward+forward(FULL) round trip, and
exports what the recorder saw: the event table on stdout (``--last``,
``--run``), the snapshot JSON (``-o``) and the Chrome trace-event format
(``--chrome``), one track per host phase. The snapshot is validated
(``trace.validate_trace``) before it is written; a malformed event exits 1.
Plans run on the card unless ``--device cpu`` is given.

    python -m spfft_tpu_torch.programs.trace -d 32 32 32 --device cpu --chrome trace.json
    python -m spfft_tpu_torch.programs.trace -d 256 256 256 --shards 4 --last 20
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from ._device import (add_device_flag, add_dtype_flag, add_radius_flag, cutoff_radius,
                      mesh_device, processing_unit, random_values)


def build_plan(args, pu):
    import spfft_tpu_torch as sp

    dx, dy, dz = args.d
    trip = sp.create_spherical_cutoff_triplets(dx, dy, dz, cutoff_radius(args))
    if args.shards > 1:
        mesh = sp.make_fft_mesh(args.shards, device=mesh_device(args.device))
        return sp.DistributedTransform(pu, sp.TransformType.C2C, dx, dy, dz, trip, mesh=mesh,
                                       engine=args.engine, dtype=args.dtype)
    return sp.Transform(pu, sp.TransformType.C2C, dx, dy, dz, indices=trip, engine=args.engine,
                        dtype=args.dtype)


def format_event(ev: dict) -> str:
    args = dict(ev["args"])
    label = args.pop("label", None)
    name = f"{ev['name']}:{label}" if label else ev["name"]
    rest = " ".join(f"{k}={v}" for k, v in args.items())
    return (f"{ev['seq']:>6d} {ev['ts'] * 1e3:>10.3f}ms {ev['run'] or '-':>8} "
            f"{ev['ph']} {name:<24} {rest}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-d", nargs=3, type=int, default=[16, 16, 16], metavar=("X", "Y", "Z"))
    add_radius_flag(ap)
    ap.add_argument("-s", type=float, default=0.15, help="nonzero fraction")
    ap.add_argument("--engine", default="auto", choices=["auto", "xla", "mxu"])
    ap.add_argument("--shards", type=int, default=1, help="1-D slab mesh width (1 = local plan)")
    ap.add_argument("--last", type=int, default=None, metavar="N",
                    help="print only the last N events")
    ap.add_argument("--run", default=None, metavar="ID",
                    help="print only events of run ID (e.g. r000001)")
    ap.add_argument("--chrome", default=None, metavar="PATH",
                    help="write Chrome trace-event JSON here")
    ap.add_argument("-o", default=None, help="write the snapshot JSON here")
    add_dtype_flag(ap)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    pu = processing_unit(args.device)

    from spfft_tpu_torch import ScalingType
    from spfft_tpu_torch.obs import trace

    trace.enable()  # the program's whole point: armed whatever SPFFT_TPU_TRACE says
    plan = build_plan(args, pu)
    plan.backward(random_values(plan, np.random.default_rng(0), args.shards > 1))
    plan.forward(scaling=ScalingType.FULL)

    snap = trace.snapshot()
    missing = trace.validate_trace(snap)
    shown = snap["events"]
    if args.run:
        shown = [ev for ev in shown if ev["run"] == args.run]
    if args.last is not None:
        shown = shown[-args.last:]
    print(f"run {plan.report()['run_id']}: {len(snap['events'])} events recorded "
          f"({snap['dropped']} dropped, capacity {snap['capacity']}), {len(shown)} shown")
    for ev in shown:
        print(format_event(ev))
    if args.o:
        Path(args.o).write_text(json.dumps(snap, indent=1) + "\n")
        print(f"snapshot written to {args.o}")
    if args.chrome:
        Path(args.chrome).write_text(json.dumps(trace.chrome_trace(snap)) + "\n")
        print(f"chrome trace written to {args.chrome} (open in Perfetto / chrome://tracing)")
    if missing:
        print(f"trace schema INCOMPLETE, missing: {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
