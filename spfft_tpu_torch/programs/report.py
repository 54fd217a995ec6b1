"""Build a plan, print its plan card + a run-metrics snapshot, write JSON.

The port of the JAX package's ``programs/report.py``: the card records every
plan-time decision (geometry, sparsity, engine choices, and for distributed
plans the exchange discipline's wire bytes, rounds and transport with the
cost-model table of the alternatives DEFAULT weighed), and the snapshot what
one round trip did (transforms executed, bytes staged, dispatch and wait
latencies). The document is validated (``obs.validate_report``) before it is
written; a missing key exits 1.

The card carries the ``compiled`` section (``report(include_compiled=True)``,
:mod:`spfft_tpu_torch.obs.hlo`: the backward program's op classes, its
element-granular gathers and scatters, and on the card its CUDA graph's
nodes) unless ``--no-compiled`` is given, as in the JAX program. Plans run
on the card unless ``--device cpu`` is given.

    python -m spfft_tpu_torch.programs.report -d 32 32 32 --device cpu
    python -m spfft_tpu_torch.programs.report -d 256 256 256 -s 0.15 --shards 4
    python -m spfft_tpu_torch.programs.report -d 64 64 64 --pencil 2 2 -o card.json
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
    trip = sp.create_spherical_cutoff_triplets(dx, dy, dz, cutoff_radius(args),
                                               hermitian_symmetry=args.r2c)
    ttype = sp.TransformType.R2C if args.r2c else sp.TransformType.C2C
    if args.pencil or args.shards > 1:
        mesh = (sp.make_fft_mesh2(*args.pencil, device=mesh_device(args.device)) if args.pencil
                else sp.make_fft_mesh(args.shards, device=mesh_device(args.device)))
        return sp.DistributedTransform(pu, ttype, dx, dy, dz, trip, mesh=mesh,
                                       engine=args.engine, dtype=args.dtype,
                                       exchange_type=sp.ExchangeType[args.exchange])
    return sp.Transform(pu, ttype, dx, dy, dz, indices=trip, engine=args.engine,
                        dtype=args.dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-d", nargs=3, type=int, default=[32, 32, 32], metavar=("X", "Y", "Z"))
    add_radius_flag(ap)
    ap.add_argument("-s", type=float, default=0.15, help="nonzero fraction")
    ap.add_argument("--r2c", action="store_true", help="R2C instead of C2C")
    ap.add_argument("--engine", default="auto", choices=["auto", "xla", "mxu"])
    ap.add_argument("--shards", type=int, default=1, help="1-D slab mesh width (1 = local plan)")
    ap.add_argument("--pencil", nargs=2, type=int, metavar=("P1", "P2"),
                    help="2-D pencil mesh (overrides --shards)")
    ap.add_argument("--exchange", default="DEFAULT",
                    help="exchange discipline name (distributed plans)")
    ap.add_argument("--no-compiled", action="store_true",
                    help="skip the compiled-program statistics (a fresh capture)")
    ap.add_argument("--no-roundtrip", action="store_true",
                    help="emit the card without executing a transform pair")
    ap.add_argument("-o", default=None, help="write the report JSON here")
    add_dtype_flag(ap)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    pu = processing_unit(args.device)

    from spfft_tpu_torch import ScalingType, obs

    plan = build_plan(args, pu)
    card = plan.report(include_compiled=not args.no_compiled)
    if not args.no_roundtrip:
        # one round trip, so that the snapshot carries real run counters
        values = random_values(plan, np.random.default_rng(0), bool(args.shards > 1 or args.pencil))
        plan.backward(values)
        plan.forward(scaling=ScalingType.FULL)

    # run_id top-level too: the join key against a flight-recorder snapshot;
    # verify_mode so that rows of unlike verification are never compared
    report = {
        "plan": card,
        "metrics": obs.snapshot(),
        "run_id": card.get("run_id"),
        "verify_mode": card.get("verification", {}).get("mode", "off"),
    }
    missing = obs.validate_report(report)
    print(json.dumps(card, indent=2))
    print()
    print(obs.prometheus_text(report["metrics"]))
    if args.o:
        Path(args.o).write_text(json.dumps(report, indent=2) + "\n")
        print(f"report written to {args.o}")
    if missing:
        print(f"report schema INCOMPLETE, missing: {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
