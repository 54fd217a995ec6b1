"""Run a self-verified transform round trip and print a verification report.

The port of the JAX package's ``programs/verify.py``: builds a C2C plan with
verification armed (``--mode on|strict``), runs backward + forward(FULL)
round trips, optionally under fault injection (``--inject``, the
``SPFFT_TPU_FAULTS`` grammar, armed for the round trips only) to show
detect -> retry -> demote -> recover, and prints a JSON report: the plan
card's ``verification`` section, its degradations, the round-trip residual
against the input values (FULL scaling makes the pair the identity, so the
residual holds through any recovery), the verify metrics and the breaker.
Exit status: 0 on a verified (possibly recovered) round trip, 3 when
verification raised typed ``VerificationError``, 1 on an incomplete card.
``--shards P`` runs a slab mesh of P shards stacked on the device. Plans
run on the card unless ``--device cpu`` is given.

    python -m spfft_tpu_torch.programs.verify -d 16 16 16 --device cpu
    python -m spfft_tpu_torch.programs.verify -d 256 256 256 --inject "engine.execute=corrupt:1.0"
    python -m spfft_tpu_torch.programs.verify -d 256 256 256 --mode strict \\
        --inject "engine.execute=nan"
    python -m spfft_tpu_torch.programs.verify -d 32 32 32 --shards 2 -o report.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np

from ._device import (add_device_flag, add_dtype_flag, add_radius_flag, cutoff_radius,
                      mesh_device, processing_unit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-d", nargs=3, type=int, default=[16, 16, 16], metavar=("X", "Y", "Z"))
    add_radius_flag(ap)
    ap.add_argument("-s", type=float, default=0.3, help="nonzero fraction")
    ap.add_argument("--mode", default="on", choices=["on", "strict"])
    ap.add_argument("--shards", type=int, default=1, help="1-D slab mesh width (1 = local plan)")
    ap.add_argument("--inject", default=None,
                    help='fault spec to arm, e.g. "engine.execute=corrupt:1.0"')
    ap.add_argument("--roundtrips", type=int, default=1,
                    help="verified round trips to run (breaker demos need > K)")
    ap.add_argument("-o", default=None, help="write the report JSON here")
    add_dtype_flag(ap)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    pu = processing_unit(args.device)

    import spfft_tpu_torch as sp
    from spfft_tpu_torch import ScalingType, TransformType, VerificationError, faults, obs

    dx, dy, dz = args.d
    trip = sp.create_spherical_cutoff_triplets(dx, dy, dz, cutoff_radius(args))
    rng = np.random.default_rng(0)
    values = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))

    if args.shards > 1:
        plan = sp.DistributedTransform(
            pu, TransformType.C2C, dx, dy, dz, trip,
            mesh=sp.make_fft_mesh(args.shards, device=mesh_device(args.device)),
            dtype=args.dtype, verify=args.mode)
        # the global values in the plan's per-shard order
        per_shard_trip = sp.distribute_triplets(trip, args.shards, dy)
        lut = {tuple(t): v for t, v in zip(map(tuple, trip), values)}
        per_shard = [np.asarray([lut[tuple(t)] for t in s]) for s in per_shard_trip]

        def run():
            return (plan.backward([v.copy() for v in per_shard]),
                    plan.forward(scaling=ScalingType.FULL))

        packed = np.concatenate(per_shard)

        def repack(out):
            return np.concatenate([v.cpu().numpy() for v in out])
    else:
        plan = sp.Transform(pu, TransformType.C2C, dx, dy, dz, indices=trip, dtype=args.dtype,
                            verify=args.mode)

        def run():
            return plan.backward(values), plan.forward(scaling=ScalingType.FULL)

        packed = values

        def repack(out):
            return out.cpu().numpy()

    report: dict = {"mode": args.mode, "injected": args.inject}
    status = 0
    # armed for the round trips only, so that a caller's later work is clean
    armed = faults.inject(args.inject) if args.inject else contextlib.nullcontext()
    try:
        with armed:
            for _ in range(max(1, args.roundtrips)):
                _, back = run()
        report["outcome"] = "verified"
        report["roundtrip_residual"] = float(
            np.max(np.abs(repack(back) - packed)) / np.max(np.abs(packed)))
    except VerificationError as e:
        report["outcome"] = "verification_error"
        report["error"] = str(e)
        status = 3

    card = plan.report()
    snap = obs.snapshot()
    report["verification"] = card["verification"]
    report["degradations"] = card["degradations"]
    report["run_id"] = card["run_id"]
    report["metrics"] = {k: v for k, v in snap["counters"].items() if k.startswith("verify")}
    report["breaker"] = sp.verify.breaker.snapshot()
    missing = obs.validate_plan_card(card)
    if missing:
        report["card_schema_missing"] = missing
        status = status or 1
    print(json.dumps(report, indent=2))
    if args.o:
        Path(args.o).write_text(json.dumps(report, indent=2) + "\n")
    return status


if __name__ == "__main__":
    sys.exit(main())
