"""Autotune a plan and keep its wisdom: the port of ``programs/tune.py``.

Builds the requested plan with ``policy="tuned"``: a wisdom hit answers with
no trial; a miss measures every candidate (the exchange disciplines of a
mesh plan, the engine axis of a local one) on the real geometry, dtype and
card, and records the winner in the store of ``SPFFT_TPU_WISDOM``
(``--wisdom`` sets it). The JSON document holds the tuning record, the
wisdom state and the plan card. A CPU plan (``--cpu``) runs trials only with
``--allow-cpu-trials`` (``SPFFT_TPU_TUNE_CPU=1``). ``--export`` and
``--merge`` write and read wisdom bundles, with or without ``-d``.

    python -m spfft_tpu_torch.programs.tune -d 256 256 256 -s 0.15 --dtype float32
    python -m spfft_tpu_torch.programs.tune -d 256 256 256 --shards 4 --wisdom w.json
    python -m spfft_tpu_torch.programs.tune -d 16 16 16 --mesh2 2 2 --cpu --allow-cpu-trials
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="autotune a plan into wisdom")
    ap.add_argument("-d", nargs=3, type=int, default=None, metavar=("X", "Y", "Z"))
    ap.add_argument("-s", type=float, default=0.3, help="nonzero fraction")
    ap.add_argument("--r2c", action="store_true")
    ap.add_argument("--shards", type=int, default=1, help="slab mesh size (1 = local)")
    ap.add_argument("--mesh2", nargs=2, type=int, default=None, metavar=("P1", "P2"),
                    help="pencil mesh factors (overrides --shards)")
    ap.add_argument("--engine", choices=["auto", "mxu", "xla"], default="auto")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None)
    ap.add_argument("--cpu", action="store_true", help="a CPU plan (no device figure)")
    ap.add_argument("--wisdom", default=None, help="wisdom file (sets SPFFT_TPU_WISDOM)")
    ap.add_argument("--repeats", type=int, default=None, help="timed repeats per trial")
    ap.add_argument("--warmup", type=int, default=None, help="warm-up round trips per trial")
    ap.add_argument("--allow-cpu-trials", action="store_true",
                    help="run trials on a CPU plan (sets SPFFT_TPU_TUNE_CPU=1)")
    ap.add_argument("--export", default=None, metavar="BUNDLE",
                    help="after tuning (or alone, without -d) export the wisdom store")
    ap.add_argument("--merge", default=None, metavar="BUNDLE",
                    help="before tuning (or alone, without -d) merge a bundle into the store")
    ap.add_argument("-o", default=None, help="output JSON path")
    args = ap.parse_args(argv)

    from spfft_tpu_torch.tuning import (TUNE_CPU_ENV, TUNE_REPEATS_ENV, TUNE_WARMUP_ENV,
                                        WISDOM_ENV, active_store, wisdom_state)

    for flag, env in ((args.wisdom, WISDOM_ENV), (args.repeats, TUNE_REPEATS_ENV),
                      (args.warmup, TUNE_WARMUP_ENV)):
        if flag is not None:
            os.environ[env] = str(flag)
    if args.allow_cpu_trials:
        os.environ[TUNE_CPU_ENV] = "1"
    if args.d is None and not (args.export or args.merge):
        ap.error("-d is required unless --export/--merge runs bundle-only")
    if args.merge:
        from spfft_tpu_torch.errors import InvalidParameterError

        try:
            added, replaced = active_store().merge(args.merge)
        except InvalidParameterError as e:
            print(f"tune: {e}", file=sys.stderr)
            return 1
        print(f"merged bundle {args.merge}: {added} added, {replaced} replaced "
              "(best-measured-wins)")
    if args.d is None:
        if args.export:
            print(f"exported {active_store().export(args.export)} wisdom entries to "
                  f"{args.export}")
        return 0
    if args.mesh2 is not None:
        args.shards = args.mesh2[0] * args.mesh2[1]
    if args.shards == 1 and args.engine != "auto":
        ap.error("local tuning explores the engine axis; use --engine auto (explicit "
                 "engines apply to distributed exchange tuning only)")

    import numpy as np

    import spfft_tpu_torch as sp

    dx, dy, dz = args.d
    radius = sp.spherical_radius_for_fraction(args.s)
    trip = sp.create_spherical_cutoff_triplets(dx, dy, dz, min(radius, 1.0),
                                               hermitian_symmetry=args.r2c)
    ttype = sp.TransformType.R2C if args.r2c else sp.TransformType.C2C
    dtype = np.dtype(args.dtype) if args.dtype else None
    pu = sp.ProcessingUnit.HOST if args.cpu else sp.ProcessingUnit.GPU
    device = "cpu" if args.cpu else None
    if args.shards > 1:
        mesh = (sp.make_fft_mesh2(*args.mesh2, device=device) if args.mesh2 is not None
                else sp.make_fft_mesh(args.shards, device=device))
        plan = sp.DistributedTransform(pu, ttype, dx, dy, dz, trip, mesh=mesh, dtype=dtype,
                                       engine=args.engine, policy="tuned")
    else:
        plan = sp.Transform(pu, ttype, dx, dy, dz, indices=trip, dtype=dtype,
                            engine=args.engine, policy="tuned")
    rec = plan._tuning
    if rec is None:
        print("plan was not tuned (the tuned policy did not engage)", file=sys.stderr)
        return 1
    print(f"tune: provenance={rec['provenance']} hit={rec['hit']} choice={rec['choice']} "
          f"({rec['reason']})")
    for row in rec["trials"]:
        model = (f"  model_cost={row['model_cost_bytes']:,}B" if "model_cost_bytes" in row
                 else "")
        if "ms" in row:
            print(f"  {row['label']:20s} {row['ms']:9.3f} ms{model}")
        else:
            print(f"  {row['label']:20s}    FAILED: {row.get('error', '?')}")
    if args.export:
        print(f"exported {active_store().export(args.export)} wisdom entries to {args.export}")
    doc = {"tuning": rec, "wisdom": wisdom_state(plan), "plan": plan.report()}
    missing = sp.obs.validate_plan_card(doc["plan"])
    if missing:
        print(f"plan card schema incomplete: {missing}", file=sys.stderr)
        return 1
    if args.o:
        Path(args.o).write_text(json.dumps(doc, indent=2))
        print(f"wrote {args.o}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
