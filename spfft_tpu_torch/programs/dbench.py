"""Distributed benchmark: strong/weak-scaling perf rows over a shard ladder.

The port of the JAX package's ``programs/dbench.py``. It builds slab (1-D)
and 2-D pencil plans over a ladder of shard counts and measures each with
the shared fenced best-of-R chain (``obs.perf.measure_pair_seconds``), one
``spfft_tpu.obs.perf/1`` report a cell: per-stage seconds, GFLOP/s, GB/s and
the ``exchange_fraction`` scoreboard (on the card with the H100's balance,
``obs.perf.CUDA_FLOP_PER_BYTE``), joined to the plan card and the flight
recorder by run ID. The "devices" of a rung are shards stacked on the one
device (``make_fft_mesh``, ``make_fft_mesh2``), as the JAX package's virtual
CPU devices are; the document's ``device`` says which device and that it
is one. A pencil cell factors P as squarely as it can (2 x 2, 2 x 4, 4 x 4);
the JAX program takes 2 x P/2. P = 1 on the slab mesh is the local plan.

Strong-scaling rows keep the grid fixed; weak-scaling rows grow ``dim_z``
with P. The document (schema ``spfft_tpu.obs.perf.scaling/1``,
``obs.perf.validate_scaling_doc``) is what ``perf_gate`` gates against a
baseline. ``--overlap`` measures each cell once per requested OVERLAPPED
chunk count (keys carry an ``ovC`` token; a request the engine clamps onto a
count already measured is skipped). Plans run on the card unless ``--device
cpu`` (or the JAX program's ``--cpu``) is given.

    python -m spfft_tpu_torch.programs.dbench --devices 1 2 4 16 --dim 256 \\
        --sparsity 0.15 --scaling strong -o scaling.json
    python -m spfft_tpu_torch.programs.dbench --devices 2 4 --dim 8 --device cpu
    python -m spfft_tpu_torch.programs.dbench --devices 4 --overlap 1 4   # OVERLAPPED rows
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

from ._device import add_device_flag, mesh_device, processing_unit


def row_key(report: dict, scaling: str) -> str:
    """Stable scenario key a gate matches rows on: everything that defines
    the cell except the measured numbers."""
    dims = "x".join(str(d) for d in report["dims"])
    return (f"{scaling}:{report['decomposition']}:P{report['device_count']}"
            f":{dims}:{report['transform_type']}:{report['dtype']}"
            f":{report['exchange_discipline']}:{report['engine']}"
            f":nnz{report['nnz_fraction']:.3f}"
            f":ov{report.get('overlap_chunks', 1)}")


def pencil_shape(p: int) -> tuple:
    """The squarest ``(P1, P2)`` with ``P1 <= P2`` and ``P1 * P2 == p``."""
    p1 = max(d for d in range(1, math.isqrt(p) + 1) if p % d == 0)
    return p1, p // p1


def build_transform(args, pu, mesh_kind, devices, dims, overlap=1):
    """One plan for a scaling cell (slab or pencil over ``devices`` shards)."""
    import numpy as np

    import spfft_tpu_torch as sp

    dx, dy, dz = dims
    radius = sp.spherical_radius_for_fraction(args.sparsity)
    trip = sp.create_spherical_cutoff_triplets(dx, dy, dz, min(radius, 1.0),
                                               hermitian_symmetry=args.r2c)
    ttype = sp.TransformType.R2C if args.r2c else sp.TransformType.C2C
    dtype = np.float64 if args.dtype == "f64" else np.float32
    if devices == 1 and mesh_kind == "slab" and not args.force_mesh:
        # the P = 1 rung is the local plan: the single-device anchor of the curve
        return sp.Transform(pu, ttype, dx, dy, dz, indices=trip, dtype=dtype,
                            engine=args.engine)
    device = mesh_device(args.device)
    mesh = (sp.make_fft_mesh2(*pencil_shape(devices), device=device) if mesh_kind == "pencil"
            else sp.make_fft_mesh(devices, device=device))
    return sp.DistributedTransform(pu, ttype, dx, dy, dz, trip, mesh=mesh, dtype=dtype,
                                   engine=args.engine,
                                   exchange_type=sp.ExchangeType[args.exchange],
                                   overlap=overlap)


def measure_row(transform, args, scaling: str) -> dict:
    """Measure one cell and wrap it as a keyed scaling row (a validating perf
    report plus the scenario key and a noise figure for the gate)."""
    from spfft_tpu_torch.obs import perf

    m = perf.measure_pair_seconds(transform, chain=args.chain, repeats=args.repeats,
                                  warmup=args.warmup)
    if m["roundtrip_residual"] is not None and m["roundtrip_residual"] > 1e-2:
        raise RuntimeError(f"roundtrip chain diverged: {m['roundtrip_residual']}")
    row = perf.perf_report(transform, m["seconds_per_pair"], repeats=m["repeats"])
    best = m["seconds_per_pair"]
    row["scaling"] = scaling
    row["rep_seconds"] = m["rep_seconds"]
    # the median-against-best spread of the repeats (the middle pair averaged
    # for even counts): the gate widens its threshold by it, capped
    reps = sorted(m["rep_seconds"])
    median = (reps[(len(reps) - 1) // 2] + reps[len(reps) // 2]) / 2.0
    row["seconds_noise"] = (median - best) / best if best else 0.0
    row["roundtrip_residual"] = m["roundtrip_residual"]
    row["key"] = row_key(row, scaling)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8],
                    help="shard-count ladder (shards stacked on the one device)")
    ap.add_argument("--dim", type=int, default=32,
                    help="strong-scaling grid edge (weak rows scale dim_z)")
    ap.add_argument("--sparsity", type=float, default=0.15,
                    help="nonzero fraction of the frequency ball")
    ap.add_argument("--mesh", nargs="+", default=["slab", "pencil"], choices=["slab", "pencil"])
    ap.add_argument("--scaling", nargs="+", default=["strong", "weak"],
                    choices=["strong", "weak"])
    ap.add_argument("--engine", default="mxu", choices=["xla", "mxu"])
    ap.add_argument("--exchange", default="DEFAULT",
                    help="exchange discipline name (DEFAULT = policy pick)")
    ap.add_argument("--r2c", action="store_true")
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    ap.add_argument("--overlap", type=int, nargs="+", default=[1],
                    help="OVERLAPPED-discipline chunk counts to measure per "
                    "cell (1 = bulk-synchronous; engines clamp infeasible "
                    "requests and duplicate-clamped cells are skipped)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--chain", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--force-mesh", action="store_true",
                    help="run P=1 through the distributed machinery too")
    ap.add_argument("-o", default=None, help="write the scaling JSON here")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if min(args.devices) < 1:
        ap.error("--devices must be positive")
    pu = processing_unit(args.device)

    import torch

    from spfft_tpu_torch.obs import perf
    from spfft_tpu_torch.parallel.policy import resolve_overlap_chunks

    overlaps = sorted({resolve_overlap_chunks(o) for o in args.overlap})
    rows = []
    for scaling in args.scaling:
        for P in sorted(set(args.devices)):
            dims = (args.dim, args.dim, args.dim * P if scaling == "weak" else args.dim)
            for mesh_kind in args.mesh:
                if mesh_kind == "pencil" and (P < 4 or P % 2):
                    print(f"note: skipping pencil at P={P} "
                          "(needs an even device count >= 4)", file=sys.stderr)
                    continue
                seen = set()
                for overlap in overlaps:
                    t = build_transform(args, pu, mesh_kind, P, dims, overlap=overlap)
                    effective = int(getattr(t, "overlap_chunks", 1))
                    if effective in seen:
                        # clamped onto a count already measured (the P = 1
                        # local plan, a small extent): its key would repeat
                        continue
                    seen.add(effective)
                    row = measure_row(t, args, scaling)
                    rows.append(row)
                    shape = "x".join(map(str, pencil_shape(P))) if mesh_kind == "pencil" else P
                    print(f"{scaling:6s} {mesh_kind:6s} P={shape!s:>3} "
                          f"{'x'.join(str(d) for d in dims):>12s} ov={row['overlap_chunks']:2d} "
                          f"{row['seconds_per_pair'] * 1e3:9.3f} ms/pair "
                          f"±{row['seconds_noise'] * 100:5.1f}% "
                          f"{row['gflops']:9.2f} GFLOP/s "
                          f"exch {row['exchange_fraction'] * 100:5.1f}% "
                          f"({row['exchange_gbps']:.2f} GB/s wire)")
                    del t
    if not rows:
        print("dbench: no measurable cells for the requested devices/mesh/scaling "
              "combination", file=sys.stderr)
        return 1
    on_card = args.device == "gpu"
    doc = {
        "schema": perf.SCALING_SCHEMA,
        "config": {k: v for k, v in vars(args).items() if k != "o"},
        "platform": "gpu" if on_card else "cpu",
        # every rung's shards sit on this one device
        "device": {"platform": "gpu" if on_card else "cpu", "count": 1,
                   "kind": torch.cuda.get_device_name() if on_card else "cpu"},
        "rows": rows,
    }
    missing = perf.validate_scaling_doc(doc)
    if args.o:
        Path(args.o).write_text(json.dumps(doc, indent=2) + "\n")
        print(f"wrote {len(rows)} rows to {args.o}")
    if missing:
        print(f"scaling doc INCOMPLETE, missing: {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
