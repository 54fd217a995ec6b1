"""Exchange-discipline comparison: BUFFERED vs COMPACT_BUFFERED vs UNBUFFERED.

The port of the JAX package's ``programs/discipline_compare.py``. Per shard
count P, each discipline's (a) off-shard wire bytes per repartition (exact
accounting from the plan geometry, the JAX package's), (b) collective
rounds (1 for every discipline in the port: ``all_to_all_single`` takes
uneven splits where the JAX package's COMPACT chain takes P-1), and (c)
time per backward+forward pair, the shards stacked on the one device.

``--imbalance w`` skews the per-shard stick weights linearly from 1 to 1+w.
``--policy`` adds a row a shard count for what a bare
``ExchangeType.DEFAULT`` resolves to: ``default`` (the cost model) or
``tuned`` (the port's exchange trials; CPU trials are allowed with
``--device cpu``), with the decision's provenance.

``--matrix`` switches to the scenario matrix (``--matrix-dims`` x
``--matrix-sparsity`` x ``--matrix-types`` x ``--matrix-dtypes`` x both wire
disciplines x the overlap axis): each cell a keyed ``spfft_tpu.obs.perf/1``
row (``dbench.measure_row``), the document one ``perf_gate`` reads. The
overlap axis takes integer OVERLAPPED chunk counts for the padded
discipline (UNBUFFERED clamps the knob, so it carries the ``1`` cell only)
and ``tuned`` (one cell a scenario whose DEFAULT, and chunk count, the
port's exchange trials resolve, ``BUFFERED/ovC`` among them).
``--matrix-batch B`` adds the ``batchB:serial`` and ``batchB:sched`` rows: B
local plans one at a time, and through ``spfft_tpu_torch.sched``. Plans run
on the card unless ``--device cpu`` is given.

    python -m spfft_tpu_torch.programs.discipline_compare --shards 4 16 --dim 256 \\
        --sparsity 0.15 --json disc.json
    python -m spfft_tpu_torch.programs.discipline_compare --shards 2 4 --dim 8 \\
        --device cpu --engine xla
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import dbench
from ._device import add_device_flag, mesh_device, processing_unit


def run_matrix(args, pu):
    """The scenario matrix (module docstring), written as a gate-compatible
    ``spfft_tpu.obs.perf.scaling/1`` document."""
    import spfft_tpu_torch as sp
    from spfft_tpu_torch.obs import perf
    from spfft_tpu_torch.parallel.policy import resolve_overlap_chunks

    P = args.shards[0]
    if "tuned" in args.matrix_overlap and args.device == "cpu":
        # tuned cells measure on this same CPU mesh, as the sweep does
        os.environ.setdefault("SPFFT_TPU_TUNE_CPU", "1")
    int_overlaps = sorted({resolve_overlap_chunks(o) for o in args.matrix_overlap
                           if o != "tuned"})
    mesh = sp.make_fft_mesh(P, device=mesh_device(args.device))
    rows = []
    for dim in args.matrix_dims:
        for sparsity in args.matrix_sparsity:
            for ttype in args.matrix_types:
                radius = sp.spherical_radius_for_fraction(sparsity)
                trip = sp.create_spherical_cutoff_triplets(dim, dim, dim, min(radius, 1.0),
                                                           hermitian_symmetry=ttype == "r2c")
                for dt in args.matrix_dtypes:
                    cells = [("UNBUFFERED", "default", 1)] + [
                        ("BUFFERED", "default", ov) for ov in int_overlaps]
                    if "tuned" in args.matrix_overlap:
                        cells.append(("DEFAULT", "tuned", None))
                    for disc, policy, overlap in cells:
                        t = sp.DistributedTransform(
                            pu, sp.TransformType.R2C if ttype == "r2c" else sp.TransformType.C2C,
                            dim, dim, dim, np.asarray(trip).copy(), mesh=mesh,
                            dtype=np.float64 if dt == "f64" else np.float32, engine=args.engine,
                            exchange_type=sp.ExchangeType[disc], policy=policy, overlap=overlap)
                        row = dbench.measure_row(t, args, scaling="matrix")
                        rows.append(row)
                        label = disc if policy == "default" else "TUNED"
                        print(f"{dim:4d}^3 nnz={row['nnz_fraction']:.3f} {ttype} {dt} "
                              f"{label:10s} ov={row['overlap_chunks']:2d} "
                              f"{row['seconds_per_pair'] * 1e3:9.3f} ms/pair "
                              f"{row['gflops']:8.2f} GFLOP/s "
                              f"exch {row['exchange_fraction'] * 100:5.1f}%")
                        del t
                    if args.matrix_batch > 0:
                        rows.extend(measure_batch_rows(pu, dim, ttype, dt, trip, args,
                                                       args.matrix_batch))
    doc = {"schema": perf.SCALING_SCHEMA, "config": vars(args),
           "platform": "cpu" if args.device == "cpu" else "gpu", "rows": rows}
    missing = perf.validate_scaling_doc(doc)
    if args.json:
        Path(args.json).write_text(json.dumps(doc, indent=2) + "\n")
        print(f"wrote {len(rows)} matrix rows to {args.json}")
    if missing:
        print(f"matrix doc INCOMPLETE, missing: {missing}", file=sys.stderr)
        return 1
    return 0


def measure_batch_rows(pu, dim, ttype, dt, trip, args, B) -> list:
    """Two gate rows a scenario: B independent local plans of this geometry
    running backward+forward(FULL) pairs one at a time (``batchB:serial``)
    and through the task-graph scheduler (``batchB:sched``); seconds per
    pair = batch wall / B."""
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import sched
    from spfft_tpu_torch.obs import perf
    from spfft_tpu_torch.sync import fence

    ttype_enum = sp.TransformType.R2C if ttype == "r2c" else sp.TransformType.C2C
    plans = [sp.Transform(pu, ttype_enum, dim, dim, dim, indices=np.asarray(trip).copy(),
                          dtype=np.float64 if dt == "f64" else np.float32, engine=args.engine)
             for _ in range(B)]
    rng = np.random.default_rng(0)
    if ttype == "r2c":
        # hermitian-consistent inputs: each plan's spectrum of a real field
        values = [p.forward(rng.standard_normal((dim, dim, dim))) for p in plans]
    else:
        values = [rng.standard_normal(p.num_local_elements)
                  + 1j * rng.standard_normal(p.num_local_elements) for p in plans]

    def serial_pairs():
        t0 = time.perf_counter()
        out = None
        for p, v in zip(plans, values):
            p.backward(v)
            out = p.forward(None, sp.ScalingType.FULL)
        fence(out)
        return time.perf_counter() - t0

    def sched_pairs():
        graph = sched.TaskGraph()
        for p, v in zip(plans, values):
            graph.add("backward", payload=v, transform=p)
            graph.add("forward", scaling=sp.ScalingType.FULL, transform=p)
        t0 = time.perf_counter()
        report = sched.run_graph(graph, devices=[plans[0].device], max_inflight=2 * B)
        wall = time.perf_counter() - t0
        bad = {t: o for t, o in report.outcomes.items() if o != "completed"}
        if bad:
            raise RuntimeError(f"scheduled batch cell degraded: {bad}")
        return wall

    rows = []
    repeats = max(2, min(3, args.repeats))
    for mode, run in (("serial", serial_pairs), ("sched", sched_pairs)):
        run()  # warm-up (captures, the scheduler's pool)
        walls = sorted(run() for _ in range(repeats))
        best = walls[0]
        median = (walls[(len(walls) - 1) // 2] + walls[len(walls) // 2]) / 2.0
        row = perf.perf_report(plans[0], best / B, repeats=repeats)
        row["scaling"] = "matrix"
        row["seconds_noise"] = (median - best) / best if best else 0.0
        row["batch"] = int(B)
        row["batch_mode"] = mode
        row["key"] = f"{dbench.row_key(row, 'matrix')}:batch{B}:{mode}"
        rows.append(row)
        print(f"{dim:4d}^3 nnz={row['nnz_fraction']:.3f} {ttype} {dt} BATCH{B}/{mode:6s} "
              f"{row['seconds_per_pair'] * 1e3:9.3f} ms/pair {row['gflops']:8.2f} GFLOP/s")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--sparsity", type=float, default=0.3)
    ap.add_argument("--imbalance", type=float, default=0.0)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--engine", default="mxu", choices=["xla", "mxu"])
    ap.add_argument("--policy", default="default", choices=["default", "tuned"],
                    help="resolver measured for the extra DEFAULT row (see module doc)")
    ap.add_argument("--matrix", action="store_true",
                    help="measure the scenario matrix instead of the per-shard-count sweep")
    ap.add_argument("--matrix-dims", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--matrix-sparsity", type=float, nargs="+", default=[0.05, 0.6],
                    help="nnz-fraction extremes")
    ap.add_argument("--matrix-types", nargs="+", default=["c2c", "r2c"], choices=["c2c", "r2c"])
    ap.add_argument("--matrix-dtypes", nargs="+", default=["f32", "f64"],
                    choices=["f32", "f64"])
    ap.add_argument("--matrix-batch", type=int, default=4,
                    help="batched multi-transform rows per scenario (serial vs sched; 0 "
                    "disables)")
    ap.add_argument("--matrix-overlap", nargs="+", default=["1", "tuned"],
                    help="overlap axis of the matrix: integer OVERLAPPED "
                    "chunk counts for the padded discipline, plus the "
                    "literal 'tuned' for an autotuner-resolved cell per "
                    "scenario (see run_matrix)")
    ap.add_argument("--chain", type=int, default=2,
                    help="chained round trips per timed repeat (matrix mode)")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--json", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    pu = processing_unit(args.device)

    import spfft_tpu_torch as sp
    from spfft_tpu_torch import ExchangeType, ScalingType
    from spfft_tpu_torch.sync import fence

    if args.matrix:
        return run_matrix(args, pu)

    dim = args.dim
    rng = np.random.default_rng(0)
    triplets = sp.create_spherical_cutoff_triplets(dim, dim, dim, args.sparsity)
    values = (rng.standard_normal(len(triplets))
              + 1j * rng.standard_normal(len(triplets))).astype(np.complex64)
    disciplines = [
        ("BUFFERED", ExchangeType.BUFFERED),
        ("COMPACT", ExchangeType.COMPACT_BUFFERED),
        ("UNBUFFERED", ExchangeType.UNBUFFERED),
        # the A/B row: what a bare DEFAULT resolves to under --policy
        (f"DEFAULT:{args.policy}", ExchangeType.DEFAULT),
    ]
    if args.policy == "tuned" and args.device == "cpu":
        os.environ.setdefault("SPFFT_TPU_TUNE_CPU", "1")
    rows = []
    order = {tuple(t): i for i, t in enumerate(map(tuple, triplets))}
    for P in args.shards:
        weights = 1.0 + args.imbalance * np.arange(P) / max(1, P - 1)
        per_shard = sp.distribute_triplets(triplets, P, dim, weights=weights)
        vps = [values[[order[tuple(t)] for t in map(tuple, p)]] for p in per_shard]
        mesh = sp.make_fft_mesh(P, device=mesh_device(args.device))
        for name, exchange in disciplines:
            t = sp.DistributedTransform(
                pu, sp.TransformType.C2C, dim, dim, dim, [p.copy() for p in per_shard],
                mesh=mesh, dtype=np.float32, engine=args.engine, exchange_type=exchange,
                # only the DEFAULT row resolves through a policy
                policy=args.policy)
            pair = t._exec.pad_values(vps)
            t.backward_pair(*pair)  # first calls: captures, libraries
            fence(t.forward_pair(scaling=ScalingType.FULL))
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(args.repeats):
                    t.backward_pair(*pair)
                    back = t.forward_pair(scaling=ScalingType.FULL)
                fence(back)
                best = min(best, (time.perf_counter() - t0) / args.repeats)
            transport = t._exec.exchange_transport()
            r = {"P": P, "discipline": name, "wire_bytes": t.exchange_wire_bytes(),
                 "rounds": t.exchange_rounds(), "transport": transport,
                 "ms_per_pair": round(best * 1e3, 3)}
            if exchange == ExchangeType.DEFAULT:
                rec = t._tuning
                r["resolved"] = t.exchange_type.name
                r["provenance"] = rec["provenance"] if rec else "model"
                if rec:
                    r["wisdom_hit"] = rec["hit"]
            rows.append(r)
            print(f"P={P:3d} {name:16s} bytes={r['wire_bytes']:>12,} rounds={r['rounds']:3d} "
                  f"{r['ms_per_pair']:8.2f} ms/pair (transport={transport})"
                  + (f" -> {r['resolved']} [{r['provenance']}]" if "resolved" in r else ""))
            del t
    if args.json:
        Path(args.json).write_text(json.dumps({"config": vars(args), "rows": rows}, indent=2))
        print(f"wrote {args.json}")
    return rows


if __name__ == "__main__":
    main()
