"""Graph-scheduling benchmark: a scheduled graph against one-at-a-time calls.

The port of ``programs/gbench.py``, the measurement of
:mod:`spfft_tpu_torch.sched`. It builds a mixed-geometry workload (several
sparse geometries, ``--tasks`` independent backwards each and ``--chain``
backward -> forward chains) and runs it two ways:

- ``serial``: each task a host-facing ``backward``/``forward`` call
  (staging, dispatch, fence and fetch) before the next starts, on one plan
  per geometry on the first device;
- ``sched``: the same task list as one task graph (windowed dispatch,
  completion-order finalize, plans placed round-robin over the devices;
  ``--policy tuned`` resolves the width through wisdom).

Both run the same tasks through the same code paths, so the ratio
(``overlap_vs_serial``, scheduled transforms/s over serial) is what the
scheduler adds. On one card only host staging and the fetch can hide behind
device work. Rows carry ``key``, ``gflops`` and ``seconds_noise`` as the JAX
program's do, with transforms/s and the p50/p99 completion latency in the
cycle. ``--cpu`` runs on the CPU device (no device figure).

    python -m spfft_tpu_torch.programs.gbench --dims 128 160 192 --tasks 8 -o g.json
    python -m spfft_tpu_torch.programs.gbench --cpu --dims 12 16 --tasks 4 --repeats 2
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

GBENCH_SCHEMA = "spfft_tpu.sched.gbench/1"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=None,
                   help="use the first N CUDA devices (default: every visible one)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU device")
    p.add_argument("--dims", type=int, nargs="+", default=[12, 16, 20],
                   help="grid edges of the mixed geometries")
    p.add_argument("--sparsity", type=float, nargs="+", default=[0.5, 0.9],
                   help="sphere radii paired round-robin with --dims")
    p.add_argument("--tasks", type=int, default=8,
                   help="independent backward tasks per geometry")
    p.add_argument("--chain", type=int, default=1,
                   help="backward -> forward chains per geometry (0 = a flat batch)")
    p.add_argument("--repeats", type=int, default=3, help="timed repeats per mode (best of)")
    p.add_argument("--inflight", type=int, default=16, help="the scheduler's window")
    p.add_argument("--policy", choices=["default", "tuned"], default="default",
                   help="placement: model round-robin, or the wisdom-tuned width")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--output", default=None, help="write JSON here")
    return p


def build_workload(args, dtype):
    """``(geometries, tasks)``: each task a JSON-plain dict both modes share."""
    import numpy as np

    import spfft_tpu_torch as sp

    rng = np.random.default_rng(args.seed)
    geometries = []
    for i, dim in enumerate(args.dims):
        sparsity = args.sparsity[i % len(args.sparsity)]
        trip = sp.create_spherical_cutoff_triplets(dim, dim, dim, sparsity)
        geometries.append({
            "dim": dim, "sparsity": sparsity, "triplets": trip,
            "values": rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip)),
            "spec": {"transform_type": "C2C", "dims": (dim, dim, dim), "indices": trip,
                     "dtype": dtype},
        })
    tasks = []
    for gi in range(len(geometries)):
        tasks += [{"geom": gi, "direction": "backward", "chain": None, "id": f"g{gi}b{t}"}
                  for t in range(args.tasks)]
        for c in range(args.chain):
            tasks.append({"geom": gi, "direction": "backward", "chain": None,
                          "id": f"g{gi}cb{c}"})
            tasks.append({"geom": gi, "direction": "forward", "chain": f"g{gi}cb{c}",
                          "id": f"g{gi}cf{c}"})
    return geometries, tasks


def run_serial(geometries, tasks, plans) -> tuple:
    """One host-facing call a task, each finished before the next."""
    from spfft_tpu_torch.types import ScalingType

    t0 = time.perf_counter()
    latencies, results = [], {}
    for task in tasks:
        plan = plans[task["geom"]]
        s0 = time.perf_counter()
        if task["direction"] == "backward":
            results[task["id"]] = plan.backward(geometries[task["geom"]]["values"])
        else:
            results[task["id"]] = plan.forward(results[task["chain"]], ScalingType.FULL)
        latencies.append(time.perf_counter() - s0)
    return {"wall": time.perf_counter() - t0, "latencies": latencies}, results


def run_sched(geometries, tasks, devices, pool, args) -> tuple:
    """The same task list as one task graph."""
    from spfft_tpu_torch import sched
    from spfft_tpu_torch.types import ScalingType

    graph = sched.TaskGraph()
    for task in tasks:
        g = geometries[task["geom"]]
        if task["direction"] == "backward":
            graph.add("backward", id=task["id"], payload=g["values"], spec=g["spec"])
        else:
            graph.add("forward", id=task["id"], scaling=ScalingType.FULL, spec=g["spec"],
                      input_from=task["chain"])
    # time.monotonic: the executor stamps Task.finished_at on that clock
    t0 = time.monotonic()
    report = sched.run_graph(graph, devices=devices, pool=pool,
                             policy=args.policy if args.policy == "tuned" else None,
                             max_inflight=args.inflight)
    wall = time.monotonic() - t0
    bad = {tid: out for tid, out in report.outcomes.items() if out not in ("completed", "demoted")}
    if bad:
        raise AssertionError(f"scheduled tasks did not complete: {bad}")
    latencies = [graph.task(t["id"]).finished_at - t0 for t in tasks]
    return {"wall": wall, "latencies": latencies}, report, graph


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))]


def make_row(key, measures, flops_total, depth) -> dict:
    """A row from the best-of-repeat measures of one mode (the latencies of
    the best wall's repeat)."""
    walls = sorted(m["wall"] for m in measures)
    best = walls[0]
    median = (walls[(len(walls) - 1) // 2] + walls[len(walls) // 2]) / 2.0
    lat = sorted(min(measures, key=lambda m: m["wall"])["latencies"])
    return {
        "key": key, "tasks": len(lat), "graph_depth": depth,
        "wall_seconds": round(best, 6),
        "transforms_per_sec": round(len(lat) / best, 3) if best else 0.0,
        "p50_ms": round(_percentile(lat, 0.50) * 1e3, 3),
        "p99_ms": round(_percentile(lat, 0.99) * 1e3, 3),
        "gflops": round(flops_total / best / 1e9, 6) if best else 0.0,
        "seconds_noise": round((median - best) / best, 4) if best else 0.0,
    }


def main(argv=None):
    """Runs the benchmark; returns ``(doc, serial_results, sched_graph)`` of
    the last repeats (the graph's tasks hold their results)."""
    import os

    import numpy as np
    import torch

    args = build_parser().parse_args(argv)
    if args.policy == "tuned" and args.cpu:
        os.environ.setdefault("SPFFT_TPU_TUNE_CPU", "1")  # the key holds the platform

    from spfft_tpu_torch import obs, sched
    from spfft_tpu_torch.obs import perf
    from spfft_tpu_torch.sched.placement import build_plan

    if args.cpu:
        devices = [torch.device("cpu")]
    else:
        devices = sched.default_devices()[: args.devices]
        if not devices:
            from spfft_tpu_torch.errors import GPUNoDeviceError

            raise GPUNoDeviceError("gbench: no CUDA device (use --cpu)")
    geometries, tasks = build_workload(args, np.dtype(args.dtype))
    flops_total = sum(perf.dense_pair_flops([geometries[t["geom"]]["dim"]] * 3) / 2.0
                      for t in tasks)
    # plans built outside the timed window: serial one a geometry on the
    # first device; sched through the placement pass and its pool
    serial_plans = [build_plan(g["spec"], devices[0]) for g in geometries]
    pool = sched.PlanPool()
    run_serial(geometries, tasks, serial_plans)  # warm-up (CUDA-graph captures)
    run_sched(geometries, tasks, devices, pool, args)
    serial_measures, sched_measures = [], []
    for _ in range(max(1, args.repeats)):
        m, serial_results = run_serial(geometries, tasks, serial_plans)
        serial_measures.append(m)
    for _ in range(max(1, args.repeats)):
        m, report, graph = run_sched(geometries, tasks, devices, pool, args)
        sched_measures.append(m)
    sig = "+".join(f"{g['dim']}s{int(round(g['sparsity'] * 100))}" for g in geometries)
    base = f"gbench:{sig}:t{args.tasks}:c{args.chain}:P{len(devices)}"
    depth = 2 if args.chain else 1
    serial_row = make_row(f"{base}:serial", serial_measures, flops_total, depth)
    sched_row = make_row(f"{base}:sched", sched_measures, flops_total, depth)
    serial_row["overlap_vs_serial"] = 1.0
    sched_row["overlap_vs_serial"] = round(
        sched_row["transforms_per_sec"] / max(serial_row["transforms_per_sec"], 1e-9), 4)
    for row in (serial_row, sched_row):
        print(f"{row['key']}: {row['transforms_per_sec']:8.1f} transforms/s (p50 "
              f"{row['p50_ms']:.2f} ms, p99 {row['p99_ms']:.2f} ms, "
              f"±{row['seconds_noise'] * 100:.1f}%, x{row['overlap_vs_serial']:.2f} vs serial)")
    first = {gi: next(t["id"] for t in tasks if t["geom"] == gi)
             for gi in range(len(geometries))}
    doc = {
        "schema": GBENCH_SCHEMA,
        "run_unix": time.time(),
        "platform": "cpu" if args.cpu else "gpu",
        "device_name": "cpu" if args.cpu else torch.cuda.get_device_name(devices[0]),
        "config": {"devices": len(devices), "dims": list(args.dims),
                   "sparsity": list(args.sparsity), "tasks": args.tasks, "chain": args.chain,
                   "repeats": args.repeats, "policy": args.policy, "inflight": args.inflight,
                   "dtype": args.dtype, "seed": args.seed, "total_tasks": len(tasks)},
        "rows": [serial_row, sched_row],
        "placement": report.placement,
        "plan_cards": [{k: card.get(k) for k in ("run_id", "engine", "dims", "placement")}
                       for card in (graph.task(tid).plan.report() for tid in first.values())],
        "metrics": {k: v for k, v in obs.snapshot()["counters"].items()
                    if k.startswith("sched_")},
    }
    if args.output:
        Path(args.output).write_text(json.dumps(doc, indent=1, sort_keys=True, default=str))
        print(f"wrote {args.output}")
    return doc, serial_results, graph


if __name__ == "__main__":
    main()
    sys.exit(0)
