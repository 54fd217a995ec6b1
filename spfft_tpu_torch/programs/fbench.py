"""fbench: fused-vs-staged A/B benchmark through the dispatch path.

The port of the JAX package's ``programs/fbench.py``. It measures whether a
host-facing pair runs as one program per direction (``SPFFT_TPU_FUSE=1``:
on the card one CUDA-graph replay a direction) or as one dispatch per stage
(``SPFFT_TPU_FUSE=0``, the staged path): inputs staged on the device
(``tuning.runner._stage_inputs``), warm-up (captures, libraries, cuFFT
plans), then the best of ``--repeats`` timed loops of ``--pairs`` device-side
``backward_pair``/``forward_pair`` round trips fenced at the loop's end; the
per-dispatch cost is in the measurement, host staging is not. The batch row
family (``--batches``) times the batched programs that ``backward_batch`` and
``forward_batch`` dispatch (``SPFFT_TPU_BATCH_FUSE``), seconds per transform.

Output: one JSON document (schema ``spfft_tpu.ir.fbench/1``) with
gate-compatible rows (``key``/``gflops``/``seconds_noise``, which
``perf_gate`` reads as it reads dbench rows), one row per fusion variant and
batch size, the ``fused_over_staged`` ratio and each plan's card ``ir``
section. Plans run on the card unless ``--device cpu`` is given.

    python -m spfft_tpu_torch.programs.fbench --dim 256 --radius 0.659 -o fbench.json
    python -m spfft_tpu_torch.programs.fbench --dim 16 --device cpu --batches 1 2
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from ._device import add_device_flag, processing_unit

FBENCH_SCHEMA = "spfft_tpu.ir.fbench/1"


def _best_of(one_pair, *, pairs: int, repeats: int, warmup: int, per: int = 1) -> dict:
    """Warm-up loops, then the best of ``repeats`` timed loops of ``pairs``
    calls of ``one_pair``, fenced at each loop's end; seconds per ``per``."""
    from spfft_tpu_torch.sync import fence

    for _ in range(max(0, warmup)):
        fence(one_pair())
    rep_seconds = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        last = None
        for _ in range(max(1, pairs)):
            last = one_pair()
        fence(last)
        rep_seconds.append((time.perf_counter() - t0) / (max(1, pairs) * per))
    best = min(rep_seconds)
    med = sorted(rep_seconds)[len(rep_seconds) // 2]
    # best-against-median spread, the gate's noise allowance
    return {"seconds": best, "rep_seconds": rep_seconds,
            "seconds_noise": (med - best) / best if best > 0 else 0.0}


def measure_dispatch_pair(t, *, pairs: int, repeats: int, warmup: int) -> dict:
    """Best-of-``repeats`` seconds per backward+forward dispatch pair."""
    from spfft_tpu_torch.tuning.runner import _stage_inputs
    from spfft_tpu_torch.types import ScalingType

    staged = _stage_inputs(t)

    def one_pair():
        # backward retains the space that the input-less forward reads
        t.backward_pair(*staged)
        return t.forward_pair(ScalingType.FULL)

    m = _best_of(one_pair, pairs=pairs, repeats=repeats, warmup=warmup)
    return {"seconds_per_pair": m["seconds"], "rep_seconds": m["rep_seconds"],
            "seconds_noise": m["seconds_noise"]}


def measure_batch_dispatch(t, *, batch: int, pairs: int, repeats: int, warmup: int) -> dict:
    """Best-of-``repeats`` seconds per transform through the batched
    programs: each timed iteration is one stacked backward + forward
    dispatch computing ``batch`` transforms."""
    from spfft_tpu_torch.tuning.runner import _stage_batch_inputs
    from spfft_tpu_torch.types import ScalingType

    re, im = _stage_batch_inputs(t, batch)
    ex = t._exec

    def one_pair():
        out = ex.backward_pair_batch(re, im)
        if out is None:
            raise RuntimeError("the batched backward program is unavailable")
        sre, sim = (out, None) if t._is_r2c else out
        pair = ex.forward_pair_batch(sre, sim, ScalingType.FULL)
        if pair is None:
            raise RuntimeError("the batched forward program is unavailable")
        return pair

    m = _best_of(one_pair, pairs=pairs, repeats=repeats, warmup=warmup, per=batch)
    return {"seconds_per_transform": m["seconds"], "rep_seconds": m["rep_seconds"],
            "seconds_noise": m["seconds_noise"]}


def build(pu, dim, radius, dtype, engine, fuse):
    import spfft_tpu_torch as sp

    trip = sp.create_spherical_cutoff_triplets(dim, dim, dim, float(radius))
    return sp.Transform(pu, sp.TransformType.C2C, dim, dim, dim, indices=trip, dtype=dtype,
                        engine=engine, fuse=fuse)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dim", type=int, default=256, help="cubic grid extent")
    ap.add_argument("--radius", type=float, default=0.659,
                    help="spherical cutoff radius fraction (0.659 ~ 15%% nnz)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--pairs", type=int, default=8, help="pairs per timed loop")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 4, 8],
                    help="batch row family: batch sizes timed through the batched "
                    "programs (seconds per transform; empty disables)")
    ap.add_argument("-o", "--output", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    pu = processing_unit(args.device)

    import torch

    import spfft_tpu_torch as sp

    dim = int(args.dim)
    dtype = np.dtype(args.dtype)
    flops = sp.obs.perf.dense_pair_flops([dim] * 3)
    key = f"fbench:c2c:{dim}:r{args.radius}:{args.dtype}"
    rows, results = [], {}
    for label, fuse in (("fused", True), ("staged", False)):
        t = build(pu, dim, args.radius, dtype, args.engine, fuse)
        if t.fused is not fuse:
            raise RuntimeError(f"{label}: the plan is {t.report()['ir']}")
        m = measure_dispatch_pair(t, pairs=args.pairs, repeats=args.repeats,
                                  warmup=args.warmup)
        results[label] = m["seconds_per_pair"]
        card = t.report()
        rows.append({
            "key": f"{key}:{label}", "fused": fuse, "engine": card["engine"],
            "seconds_per_pair": m["seconds_per_pair"], "rep_seconds": m["rep_seconds"],
            "seconds_noise": m["seconds_noise"], "gflops": flops / m["seconds_per_pair"] / 1e9,
            "nnz_fraction": card["nnz_fraction"], "ir": card["ir"], "run_id": card["run_id"]})
        print(f"{label:7s} {m['seconds_per_pair'] * 1e3:10.3f} ms/pair  "
              f"{rows[-1]['gflops']:9.2f} GFLOP/s  (noise {m['seconds_noise']:.1%})",
              file=sys.stderr)
        del t
    batch_results = {}
    if args.batches:
        t = build(pu, dim, args.radius, dtype, args.engine, True)
        bmax = max(int(x) for x in args.batches)
        for b in sorted({int(x) for x in args.batches}):
            # equal work per timed repeat across the family (pairs * bmax transforms)
            pairs_b = max(1, args.pairs * bmax // b)
            m = measure_batch_dispatch(t, batch=b, pairs=pairs_b, repeats=args.repeats,
                                       warmup=args.warmup)
            batch_results[b] = m["seconds_per_transform"]
            card = t.report()
            # the whole stacked pair, so that the report's gflops is this row's
            perf = sp.obs.perf.perf_report(t, m["seconds_per_transform"] * b,
                                           repeats=args.repeats, batch=b)
            rows.append({
                "key": f"{key}:b{b}", "batch": b, "engine": card["engine"],
                "seconds_per_transform": m["seconds_per_transform"],
                "rep_seconds": m["rep_seconds"], "seconds_noise": m["seconds_noise"],
                "gflops": flops / m["seconds_per_transform"] / 1e9,
                "nnz_fraction": card["nnz_fraction"], "ir": card["ir"],
                "batch_provenance": card["batch"], "perf": perf, "run_id": card["run_id"]})
            print(f"batch{b:<3d} {m['seconds_per_transform'] * 1e3:10.3f} ms/transform  "
                  f"{rows[-1]['gflops']:9.2f} GFLOP/s  (noise {m['seconds_noise']:.1%})",
                  file=sys.stderr)
    doc = {
        "schema": FBENCH_SCHEMA,
        "config": {
            "dim": dim, "radius": args.radius, "dtype": args.dtype, "engine": args.engine,
            "pairs": args.pairs, "repeats": args.repeats, "batches": sorted(batch_results),
            "platform": "cpu" if args.device == "cpu" else "gpu",
            "device": torch.cuda.get_device_name() if args.device == "gpu" else "cpu",
            "device_count": 1, "torch": torch.__version__, "spfft_tpu": sp.__version__,
        },
        "fused_over_staged": results["staged"] / results["fused"],
        "rows": rows,
    }
    if 1 in batch_results and any(b > 1 for b in batch_results):
        doc["batch_over_single"] = batch_results[1] / batch_results[max(batch_results)]
    out = json.dumps(doc, indent=1)
    if args.output:
        Path(args.output).write_text(out)
        print(f"wrote {args.output}", file=sys.stderr)
    else:
        print(out)
    print(f"fused-over-staged speedup: x{doc['fused_over_staged']:.3f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
