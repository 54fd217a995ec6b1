"""Capture a torch.profiler trace of transform pairs, tagged by pipeline stage.

The port of the JAX package's ``programs/profile.py``, on ``torch.profiler``
in place of ``jax.profiler``. On the staged path every stage-graph node runs
under its canonical ``spfft_tpu_torch.obs.STAGES`` label
(``timing.trace_annotation``), which the profiler draws as a range on the
host's and on the device's timeline, so the trace reads like the reference's
timing tree with the kernels visible. The traced pairs therefore run staged
by default (``--fuse 0``); a fused pair is one CUDA-graph replay with no
ranges in it.

Timing rides the shared discipline (``obs.perf.measure_pair_seconds``:
warm-up, then the best of ``--repeats`` chains of ``--chain`` dependent
pairs, fenced), and the per-stage breakdown printed is the perf layer's
attributed report (``perf_report``, schema ``spfft_tpu.obs.perf/1``) as
one JSON line, its stages summing to ``seconds_per_pair``. Beside it, one
JSON line ``{"profile": ...}`` holds what the trace measured: per stage
range, the device ms a pair of the kernels inside it and their names (on
the card; the CPU has no device timeline). The host timing tree prints
last. The Chrome trace goes to ``<-o>/spfft_trace.json`` (Perfetto,
chrome://tracing). Plans run on the card unless ``--device cpu`` is given.

    python -m spfft_tpu_torch.programs.profile -d 256 256 256 --radius 0.659 \\
        --engine mxu -r 3 -o build/profile
    python -m spfft_tpu_torch.programs.profile -d 16 16 16 -r 2 --device cpu -o /tmp/p
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from ._device import add_device_flag, add_radius_flag, cutoff_radius, processing_unit

TRACE_FILE = "spfft_trace.json"


def stage_kernels(prof, pairs: int) -> dict:
    """Per ``STAGES`` range on the device's timeline: the device ms a pair
    of the kernels that run inside it, and their names with counts. The
    ``timing.scoped`` ranges (``spfft:<label>``) are drawn there too, and
    are no kernels."""
    from torch.autograd import DeviceType

    from spfft_tpu_torch import timing
    from spfft_tpu_torch.obs import STAGES

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if e.name not in STAGES
               and not e.name.startswith(timing.RANGE_PREFIX)]
    out = {}
    for rng in (e for e in device if e.name in STAGES):
        lo, hi = rng.time_range.start, rng.time_range.end
        row = out.setdefault(rng.name, {"device_ms": 0.0, "kernels": {}})
        reach = None
        for k in sorted((k for k in kernels if k.time_range.end > lo and k.time_range.start < hi),
                        key=lambda k: k.time_range.start):
            a, b = max(k.time_range.start, lo), min(k.time_range.end, hi)
            if reach is not None and a < reach:
                a = reach
            if b > a:
                row["device_ms"] += (b - a) / 1e3 / pairs
                reach = b
            row["kernels"][k.name] = row["kernels"].get(k.name, 0) + 1
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-d", nargs=3, type=int, default=[128, 128, 128], metavar=("X", "Y", "Z"))
    add_radius_flag(ap)
    ap.add_argument("-s", type=float, default=0.15, help="nonzero fraction")
    ap.add_argument("-r", type=int, default=5, help="traced round trips")
    ap.add_argument("--repeats", type=int, default=3, help="timed best-of repeats (perf report)")
    ap.add_argument("--chain", type=int, default=2, help="chained round trips per timed repeat")
    ap.add_argument("--engine", default="auto", choices=["auto", "xla", "mxu"])
    ap.add_argument("--fuse", type=int, choices=[0, 1], default=0,
                    help="0 (default): the staged path, whose nodes carry the stage ranges")
    ap.add_argument("-o", default="spfft_trace", help="trace output directory")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.r < 1:
        ap.error("-r must be >= 1")
    pu = processing_unit(args.device)

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import spfft_tpu_torch as sp
    from spfft_tpu_torch import ScalingType, TransformType, obs, timing

    was_timing = timing.is_enabled()
    timing.enable()
    try:
        dx, dy, dz = args.d
        trip = sp.create_spherical_cutoff_triplets(dx, dy, dz, cutoff_radius(args))
        with timing.scoped("Grid + Transform init"):
            t = sp.Transform(pu, TransformType.C2C, dx, dy, dz, indices=trip, dtype=np.float32,
                             engine=args.engine, fuse=bool(args.fuse))
        measured = obs.perf.measure_pair_seconds(t, chain=args.chain, repeats=args.repeats)
        report = obs.perf.perf_report(t, measured["seconds_per_pair"],
                                      repeats=measured["repeats"])

        rng = np.random.default_rng(0)
        values = torch.as_tensor(rng.standard_normal(len(trip))
                                 + 1j * rng.standard_normal(len(trip))).to(t.device)
        # the host-facing entry points once outside the capture, so that it
        # records steady-state pairs, not first calls
        with timing.scoped("warmup"):
            t.backward(values)
            t.forward(scaling=ScalingType.FULL)
            t.synchronize()
        activities = [ProfilerActivity.CPU]
        if t.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        out_dir = Path(args.o)
        out_dir.mkdir(parents=True, exist_ok=True)
        # one more pair as the schedule's warm-up step: the profiler loses
        # device events at the start of a window, and the step is not kept
        with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            t.backward(values)
            t.forward(scaling=ScalingType.FULL)
            t.synchronize()
            prof.step()
            with timing.scoped("traced roundtrips"):
                for _ in range(args.r):
                    t.backward(values)
                    t.forward(scaling=ScalingType.FULL)
                t.synchronize()
        trace_path = out_dir / TRACE_FILE
        prof.export_chrome_trace(str(trace_path))
        stages = stage_kernels(prof, args.r)
        print(f"trace written to {trace_path} (open in Perfetto / chrome://tracing)")
        print(f"  stage ranges (spfft_tpu_torch.obs.STAGES): {', '.join(sp.obs.STAGES)}")
        print()
        print(f"perf report (spfft_tpu.obs.perf/1, best of {args.repeats} x chain "
              f"{measured['chain']}): {report['seconds_per_pair'] * 1e3:.3f} ms/pair, "
              f"{report['gflops']:.2f} GFLOP/s")
        for row in report["stages"]:
            device_ms = stages.get(row["stage"], {}).get("device_ms")
            print(f"  {row['stage']:<22s} {row['seconds'] * 1e6:12.1f} us "
                  f"{row['fraction'] * 100:6.2f}%  {row['gflops']:10.2f} GFLOP/s "
                  f"{row['gbps']:8.2f} GB/s"
                  + ("" if device_ms is None else f"  device {device_ms * 1e3:10.1f} us"))
        print(json.dumps(report))
        profiled = {"trace": str(trace_path), "pairs": args.r, "fused": t.fused,
                    "stages": stages}
        print(json.dumps({"profile": profiled}))
        print()
        print(timing.process())
    finally:
        if not was_timing:
            timing.disable()
    return {"report": report, "profile": profiled, "transform": t}


if __name__ == "__main__":
    main()
    sys.exit(0)
