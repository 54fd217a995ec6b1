"""Run one cell of the port's benchmark once; print its result as one JSON line.

    python3 perfbench/run.py --workload c2c-256-s15.bands-ahead --seed 7 --seconds 10 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. Set-up builds the configuration's plan with
``spfft_tpu_torch.Transform`` at its defaults (``engine="auto"``, the fused
path; no ``SPFFT_TPU_*`` knob is set here), makes every band's values and
the potential ``V(r)`` on the card from ``--seed``, and runs one untimed sweep of the traffic, which
captures the plan's CUDA graphs. The window then runs the traffic for
``--seconds`` (:mod:`perfbench.drive`). ``--trace 1`` adds a profiled
stretch after the window (:mod:`perfbench.trace`) and reports the per-layer
metrics instead of the end-to-end ones. Once the window has closed and the
peak memory is read, the port's plan is freed and what the window produced
is held to the plain reference (:mod:`perfbench.check`).

A configuration with ``ranks`` runs over a process group, one process a
card, each holding one slab of a ``spfft_tpu_torch.DistributedTransform``
(:mod:`perfbench.ranks`); this process starts them and prints rank 0's
result.

The run fails, and prints no result, where there is no CUDA device (it
never falls back to the CPU), where the cell needs more cards than there
are, and where ``jax``, ``jaxlib``, ``flax`` or ``spfft_tpu`` is loaded once
the window has closed. The kernels build into the checkout's
``build/spfft_tpu_torch/`` (the port's own cache); the caches of CUDA and of
torch's compilers go to ``build/perfbench/``.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench"
for _var, _sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(CACHE / _sub)
# the checkout's root, not this folder, on the path: the harness's modules
# are imported as ``perfbench.*`` and shadow no other
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() not in (ROOT, ROOT / "perfbench")]

FORBIDDEN = ("jax", "jaxlib", "flax", "spfft_tpu")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    """The forbidden packages loaded in this process, by whole top-level name."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def build(cfg: dict, device, precision=None):
    """The configuration's local plan and triplets on ``device``, at the
    configuration's precision unless ``precision`` names another."""
    import numpy as np

    import spfft_tpu_torch as sp
    from perfbench import inputs

    trip = inputs.triplets(cfg, device)
    pu = sp.ProcessingUnit.GPU if device.type == "cuda" else sp.ProcessingUnit.HOST
    plan = sp.Transform(pu, sp.TransformType[cfg["transform"].upper()], *inputs.dims(cfg),
                        indices=trip.cpu().numpy(), dtype=np.dtype(cfg["dtype"]),
                        precision=precision or cfg["precision"])
    return plan, trip


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def execute(cell, seed: int, seconds: float, trace: bool, device="cuda", t0=None,
            precision=None) -> dict:
    """One run of ``cell``; returns the result (``check`` last). ``precision``
    builds the plan at another precision than the configuration's (the
    control, ``perfbench/calibrate.py``); the limits stay the configuration's."""
    if "ranks" in cell.config:
        from perfbench import ranks

        return ranks.execute(cell, seed, seconds, trace, device, t0, precision)
    import torch

    from perfbench import check, drive, inputs, spec
    from perfbench import trace as tracing

    stamps, parts = [time.perf_counter() if t0 is None else t0], []

    def mark(part):
        parts.append(part)
        stamps.append(time.perf_counter())

    mark("imports")
    device = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    plan, trip = build(cfg, device, precision)
    mark("context_triplets_plan")
    layout = plan.space_domain_layout
    values = inputs.band_values(cfg, trip, seed, device)
    potential = inputs.potential(cfg, layout, seed, device)
    sampled = inputs.sampled_bands(seed, values.shape[0], cfg["check"]["sampled_spaces"])
    sweep = drive.Sweep(plan, values, mix, potential, sampled, device)
    sweep.fence()
    mark("band_data")
    sweep.sweep()
    if trace:
        tracing.warm()
    sweep.fence()
    mark("warm_sweep")
    setup_s = stamps[-1] - stamps[0]
    done = sweep.done
    sweep.spans = trace
    window = sweep.window(seconds)
    window.update(latency_ms=sweep.latency_ms, host_call_s=sweep.host_call_s)
    sweep.spans = False
    profile = (tracing.profile_stretch(sweep, int(mix["profile_pairs"]), spec.kernel_families())
               if trace else None)
    attempted = sweep.done - done
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    results, kept = sweep.results, sweep.kept
    del sweep, plan
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.compare(cfg, trip, values, potential, results, kept, layout)
    correct, failed, shown = check.judge(numbers, cfg["check"]["limits"])

    ctx = SimpleNamespace(setup_s=setup_s, window=window, profile=profile, cell=cell)
    busy = (profile.busy_us(), profile.window_us) if profile is not None else None
    return result(correct, attempted, failed, read_metrics(cell, trace, ctx),
                  device_info(device, 1, peak), profile, busy,
                  {p: b - a for p, a, b in zip(parts, stamps, stamps[1:])}, shown)


def read_metrics(cell, trace: bool, ctx) -> dict:
    """The run's metrics by name, each reader's number with its unit; a
    metric whose reader finds nothing is left out."""
    from perfbench import spec

    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def device_info(device, count: int, peak: int) -> dict:
    import torch

    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": count, "memory_peak_bytes": peak,
            "power_limit_w": power_limit_w() if cuda else None}


def result(correct, attempted, failed, metrics, dev, profile, busy, setup_parts_s, shown,
           **extra) -> dict:
    """The result line's object (``check`` last). ``busy``: the device's busy
    and traced µs, ``(busy_us, window_us)``, where ``profile`` is the traced
    stretch's (whose breakdown the line carries)."""
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if profile is not None:
        dev["busy_s"] = busy[0] / 1e6
        dev["window_s"] = busy[1] / 1e6
        out["breakdown"] = {"device_ops": profile.device_ops_s(),
                            "idle_gaps": profile.idle_by_host_s()}
    out["setup_parts_s"] = setup_parts_s
    out.update(extra)
    out["check"] = shown
    return out


def finite(value):
    """``value`` with every non-finite float written as a string, so that the
    line stays JSON (a reading of an incorrect run can be infinite)."""
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    if isinstance(value, dict):
        return {k: finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite(v) for v in value]
    return value


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import torch

        import spfft_tpu_torch  # noqa: F401
        from perfbench import spec
    except ImportError as e:
        print(f"perfbench: cannot import what the run needs: {e}", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(finite(out)), flush=True)
    for name, s in out["check"].items():
        print(f"check {name} {s['value']!r} limit {s['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
