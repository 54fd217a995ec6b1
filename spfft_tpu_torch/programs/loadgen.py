"""Open-loop load generator for the serving layer (`spfft_tpu_torch.serve`).

The port of ``programs/loadgen.py``. It drives sustained multi-tenant traffic
against a :class:`~spfft_tpu_torch.serve.TransformService` the way a fleet of
independent callers would: arrivals are scheduled on a fixed offered-rate
clock and submitted WITHOUT waiting for completions (open-loop — offered
load does not slow down when the service does, which is what makes overload
visible). Each ramp step multiplies the offered rate, so one run sweeps from
comfortable load into deliberate overload and records how the service
degrades: typed rejections and sheds instead of latency collapse.

Output: a JSON report (schema ``spfft_tpu.serve.loadgen/1``, the JAX
package's) whose rows carry ``key`` / ``gflops`` / ``seconds_noise`` and the
serving scoreboard: offered/accepted/completed/rejected/shed/deadline-miss
counts, completed transforms/s, p50/p99 latency ms, per-phase latency and,
in the port, the target rate, the mean batch occupancy of the step and the
tickets still unresolved at the settle deadline (counted in ``failed``, as
the JAX program counts them). Each completed transform is billed the dense
one-direction flop count (``perf.dense_pair_flops(dims) / 2``).

Two rules of the port's generator: ``--submitters N`` threads share the
arrivals, and an arrival not yet submitted when the step's window closes is
not offered (``unoffered``), so a generator slower than its target rate
shows as an ``offered_rate`` below ``target_rate``, not as a longer step.
A collector thread takes every ticket as it is submitted and waits for it in
order, as the callers of an open-loop fleet do, so a result (on the card a
tensor of the plan's device) is released once its latency is read.

The service runs on the card unless ``--device cpu`` is given (the JAX
program reads ``JAX_PLATFORMS``); ``--dtype`` is the plans' dtype (the JAX
program reads its x64 flag). ``--hosts N`` spawns N RPC worker processes
(:mod:`spfft_tpu_torch.hostmesh`) and drives a
:class:`~spfft_tpu_torch.serve.ClusterFront`; ``--kill-host K`` SIGKILLs
worker K in the first measured step. ``--mix X Y Z S`` interleaves a second
geometry with the first, request by request.

    python -m spfft_tpu_torch.programs.loadgen -d 128 128 128 -s 0.659 \\
        --dtype float32 --tenants 3 --rate 400 --ramp 0.5 1 2 -o loadgen.json
    python -m spfft_tpu_torch.programs.loadgen --device cpu -d 12 12 12 -s 0.8 \\
        --rate 40 --ramp 1 --duration 1 --hosts 2 --kill-host 1
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import random
import sys
import threading
import time
from pathlib import Path

import numpy as np

LOADGEN_SCHEMA = "spfft_tpu.serve.loadgen/1"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-d", "--dims", type=int, nargs=3, default=[16, 16, 16],
                   metavar=("X", "Y", "Z"))
    p.add_argument("-s", "--sparsity", type=float, default=0.8,
                   help="spherical-cutoff radius fraction (triplet density)")
    p.add_argument("--mix", type=float, nargs=4, default=None,
                   metavar=("X", "Y", "Z", "S"),
                   help="a second geometry (dims and radius fraction), "
                   "interleaved with the first request by request")
    p.add_argument("--tenants", type=int, default=2)
    p.add_argument("--rate", type=float, default=50.0,
                   help="offered requests/sec at ramp multiplier 1")
    p.add_argument("--ramp", type=float, nargs="+", default=[1.0, 2.0],
                   help="offered-rate multipliers, one measured row each")
    p.add_argument("--duration", type=float, default=2.0,
                   help="seconds of offered traffic per ramp step")
    p.add_argument("--timeout-s", type=float, default=0.0,
                   help="per-request deadline (0 = none)")
    p.add_argument("--queue-cap", type=int, default=None)
    p.add_argument("--batch-max", type=int, default=None)
    p.add_argument("--retries", type=int, default=None)
    p.add_argument("--verify", default=None,
                   help="verify mode for the service's plans (e.g. 'on')")
    p.add_argument("--device", choices=["gpu", "cpu"], default="gpu",
                   help="where the service (or every worker) runs; default the card")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float64",
                   help="the plans' dtype (the port's dtype=None is float64)")
    p.add_argument("--sched", type=int, choices=[0, 1], default=0,
                   help="A/B the task-graph scheduler: 1 dispatches "
                   "mixed-geometry batches as one graph per cycle")
    p.add_argument("--batch-fuse", type=int, choices=[0, 1], default=1,
                   help="A/B batch fusion (SPFFT_TPU_BATCH_FUSE): 1 runs a "
                   "coalesced batch as ONE program per direction, 0 keeps "
                   "the split-phase per-request loop")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--settle-s", type=float, default=30.0,
                   help="max wait for outstanding tickets after each step")
    p.add_argument("--hosts", type=int, default=0,
                   help="spawn N RPC worker hosts and drive the ClusterFront "
                   "instead of an in-process service; 0 = single-process")
    p.add_argument("--host-devices", type=int, default=1,
                   help="cards per spawned worker host (CUDA_VISIBLE_DEVICES)")
    p.add_argument("--kill-host", type=int, default=None, metavar="K",
                   help="chaos: SIGKILL worker K mid-ramp (requires --hosts); "
                   "the row records completed_after_kill")
    p.add_argument("--kill-at", type=float, default=0.4,
                   help="when to kill, as a fraction of the first measured "
                   "step's offered window")
    p.add_argument("--submitters", type=int, default=1,
                   help="submitting threads sharing the arrivals (the JAX program "
                   "submits from one)")
    p.add_argument("--sample", type=int, default=0,
                   help="keep N completed (geometry, payload, result) samples "
                   "per measured step for a caller's hook")
    p.add_argument("-o", "--output", default=None, help="write JSON report here")
    return p


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _occupancy():
    """(count, sum) of the process's serve_batch_occupancy histogram."""
    from spfft_tpu_torch import obs

    h = obs.snapshot()["histograms"].get("serve_batch_occupancy", {})
    return h.get("count", 0), h.get("sum", 0.0)


def run_step(service, *, key, rate, duration, tenants, trip, values, dims,
             transform_type, timeout_s, flops_per_transform, settle_s, rng,
             kill_fn=None, kill_at_s=None, mix=None, consume=None,
             samples=None, sample_n=0, submitters=1):
    """One measured open-loop step at ``rate`` requests/sec; returns the
    row. ``kill_fn`` (with ``kill_at_s`` seconds into the offered window)
    fires once, mid-step, and the row records how many requests completed
    after it. ``mix`` lists further ``(trip, values, dims)`` geometries that
    take turns with the first. ``submitters`` threads share the arrivals
    (arrival i goes to thread i mod N); an arrival still unsubmitted when
    the window closes is not offered (``unoffered``), so a generator that
    cannot keep up shows as an ``offered_rate`` below the target, never as
    a longer step. ``consume`` is applied to each completed result by the
    collector; ``samples`` (a list) receives ``sample_n`` ``(geometry index,
    payload, result)`` triples drawn uniformly from the step's completions
    (a reservoir, so at most ``sample_n`` results are held)."""
    from spfft_tpu_torch.errors import (
        DeadlineExceededError,
        GenericError,
        ServiceOverloadError,
    )

    geoms = [(trip, values, dims)] + list(mix or [])
    n_requests = max(1, int(round(rate * duration)))
    spacing = duration / n_requests
    picker = random.Random(0)  # the sample reservoir's draws
    seen = [0]
    counts = {"offered": 0, "accepted": 0, "rejected": 0, "shed": 0,
              "deadline_miss": 0, "failed": 0, "unresolved": 0}
    lock = threading.Lock()
    latencies, phase_samples, finished = [], {}, []
    occ0 = _occupancy()
    inbox: queue.Queue = queue.Queue()
    settle = {"deadline": None}
    # the per-request value perturbation, drawn up front: payloads differ per
    # request the way real traffic's do (coalescing must not depend on
    # equal data), and the draws do not depend on the threads' interleaving
    scales = 1.0 + 0.01 * rng.standard_normal(n_requests)

    def count(what):
        with lock:
            counts[what] += 1

    def collect():
        while True:
            item = inbox.get()
            if item is None:
                return
            i, g, payload, t = item
            while True:
                try:
                    value = t.result(timeout=0.05)
                except TimeoutError:
                    if settle["deadline"] is not None and time.time() > settle["deadline"]:
                        count("failed")
                        count("unresolved")
                        break
                    continue
                except DeadlineExceededError:
                    count("deadline_miss")
                except ServiceOverloadError:
                    count("shed")
                except GenericError:
                    count("failed")
                else:
                    latencies.append(t.latency_s())
                    finished.append(t.finished_at)
                    if consume is not None:
                        consume(value)
                    if samples is not None and sample_n:
                        seen[0] += 1
                        if len(samples) < sample_n:
                            samples.append((g, payload, value))
                        else:
                            j = picker.randrange(seen[0])
                            if j < sample_n:
                                samples[j] = (g, payload, value)
                break
            for phase, seconds in t.phase_seconds().items():
                phase_samples.setdefault(phase, []).append(seconds)

    kill_mono = []

    def fire():
        kill_mono.append(time.monotonic())
        kill_fn()

    t0 = time.perf_counter()

    def submit_loop(k):
        for i in range(k, n_requests, submitters):
            delay = t0 + i * spacing - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            if time.perf_counter() - t0 >= duration:
                return  # the window closed: the rest of this thread's arrivals go unoffered
            g = i % len(geoms)
            g_trip, g_values, g_dims = geoms[g]
            vals = g_values * scales[i]
            count("offered")
            try:
                t = service.submit(
                    transform_type, g_dims, g_trip, vals, tenant=f"tenant{i % tenants}",
                    timeout_s=timeout_s if timeout_s > 0 else None,
                )
            except (ServiceOverloadError, DeadlineExceededError):
                count("rejected")
                continue
            except GenericError:
                count("failed")
                continue
            count("accepted")
            inbox.put((i, g, vals, t))

    collector = threading.Thread(target=collect, name="loadgen-collect", daemon=True)
    collector.start()
    threads = [threading.Thread(target=submit_loop, args=(k,), name=f"loadgen-submit{k}",
                                daemon=True) for k in range(max(1, int(submitters)))]
    submitters = len(threads)
    # the kill fires on its own clock, whichever thread holds which arrival
    timer = None if kill_fn is None else threading.Timer(float(kill_at_s or 0.0), fire)
    if timer is not None:
        timer.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if timer is not None:
        timer.join()
    offered_wall = time.perf_counter() - t0
    settle["deadline"] = time.time() + settle_s
    inbox.put(None)
    collector.join(settle_s + 5.0)
    wall = time.perf_counter() - t0
    occ1 = _occupancy()
    completed = len(latencies)
    latencies.sort()
    p50 = _percentile(latencies, 0.50)
    p99 = _percentile(latencies, 0.99)
    noise = min(0.5, (p99 - p50) / p50) if p50 > 0 else 0.0
    phases = {}
    for phase, vals in phase_samples.items():
        vals.sort()
        phases[phase] = {
            "n": len(vals),
            "p50_ms": round(_percentile(vals, 0.50) * 1e3, 3),
            "p99_ms": round(_percentile(vals, 0.99) * 1e3, 3),
        }
    batches = occ1[0] - occ0[0]
    row = {
        "key": key,
        "target_rate": round(float(rate), 3),
        "offered": counts["offered"],
        "unoffered": n_requests - counts["offered"],
        "offered_rate": round(counts["offered"] / max(offered_wall, 1e-9), 3),
        "submitters": submitters,
        "accepted": counts["accepted"],
        "completed": completed,
        "rejected": counts["rejected"],
        "shed": counts["shed"],
        "deadline_miss": counts["deadline_miss"],
        "failed": counts["failed"],
        "unresolved": counts["unresolved"],
        "transforms_per_sec": round(completed / max(wall, 1e-9), 3),
        "p50_ms": round(p50 * 1e3, 3),
        "p99_ms": round(p99 * 1e3, 3),
        "phases": phases,
        "mean_batch_occupancy": round((occ1[1] - occ0[1]) / batches, 3) if batches else 0.0,
        "gflops": round(completed * flops_per_transform / max(wall, 1e-9) / 1e9, 6),
        "seconds_noise": round(noise, 4),
        "wall_seconds": round(wall, 4),
    }
    if kill_mono:
        row["killed_at_s"] = round(float(kill_at_s or 0.0), 3)
        row["completed_after_kill"] = sum(1 for f in finished
                                          if f is not None and f > kill_mono[0])
    return row


def main(argv=None, *, hooks=None) -> int:
    """Run the ramp and write the report. ``hooks`` (for programs that
    drive this one, such as ``chip_smoke.py``): ``"consume"`` is applied to
    each completed result, ``"during"`` is called as ``during(service,
    step)`` at ``--kill-at`` of every measured step without a kill, and
    ``"step"`` as ``step(service, row, samples)`` after each measured row,
    with the live service."""
    args = build_parser().parse_args(argv)
    hooks = dict(hooks or {})
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import ProcessingUnit, TransformType, obs
    from spfft_tpu_torch.obs import perf
    from spfft_tpu_torch.serve import TransformService

    # the knob is read at dispatch time (ir.compile.resolve_batch_fuse), so
    # setting the env here owns the whole run, spawned workers included
    os.environ["SPFFT_TPU_BATCH_FUSE"] = str(int(args.batch_fuse))
    dx, dy, dz = args.dims
    rng = np.random.default_rng(args.seed)

    def geometry(dims, sparsity):
        trip = sp.create_spherical_cutoff_triplets(*dims, sparsity)
        vals = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
        return trip, vals, tuple(int(d) for d in dims)

    trip, values, _ = geometry((dx, dy, dz), args.sparsity)
    mix = None
    if args.mix is not None:
        mix = [geometry(tuple(int(v) for v in args.mix[:3]), float(args.mix[3]))]
    flops_per_transform = perf.dense_pair_flops((dx, dy, dz)) / 2.0
    dtype = "f64" if args.dtype == "float64" else "f32"

    # argument validation BEFORE any worker is spawned: an early exit here
    # must never orphan child processes
    if args.kill_host is not None:
        if args.hosts <= 0:
            raise SystemExit("--kill-host requires --hosts N")
        if not 0 <= args.kill_host < args.hosts:
            raise SystemExit(
                f"--kill-host {args.kill_host} out of range for --hosts {args.hosts}"
            )
    workers = []
    if args.hosts > 0:
        from spfft_tpu_torch import hostmesh
        from spfft_tpu_torch.serve.cluster import ClusterFront

        workers = hostmesh.spawn_workers(
            args.hosts, devices_per_host=args.host_devices, device=args.device,
            dtype=args.dtype,
        )
        try:
            service = ClusterFront(
                [w.address for w in workers],
                queue_capacity=args.queue_cap, batch_max=args.batch_max,
                retries=args.retries, platform=args.device,
            )
        except BaseException:
            hostmesh.stop_workers(workers)
            raise
    else:
        pu = ProcessingUnit.GPU if args.device == "gpu" else ProcessingUnit.HOST
        service = TransformService(
            pu, dtype=np.dtype(args.dtype), queue_capacity=args.queue_cap, batch_max=args.batch_max,
            retries=args.retries, verify=args.verify, sched=bool(args.sched),
        )
    kill_fn = None
    if args.kill_host is not None:
        kill_fn = workers[args.kill_host].kill
    rows = []
    try:
        # warmup outside the measured window: plan build, the first captures
        # and the clone pool. Spread across tenants and tolerate quota
        # refusals: with a tiny queue the admission rules apply here too.
        from spfft_tpu_torch.errors import ServiceOverloadError as _Overload

        warm = []
        for g_trip, g_values, g_dims in [(trip, values, (dx, dy, dz))] + list(mix or []):
            for i in range(service.batch_max):
                try:
                    warm.append(
                        service.submit(
                            TransformType.C2C, g_dims, g_trip, g_values,
                            tenant=f"warmup{i % max(1, args.tenants)}",
                        )
                    )
                except _Overload:
                    break
        for tk in warm:
            tk.result(timeout=args.settle_s)
        del warm
        # unmeasured preflight at the base rate: the whole dispatcher path
        # (batch shapes, allocator, scheduler) before the first recorded row
        run_step(
            service, key="preflight", rate=args.rate,
            duration=min(1.0, args.duration), tenants=args.tenants,
            trip=trip, values=values, dims=(dx, dy, dz),
            transform_type=TransformType.C2C, timeout_s=0.0,
            flops_per_transform=flops_per_transform,
            settle_s=args.settle_s, rng=rng, mix=mix, consume=hooks.get("consume"),
            submitters=args.submitters,
        )
        for step_i, mult in enumerate(args.ramp):
            rate = args.rate * mult
            family = "mhost" if args.hosts > 0 else "serve"
            hosts_token = f":h{args.hosts}" if args.hosts > 0 else ""
            mix_token = ""
            if mix:
                mx = args.mix
                mix_token = (f":mix{int(mx[0])}x{int(mx[1])}x{int(mx[2])}"
                             f":s{int(round(mx[3] * 100))}")
            key = (
                f"{family}:{dx}x{dy}x{dz}:s{int(round(args.sparsity * 100))}{mix_token}"
                f":c2c:{dtype}:t{args.tenants}{hosts_token}:x{mult:g}"
            )
            step_fn = kill_fn if (kill_fn is not None and step_i == 0) else None
            if step_fn is not None:
                key += ":chaos-kill"
            elif hooks.get("during") is not None:
                step_fn = lambda i=step_i: hooks["during"](service, i)  # noqa: E731
            samples = []
            row = run_step(
                service, key=key, rate=rate, duration=args.duration,
                tenants=args.tenants, trip=trip, values=values,
                dims=(dx, dy, dz), transform_type=TransformType.C2C,
                timeout_s=args.timeout_s,
                flops_per_transform=flops_per_transform,
                settle_s=args.settle_s, rng=rng,
                kill_fn=step_fn, kill_at_s=args.kill_at * args.duration,
                mix=mix, consume=hooks.get("consume"), samples=samples,
                sample_n=args.sample, submitters=args.submitters,
            )
            if step_fn is not None and step_fn is not kill_fn:
                # a hook's mark is not a kill: the row keeps the JAX keys
                row.pop("killed_at_s", None)
                row.pop("completed_after_kill", None)
            rows.append(row)
            if hooks.get("step") is not None:
                hooks["step"](service, row, samples)
            del samples
            queue_wait = row["phases"].get("coalesced")
            print(
                f"{row['key']}: target {row['target_rate']:.0f}/s, "
                f"offered {row['offered_rate']:.0f}/s -> "
                f"{row['transforms_per_sec']:.0f} done/s "
                f"(p50 {row['p50_ms']:.1f} ms, p99 {row['p99_ms']:.1f} ms, "
                + (
                    f"queue-wait p99 {queue_wait['p99_ms']:.1f} ms, "
                    if queue_wait else ""
                )
                + f"occupancy {row['mean_batch_occupancy']}, "
                f"rejected {row['rejected']}, shed {row['shed']}, "
                f"deadline {row['deadline_miss']}, failed {row['failed']})",
                flush=True,
            )
    finally:
        described = service.describe()
        topology = [w.describe() for w in workers] or None
        service.close()
        if workers:
            from spfft_tpu_torch import hostmesh

            hostmesh.stop_workers(workers)

    doc = {
        "schema": LOADGEN_SCHEMA,
        "run_unix": time.time(),
        "config": {
            "dims": [dx, dy, dz], "sparsity": args.sparsity,
            "mix": None if args.mix is None else list(args.mix),
            "tenants": args.tenants, "base_rate": args.rate,
            "ramp": list(args.ramp), "duration_s": args.duration,
            "timeout_s": args.timeout_s, "num_values": int(len(trip)),
            "flops_per_transform": flops_per_transform, "dtype": dtype,
            "device": args.device,
            "seed": args.seed, "sched": bool(args.sched),
            "submitters": args.submitters,
            "batch_fuse": bool(args.batch_fuse),
            "hosts": int(args.hosts),
            "host_devices": int(args.host_devices) if args.hosts else None,
            "topology": topology,
            "kill_host": args.kill_host,
        },
        "rows": rows,
        "service": described,
        "metrics": obs.snapshot(),
    }
    if args.output:
        Path(args.output).write_text(json.dumps(doc, indent=1, sort_keys=True))
        print(f"wrote {args.output}")
    else:
        json.dump(doc, sys.stdout, indent=1, sort_keys=True)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
