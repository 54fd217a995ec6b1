"""The rank path: one run of a cell over a process group, one process a card.

A configuration with ``ranks`` (and ``"decomposition": "slab"``) runs here,
from :func:`perfbench.run.execute`. This process builds the port's kernels
once (on the card), then starts ``ranks`` workers (``spawn``): worker ``r``
takes ``cuda:r`` and joins the others with ``spfft_tpu_torch.init_distributed``
over NCCL (gloo on the CPU), beside a gloo group of the harness's own for
the host's scalars. Each builds its slab of
``DistributedTransform(..., indices=<every shard's triplets>, mesh=
make_fft_mesh(1, cuda:r, group))`` at the plan's defaults, the sticks
balanced by value count (``spfft_tpu_torch.distribute_triplets``), and
holds its share of every band (:mod:`perfbench.shards`).

Every rank runs the same pairs in the same order (:mod:`perfbench.drive`);
they start the window together (a barrier), and rank 0 decides after each
fenced block whether the next is the last (one broadcast a block, on the
gloo group, read a block later: :class:`RankSweep`; the pairs get no sync
of their own). The rate is the pairs over the
longest rank's window. ``setup_s`` runs from this process's start to the
end of rank 0's warm sweep. A traced run profiles the same stretch on every
rank: the per-layer metrics are rank 0's, ``busy_s`` and ``window_s`` the
ranks' mean. Once the window has closed and each rank's peak is read, the
plans are freed, the results and the sampled spaces are gathered to rank 0
in the global order, and the unchanged :mod:`perfbench.check` judges them.
The workers leave through ``spfft_tpu_torch.shutdown_distributed``.

A worker that fails, or dies, fails the run: its traceback is raised here
and every worker is stopped.
"""
from __future__ import annotations

import dataclasses
import gc
import multiprocessing
import os
import queue as queues
import socket
import time
import traceback
from types import SimpleNamespace

import torch

from . import drive

# a run's own allowance past its window: set-up, the check, the way out
RUN_ALLOWANCE_S = 600.0
JOIN_S = 60.0


class RankSweep(drive.Sweep):
    """A sweep whose window closes on rank 0's verdict, which reaches every
    rank one block late. After each fenced block rank 0 decides whether the
    next block is the window's last (whether, at the window's mean block
    time so far, it would end at or past ``seconds``) and broadcasts that
    over ``control`` (a gloo group) without waiting; each rank reads the
    verdict after that next block's fence, long after it has arrived. So no
    rank waits on the others' hosts between two blocks: a blocking
    broadcast there took 1.0-1.3 ms of each 32 ms block on four H100s, with
    tails of 13-35 ms a run."""

    def __init__(self, *args, control, **kwargs):
        super().__init__(*args, **kwargs)
        self.control = control
        self.blocks = 0  # blocks of this window so far
        self.verdict = None  # (the broadcast's work, its flag) from the block before

    def over(self, elapsed: float, seconds: float) -> bool:
        import torch.distributed as dist

        self.blocks += 1
        if self.verdict is not None:
            work, last = self.verdict
            work.wait()
            if bool(last):
                self.blocks, self.verdict = 0, None
                return True
        last = torch.tensor([elapsed * (self.blocks + 1) / self.blocks >= seconds],
                            dtype=torch.uint8)
        self.verdict = (dist.broadcast(last, src=0, group=self.control, async_op=True), last)
        return False


@dataclasses.dataclass
class Job:
    """What every worker is given (pickled to it)."""

    cell: object
    runs: list  # (seed, precision or None) a run, in order
    seconds: float
    trace: bool
    device: str  # "cuda" or "cpu"
    world: int
    port: int
    t0: float | None  # the first run's start, on the launcher's clock
    hook: object = None  # hook(rank), called in each worker before its first plan
    keep: bool = False  # rank 0 hands back what it assembled (the tests)


def ranks_of(cfg: dict) -> int:
    if cfg.get("decomposition", "slab") != "slab":
        raise ValueError(f"the rank path runs slab plans, not {cfg['decomposition']!r}")
    return int(cfg["ranks"])


def execute(cell, seed: int, seconds: float, trace: bool, device="cuda", t0=None,
            precision=None, *, hook=None, keep=None) -> dict:
    """One run of ``cell`` over its ranks; the result as
    :func:`perfbench.run.execute` gives it. ``hook(rank)`` runs in each
    worker before its plan is built (a picklable callable: the tests plant
    faults with it); a list ``keep`` receives rank 0's assembled results
    and spaces."""
    return execute_runs(cell, [(seed, precision)], seconds, trace, device, t0, hook=hook,
                        keep=keep)[0]


def execute_runs(cell, runs: list, seconds: float, trace: bool, device="cuda", t0=None, *,
                 hook=None, keep=None) -> list:
    """Runs of ``cell``, ``(seed, precision)`` each, one after the other in
    one set of workers (each run its own plan); their results in order."""
    device = torch.device(device).type
    if device == "cuda":
        prebuild()
    world = ranks_of(cell.config)
    job = Job(cell, list(runs), seconds, trace, device, world, free_port(), t0, hook,
              keep is not None)
    ctx = multiprocessing.get_context("spawn")
    messages = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(rank, job, messages), name=f"perfbench-rank{rank}")
             for rank in range(world)]
    for p in procs:
        p.start()
    outs, done = [None] * len(job.runs), set()
    deadline = time.monotonic() + len(job.runs) * (seconds + RUN_ALLOWANCE_S)
    try:
        while len(done) < world:
            try:
                kind, who, what = messages.get(timeout=1.0)
            except queues.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"perfbench: rank {dead[0][0]} exited with "
                                       f"{dead[0][1]} before its end")
                if time.monotonic() > deadline:
                    raise RuntimeError("perfbench: the ranks did not finish in time")
                continue
            if kind == "error":
                raise RuntimeError(f"perfbench: rank {who} failed:\n{what}")
            if kind == "result":
                outs[who], kept = what
                if keep is not None:
                    keep.append(kept)
            else:
                done.add(who)
        for p in procs:
            p.join(timeout=JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=JOIN_S)
    return outs


def prebuild() -> None:
    """Every CUDA source of the port built once, here, before the ranks
    start: four first launches would otherwise each run nvcc on the same
    sources in the checkout's build directory."""
    from spfft_tpu_torch import _build

    _build.build_all(sorted(p.stem for p in _build.CSRC.glob("*.cu")))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, job: Job, messages) -> None:
    """One rank: join the group, make the job's runs, leave. A failure is
    reported to the launcher, and the process ends at once: its peers may be
    waiting in a collective that will not come."""
    import torch.distributed as dist

    import spfft_tpu_torch as sp
    from perfbench.run import forbidden_modules

    try:
        device = torch.device(job.device, rank) if job.device == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        group = sp.init_distributed(f"localhost:{job.port}", job.world, rank,
                                    backend="nccl" if device.type == "cuda" else "gloo")
        control = dist.new_group(backend="gloo")
        if job.hook is not None:
            job.hook(rank)
        for i, (seed, precision) in enumerate(job.runs):
            out = run(job, rank, device, group, control, seed, precision,
                      job.t0 if i == 0 else None)
            if rank == 0:
                messages.put(("result", i, out))
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"the run loaded {', '.join(found)}")
        sp.shutdown_distributed()
    except BaseException:
        messages.put(("error", rank, traceback.format_exc()))
        messages.close()
        messages.join_thread()
        os._exit(1)
    messages.put(("done", rank, None))
    messages.close()
    messages.join_thread()


def build(cfg: dict, per_shard: list, device, group, precision=None):
    """This rank's slab plan over ``group``: every shard's triplets, one shard here."""
    import numpy as np

    import spfft_tpu_torch as sp
    from perfbench import inputs

    pu = sp.ProcessingUnit.GPU if device.type == "cuda" else sp.ProcessingUnit.HOST
    return sp.DistributedTransform(
        pu, sp.TransformType[cfg["transform"].upper()], *inputs.dims(cfg), indices=per_shard,
        mesh=sp.make_fft_mesh(1, device=device, group=group),
        exchange_type=sp.ExchangeType[cfg.get("exchange", "default").upper()],
        dtype=np.dtype(cfg["dtype"]), precision=precision or cfg["precision"])


def run(job: Job, rank: int, device, group, control, seed: int, precision, t0):
    """One run on this rank; rank 0 returns ``(result, assembled or None)``."""
    import torch.distributed as dist

    import spfft_tpu_torch as sp
    from perfbench import check, inputs, shards, spec
    from perfbench import trace as tracing
    from perfbench.run import device_info, read_metrics, result

    stamps, parts = [time.perf_counter() if t0 is None else t0], []

    def mark(part):
        parts.append(part)
        stamps.append(time.perf_counter())

    mark("imports_group")
    cell, world, cuda = job.cell, job.world, device.type == "cuda"
    cfg, mix = cell.config, cell.traffic
    dims = inputs.dims(cfg)
    trip = inputs.triplets(cfg, device)
    per_shard = sp.distribute_triplets(trip.cpu().numpy(), world, dims[1])
    plan = build(cfg, per_shard, device, group, precision)
    mark("context_triplets_plan")
    layout = plan.space_domain_layout
    lengths = [plan.local_z_length(s) for s in range(world)]
    v_max, l_max = plan.params.max_num_values, max(lengths)
    rows = [shards.shard_rows(trip, torch.as_tensor(t), dims) for t in per_shard]
    values = shards.local_values(inputs.band_values(cfg, trip, seed, device), rows[rank], v_max)
    potential = shards.local_potential(inputs.potential(cfg, layout, seed, device),
                                       plan.local_z_offset(rank), lengths[rank], l_max)
    sampled = inputs.sampled_bands(seed, values.shape[0], cfg["check"]["sampled_spaces"])
    sweep = RankSweep(plan, values, mix, potential, sampled, device, control=control)
    sweep.fence()
    mark("band_data")
    sweep.sweep()
    if job.trace:
        tracing.warm()
    sweep.fence()
    mark("warm_sweep")
    setup_s = stamps[-1] - stamps[0]
    dist.barrier(group=control)
    done = sweep.done
    sweep.spans = job.trace
    window = sweep.window(job.seconds)
    window.update(latency_ms=sweep.latency_ms, host_call_s=sweep.host_call_s)
    sweep.spans = False
    profile = (tracing.profile_stretch(sweep, int(mix["profile_pairs"]), spec.kernel_families())
               if job.trace else None)
    attempted = sweep.done - done
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    results = [shards.flat_values(r, v_max) for r in sweep.results]
    kept = {b: shards.slab(space) for b, space in sweep.kept.items()}
    planes = 1 if inputs.is_r2c(cfg) else 2
    dtype = values.dtype
    del sweep, plan, values, potential
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    mine = {"seconds": window["seconds"], "pairs": window["pairs"], "peak": peak,
            "busy": None if profile is None else (profile.busy_us(), profile.window_us)}
    every = [None] * world if rank == 0 else None
    dist.gather_object(mine, every, dst=0, group=control)
    got = shards.gather_values(results, rows, trip.shape[0], v_max, group, rank, world, device,
                               dtype)
    spaces = shards.gather_spaces(kept, sampled, (planes, dims[1], dims[0], l_max), lengths,
                                  group, rank, world, device, dtype)
    del results, kept
    if rank != 0:
        return None

    if len({e["pairs"] for e in every}) != 1:
        raise RuntimeError(f"the ranks ran different numbers of pairs: {every}")
    kept = {b: s[0] if planes == 1 else (s[0], s[1]) for b, s in spaces.items()}
    numbers = check.compare(cfg, trip, inputs.band_values(cfg, trip, seed, device),
                            inputs.potential(cfg, layout, seed, device), got, kept, layout)
    correct, failed, shown = check.judge(numbers, cfg["check"]["limits"])

    window["seconds"] = max(e["seconds"] for e in every)
    ctx = SimpleNamespace(setup_s=setup_s, window=window, profile=profile, cell=cell,
                          exchange_bytes=shards.exchange_bytes_per_pair(per_shard[0], dims,
                                                                        lengths[0]))
    busy = None
    if profile is not None:
        busy = tuple(sum(e["busy"][i] for e in every) / world for i in range(2))
    out = result(correct, attempted, failed, read_metrics(cell, job.trace, ctx),
                 device_info(device, world, max(e["peak"] for e in every)), profile, busy,
                 {p: b - a for p, a, b in zip(parts, stamps, stamps[1:])}, shown,
                 ranks={"window_s": [e["seconds"] for e in every],
                        "memory_peak_bytes": [e["peak"] for e in every]})
    assembled = None
    if job.keep:
        assembled = {"results": [None if g is None else g.cpu().numpy() for g in got],
                     "spaces": {b: s.cpu().numpy() for b, s in spaces.items()}}
    return out, assembled
