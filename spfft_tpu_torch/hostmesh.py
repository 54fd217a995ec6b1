"""Multi-host bootstrap: spawn, configure and join worker host processes.

The port of ``spfft_tpu/hostmesh.py``. Three concerns, each a place where
multi-process runs classically fail opaquely, made typed and testable:

1. **Joining a run** (:func:`boot`): wraps
   :func:`spfft_tpu_torch.parallel.mesh.init_distributed` (which validates
   the coordinator address and process coordinates up front) and returns the
   observed topology from ``torch.distributed`` and
   ``torch.cuda.device_count()``, so a rank asserts what it joined.
2. **Spawning workers** (:func:`spawn_workers`): launches N
   ``python -m spfft_tpu_torch.programs.serve_worker`` processes with
   :func:`child_env` (every ambient ``SPFFT_TPU_*`` knob propagated
   verbatim) and waits for each worker's ready file; a worker that fails to
   boot surfaces its log tail in a typed error, never a silent hang.
3. **Warm-starting wisdom** (:func:`warm_start`): merges the fleet wisdom
   bundle at ``SPFFT_TPU_HOSTS_WISDOM_BUNDLE`` into the host's own store.

Where the JAX package sets a child's virtual CPU device count
(``XLA_FLAGS``), ``child_env(devices=N)`` sets ``CUDA_VISIBLE_DEVICES`` to
the first N of the cards this process may use: several workers with
``devices=1`` share card 0, each with its own CUDA context. The kernels'
libraries are built into the checkout's ``build/`` by whoever needs them
first; a build writes a per-process temporary and renames it into place, so
workers that load them at once never see a partial library. Lockdep is
included: a worker spawned under ``SPFFT_TPU_LOCKDEP=1`` records its own
acquisition graph, and ``spawn_workers(lockdep_dir=)`` gives each host its
own report (``<dir>/host<i>.json``, written when the worker exits cleanly:
:func:`stop_workers`), which ``spfft_tpu_torch/programs/analyze.py
--lockdep-check`` merges and cross-checks as one graph.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from . import knobs
from .errors import HostExecutionError, InvalidParameterError

WISDOM_BUNDLE_ENV = "SPFFT_TPU_HOSTS_WISDOM_BUNDLE"

WORKER_MODULE = "spfft_tpu_torch.programs.serve_worker"

# the directory that holds the package: the workers' working directory and
# the head of their import path
_ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    """An OS-assigned free TCP port (the coordinator-allocation helper)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _visible_cards() -> list:
    """The card ids this process may hand to a child: its own
    ``CUDA_VISIBLE_DEVICES`` where set, else 0 .. device_count - 1."""
    own = os.environ.get("CUDA_VISIBLE_DEVICES")
    if own:
        return [c.strip() for c in own.split(",") if c.strip()]
    import torch

    return [str(i) for i in range(torch.cuda.device_count())]


def child_env(overrides=None, *, devices: int | None = None) -> dict:
    """Environment for a spawned worker process.

    A minimal base (``PATH``, ``HOME``, ``TMPDIR``, ``PYTHONPATH``,
    ``CUDA_VISIBLE_DEVICES`` where set) plus **every ambient ``SPFFT_TPU_*``
    knob propagated verbatim**, so a chaos spec or a serving knob configured
    on the parent governs the children too. ``devices`` gives the child the
    first ``devices`` cards this process may use (``CUDA_VISIBLE_DEVICES``;
    none is set where this process sees no card); ``overrides`` merge last
    and win."""
    env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin:/usr/local/bin"),
        "HOME": os.environ.get("HOME", str(Path.home())),
    }
    if "PYTHONPATH" in os.environ:
        env["PYTHONPATH"] = os.environ["PYTHONPATH"]
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    if "CUDA_VISIBLE_DEVICES" in os.environ:
        env["CUDA_VISIBLE_DEVICES"] = os.environ["CUDA_VISIBLE_DEVICES"]
    if "LD_LIBRARY_PATH" in os.environ:
        env["LD_LIBRARY_PATH"] = os.environ["LD_LIBRARY_PATH"]
    for key, value in os.environ.items():
        if key.startswith(knobs.PREFIX):
            env[key] = value
    # two knobs that must NOT propagate verbatim: both name parent-owned
    # output paths (a shared lockdep report would be clobbered by every
    # process at exit; a shared trace-dump directory mixes every host's
    # dumps). Workers get per-host paths through spawn_workers or overrides.
    env.pop("SPFFT_TPU_LOCKDEP_REPORT", None)
    env.pop("SPFFT_TPU_TRACE_DUMP", None)
    if devices is not None:
        if int(devices) < 1:
            raise InvalidParameterError(f"devices must be >= 1, got {devices}")
        cards = _visible_cards()
        if cards:
            env["CUDA_VISIBLE_DEVICES"] = ",".join(cards[: int(devices)])
    if overrides:
        env.update({str(k): str(v) for k, v in dict(overrides).items()})
    return env


def warm_start(bundle_path: str | None = None) -> tuple:
    """Merge a fleet wisdom bundle into this host's active store at boot.

    ``bundle_path`` defaults to ``SPFFT_TPU_HOSTS_WISDOM_BUNDLE``; unset or
    empty is a no-op ``(0, 0)``. Returns ``(added, replaced)`` from
    :meth:`~spfft_tpu_torch.tuning.wisdom.WisdomStore.merge`
    (best-measured-wins, version-checked, corrupt bundles quarantined
    typed)."""
    path = bundle_path if bundle_path is not None else knobs.get_str(WISDOM_BUNDLE_ENV)
    if not path:
        return (0, 0)
    from .tuning.wisdom import active_store

    return active_store().merge(path)


def boot(coordinator_address: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, *, backend: str | None = None, **kwargs) -> dict:
    """Join a multi-process run and report the observed topology.

    Validates the coordinates typed up front (a malformed value raises
    :class:`~spfft_tpu_torch.errors.InvalidParameterError` here, not a
    rendezvous timeout), joins through
    :func:`~spfft_tpu_torch.parallel.mesh.init_distributed` (``backend``
    None: NCCL with a card, else gloo) and returns ``{"process_count",
    "process_index", "global_devices", "local_devices"}``: the devices are
    this process's cards (one CPU device without a card), summed over the
    group."""
    import torch
    import torch.distributed as dist

    from .parallel import mesh as _mesh

    _mesh.init_distributed(coordinator_address, num_processes, process_id,
                           backend=backend, **kwargs)
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, local)
    return {
        "process_count": int(dist.get_world_size()),
        "process_index": int(dist.get_rank()),
        "global_devices": int(sum(counts)),
        "local_devices": int(local),
    }


class WorkerHost:
    """One spawned worker process: its handle, address, and ready record."""

    def __init__(self, host_id: int, proc, ready: dict, log_path: str):
        self.host_id = int(host_id)
        self.proc = proc
        self.ready = dict(ready)
        self.log_path = str(log_path)
        self.address = f"127.0.0.1:{int(ready['port'])}"

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the chaos primitive: no cleanup, no exit hooks, the
        exact shape of an OOM-killed or power-failed host."""
        if self.alive():
            self.proc.send_signal(signal.SIGKILL)

    def join(self, timeout_s: float = 10.0) -> int | None:
        try:
            return self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            return None

    def log_tail(self, limit: int = 2000) -> str:
        try:
            return Path(self.log_path).read_text()[-limit:]
        except OSError:
            return "<no log>"

    def describe(self) -> dict:
        return {
            "host_id": self.host_id,
            "pid": self.pid,
            "address": self.address,
            "alive": self.alive(),
            "ready": self.ready,
        }


def stop_workers(workers, timeout_s: float = 10.0) -> None:
    """Clean-stop a worker fleet: ask each RPC server to shut down (so exit
    hooks run), then escalate to SIGKILL on the stragglers."""
    from .errors import GenericError
    from .serve.rpc import RpcClient

    for w in workers:
        if not w.alive():
            continue
        client = RpcClient(w.address, timeout_s=2.0)
        try:
            client.call({"op": "shutdown"})
        except GenericError:
            pass  # already dead / wedged: the kill below owns it
        finally:
            client.close()
    deadline = time.monotonic() + float(timeout_s)
    for w in workers:
        remaining = max(0.1, deadline - time.monotonic())
        if w.join(remaining) is None:
            w.kill()
            w.join(2.0)


def spawn_workers(
    n: int,
    *,
    devices_per_host: int = 1,
    mesh: bool = False,
    device: str | None = None,
    dtype: str | None = None,
    wisdom_bundle: str | None = None,
    lockdep_dir: str | None = None,
    env=None,
    workdir: str | None = None,
    ready_timeout_s: float = 120.0,
    python: str | None = None,
) -> list:
    """Spawn ``n`` RPC serving workers; returns their :class:`WorkerHost`\\ s.

    Each worker runs ``python -m spfft_tpu_torch.programs.serve_worker``
    under :func:`child_env` (every ambient ``SPFFT_TPU_*`` knob propagated,
    ``devices_per_host`` cards). ``device`` (``"gpu"``, the worker's
    default, or ``"cpu"``) and ``dtype`` (``"float32"`` / ``"float64"``)
    configure each worker's service. ``mesh=True`` additionally joins the
    workers into ONE ``torch.distributed`` run (a coordinator port is
    allocated here; worker 0 hosts the store). ``wisdom_bundle``
    warm-starts every worker's store; ``lockdep_dir`` arms
    ``SPFFT_TPU_LOCKDEP=1`` in every worker with a per-host report path
    ``<dir>/host<i>.json`` (written on clean shutdown —
    :func:`stop_workers`).

    Boot failures are typed: a worker that dies or fails to write its ready
    file within ``ready_timeout_s`` kills the whole fleet and raises
    :class:`~spfft_tpu_torch.errors.HostExecutionError` carrying its log
    tail."""
    n = int(n)
    if n < 1:
        raise InvalidParameterError(f"spawn_workers needs n >= 1, got {n}")
    workdir = workdir or tempfile.mkdtemp(prefix="spfft-hostmesh-")
    Path(workdir).mkdir(parents=True, exist_ok=True)
    if lockdep_dir:
        # a worker writes its report at exit, where a missing folder would
        # lose it without a word
        Path(lockdep_dir).mkdir(parents=True, exist_ok=True)
    coordinator = f"127.0.0.1:{free_port()}" if mesh else None
    procs = []
    for i in range(n):
        ready_path = Path(workdir) / f"worker{i}.ready.json"
        log_path = Path(workdir) / f"worker{i}.log"
        cmd = [
            python or sys.executable, "-m", WORKER_MODULE,
            "--host-id", str(i),
            "--port", "0",
            "--ready-file", str(ready_path),
        ]
        if device is not None:
            cmd += ["--device", str(device)]
        if dtype is not None:
            cmd += ["--dtype", str(dtype)]
        if coordinator is not None:
            cmd += [
                "--coordinator", coordinator,
                "--num-processes", str(n),
                "--process-id", str(i),
            ]
        overrides = dict(env or {})
        if wisdom_bundle:
            overrides[WISDOM_BUNDLE_ENV] = str(wisdom_bundle)
        if lockdep_dir:
            overrides["SPFFT_TPU_LOCKDEP"] = "1"
            overrides["SPFFT_TPU_LOCKDEP_REPORT"] = str(Path(lockdep_dir) / f"host{i}.json")
        # a parent trace-dump dir fans out per host (child_env pops the
        # verbatim value): each worker's dumps stay attributable
        trace_dump = knobs.get_str("SPFFT_TPU_TRACE_DUMP")
        if trace_dump:
            overrides.setdefault("SPFFT_TPU_TRACE_DUMP", str(Path(trace_dump) / f"host{i}"))
        cenv = child_env(overrides, devices=devices_per_host)
        # the checkout first on the import path: `-m` finds this package
        cenv["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + ([cenv["PYTHONPATH"]] if cenv.get("PYTHONPATH") else []))
        with open(log_path, "wb") as log:
            proc = subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=cenv, cwd=str(_ROOT),
            )
        procs.append((i, proc, ready_path, log_path))

    workers = []
    deadline = time.monotonic() + float(ready_timeout_s)
    try:
        for i, proc, ready_path, log_path in procs:
            ready = None
            while time.monotonic() < deadline:
                if ready_path.exists():
                    try:
                        ready = json.loads(ready_path.read_text())
                        break
                    except (OSError, json.JSONDecodeError):
                        pass  # mid-write: the atomic rename makes this rare
                if proc.poll() is not None:
                    break
                time.sleep(0.05)
            if ready is None:
                tail = "<no log>"
                try:
                    tail = Path(log_path).read_text()[-2000:]
                except OSError:
                    pass
                raise HostExecutionError(
                    f"worker {i} failed to become ready within "
                    f"{ready_timeout_s}s (exit code {proc.poll()}); log "
                    f"tail:\n{tail}"
                )
            workers.append(WorkerHost(i, proc, ready, str(log_path)))
    except Exception:
        for _, proc, _, _ in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
                proc.wait(5.0)
        raise
    return workers
