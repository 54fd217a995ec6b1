"""The port's multi-host bootstrap (spfft_tpu_torch.hostmesh) and its
multi-process smoke program.

The counterparts of ``tests/test_hostmesh.py`` and the two-process cases of
``tests/test_multihost.py``: typed up-front validation of the distributed
coordinates, worker-spawn environment propagation (every ambient
``SPFFT_TPU_*`` knob reaches the child; ``devices`` becomes
``CUDA_VISIBLE_DEVICES`` where the JAX package sets a virtual CPU device
count), wisdom warm-start from fleet bundles, a worker's ready handshake and
clean stop, the two-process ``torch.distributed`` boot on gloo, and one rank
per process of a distributed transform (``programs/multihost_smoke``)
against the dense oracle at 1e-6. Every spawned process has its own join
timeout and is stopped in ``finally``.
"""
from __future__ import annotations

import subprocess
import sys

import pytest

from spfft_tpu_torch import hostmesh, tuning
from spfft_tpu_torch.errors import GenericError, HostExecutionError, InvalidParameterError
from spfft_tpu_torch.parallel.mesh import validate_distributed_args
from spfft_tpu_torch.serve.rpc import RpcClient

JOIN_SECONDS = 120


# ---- init_distributed up-front validation -----------------------------------


@pytest.mark.parametrize(
    "coord,nprocs,pid",
    [
        ("localhost", 2, 0),          # no port
        (":8476", 2, 0),              # no host
        ("localhost:notaport", 2, 0),  # non-integer port
        ("localhost:0", 2, 0),        # port out of range
        ("localhost:99999", 2, 0),    # port out of range
        ("localhost:8476", 0, 0),     # num_processes < 1
        ("localhost:8476", "two", 0),  # non-integer num_processes
        ("localhost:8476", 2, -1),    # negative process_id
        ("localhost:8476", 2, 2),     # process_id >= num_processes
        ("localhost:8476", 2, "one"),  # non-integer process_id
        ("localhost:8476", None, 0),  # process_id without num_processes
    ],
)
def test_distributed_args_malformed_raise_typed(coord, nprocs, pid):
    with pytest.raises(InvalidParameterError):
        validate_distributed_args(coord, nprocs, pid)


def test_boot_validates_before_joining(monkeypatch):
    """boot refuses malformed coordinates WITHOUT touching
    torch.distributed (the opaque-in-child failure it exists to prevent)."""
    import torch.distributed as dist

    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: called.append(kw))
    with pytest.raises(InvalidParameterError):
        hostmesh.boot("nonsense", 2, 0)
    assert called == []


# ---- child env propagation --------------------------------------------------


def test_child_env_propagates_every_ambient_knob(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_LOCKDEP", "1")
    monkeypatch.setenv("SPFFT_TPU_SERVE_QUEUE_CAP", "17")
    monkeypatch.setenv("SPFFT_TPU_FAULTS_SEED", "42")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5,6")
    env = hostmesh.child_env(devices=2)
    assert env["SPFFT_TPU_LOCKDEP"] == "1"
    assert env["SPFFT_TPU_SERVE_QUEUE_CAP"] == "17"
    assert env["SPFFT_TPU_FAULTS_SEED"] == "42"
    assert env["CUDA_VISIBLE_DEVICES"] == "3,5"  # the first two of this process's cards
    assert "XLA_FLAGS" not in env and "JAX_PLATFORMS" not in env


def test_child_env_overrides_win_and_devices_without_cards(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_LOCKDEP", "0")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(hostmesh, "_visible_cards", lambda: [])
    env = hostmesh.child_env({"SPFFT_TPU_LOCKDEP": "1"}, devices=2)
    assert env["SPFFT_TPU_LOCKDEP"] == "1"
    assert "CUDA_VISIBLE_DEVICES" not in env  # no card: nothing to hand out
    env = hostmesh.child_env({"CUDA_VISIBLE_DEVICES": "7"}, devices=1)
    assert env["CUDA_VISIBLE_DEVICES"] == "7"


def test_child_env_devices_typed():
    with pytest.raises(InvalidParameterError):
        hostmesh.child_env(devices=0)


def test_child_env_never_propagates_shared_lockdep_report(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_LOCKDEP", "1")
    monkeypatch.setenv("SPFFT_TPU_LOCKDEP_REPORT", "/tmp/shared.json")
    env = hostmesh.child_env()
    assert "SPFFT_TPU_LOCKDEP_REPORT" not in env
    assert env["SPFFT_TPU_LOCKDEP"] == "1"
    env = hostmesh.child_env({"SPFFT_TPU_LOCKDEP_REPORT": "/tmp/host0.json"})
    assert env["SPFFT_TPU_LOCKDEP_REPORT"] == "/tmp/host0.json"


def test_child_env_never_propagates_shared_trace_dump(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_TRACE", "1")
    monkeypatch.setenv("SPFFT_TPU_TRACE_DUMP", "/tmp/shared-dumps")
    env = hostmesh.child_env()
    assert "SPFFT_TPU_TRACE_DUMP" not in env
    assert env["SPFFT_TPU_TRACE"] == "1"
    env = hostmesh.child_env({"SPFFT_TPU_TRACE_DUMP": "/tmp/dumps/host0"})
    assert env["SPFFT_TPU_TRACE_DUMP"] == "/tmp/dumps/host0"


def test_spawn_fans_out_trace_dump_per_host(tmp_path, monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_TRACE_DUMP", str(tmp_path / "dumps"))
    captured = []

    class _DeadProc:
        def poll(self):
            return 1  # exited: the readiness wait gives up immediately

        def send_signal(self, sig):
            pass

    def fake_popen(cmd, stdout=None, stderr=None, env=None, cwd=None):
        captured.append((cmd, env))
        return _DeadProc()

    monkeypatch.setattr(hostmesh.subprocess, "Popen", fake_popen)
    with pytest.raises(HostExecutionError, match="failed to become ready"):
        hostmesh.spawn_workers(2, workdir=str(tmp_path / "w"), device="cpu", dtype="float32")
    assert [e.get("SPFFT_TPU_TRACE_DUMP") for _, e in captured] == [
        str(tmp_path / "dumps" / "host0"),
        str(tmp_path / "dumps" / "host1"),
    ]
    cmd = captured[0][0]
    assert cmd[1:3] == ["-m", hostmesh.WORKER_MODULE]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--dtype") + 1] == "float32"
    captured.clear()
    with pytest.raises(HostExecutionError):
        hostmesh.spawn_workers(1, workdir=str(tmp_path / "w2"),
                               env={"SPFFT_TPU_TRACE_DUMP": str(tmp_path / "mine")})
    assert captured[0][1]["SPFFT_TPU_TRACE_DUMP"] == str(tmp_path / "mine")


# ---- wisdom warm-start ------------------------------------------------------


def test_warm_start_merges_fleet_bundle(tmp_path, monkeypatch):
    donor = tuning.WisdomStore(str(tmp_path / "donor.json"))
    key = {"kind": "local", "probe": 1}
    donor.record(key, tuning.make_entry(key, {"engine": "xla"}, [{"label": "c0", "ms": 1.0}]))
    bundle = tmp_path / "fleet.json"
    assert donor.export(str(bundle)) == 1
    monkeypatch.setenv("SPFFT_TPU_WISDOM", str(tmp_path / "host.json"))
    monkeypatch.setenv(hostmesh.WISDOM_BUNDLE_ENV, str(bundle))
    assert hostmesh.warm_start() == (1, 0)
    store = tuning.WisdomStore(str(tmp_path / "host.json"))
    assert store.lookup(key)["choice"] == {"engine": "xla"}
    assert hostmesh.warm_start() == (0, 0)  # idempotent


def test_warm_start_unset_is_noop(monkeypatch):
    monkeypatch.delenv(hostmesh.WISDOM_BUNDLE_ENV, raising=False)
    assert hostmesh.warm_start() == (0, 0)


def test_warm_start_corrupt_bundle_typed(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv("SPFFT_TPU_WISDOM", str(tmp_path / "host.json"))
    with pytest.raises(GenericError):
        hostmesh.warm_start(str(bad))


# ---- spawn validation -------------------------------------------------------


def test_spawn_workers_typed_validation():
    with pytest.raises(InvalidParameterError):
        hostmesh.spawn_workers(0)


def test_spawn_workers_boot_failure_typed(tmp_path):
    """A worker that dies before readiness surfaces typed with its log tail."""
    with pytest.raises(HostExecutionError, match="failed to become ready"):
        hostmesh.spawn_workers(1, workdir=str(tmp_path), ready_timeout_s=20.0,
                               python="/bin/false")


def test_worker_refuses_to_serve_on_the_cpu_unasked(tmp_path):
    """Without a card the default worker fails its boot typed (in-process:
    the worker's main, no spawn)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from spfft_tpu_torch.errors import GPUNoDeviceError
    from spfft_tpu_torch.programs import serve_worker

    with pytest.raises(GPUNoDeviceError):
        serve_worker.main(["--ready-file", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()


# ---- real worker boot (spawned processes) -----------------------------------


def test_spawn_worker_ready_env_and_clean_stop(tmp_path, monkeypatch):
    """One spawned worker on the CPU: ready handshake, knob propagation seen
    from inside the child, the knob governing its service, clean stop."""
    monkeypatch.setenv("SPFFT_TPU_SERVE_QUEUE_CAP", "19")
    workers = hostmesh.spawn_workers(1, workdir=str(tmp_path / "w"), device="cpu",
                                     ready_timeout_s=JOIN_SECONDS)
    try:
        w = workers[0]
        assert w.alive()
        assert w.ready["port"] > 0 and w.ready["device"] == "cpu"
        assert w.ready["dtype"] == "float64"
        assert "SPFFT_TPU_SERVE_QUEUE_CAP" in w.ready["env_knobs"]
        client = RpcClient(w.address, timeout_s=10.0)
        try:
            assert client.call({"op": "ping"})["ok"] == 1
            assert client.call({"op": "stats"})["stats"]["queue_capacity"] == 19
        finally:
            client.close()
    finally:
        hostmesh.stop_workers(workers)
    assert not workers[0].alive()


def test_spawn_mesh_boot_two_process_topology(tmp_path):
    """Two worker processes join ONE torch.distributed run on gloo: every
    rank observes process_count 2 and one CPU device each."""
    workers = hostmesh.spawn_workers(2, mesh=True, workdir=str(tmp_path), device="cpu",
                                     ready_timeout_s=JOIN_SECONDS)
    try:
        for w in workers:
            topo = w.ready["topology"]
            assert topo is not None, w.log_tail()
            assert topo["process_count"] == 2
            assert topo["process_index"] == w.host_id
            assert topo["global_devices"] == 2
            assert topo["local_devices"] == 1
    finally:
        hostmesh.stop_workers(workers)


@pytest.mark.parametrize("engine,ttype,exchange", [
    ("xla", "c2c", "buffered"),
    ("mxu", "r2c", "unbuffered"),
])
def test_two_process_roundtrip(engine, ttype, exchange):
    port = hostmesh.free_port()
    env = hostmesh.child_env()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "spfft_tpu_torch.programs.multihost_smoke", str(rank),
             str(port), engine, ttype, exchange, "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
            cwd=str(hostmesh._ROOT),
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_SECONDS)
            outs.append(out)
    finally:
        for p in procs:  # a hung rank must not leak gloo processes or the port
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-2000:]}"
        assert f"RANK {rank} PASS" in out


def test_multihost_smoke_refuses_overlapped_exchange():
    """overlap_chunks > 1 runs the OVERLAPPED exchange over the group, as the
    JAX program's does: two ranks, four chunk collectives a direction, each
    issued asynchronously (gloo) and waited on by its unpack."""
    port = hostmesh.free_port()
    env = hostmesh.child_env()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "spfft_tpu_torch.programs.multihost_smoke", str(rank),
             str(port), "mxu", "c2c", "buffered", "2", "4"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
            cwd=str(hostmesh._ROOT),
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_SECONDS)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-2000:]}"
        assert f"RANK {rank} PASS" in out