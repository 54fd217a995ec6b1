"""The port's RPC transport and cluster front against the JAX package's.

The counterparts of ``tests/test_cluster.py``: the wire protocol with typed
error marshalling, the executor's host-loss requeue ladder on fake plans,
the cluster front against stub RPC workers with the ``rpc.submit`` and
``host.heartbeat`` fault sites armed, trace propagation and ticket
timelines, the fleet document, and a SIGKILLed worker process mid-burst.

Wire parity, both ways: a JAX ``RpcClient``/``ClusterFront`` over a port
``RpcServer`` worker gives the JAX worker's results, and a port front over a
JAX worker the port worker's (float64; bar 1e-12 relative to the largest
value, the two packages' plans differ only in rounding); the frames are
byte for byte equal, and a port error payload decodes to the JAX class with
the same code.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

import spfft_tpu as jsp
import spfft_tpu_torch as sp
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.serve import rpc as jrpc
from spfft_tpu.serve.cluster import ClusterFront as JClusterFront
from spfft_tpu_torch import TransformType, faults, hostmesh, obs, sched, verify
from spfft_tpu_torch.errors import (
    DeadlineExceededError,
    GenericError,
    HostExecutionError,
    HostLostError,
    InvalidParameterError,
    ServiceOverloadError,
)
from spfft_tpu_torch.obs import fleet, trace
from spfft_tpu_torch.serve import cluster, queue, rpc
from spfft_tpu_torch.serve.cluster import ClusterFront
from spfft_tpu_torch.serve.rpc import RpcClient, RpcServer

WIRE_BAR = 1e-12
JOIN_SECONDS = 120

CLUSTER_ENV_KNOBS = (
    "SPFFT_TPU_HOSTS_HEARTBEAT_S",
    "SPFFT_TPU_HOSTS_HEARTBEAT_MISSES",
    "SPFFT_TPU_HOSTS_RETRIES",
    "SPFFT_TPU_HOSTS_BACKOFF_S",
    "SPFFT_TPU_RPC_TIMEOUT_S",
    "SPFFT_TPU_SERVE_QUEUE_CAP",
    "SPFFT_TPU_SERVE_BATCH_MAX",
    "SPFFT_TPU_SERVE_RETRIES",
)


@pytest.fixture(autouse=True)
def clean_cluster(monkeypatch):
    for f in (faults, jfaults):
        f.disarm()
        f.reseed(0)
    verify.breaker.reset()
    for o in (obs, jobs):
        o.enable()
        o.clear()
    for knob in CLUSTER_ENV_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    yield
    for f in (faults, jfaults):
        f.disarm()
    verify.breaker.reset()


def _counter(name_prefix: str) -> int:
    return sum(
        v for k, v in obs.snapshot().get("counters", {}).items() if k.startswith(name_prefix)
    )


# ---- wire protocol ----------------------------------------------------------


def test_wire_array_roundtrip():
    for a in (
        np.arange(12, dtype=np.int32).reshape(4, 3),
        np.linspace(0, 1, 7, dtype=np.float32),
        (np.arange(6) + 1j * np.arange(6)).astype(np.complex128),
    ):
        out = rpc.decode_value(rpc.encode_value({"x": [a, {"y": a}]}))
        np.testing.assert_array_equal(out["x"][0], a)
        np.testing.assert_array_equal(out["x"][1]["y"], a)
        assert out["x"][0].dtype == a.dtype


def test_wire_frames_are_the_jax_packages_byte_for_byte():
    import socket
    import torch

    vals = np.arange(5, dtype=np.complex64) * (1 + 2j)
    msg = {"op": "submit_batch", "transform_type": 0, "dims": [4, 4, 4],
           "indices": np.zeros((5, 3), np.int32), "payloads": [vals, vals * 2],
           "runs": ["r1", None], "scaling": 1}
    frames = []
    for send, m in ((jrpc.send_msg, msg), (rpc.send_msg, msg),
                    (rpc.send_msg, dict(msg, payloads=[torch.as_tensor(vals),
                                                       torch.as_tensor(vals * 2)]))):
        a, b = socket.socketpair()
        try:
            send(a, m)
            a.close()
            chunks = []
            while chunk := b.recv(1 << 16):
                chunks.append(chunk)
            frames.append(b"".join(chunks))
        finally:
            b.close()
    assert frames[0] == frames[1] == frames[2]
    assert rpc.MAX_FRAME_BYTES == jrpc.MAX_FRAME_BYTES == 256 * 1024 * 1024
    assert rpc.OPS == jrpc.OPS and rpc.SEGMENT_LIMIT == jrpc.SEGMENT_LIMIT


def test_wire_error_payload_roundtrips_taxonomy():
    for exc in (
        ServiceOverloadError("queue full"),
        DeadlineExceededError("too late"),
        HostLostError("host died"),
        InvalidParameterError("bad dims"),
    ):
        payload = rpc.error_payload(exc)["error"]
        with pytest.raises(type(exc), match=str(exc)):
            rpc.raise_error_payload(payload)
        # the port's payload decodes to the JAX class of the same code
        jcls = getattr(jsp.errors, type(exc).__name__)
        with pytest.raises(jcls, match=str(exc)):
            jrpc.raise_error_payload(payload)
        assert int(jcls.error_code) == payload["code"]


def test_rpc_client_malformed_address_typed():
    with pytest.raises(InvalidParameterError):
        RpcClient("nonsense")
    with pytest.raises(InvalidParameterError):
        RpcClient("host:notaport")


def test_rpc_client_unreachable_is_host_lost():
    client = RpcClient("127.0.0.1:9", timeout_s=0.5)  # discard port: refused
    with pytest.raises(HostLostError, match="unreachable"):
        client.call({"op": "ping"})
    client.close()


# ---- stub worker (a real RpcServer around a fake service) -------------------


class _StubTicket:
    def __init__(self, value):
        self._value = value

    def result(self, timeout=None):
        if isinstance(self._value, BaseException):
            raise self._value
        return self._value


class _StubQueue:
    def depth(self):
        return 0


class _StubService:
    """Echo service: backward doubles the payload (no plans)."""

    def __init__(self, fail_with=None, fail_submits=()):
        self.queue = _StubQueue()
        self.fail_with = fail_with
        self.fail_submits = set(fail_submits)  # 0-based submit ordinals
        self.submitted = 0

    def submit(self, transform_type, dims, indices, payload, *,
               direction="backward", tenant="default", timeout_s=None,
               scaling=None, run_id=None):
        ordinal = self.submitted
        self.submitted += 1
        if self.fail_with is not None:
            raise self.fail_with
        if ordinal in self.fail_submits:
            raise ServiceOverloadError(f"stub refused submit {ordinal}")
        return _StubTicket(np.asarray(payload) * 2)

    def stats(self):
        return {"queue_capacity": 0}

    def describe(self):
        return {"stub": True}


@pytest.fixture()
def stub_worker():
    service = _StubService()
    server = RpcServer(service, port=0, timeout_s=10.0)
    yield service, server
    server.close()


def test_rpc_server_unknown_op_typed(stub_worker):
    _, server = stub_worker
    client = RpcClient(server.address, timeout_s=5.0)
    try:
        with pytest.raises(InvalidParameterError, match="unknown RPC op"):
            client.call({"op": "bogus"})
    finally:
        client.close()


def test_rpc_server_submit_and_batch(stub_worker):
    _, server = stub_worker
    client = RpcClient(server.address, timeout_s=5.0)
    vals = np.arange(5, dtype=np.float64)
    msg = {
        "op": "submit", "transform_type": 0, "dims": [4, 4, 4],
        "indices": np.zeros((5, 3), np.int32), "payload": vals,
    }
    try:
        np.testing.assert_array_equal(client.call(msg)["result"], vals * 2)
        out = client.call({**msg, "op": "submit_batch", "payloads": [vals, vals + 1]})
        np.testing.assert_array_equal(out["results"][0]["result"], vals * 2)
        np.testing.assert_array_equal(out["results"][1]["result"], (vals + 1) * 2)
    finally:
        client.close()


def test_rpc_idle_pooled_connection_stays_usable():
    service = _StubService()
    server = RpcServer(service, port=0, timeout_s=0.3)
    client = RpcClient(server.address, timeout_s=5.0)
    try:
        assert client.call({"op": "ping"})["ok"] == 1
        time.sleep(1.0)  # > 3 server-side recv timeouts of idleness
        assert client.call({"op": "ping"})["ok"] == 1
    finally:
        client.close()
        server.close()


def test_rpc_oversized_reply_is_typed_not_host_loss(monkeypatch):
    class _BigStub(_StubService):
        def submit(self, *a, **kw):
            self.submitted += 1
            return _StubTicket(np.zeros(100_000))

    server = RpcServer(_BigStub(), port=0, timeout_s=5.0)
    monkeypatch.setattr(rpc, "MAX_FRAME_BYTES", 50_000)
    client = RpcClient(server.address, timeout_s=5.0)
    try:
        with pytest.raises(InvalidParameterError, match="frame"):
            client.call({
                "op": "submit", "transform_type": 0, "dims": [4, 4, 4],
                "indices": np.zeros((1, 3), np.int32), "payload": np.zeros(1),
            })
        assert client.call({"op": "ping"})["ok"] == 1
    finally:
        client.close()
        server.close()


def test_rpc_server_application_error_crosses_typed(stub_worker):
    service, server = stub_worker
    service.fail_with = ServiceOverloadError("stub is full")
    client = RpcClient(server.address, timeout_s=5.0)
    jclient = jrpc.RpcClient(server.address, timeout_s=5.0)
    msg = {"op": "submit", "transform_type": 0, "dims": [4, 4, 4],
           "indices": np.zeros((1, 3), np.int32), "payload": np.zeros(1)}
    try:
        with pytest.raises(ServiceOverloadError, match="stub is full"):
            client.call(msg)
        with pytest.raises(jsp.errors.ServiceOverloadError, match="stub is full"):
            jclient.call(msg)
        assert client.call({"op": "ping"})["ok"] == 1
    finally:
        client.close()
        jclient.close()


def test_rpc_server_types_an_untyped_failure_with_the_services_platform():
    class _Card(_StubService):
        def _platform(self):
            return "gpu"

        def submit(self, *a, **kw):
            raise RuntimeError("device fell over")

    server = RpcServer(_Card(), port=0, timeout_s=5.0)
    client = RpcClient(server.address, timeout_s=5.0)
    try:
        with pytest.raises(sp.errors.GPUFFTError, match="device fell over"):
            client.call({"op": "submit", "transform_type": 0, "dims": [4, 4, 4],
                         "indices": np.zeros((1, 3), np.int32), "payload": np.zeros(1)})
    finally:
        client.close()
        server.close()


# ---- wire parity with the JAX package, both ways -----------------------------


def _geometry():
    trip = np.asarray(sp.create_spherical_cutoff_triplets(8, 8, 8, 0.8), dtype=np.int32)
    rng = np.random.default_rng(5)
    vals = [rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
            for _ in range(3)]
    return trip, vals


def _front_results(front_cls, address, trip, vals, **kw):
    front = front_cls([address], heartbeat_s=5.0, rpc_timeout_s=20.0, start=False, **kw)
    try:
        tickets = [front.submit(int(TransformType.C2C), (8, 8, 8), trip, v) for v in vals]
        front.pump()
        return [np.asarray(t.result(timeout=30)) for t in tickets]
    finally:
        front.close()


def test_jax_front_over_a_port_worker_matches_the_jax_worker():
    trip, vals = _geometry()
    port_svc = sp.serve.TransformService(sp.ProcessingUnit.HOST, engine="xla")
    jax_svc = jsp.serve.TransformService(engine="xla", dtype=np.float64)
    port_srv, jax_srv = RpcServer(port_svc, port=0), jrpc.RpcServer(jax_svc, port=0)
    try:
        got = _front_results(JClusterFront, port_srv.address, trip, vals)
        want = _front_results(JClusterFront, jax_srv.address, trip, vals)
    finally:
        port_srv.close()
        jax_srv.close()
        port_svc.close()
        jax_svc.close()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.abs(g - w).max() <= WIRE_BAR * np.abs(w).max()


def test_port_front_over_a_jax_worker_matches_the_port_worker():
    trip, vals = _geometry()
    port_svc = sp.serve.TransformService(sp.ProcessingUnit.HOST, engine="mxu")
    jax_svc = jsp.serve.TransformService(engine="xla", dtype=np.float64)
    port_srv, jax_srv = RpcServer(port_svc, port=0), jrpc.RpcServer(jax_svc, port=0)
    try:
        got = _front_results(ClusterFront, jax_srv.address, trip, vals, platform="cpu")
        want = _front_results(ClusterFront, port_srv.address, trip, vals, platform="cpu")
    finally:
        port_srv.close()
        jax_srv.close()
        port_svc.close()
        jax_svc.close()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.abs(g - w).max() <= WIRE_BAR * np.abs(w).max()


# ---- executor host_lost ladder (fake plans, no RPC) -------------------------


class _FakePending:
    def is_ready(self):
        return True


class _LostPlan:
    """Dispatch raises HostLostError while ``lost``; ``rehost`` heals it."""

    _verifier = None
    _guard = False
    _platform = "cpu"
    device = None

    def __init__(self, lost=True, can_rehost=True, lose_finalize=0):
        self.lost = lost
        self.can_rehost = can_rehost
        self.lose_finalize = lose_finalize
        self.rehosts = 0

    def rehost(self, error):
        if not self.can_rehost:
            raise HostLostError("no live worker hosts remain")
        self.rehosts += 1
        self.lost = False

    def _dispatch_backward(self, payload):
        if self.lost:
            raise HostLostError("host died at dispatch")
        return _FakePending()

    def _finalize_backward(self, pending):
        if self.lose_finalize > 0:
            self.lose_finalize -= 1
            self.lost = True
            raise HostLostError("host died in flight")
        return "ok"


class _NoHookPlan:
    _verifier = None
    _guard = False
    _platform = "cpu"
    device = None

    def _dispatch_backward(self, payload):
        raise HostLostError("host died; this plan cannot move")


def test_executor_rehosts_and_completes():
    plan = _LostPlan(lost=True)
    graph = sched.TaskGraph()
    tid = graph.add("backward", payload=[1.0], transform=plan)
    report = sched.run_graph(graph, retries=0, demote=False, host_retries=2)
    assert report.outcomes[tid] == "completed"
    assert report.results[tid] == "ok"
    assert plan.rehosts == 1
    assert _counter("host_requeues_total") == 1


def test_executor_finalize_host_loss_rehosts():
    plan = _LostPlan(lost=False, lose_finalize=1)
    graph = sched.TaskGraph()
    tid = graph.add("backward", payload=[1.0], transform=plan)
    report = sched.run_graph(graph, retries=0, demote=False, host_retries=2)
    assert report.outcomes[tid] == "completed"
    assert plan.rehosts == 1


def test_executor_no_hook_resolves_host_lost_and_cascades():
    graph = sched.TaskGraph()
    t1 = graph.add("backward", payload=[1.0], transform=_NoHookPlan())
    t2 = graph.add("backward", payload=[2.0], transform=_LostPlan(lost=False), after=[t1])
    report = sched.run_graph(graph, retries=0, demote=False, host_retries=2)
    assert report.outcomes[t1] == "host_lost"
    assert isinstance(report.errors[t1], HostLostError)
    assert report.outcomes[t2] == "upstream_failed"
    assert isinstance(report.errors[t2], HostExecutionError)
    with pytest.raises(HostLostError):
        report.result(t1)


def test_executor_no_survivors_resolves_host_lost():
    plan = _LostPlan(lost=True, can_rehost=False)
    graph = sched.TaskGraph()
    tid = graph.add("backward", payload=[1.0], transform=plan)
    report = sched.run_graph(graph, retries=0, demote=False, host_retries=3)
    assert report.outcomes[tid] == "host_lost"
    assert isinstance(report.errors[tid], HostLostError)


@pytest.mark.parametrize("source", ["argument", "knob"])
def test_executor_host_retry_budget_exhausts(monkeypatch, source):
    class _AlwaysLost(_LostPlan):
        def rehost(self, error):
            self.rehosts += 1  # "moves", but the next host dies too

    plan = _AlwaysLost(lost=True)
    graph = sched.TaskGraph()
    tid = graph.add("backward", payload=[1.0], transform=plan)
    if source == "knob":
        monkeypatch.setenv("SPFFT_TPU_HOSTS_RETRIES", "2")
        monkeypatch.setenv("SPFFT_TPU_HOSTS_BACKOFF_S", "0")
        report = sched.run_graph(graph, retries=0, demote=False)
    else:
        report = sched.run_graph(graph, retries=0, demote=False, host_retries=2)
    assert report.outcomes[tid] == "host_lost"
    assert plan.rehosts == 2  # exactly the budget, then typed resolution


# ---- cluster front against stub workers -------------------------------------


def _front(addresses, **kw):
    kw.setdefault("heartbeat_s", 5.0)  # quiet by default: tests own timing
    kw.setdefault("rpc_timeout_s", 10.0)
    kw.setdefault("platform", "cpu")
    return ClusterFront(addresses, **kw)


def test_front_typed_validation(stub_worker):
    _, server = stub_worker
    with pytest.raises(InvalidParameterError):
        ClusterFront([])
    front = _front([server.address], start=False)
    trip = np.zeros((4, 3), np.int32)
    with pytest.raises(InvalidParameterError, match="unknown direction"):
        front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(4), direction="sideways")
    with pytest.raises(InvalidParameterError, match="dims"):
        front.submit(TransformType.C2C, (4, 4), trip, np.zeros(4))
    with pytest.raises(InvalidParameterError, match="frequency values"):
        front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(3))
    with pytest.raises(InvalidParameterError, match="indices"):
        front.submit(TransformType.C2C, (4, 4, 4), np.zeros((4, 2), np.int32), np.zeros(4))
    front.close()


def test_front_roundtrip_and_describe(stub_worker):
    _, server = stub_worker
    front = _front([server.address], start=False)
    trip = np.zeros((4, 3), np.int32)
    vals = np.arange(4, dtype=np.float64)
    tk = front.submit(TransformType.C2C, (4, 4, 4), trip, vals)
    front.pump()
    np.testing.assert_array_equal(tk.result(timeout=10), vals * 2)
    d = front.describe()
    assert d["stats"]["counts"]["completed"] == 1
    assert d["hosts"][0]["lost"] is False
    assert d["plan_cards"][0]["degradations"] == []
    assert d["config"]["heartbeat_s"] == 5.0
    assert d["config"]["platform"] == "cpu"
    front.close()


def test_front_expired_deadline_refused_typed(stub_worker):
    _, server = stub_worker
    front = _front([server.address], start=False)
    trip = np.zeros((4, 3), np.int32)
    with pytest.raises(DeadlineExceededError):
        front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(4), timeout_s=1e-12)
    front.close()


@pytest.mark.parametrize("platform,error", [("cpu", HostExecutionError),
                                            ("gpu", sp.errors.GPUFFTError)])
def test_front_rpc_submit_chaos_resolves_typed(stub_worker, platform, error):
    """Every dispatch fails, retries exhaust, every ticket resolves with the
    front's platform's typed error."""
    _, server = stub_worker
    front = _front([server.address], start=False, retries=1, backoff_s=0.0,
                   platform=platform)
    trip = np.zeros((4, 3), np.int32)
    with faults.inject("rpc.submit=raise"):
        tickets = [front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(4))
                   for _ in range(4)]
        front.pump()
    for tk in tickets:
        with pytest.raises(error):
            tk.result(timeout=10)
        assert tk.outcome == "failed"
    assert _counter("faults_injected_total") > 0
    front.close()


def test_front_rpc_submit_fractional_chaos_heals(stub_worker):
    _, server = stub_worker
    front = _front([server.address], start=False, retries=4, backoff_s=0.0, batch_max=2)
    trip = np.zeros((4, 3), np.int32)
    vals = np.arange(4, dtype=np.float64)
    faults.reseed(7)
    with faults.inject("rpc.submit=raise:0.3"):
        tickets = [front.submit(TransformType.C2C, (4, 4, 4), trip, vals + i) for i in range(8)]
        front.pump()
    for i, tk in enumerate(tickets):
        np.testing.assert_array_equal(tk.result(timeout=10), (vals + i) * 2)
    front.close()


def test_front_heartbeat_chaos_declares_host_lost(stub_worker):
    _, server = stub_worker
    with faults.inject("host.heartbeat=raise"):
        front = _front([server.address], start=True, heartbeat_s=0.05, heartbeat_misses=2)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not front.hosts[0].lost:
            time.sleep(0.02)
        assert front.hosts[0].lost
        trip = np.zeros((4, 3), np.int32)
        tk = front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(4))
        with pytest.raises(HostLostError):
            tk.result(timeout=10)
        front.close()
    assert _counter("hosts_lost_total") == 1
    assert _counter("host_heartbeats_total") > 0
    assert front.describe()["degradations"][0]["event"] == "host_lost"


def test_front_member_failure_preserves_peers():
    service = _StubService(fail_submits={1})
    server = RpcServer(service, port=0, timeout_s=10.0)
    front = _front([server.address], start=False, retries=0, batch_max=8)
    trip = np.zeros((4, 3), np.int32)
    vals = np.arange(4, dtype=np.float64)
    try:
        tickets = [front.submit(TransformType.C2C, (4, 4, 4), trip, vals + i) for i in range(4)]
        front.pump()
        for i, tk in enumerate(tickets):
            if i == 1:
                with pytest.raises(ServiceOverloadError, match="refused"):
                    tk.result(timeout=10)
            else:
                np.testing.assert_array_equal(tk.result(timeout=10), (vals + i) * 2)
        assert service.submitted == 4  # each member executed once
    finally:
        front.close()
        server.close()


def test_remote_plan_short_reply_is_host_lost(stub_worker):
    _, server = stub_worker
    front = _front([server.address], start=False)
    entry = front._ensure_entry(TransformType.C2C, (4, 4, 4), np.zeros((4, 3), np.int32))
    plan = cluster.RemotePlan(front, entry, front.hosts[0])

    class _ShortPending:
        expected = 3
        _client = front.hosts[0].client

        def result(self):
            return {"results": [{"result": np.zeros(4)}]}  # 1 of 3

    with pytest.raises(HostLostError, match="malformed"):
        plan._finalize(_ShortPending())
    front.close()


def test_front_requeues_to_surviving_stub():
    s0, s1 = _StubService(), _StubService()
    server0 = RpcServer(s0, port=0, timeout_s=5.0)
    server1 = RpcServer(s1, port=0, timeout_s=5.0)
    front = _front([server0.address, server1.address], start=False, retries=0)
    trip = np.zeros((4, 3), np.int32)
    vals = np.arange(4, dtype=np.float64)
    try:
        server0.close()  # worker 0 dies outright
        tickets = [front.submit(TransformType.C2C, (4, 4, 4), trip, vals + i) for i in range(4)]
        front.pump()
        for i, tk in enumerate(tickets):
            np.testing.assert_array_equal(tk.result(timeout=10), (vals + i) * 2)
        assert front.hosts[0].lost and not front.hosts[1].lost
        assert s1.submitted > 0 and s0.submitted == 0
        cards = front.describe()["plan_cards"]
        assert any(d["event"] == "host_lost" and d.get("rehomed_to") == "host1"
                   for c in cards for d in c["degradations"])
        assert any(d["event"] == "host_lost" and "rehomed_to" not in d
                   for c in cards for d in c["degradations"])
        assert _counter("hosts_lost_total") == 1
    finally:
        front.close()
        server1.close()


# ---- the real thing: SIGKILLed worker process mid-burst ---------------------


def test_sigkill_worker_mid_flight_requeues_and_serves(tmp_path):
    """2 real worker processes (on the CPU), a burst in flight, worker 0
    SIGKILLed with the heartbeat too slow to notice: every ticket resolves,
    the accounting is exact, the survivor serves, and the float64 result
    matches the dense oracle to 1e-10."""
    workers = hostmesh.spawn_workers(2, workdir=str(tmp_path), device="cpu",
                                     ready_timeout_s=JOIN_SECONDS)
    front = None
    try:
        front = ClusterFront([w.address for w in workers], heartbeat_s=30.0, batch_max=2,
                             rpc_timeout_s=60.0, platform="cpu")
        trip = sp.create_spherical_cutoff_triplets(8, 8, 8, 0.8)
        rng = np.random.default_rng(0)
        vals = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
        warm = [front.submit(TransformType.C2C, (8, 8, 8), trip, vals * (1 + i))
                for i in range(4)]
        for tk in warm:
            tk.result(timeout=JOIN_SECONDS)
        tickets = [front.submit(TransformType.C2C, (8, 8, 8), trip, vals * (1 + i))
                   for i in range(10)]
        time.sleep(0.02)
        workers[0].kill()
        outcomes = {"completed": 0, "failed": 0}
        for tk in tickets:
            try:
                tk.result(timeout=JOIN_SECONDS)
                outcomes["completed"] += 1
            except GenericError:
                outcomes["failed"] += 1
        assert outcomes["completed"] + outcomes["failed"] == len(tickets)
        assert outcomes["completed"] > 0
        wave = [front.submit(TransformType.C2C, (8, 8, 8), trip, vals * (1 + i))
                for i in range(4)]
        for tk in wave:
            tk.result(timeout=JOIN_SECONDS)
        assert front.hosts[0].lost and not front.hosts[1].lost
        assert _counter("hosts_lost_total") == 1
        res = front.submit(TransformType.C2C, (8, 8, 8), trip, vals).result(timeout=JOIN_SECONDS)
        dense = np.zeros((8, 8, 8), complex)
        t = np.asarray(trip)
        dense[t[:, 2] % 8, t[:, 1] % 8, t[:, 0] % 8] = vals
        oracle = np.fft.ifftn(dense) * 512
        assert np.abs(np.asarray(res) - oracle).max() < 1e-10
    finally:
        if front is not None:
            front.close()
        hostmesh.stop_workers(workers)


# ---- fleet observability ------------------------------------------------------


def test_front_trace_propagation_joins_run(stub_worker):
    _, server = stub_worker
    trace.enable(capacity=4096)
    try:
        front = _front([server.address], start=False)
        trip = np.zeros((4, 3), np.int32)
        vals = np.arange(4, dtype=np.float64)
        tk = front.submit(TransformType.C2C, (4, 4, 4), trip, vals)
        front.pump()
        np.testing.assert_array_equal(tk.result(timeout=10), vals * 2)
        assert tk.run
        evs = [e for e in trace.snapshot()["events"] if e["run"] == tk.run]
        local = [e for e in evs if "host" not in e["args"]]
        spliced = [e for e in evs if "host" in e["args"]]
        assert any(e["name"] == "serve" and e["args"].get("what") == "admit" for e in local)
        assert spliced, evs
        assert all(e["args"]["host"] == "host0" for e in spliced)
        assert all("remote_ts" in e["args"] for e in spliced)
        assert _counter("remote_spans_spliced_total") == len(spliced)
        front.close()
    finally:
        trace.disable()


def test_front_ticket_timeline_and_phase_histograms(stub_worker):
    _, server = stub_worker
    front = _front([server.address], start=False)
    trip = np.zeros((4, 3), np.int32)
    tk = front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(4))
    front.pump()
    tk.result(timeout=10)
    tl = [p["phase"] for p in tk.timeline()]
    assert tl == [p for p in queue.PHASES if p in tl]
    for phase in ("admitted", "dispatched", "wire", "remote_execute", "finalized"):
        assert phase in tl, (phase, tl)
    ts = [p["t"] for p in tk.timeline()]
    assert ts == sorted(ts) and ts[0] >= 0.0
    ps = tk.phase_seconds()
    assert set(ps) <= set(queue.PHASES) and "admitted" not in ps
    hists = obs.snapshot()["histograms"]
    for phase in ("wire", "remote_execute", "finalized"):
        assert hists[f'serve_phase_seconds{{phase="{phase}"}}']["count"] >= 1, sorted(hists)
    front.close()


def test_front_chaos_closes_trace_typed_and_fleet_skips_lost(stub_worker):
    _, server = stub_worker
    trace.enable(capacity=4096)
    try:
        with faults.inject("host.heartbeat=raise,rpc.submit=raise"):
            front = _front([server.address], start=True, heartbeat_s=0.05,
                           heartbeat_misses=2, retries=0, backoff_s=0.0)
            trip = np.zeros((4, 3), np.int32)
            tk = front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(4))
            with pytest.raises(GenericError):
                tk.result(timeout=10)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not front.hosts[0].lost:
                time.sleep(0.02)
            assert front.hosts[0].lost
            tk2 = front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(4))
            with pytest.raises(HostLostError):
                tk2.result(timeout=10)
            evs = [e for e in trace.snapshot()["events"] if e["run"] == tk2.run]
            assert any(e["name"] == "error" and e["args"].get("what") == "host_lost"
                       for e in evs), evs
            t0 = time.monotonic()
            doc = front.fleet_metrics(timeout_s=0.5)
            assert time.monotonic() - t0 < 5.0
            entry = doc["hosts"]["host0"]
            assert entry["state"] == "lost" and "skipped_unix" in entry
            assert fleet.validate_fleet(doc) == []
            assert _counter("fleet_scrapes_total") == 1
            front.close()
        server.close()

        class _H:
            name, lost = "host9", False
            client = RpcClient(server.address, timeout_s=0.5)

        t0 = time.monotonic()
        doc = fleet.fleet_snapshot([_H], timeout_s=0.5)
        assert time.monotonic() - t0 < 5.0
        assert doc["hosts"]["host9"]["state"] == "unreachable"
        _H.client.close()
    finally:
        trace.disable()


def test_front_describe_joins_fleet_document(stub_worker):
    from spfft_tpu.obs import fleet as jfleet

    _, server = stub_worker
    front = _front([server.address], start=False)
    trip = np.zeros((4, 3), np.int32)
    tk = front.submit(TransformType.C2C, (4, 4, 4), trip, np.zeros(4))
    front.pump()
    tk.result(timeout=10)
    d = front.describe()
    assert fleet.validate_fleet(d["fleet"]) == [] == jfleet.validate_fleet(d["fleet"])
    assert d["fleet"]["hosts"]["host0"]["state"] == "live"
    assert any('host="host0"' in k for k in d["fleet"]["counters"]), sorted(d["fleet"]["counters"])
    front.close()
