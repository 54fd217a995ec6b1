"""Length-prefixed JSON RPC: the cross-host transport of the serving layer.

The port of ``spfft_tpu/serve/rpc.py``, byte for byte the JAX package's wire:
a JAX client and a port worker (or a port client and a JAX worker)
understand each other. The thin wire protocol that puts a
:class:`~spfft_tpu_torch.serve.service.TransformService` on the network:
stdlib ``socket`` only — no new dependencies — with every message a 4-byte
big-endian length prefix followed by a UTF-8 JSON object. Arrays cross the
wire as ``{"__nd__": {dtype, shape, b64}}`` envelopes (raw little-endian
bytes, base64), so the protocol stays pure JSON while payloads round-trip
bit-exactly.

Failure surface is typed on both sides, which is the whole point:

* an **application** failure on the worker (overload refusal, deadline
  miss, execution failure) crosses back as ``{"error": {code, type,
  message}}`` and the client re-raises the *same*
  :mod:`spfft_tpu_torch.errors` taxonomy member — a refused admission on a remote
  host looks exactly like a refused admission on a local service;
* a **transport** failure (connect refused, reset, timeout — what a
  SIGKILLed worker produces) raises
  :class:`~spfft_tpu_torch.errors.HostLostError` naming the host, which is the
  signal the cluster layer's requeue ladder and the scheduler's
  ``host_lost`` rung key on.

The ``rpc.submit`` fault site fires in the client's dispatch path
(:meth:`RpcClient.call` via the cluster layer), so chaos runs prove an RPC
machinery failure degrades through the typed ladder, never an untyped hang.
Server-side, every request counts ``rpc_requests_total{op,outcome}`` and
lands a ``rpc`` flight-recorder event.

**Cross-host trace propagation**: submit frames may carry the caller's trace
run ID (``run`` on ``submit``, a ``runs`` list aligned with ``payloads`` on
``submit_batch``).
The server enters ``trace.with_run(...)`` for the whole handling scope, so
everything the worker records — admission verdicts, dispatch spans,
degradations, guard verdicts — lands under the CALLER's key, and the reply
carries back a compact, schema-pinned remote-span segment
(``trace.SEGMENT_SCHEMA``, capped at :data:`SEGMENT_LIMIT` events) that the
cluster front splices into its own flight recorder tagged ``host=``. One
front-side ``trace.snapshot()`` then shows the whole cross-host request.

A result on the card crosses as numpy: the server moves it to the host with
``.cpu().numpy()`` (a pageable copy), where the JAX server calls
``np.asarray``. Failures are typed with the wrapped service's platform, so an
execution failure on the card crosses as ``GPUFFTError``.
"""
from __future__ import annotations

import base64
import json
import socket
import struct
import threading
import time

import numpy as np
import torch

from .. import knobs, obs
from ..errors import (
    GenericError,
    HostLostError,
    InvalidParameterError,
)
from ..types import ScalingType, TransformType
from .errors import as_typed

RPC_TIMEOUT_ENV = "SPFFT_TPU_RPC_TIMEOUT_S"

# One frame's length prefix: 4-byte big-endian unsigned. The size cap
# refuses absurd frames before allocating (a corrupted prefix must not
# become a 4 GB allocation).
_LEN = struct.Struct(">I")
MAX_FRAME_BYTES = 256 * 1024 * 1024

# Ops a worker's RpcServer answers. "submit"/"submit_batch" execute through
# the wrapped TransformService; "ping" is the heartbeat probe; "describe"/
# "stats" export the service surfaces; "metrics" returns the host's
# ``obs.snapshot()`` (the fleet-aggregation scrape, ``obs.fleet``);
# "shutdown" asks the worker process to exit cleanly (so its exit hooks
# run — a SIGKILL deliberately does not).
OPS = (
    "ping", "submit", "submit_batch", "describe", "stats", "metrics",
    "shutdown",
)

# Cap on the events one remote-span reply segment carries back per request
# (newest win): replies stay small next to their array payloads while a
# pathological event storm on the worker cannot bloat a frame to the cap.
SEGMENT_LIMIT = 256


def resolve_timeout_s(value=None) -> float:
    """The per-call RPC wall deadline (``SPFFT_TPU_RPC_TIMEOUT_S``)."""
    return knobs.get_float(RPC_TIMEOUT_ENV, value)


# ---- wire encoding ----------------------------------------------------------


def encode_array(a) -> dict:
    """numpy array -> JSON-plain ``__nd__`` envelope (C-order raw bytes)."""
    a = np.ascontiguousarray(a)
    return {
        "__nd__": {
            "dtype": a.dtype.str,
            "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        }
    }


def decode_value(obj):
    """Recursively decode ``__nd__`` envelopes inside a parsed message."""
    if isinstance(obj, dict):
        nd = obj.get("__nd__")
        if nd is not None and set(obj) == {"__nd__"}:
            a = np.frombuffer(
                base64.b64decode(nd["b64"]), dtype=np.dtype(nd["dtype"])
            )
            return a.reshape(nd["shape"]).copy()
        return {k: decode_value(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_value(v) for v in obj]
    return obj


def host_array(value) -> np.ndarray:
    """A result as a host numpy array: a tensor (on the card or the CPU)
    through ``.cpu().numpy()``, anything else through ``np.asarray``."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def encode_value(obj):
    """Recursively encode numpy arrays (and tensors, moved to the host) into
    ``__nd__`` envelopes."""
    if isinstance(obj, np.ndarray):
        return encode_array(obj)
    if torch.is_tensor(obj):
        return encode_array(host_array(obj))
    if isinstance(obj, dict):
        return {k: encode_value(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_value(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def error_payload(exc: GenericError) -> dict:
    """Typed error -> wire form (code + class name + first message line)."""
    return {
        "error": {
            "code": int(exc.error_code),
            "type": type(exc).__name__,
            "message": str(exc),
        }
    }


def _code_classes() -> dict:
    from .. import errors as _errors

    table = {}
    for name in dir(_errors):
        cls = getattr(_errors, name)
        if (
            isinstance(cls, type)
            and issubclass(cls, GenericError)
            and cls is not GenericError
        ):
            table[int(cls.error_code)] = cls
    return table


_CODE_CLASSES = _code_classes()


def raise_error_payload(err: dict):
    """Re-raise a wire-form error as its taxonomy member (the class with the
    matching C enum code; unknown codes fall back to ``GenericError``)."""
    cls = _CODE_CLASSES.get(int(err.get("code", -1)), GenericError)
    # cls is resolved from the taxonomy table above — every raise here IS a
    # GenericError subclass, just not spellable statically
    raise cls(str(err.get("message", "remote error")))  # noqa: SA010


# ---- framing ----------------------------------------------------------------


def send_msg(sock: socket.socket, msg: dict) -> None:
    """Send one length-prefixed JSON frame."""
    body = json.dumps(encode_value(msg)).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise InvalidParameterError(
            f"RPC frame of {len(body)} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap"
        )
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            # deliberate builtin contract: a short read is a TRANSPORT
            # failure, caught by the client (-> typed HostLostError naming
            # the host) and the server's per-connection loop (-> drop)
            raise ConnectionError("RPC peer closed the connection")  # noqa: SA010
        buf.extend(chunk)
    return bytes(buf)


def recv_msg(sock: socket.socket) -> dict:
    """Receive one length-prefixed JSON frame (arrays decoded)."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME_BYTES:
        raise InvalidParameterError(
            f"RPC frame of {n} bytes exceeds the {MAX_FRAME_BYTES}-byte cap"
        )
    return decode_value(json.loads(_recv_exact(sock, n).decode("utf-8")))


# ---- server -----------------------------------------------------------------


class RpcServer:
    """Serve one :class:`TransformService` over length-prefixed JSON.

    One daemon accept thread plus one daemon handler thread per live
    connection; every socket operation runs under the configured timeout, so
    no thread can block unboundedly (the SA017 discipline). ``close()`` is
    idempotent and joins the accept thread with a bounded wait. The optional
    ``on_shutdown`` callback runs when a peer sends the ``shutdown`` op —
    the worker entry point uses it to exit cleanly."""

    def __init__(
        self,
        service,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        timeout_s: float | None = None,
        on_shutdown=None,
    ):
        self.service = service
        self.timeout_s = resolve_timeout_s(timeout_s)
        self.on_shutdown = on_shutdown
        self._closing = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        # short accept timeout: the loop polls the closing flag (bounded
        # waits everywhere — a close() can never hang behind accept())
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()
        self._accept = threading.Thread(
            target=self._accept_loop, name="spfft-rpc-accept", daemon=True
        )
        self._accept.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed under us: close() owns shutdown
            conn.settimeout(self.timeout_s)
            threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                name="spfft-rpc-conn",
                daemon=True,
            ).start()

    def _serve_conn(self, conn) -> None:
        import select

        try:
            while not self._closing:
                # idle-wait OUTSIDE the frame reader: an IDLE connection is
                # not a dead one (the client pool keeps sockets across
                # bursts; dropping them would make the next pooled call
                # read as host death, ejecting a healthy host) — but a
                # timeout MID-frame below is a genuine stall and does drop
                # the connection (resuming mid-stream would desync framing)
                readable, _, _ = select.select([conn], [], [], 0.2)
                if not readable:
                    continue
                try:
                    msg = recv_msg(conn)
                except (OSError, ConnectionError, ValueError, GenericError):
                    # peer went away, garbage frame, mid-frame stall, or an
                    # over-cap length prefix (typed refusal): drop the conn
                    return
                reply = self._handle(msg)
                try:
                    send_msg(conn, reply)
                except GenericError as e:
                    # the REPLY breached the frame cap: answer with the
                    # typed error instead of dying — a silent connection
                    # drop reads as host loss and would requeue the same
                    # doomed oversized batch onto every host in turn
                    send_msg(conn, error_payload(e))
        except OSError:
            return  # reply write failed: peer is gone
        finally:
            conn.close()

    def _handle(self, msg: dict) -> dict:
        op = str(msg.get("op", ""))
        try:
            if op not in OPS:
                raise InvalidParameterError(
                    f"unknown RPC op {op!r}: expected one of {OPS}"
                )
            out = getattr(self, f"_op_{op}")(msg)
        except Exception as e:  # noqa: BLE001 — count + convert (typed wire
            # contract: EVERY failure crosses back as a taxonomy member, so
            # the remote caller's ladder sees exactly what a local one would)
            err = as_typed(e, self._platform())
            obs.counter("rpc_requests_total", op=op, outcome="error").inc()
            obs.trace.event("rpc", what="error", op=op, error=type(err).__name__)
            return error_payload(err)
        obs.counter("rpc_requests_total", op=op, outcome="ok").inc()
        obs.trace.event("rpc", what="serve", op=op)
        return out

    def _platform(self) -> str:
        """The wrapped service's platform (``"cpu"`` for a service that
        names none)."""
        platform = getattr(self.service, "_platform", None)
        return platform() if callable(platform) else "cpu"

    # ---- ops ----------------------------------------------------------------

    def _op_ping(self, msg: dict) -> dict:
        return {"ok": 1, "queue_depth": self.service.queue.depth()}

    def _op_stats(self, msg: dict) -> dict:
        return {"stats": self.service.stats()}

    def _op_describe(self, msg: dict) -> dict:
        return {"describe": self.service.describe()}

    def _op_shutdown(self, msg: dict) -> dict:
        if self.on_shutdown is not None:
            self.on_shutdown()
        return {"ok": 1}

    def _op_metrics(self, msg: dict) -> dict:
        """This host's metrics-registry snapshot — the fleet-aggregation
        scrape (``obs.fleet`` merges one of these per live host)."""
        return {"metrics": obs.snapshot()}

    def _submit_one(self, msg: dict):
        run = msg.get("run")
        return self.service.submit(
            TransformType(int(msg["transform_type"])),
            tuple(int(d) for d in msg["dims"]),
            np.asarray(msg["indices"], dtype=np.int32),
            msg["payload"],
            direction=str(msg.get("direction", "backward")),
            tenant=str(msg.get("tenant", "default")),
            timeout_s=msg.get("timeout_s"),
            scaling=ScalingType(int(msg.get("scaling", 0))),
            run_id=None if run is None else str(run),
        )

    def _reply_budget_s(self) -> float:
        """The wall budget for producing one reply: strictly inside the
        client's per-call socket timeout (minus a wire margin), so a slow
        worker answers with per-entry typed timeout errors instead of
        letting the CLIENT's recv expire — a recv timeout reads as host
        loss and would eject a live-but-backlogged host from the fleet."""
        return max(0.5, self.timeout_s - 2.0)

    def _op_submit(self, msg: dict) -> dict:
        run = msg.get("run")
        run = None if run is None else str(run)
        with obs.trace.with_run(run):
            with obs.trace.span("rpc", what="remote", op="submit"):
                ticket = self._submit_one(msg)
                result = host_array(
                    ticket.result(timeout=self._reply_budget_s())
                )
        reply = {"result": result}
        if run is not None:
            reply["spans"] = obs.trace.segment(run, limit=SEGMENT_LIMIT)
        return reply

    def _op_submit_batch(self, msg: dict) -> dict:
        """Admit every payload of one same-geometry chunk, then wait for all
        tickets: per-entry results so one member's typed failure never hides
        its peers' completions. The whole wait runs under ONE reply budget
        (:meth:`_reply_budget_s`), not a per-ticket one — N tickets must
        never stack N socket timeouts. A ``runs`` list aligned with
        ``payloads`` propagates each caller's trace run ID; the reply's
        ``spans`` list carries one remote-span segment per entry."""
        payloads = msg["payloads"]
        if not isinstance(payloads, list) or not payloads:
            raise InvalidParameterError(
                "submit_batch needs a non-empty 'payloads' list"
            )
        runs = msg.get("runs")
        if not isinstance(runs, list) or len(runs) != len(payloads):
            runs = [None] * len(payloads)
        runs = [None if r is None else str(r) for r in runs]
        tickets = []
        for payload, run in zip(payloads, runs):
            one = dict(msg)
            one["payload"] = payload
            one["run"] = run
            with obs.trace.with_run(run):
                with obs.trace.span("rpc", what="remote", op="submit_batch"):
                    try:
                        tickets.append(self._submit_one(one))
                    except GenericError as e:
                        tickets.append(e)
        deadline = time.monotonic() + self._reply_budget_s()
        results = []
        for t in tickets:
            if isinstance(t, GenericError):
                results.append(error_payload(t))
                continue
            try:
                remaining = max(0.05, deadline - time.monotonic())
                results.append(
                    {"result": host_array(t.result(timeout=remaining))}
                )
            except GenericError as e:
                results.append(error_payload(e))
            except TimeoutError as e:
                results.append(error_payload(as_typed(e, self._platform())))
        reply = {"results": results}
        if any(r is not None for r in runs):
            # segments are cut AFTER the waits, so dispatcher-side events
            # recorded under each caller's run during execution ride along
            reply["spans"] = [
                None if r is None else obs.trace.segment(r, limit=SEGMENT_LIMIT)
                for r in runs
            ]
        return reply

    # ---- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept.join(2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---- client -----------------------------------------------------------------


class RpcClient:
    """Pooled client for one worker host's :class:`RpcServer`.

    ``call`` checks a connection out of the idle pool (dialing a new one
    when empty), runs one request/response exchange under the configured
    timeout, and returns the connection to the pool. Any transport failure
    — connect refused, reset, short read, timeout — closes the connection
    and raises typed :class:`~spfft_tpu_torch.errors.HostLostError` naming the
    host: the cluster layer keys its requeue ladder on exactly that class.
    Application errors from the worker re-raise as their own taxonomy
    members and do NOT mark the transport dead."""

    def __init__(self, address: str, *, timeout_s: float | None = None):
        host, sep, port_s = str(address).rpartition(":")
        if not sep or not host:
            raise InvalidParameterError(
                f"malformed RPC address {address!r}: expected 'host:port'"
            )
        try:
            self.port = int(port_s)
        except ValueError:
            raise InvalidParameterError(
                f"malformed RPC address {address!r}: port {port_s!r} is not "
                "an integer"
            ) from None
        self.host = host
        self.address = f"{host}:{self.port}"
        self.timeout_s = resolve_timeout_s(timeout_s)
        self._idle: list = []
        self._lock = threading.Lock()
        self._closed = False

    def _checkout(self, timeout_s: float | None = None):
        with self._lock:
            if self._closed:
                raise HostLostError(
                    f"RPC client for {self.address} is closed"
                )
            if self._idle:
                return self._idle.pop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # the caller's deadline governs the DIAL too: a blackholed host
        # (dropped SYNs, no RST) must not hold a short-deadline probe —
        # the heartbeat's interval-bounded ping — for the default timeout
        sock.settimeout(self.timeout_s if timeout_s is None else float(timeout_s))
        sock.connect((self.host, self.port))
        return sock

    def _checkin(self, sock) -> None:
        with self._lock:
            if not self._closed:
                self._idle.append(sock)
                return
        sock.close()

    def call(self, msg: dict, *, timeout_s: float | None = None) -> dict:
        """One request/response exchange; returns the decoded reply body.

        Raises the reply's taxonomy member when the worker answered with a
        typed error, and :class:`HostLostError` when the transport itself
        failed."""
        try:
            sock = self._checkout(timeout_s)
        except (OSError, ConnectionError) as e:
            raise HostLostError(
                f"host {self.address} unreachable: {type(e).__name__}: {e}"
            ) from e
        try:
            if timeout_s is not None:
                sock.settimeout(float(timeout_s))
            send_msg(sock, msg)
            reply = recv_msg(sock)
        except (OSError, ConnectionError, ValueError) as e:
            sock.close()
            raise HostLostError(
                f"host {self.address} died mid-call "
                f"(op {msg.get('op')!r}): {type(e).__name__}: {e}"
            ) from e
        except BaseException:
            # non-transport failure (an over-cap request frame's typed
            # refusal, a serialization bug): the socket's state is unknown —
            # close it rather than leak it or pool it half-written
            sock.close()
            raise
        if timeout_s is not None:
            sock.settimeout(self.timeout_s)
        self._checkin(sock)
        err = reply.get("error") if isinstance(reply, dict) else None
        if err is not None:
            raise_error_payload(err)
        return reply

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            sock.close()
