"""Serving fleet: replica router with health-gated failover.

Counterpart of ``dist_svgd_tpu/serving/fleet.py`` with the same
``__all__``, copied (the port imports nothing of the JAX package).  N
independent :class:`~dist_svgd_torch.serving.server.PredictionServer`
replicas sit behind one :class:`FleetRouter` whose **unit of failure is a
whole process** and whose job is to keep serving anyway.

Deliberately **pure stdlib + telemetry** — no torch, no numpy.  The router
runs fine in a process that never touches the card; replicas carry the
models.

- :class:`ReplicaSet` — membership + health.  Each replica owns a
  circuit breaker (``closed``/``open``/``half_open``, all transitions on an
  injectable clock): **active** probes hit ``/healthz`` (and
  ``/healthz/<tenant>`` for the tenants it should carry) plus ``/slo``;
  **passive** scoring feeds per-request outcomes back in.  A replica is
  ejected (circuit opened) when probes fail ``fail_threshold`` times in a
  row, when consecutive forwards fail ``passive_fail_threshold`` times,
  when a probe reports ``"draining"`` (a deliberate signal — one strike),
  or when its own SLO engine reports **burning** (``/slo`` status
  ``breach``); after ``open_cooldown_s`` the circuit half-opens and ONE
  trial (probe or forward) decides: success re-admits, failure re-opens.
  A stale or absent ``/slo`` verdict reads **unknown, never healthy**
  (:func:`classify_slo`).
- :class:`FleetRouter` — the HTTP front door.  Tenants spread over
  replicas by **consistent hashing** (virtual nodes, the same ``sha1``
  ring points as JAX's) with **bounded-load overflow**: a replica already
  carrying more than ``load_factor×`` its fair share of in-flight requests
  overflows the request to the next ring candidate.  The forwarding path
  carries the full robustness kit:

  * **deadline propagation** — every attempt forwards the remaining
    budget downstream as ``X-Fleet-Deadline-S`` (replicas cap their own
    future-wait with it) and the router answers 504 the moment the budget
    is gone;
  * **idempotency-aware retries** — connect errors, timeouts and 5xx
    retry against the next ring candidate under the shared
    :class:`~dist_svgd_torch.resilience.backoff.Backoff` (jittered, capped,
    clamped to the deadline).  A **429 shed is never retried** — that's
    load, not failure; the router passes the replica's computed
    ``Retry-After`` through to the client and remembers the backpressure
    window so the next requests prefer other candidates;
  * **tail hedging** (opt-in) — after a p99-derived delay without a
    response, the same request is hedged to a second admitted replica and
    the first reply wins (the degraded-replica shape
    :class:`~dist_svgd_torch.resilience.faults.SlowReplicaAt` injects);
  * **graceful degradation** — when every candidate for a tenant is out,
    the router answers 503 immediately with a ``Retry-After`` derived
    from the soonest half-open eligibility plus a last-known-healthy
    hint, instead of hanging the client.

Transports are injectable: :class:`HttpTransport` (stdlib
``http.client``, with a router-side ``partition``/``heal`` deny-list so
real-subprocess drills can cut a link without touching the network) for
production, :class:`FakeTransport` + :class:`LoopbackReplica` for the CPU
tests — every failover path runs without real sockets, driven by the
process-level faults in ``resilience/faults.py`` (``ReplicaKillAt``,
``ReplicaHangAt``, ``SlowReplicaAt``, ``PartitionAt``).

Telemetry rides the shared registry: ``svgd_fleet_replica_state{replica}``
(0 closed / 1 half-open / 2 open), ``svgd_fleet_retries_total{reason}``,
``svgd_fleet_hedges_total``, ``svgd_fleet_failovers_total{tenant}``,
ejection/readmission counters, and one ``fleet.route ⊃ fleet.attempt ⊃
fleet.forward`` lane tree per routed request while tracing is enabled.
``dist_svgd_torch/tools/fleet_drill.py`` measures the whole story as the
``fleet_failover`` row.

Cross-process observability:

- **trace propagation** — every routed request carries a trace id
  (client-supplied ``X-Fleet-Trace`` or minted here) downstream on each
  attempt; the router's ``fleet.route``/``fleet.attempt`` lane trees and
  the replica's ``serve.request`` trees tag it, and every trace export
  carries a process-identity header + clock anchor, so
  ``python -m dist_svgd_torch.tools.trace_report --stitch`` joins the
  disjoint per-process exports into one tree per request (retries as
  sibling attempts, the network/queue gap as a synthetic span);
- **metrics federation** (:class:`MetricsFederation`) — the router's
  ``/metrics`` scrapes every replica's full-fidelity ``/metrics.dump``
  and merges clamped per-replica deltas into one fleet registry
  (replica-labelled series + exact rollups; a restarted replica's
  counter reset clamps to a zero delta, never a negative rate; scrape
  failures are themselves counted per replica);
- **fleet SLO + status plane** — the router's ``/slo`` evaluates
  ``default_serving_slos`` over the *federated* window (fleet-wide p99,
  not any one replica's), and ``/fleet`` serves the one-stop status
  document ``dist_svgd_torch/tools/fleet_status.py`` renders (breaker
  states, per-tenant fleet rps/p99 from merged histograms, fleet-wide cost
  columns from the federated ``svgd_usage_*`` series, SLO verdicts);
  ``/usage`` answers cost-per-tenant across the fleet
  (``telemetry/usage.py:usage_summary`` over the merged registry,
  per-replica breakdown included).

The front door and the replica server both listen with
:data:`LISTEN_BACKLOG` pending connections (1024), defined here: the
standard library's 5 resets connections under a burst of concurrent
clients.  Both keep HTTP/1.1 connections open between requests
(:class:`_KeepAliveHandler`: one write a reply, no body left unread, an
idle timeout, idle connections ended at shutdown), and
:class:`HttpTransport` pools them, so a forward pays no connect and the
replica no accept and no thread spawn.  JAX's transport opens one
connection a request; the route outcomes are the same.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import math
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as futures_wait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from dist_svgd_torch.resilience.backoff import Backoff
from dist_svgd_torch.serving import predict_body
from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry import trace as _trace
from dist_svgd_torch.telemetry import usage as _usage
from dist_svgd_torch.telemetry.slo import default_serving_slos

__all__ = [
    "TransportError",
    "ConnectError",
    "RequestTimeout",
    "Reply",
    "HttpTransport",
    "FakeTransport",
    "LoopbackReplica",
    "Shed",
    "classify_slo",
    "format_retry_after",
    "MetricsFederation",
    "ReplicaSet",
    "FleetRouter",
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
]

#: Circuit-breaker states (and the ``svgd_fleet_replica_state`` gauge
#: encoding: closed=0, half_open=1, open=2 — "bigger is sicker").
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

#: Downstream headers: the remaining per-request budget, the attempt
#: ordinal, and the per-request trace id — so replicas can bound their
#: own waits, logs can join retries to one logical request, and every
#: hop's spans stitch into one cross-process tree
#: (``dist_svgd_torch.tools.trace_report --stitch``).
DEADLINE_HEADER = "X-Fleet-Deadline-S"
ATTEMPT_HEADER = "X-Fleet-Attempt"
TRACE_HEADER = _trace.TRACE_HEADER  # one spelling, shared with server.py

#: Pending connections a listening socket holds (``listen`` backlog), for
#: the front door here and the replica server alike.
LISTEN_BACKLOG = 1024

#: Seconds a server holds a persistent connection with no next request
#: before its handler thread ends (the front door and the replica server
#: alike): longer than a router's 0.25 s probe cadence, so a probed
#: connection stays warm.
IDLE_TIMEOUT_S = 5.0

#: Idle persistent connections :class:`HttpTransport` keeps for each
#: replica; one given back beyond that is closed.  It bounds what is kept,
#: not how many requests run at once.
POOL_IDLE_MAX = 16

#: A request body a handler left unread is read and dropped before the
#: reply up to this many bytes; a longer (or unsized) one closes the
#: connection instead, so the next request on it is never parsed from it.
_DISCARD_MAX = 1 << 20


class _HTTPServer(ThreadingHTTPServer):
    """The front door's and the replica server's listener: a
    :data:`LISTEN_BACKLOG` backlog, and a register of the persistent
    connections waiting for their next request, so :meth:`close_idle` can
    end them at shutdown (``server_close`` joins every handler thread)."""

    request_queue_size = LISTEN_BACKLOG

    def __init__(self, *args, **kw):
        self._conn_lock = threading.Lock()
        self._idle: Dict[Any, Any] = {}  # handler -> its socket, idle only
        self.closing = False
        super().__init__(*args, **kw)

    def idle_begin(self, handler) -> bool:
        """Register ``handler``'s connection as waiting; False once
        :meth:`close_idle` ran (the handler then ends its connection)."""
        with self._conn_lock:
            if self.closing:
                return False
            self._idle[handler] = handler.connection
            return True

    def idle_end(self, handler) -> None:
        with self._conn_lock:
            self._idle.pop(handler, None)

    def close_idle(self) -> None:
        """End every connection waiting for its next request, now and from
        now on (after ``shutdown()``: no new connection arrives)."""
        import socket

        with self._conn_lock:
            self.closing = True
            socks = list(self._idle.values())
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already gone


class _KeepAliveHandler(BaseHTTPRequestHandler):
    """HTTP/1.1 persistent connections for the front door and the replica
    server: ``TCP_NODELAY`` on the accepted socket, an idle timeout of
    :data:`IDLE_TIMEOUT_S`, every reply written with one ``sendall``
    (:meth:`send_reply`), no request body left unread on a connection that
    stays open, and a connection between requests registered with its
    :class:`_HTTPServer`, so shutdown ends it."""

    protocol_version = "HTTP/1.1"
    timeout = IDLE_TIMEOUT_S
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # stderr chatter off
        pass

    def handle_one_request(self):
        if not self.server.idle_begin(self):
            self.close_connection = True
            return
        try:
            super().handle_one_request()
        finally:
            self.server.idle_end(self)

    def parse_request(self):
        # a request line arrived: busy until its reply is written
        self.server.idle_end(self)
        self._body_read = False
        return super().parse_request()

    def read_body(self) -> bytes:
        self._body_read = True
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def _settle_body(self) -> None:
        """Read and drop a body no route read, or end the connection."""
        if self._body_read:
            return
        self._body_read = True
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if self.headers.get("Transfer-Encoding") or not 0 <= length <= _DISCARD_MAX:
            self.close_connection = True
        elif length:
            self.rfile.read(length)

    def closing(self) -> bool:
        """Whether replies end their connection (the server is shutting
        down; the replica server adds its drain)."""
        return self.server.closing

    def send_reply(self, code: int, headers: Dict[str, str],
                   body: bytes) -> None:
        """Status line, headers and body in one write; ``Connection:
        close`` (and the connection closed after) when the request asked
        for it, its body could not be settled, or :meth:`closing`."""
        self._settle_body()
        if self.closing():
            self.close_connection = True
        self.log_request(code)
        lines = [f"{self.protocol_version} {code} "
                 f"{self.responses.get(code, ('',))[0]}",
                 f"Server: {self.version_string()}",
                 f"Date: {self.date_time_string()}"]
        lines += [f"{k}: {v}" for k, v in headers.items()]
        lines.append(f"Content-Length: {len(body)}")
        if self.close_connection:
            lines.append("Connection: close")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1", "strict")
        self.wfile.write(head + body)


class TransportError(RuntimeError):
    """Transport-level failure (the retryable kind — the request may never
    have reached the replica, and predict is idempotent by construction)."""


class ConnectError(TransportError):
    """Connection refused / replica unreachable (dead process, partition)."""


class RequestTimeout(TransportError):
    """No response within the per-try budget (hung process, slow network)."""


class Reply:
    """One transport response: ``status``, lower-cased ``headers``, raw
    ``body`` bytes (the router is payload-agnostic passthrough)."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: Optional[Dict[str, str]] = None,
                 body: bytes = b""):
        self.status = int(status)
        self.headers = {k.lower(): str(v)
                        for k, v in (headers or {}).items()}
        self.body = body if isinstance(body, bytes) else str(body).encode()

    def json(self) -> Any:
        try:
            return json.loads(self.body or b"null")
        except (ValueError, UnicodeDecodeError):
            return None

    def retry_after_s(self) -> Optional[float]:
        """The ``Retry-After`` header as seconds (delta-seconds form only —
        the only form this codebase emits), None when absent/garbled."""
        raw = self.headers.get("retry-after")
        if raw is None:
            return None
        try:
            return max(float(raw), 0.0)
        except ValueError:
            return None

    def __repr__(self):
        return f"Reply(status={self.status}, bytes={len(self.body)})"


# --------------------------------------------------------------------- #
# transports


class _StaleConnection(Exception):
    """A reused connection failed before any byte of a response arrived
    (the replica closed it while it sat idle)."""


def _close_all(conns) -> None:
    for conn in conns:
        conn.close()


class HttpTransport:
    """Real-socket transport over stdlib ``http.client``, on persistent
    connections.

    ``addresses`` maps replica id → ``(host, port)``; :meth:`set_address`
    re-points a replica after a restart on a new port.  The
    :meth:`partition`/:meth:`heal` deny-list simulates a network partition
    from the router's side — the replica process stays untouched, exactly
    the :class:`~dist_svgd_torch.resilience.faults.PartitionAt` semantics,
    usable against real subprocesses (``dist_svgd_torch/tools/fleet_drill.py``).

    Each replica has a pool of idle keep-alive connections.  A request
    takes one (or opens one) for itself alone and gives it back once the
    whole response body is read; at most :data:`POOL_IDLE_MAX` stay idle a
    replica.  A timeout, an error or a ``Connection: close`` reply closes
    the connection instead.  A reused connection that fails before any
    byte of a response arrived is retried once on a fresh one, so only a
    fresh connection's failure raises :class:`ConnectError` and one call
    still yields one outcome.  :meth:`partition`, :meth:`set_address` and
    :meth:`close` close the idle connections they concern.
    ``connections_opened`` counts the connections made and ``requests``
    the responses read over them."""

    def __init__(self, addresses: Dict[str, Tuple[str, int]]):
        self._lock = threading.Lock()
        self._addresses = {str(k): (str(h), int(p))
                           for k, (h, p) in addresses.items()}
        self._partitioned: set = set()
        self._idle: Dict[str, List[Any]] = {}
        self.connections_opened = 0
        self.requests = 0

    def set_address(self, replica: str, host: str, port: int) -> None:
        with self._lock:
            self._addresses[replica] = (host, int(port))
            stale = self._idle.pop(replica, [])
        _close_all(stale)

    def partition(self, replica: str) -> None:
        with self._lock:
            self._partitioned.add(replica)
            stale = self._idle.pop(replica, [])
        _close_all(stale)

    def heal(self, replica: str) -> None:
        with self._lock:
            self._partitioned.discard(replica)

    def close(self) -> None:
        """Close every idle connection (a later request opens anew)."""
        with self._lock:
            stale = [c for conns in self._idle.values() for c in conns]
            self._idle.clear()
        _close_all(stale)

    def idle_connections(self) -> Dict[str, int]:
        """Idle pooled connections by replica (replicas with none left out)."""
        with self._lock:
            return {rid: len(conns) for rid, conns in self._idle.items() if conns}

    def request(self, replica: str, method: str, path: str,
                body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None,
                timeout_s: float = 5.0) -> Reply:
        import http.client

        with self._lock:
            if replica in self._partitioned:
                raise ConnectError(
                    f"replica {replica!r} unreachable (partitioned)")
            try:
                address = self._addresses[replica]
            except KeyError:
                raise ConnectError(f"unknown replica {replica!r}") from None
            idle = self._idle.get(replica)
            conn = idle.pop() if idle else None
        args = (replica, address, method, path, body, headers or {},
                timeout_s)
        if conn is not None:
            try:
                return self._exchange(conn, True, *args)
            except _StaleConnection:
                pass
        return self._exchange(
            http.client.HTTPConnection(*address, timeout=timeout_s), False,
            *args)

    def _exchange(self, conn, reused, replica, address, method, path, body,
                  headers, timeout_s) -> Reply:
        """One request and its whole response on ``conn``, which goes back
        to the pool after it or is closed."""
        import socket

        try:
            if reused:
                conn.sock.settimeout(timeout_s)
            else:
                conn.connect()
                with self._lock:
                    self.connections_opened += 1
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
            except (BrokenPipeError, ConnectionResetError,
                    ConnectionAbortedError) as e:
                # RemoteDisconnected (no status line) is a reset as well
                if reused:
                    raise _StaleConnection() from e
                raise
            data = resp.read()
        except socket.timeout as e:
            conn.close()
            raise RequestTimeout(
                f"replica {replica!r} timed out after {timeout_s}s") from e
        except (ConnectionError, OSError) as e:
            conn.close()
            raise ConnectError(f"replica {replica!r}: {e}") from e
        except BaseException:  # _StaleConnection among them
            conn.close()
            raise
        with self._lock:
            self.requests += 1
        reply = Reply(resp.status, dict(resp.getheaders()), data)
        if conn.sock is None:  # the reply closed it (Connection: close)
            return reply
        with self._lock:
            idle = self._idle.setdefault(replica, [])
            keep = (self._addresses.get(replica) == address
                    and replica not in self._partitioned
                    and len(idle) < POOL_IDLE_MAX)
            if keep:
                idle.append(conn)
        if not keep:
            conn.close()
        return reply


class Shed(RuntimeError):
    """Raised by a :class:`LoopbackReplica` predict fn to model the
    micro-batcher's Overloaded shed: surfaces as a 429 with the computed
    ``Retry-After`` — load, not failure."""

    def __init__(self, msg: str = "overloaded", retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class LoopbackReplica:
    """In-process stand-in for one ``PredictionServer`` replica: the same
    route surface (``POST /predict``, ``GET /healthz``,
    ``GET /healthz/<tenant>``, ``GET /slo``, ``GET /metrics``,
    ``GET /metrics.dump``) with no model, no sockets and no threads —
    the CPU failover tests drive it through :class:`FakeTransport`.

    ``predict_fn(inputs, tenant, headers)`` returns the outputs dict (or
    raises :class:`Shed` to model a 429).  ``slo_status`` and ``draining``
    are plain mutable attributes for tests/drills.  ``flight_trips``
    counts internal crashes (a handler exception → 500) — the partition
    acceptance test asserts it stays 0 while the router ejects the
    replica, pinning *partition ≠ crash*.

    Observability: each loopback owns its OWN metrics registry
    (default: a fresh one — it stands in for a separate process) and
    writes the real server's series names (``svgd_serve_requests_total``,
    ``svgd_serve_request_latency_seconds``, ``svgd_serve_shed_total``,
    ``svgd_http_requests_total``), so the router's federation merges fake
    and real replicas identically.  Pass ``tracer=`` (a per-replica
    :class:`~dist_svgd_torch.telemetry.trace.Tracer`, again standing in for
    the other process's tracer) and every served predict emits a
    ``serve.request`` lane tree tagged with the incoming
    ``X-Fleet-Trace`` id — the replica half of a stitch."""

    def __init__(self, name: str,
                 predict_fn: Optional[Callable] = None,
                 tenants: Sequence[str] = (),
                 clock: Callable[[], float] = time.time,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 tracer: Optional[_trace.Tracer] = None):
        self.name = name
        self.tenants = list(tenants)
        self.slo_status = "ok"
        self.draining = False
        self.flight_trips = 0
        self.requests = 0
        self.last_headers: Dict[str, str] = {}
        self._clock = clock
        self._predict = predict_fn or (
            lambda inputs, tenant, headers: {
                "mean": [0.0] * len(inputs)})
        self.registry = (registry if registry is not None
                         else _metrics.MetricsRegistry())
        self.tracer = tracer
        if tracer is not None:
            tracer.set_process("replica", name, only_if_default=True)
        self._m_requests = self.registry.counter(
            "svgd_serve_requests_total", "requests fully resolved")
        self._m_latency = self.registry.histogram(
            "svgd_serve_request_latency_seconds",
            "request end-to-end latency (enqueue to resolve)")
        self._m_shed = self.registry.counter(
            "svgd_serve_shed_total",
            "requests shed with Overloaded (bounded queue full)")
        self._m_http = self.registry.counter(
            "svgd_http_requests_total", "HTTP requests by route and status")

    def handle(self, method: str, path: str, body: Optional[bytes],
               headers: Optional[Dict[str, str]]) -> Reply:
        try:
            return self._handle(method, path, body, headers or {})
        except Shed as e:
            self._m_shed.inc()
            self._m_http.inc(route="/predict", status=429)
            return _json_reply(429, {"error": str(e),
                                     "retry_after_s": e.retry_after_s},
                               {"Retry-After": format_retry_after(
                                   e.retry_after_s)})
        except Exception as e:  # a crashed handler — the flight-recorder
            self.flight_trips += 1  # shape a partition must NOT produce
            return _json_reply(500, {"error": f"{type(e).__name__}: {e}"})

    def _handle(self, method, path, body, headers) -> Reply:
        path = path.split("?", 1)[0]
        if method == "POST" and path == "/predict":
            self.requests += 1
            # per-request headers stay LOCAL through the handler: the
            # loopback serves concurrent requests on many router threads,
            # and reading the instance attribute after the predict would
            # tag this request with whichever trace id arrived last
            hdrs = {k.lower(): v for k, v in headers.items()}
            self.last_headers = hdrs  # test introspection only
            if self.draining:
                return _json_reply(503, {"error": "draining"})
            doc = json.loads(body or b"null")
            inputs = doc.get("inputs") if isinstance(doc, dict) else None
            if inputs is None:
                return _json_reply(400, {"error": "body needs inputs"})
            tenant = doc.get("tenant") if isinstance(doc, dict) else None
            tr = self.tracer
            t0 = tr.now() if tr is not None else 0.0
            wall0 = time.perf_counter()
            out = self._predict(inputs, tenant, hdrs)
            wall = time.perf_counter() - wall0
            tl = {} if tenant is None else {"tenant": tenant}
            self._m_requests.inc(**tl)
            self._m_latency.observe(wall, **tl)
            self._m_http.inc(route="/predict", status=200, **tl)
            if tr is not None:
                t1 = tr.now()
                attrs = {"rows": len(inputs), "replica": self.name, **tl}
                trace_id = hdrs.get(TRACE_HEADER.lower())
                if trace_id:
                    attrs["trace"] = trace_id
                attempt = hdrs.get(ATTEMPT_HEADER.lower())
                if attempt is not None:
                    attrs["attempt"] = attempt
                tr.lane_tree(
                    "serve.request", t0, t1, attrs,
                    children=[("serve.dispatch", t0, t1,
                               {"rows": len(inputs)})])
            payload = {"outputs": out, "replica": self.name}
            if tenant is not None:
                payload["tenant"] = tenant
            return _json_reply(200, payload)
        if method == "GET" and path == "/metrics":
            return Reply(200, {"Content-Type":
                               "text/plain; version=0.0.4; charset=utf-8"},
                         self.registry.exposition().encode())
        if method == "GET" and path == "/metrics.dump":
            return _json_reply(200, self.registry.dump())
        if method == "GET" and path == "/healthz":
            if self.draining:
                return _json_reply(503, {"status": "draining"})
            return _json_reply(200, {"status": "ok", "replica": self.name})
        if method == "GET" and path.startswith("/healthz/"):
            tenant = path[len("/healthz/"):]
            if self.draining:
                return _json_reply(503, {"status": "draining"})
            if self.tenants and tenant not in self.tenants:
                return _json_reply(404, {"error": f"no tenant {tenant!r}"})
            return _json_reply(200, {"status": "ok", "tenant": tenant})
        if method == "GET" and path == "/slo":
            return _json_reply(200, {"status": self.slo_status,
                                     "ts": self._clock()})
        return _json_reply(404, {"error": f"no route {path}"})


def _json_reply(status: int, payload: dict,
                headers: Optional[Dict[str, str]] = None) -> Reply:
    return Reply(status, {"Content-Type": "application/json",
                          **(headers or {})},
                 json.dumps(payload).encode())


def format_retry_after(seconds: float) -> str:
    """HTTP ``Retry-After`` delta-seconds (integer per RFC 9110, rounded
    up and floored at 1 so the client never comes back early).  The ONE
    formatter — the replica server and the router must emit the same
    header for the same hint."""
    return str(max(int(math.ceil(seconds)), 1))


class FakeTransport:
    """Injectable in-process transport: replica id → handler (anything
    with ``handle(method, path, body, headers) -> Reply``, i.e. a
    :class:`LoopbackReplica`).

    Process-level faults come in two flavors:

    - **scheduled** — ``faults=[ReplicaKillAt(at=40, replica="r1"), ...]``
      keyed by the transport's request ordinal (every :meth:`request`
      increments it, probes included), for deterministic test schedules;
    - **runtime** — :meth:`kill` / :meth:`hang` / :meth:`partition` /
      :meth:`slow` / :meth:`restore`, for drills that flip state on wall
      clock.

    ``advance(seconds)`` models elapsed time (``time.sleep`` by default;
    tests pass the fake clock's advance) — a hang charges the full per-try
    timeout, a slow replica charges its delay, so drills measure fault
    cost instead of waiting for it."""

    def __init__(self, replicas: Dict[str, Any], faults: Sequence = (),
                 advance: Callable[[float], None] = time.sleep):
        self._replicas = dict(replicas)
        self._faults = list(faults)
        self._advance = advance
        self._lock = threading.Lock()
        self._ordinal = 0
        self._forced: Dict[str, str] = {}  # replica -> kind
        self._forced_slow: Dict[str, float] = {}

    # runtime fault switches (drills) ---------------------------------- #

    def kill(self, replica: str) -> None:
        with self._lock:
            self._forced[replica] = "kill"

    def hang(self, replica: str) -> None:
        with self._lock:
            self._forced[replica] = "hang"

    def partition(self, replica: str) -> None:
        with self._lock:
            self._forced[replica] = "partition"

    def slow(self, replica: str, seconds: float) -> None:
        with self._lock:
            self._forced_slow[replica] = float(seconds)

    def restore(self, replica: str) -> None:
        """Lift every runtime fault on ``replica`` (process restarted /
        partition healed / slowdown over)."""
        with self._lock:
            self._forced.pop(replica, None)
            self._forced_slow.pop(replica, None)

    def set_replica(self, replica: str, handler: Any) -> None:
        """Swap the handler behind ``replica`` — a drill models a process
        *restart* by installing a FRESH :class:`LoopbackReplica` (new
        registry, counters back at zero, new tracer), which is exactly
        what exercises the federation's counter-reset clamping."""
        with self._lock:
            self._replicas[replica] = handler

    @property
    def ordinal(self) -> int:
        with self._lock:
            return self._ordinal

    # transport -------------------------------------------------------- #

    def _state_for(self, replica: str) -> Tuple[Optional[str], float]:
        """(fault kind or None, slow seconds) for this request — advances
        the ordinal."""
        with self._lock:
            self._ordinal += 1
            n = self._ordinal
            kind = self._forced.get(replica)
            slow = self._forced_slow.get(replica, 0.0)
            for f in self._faults:
                if f.replica == replica and f.active(n):
                    if f.kind == "slow":
                        slow = max(slow, f.seconds)
                    elif kind is None:
                        kind = f.kind
            return kind, slow

    def request(self, replica: str, method: str, path: str,
                body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None,
                timeout_s: float = 5.0) -> Reply:
        handler = self._replicas.get(replica)
        if handler is None:
            raise ConnectError(f"unknown replica {replica!r}")
        kind, slow = self._state_for(replica)
        if kind == "kill":
            raise ConnectError(
                f"replica {replica!r} connection refused (process dead)")
        if kind == "partition":
            # the replica object is NOT touched: it stays alive and
            # reachable by anyone on the healthy side of the cut
            raise ConnectError(
                f"replica {replica!r} unreachable (partitioned)")
        if kind == "hang":
            self._advance(timeout_s)
            raise RequestTimeout(
                f"replica {replica!r} hung past {timeout_s}s")
        if slow:
            self._advance(slow)
        return handler.handle(method, path, body, headers)


# --------------------------------------------------------------------- #
# health classification


def classify_slo(doc: Any, now_s: Optional[float] = None,
                 max_age_s: Optional[float] = None) -> str:
    """Map a replica's ``/slo`` document to a routing verdict:
    ``"burning"`` (status ``breach`` — eject), ``"healthy"`` (status
    ``ok``), else ``"unknown"``.

    Unknown is sticky-conservative: a missing/garbled document, a
    ``no_data`` engine, or a verdict older than ``max_age_s`` (judged by
    the document's own ``ts`` stamp) must read **unknown, never
    healthy** — stale good news is no news.  Unknown neither ejects nor
    re-admits; only a fresh verdict moves the circuit."""
    if not isinstance(doc, dict):
        return "unknown"
    status = doc.get("status")
    if (max_age_s is not None and now_s is not None):
        ts = doc.get("ts")
        if not isinstance(ts, (int, float)) or now_s - ts > max_age_s:
            return "unknown"
    if status == "breach":
        return "burning"
    if status == "ok":
        return "healthy"
    return "unknown"


# --------------------------------------------------------------------- #
# membership / circuit breaker


class _ReplicaState:
    __slots__ = ("state", "probe_failures", "request_failures", "opened_at",
                 "last_healthy", "inflight", "ejections", "reason",
                 "backpressure_until", "generation")

    def __init__(self):
        self.state = CLOSED
        self.probe_failures = 0
        self.request_failures = 0
        self.opened_at = 0.0
        self.last_healthy: Optional[float] = None
        self.inflight = 0
        self.ejections = 0
        self.reason = ""
        self.backpressure_until = 0.0
        # serving generation the last healthy probe reported:
        # a mid-rollout fleet shows which replicas flipped generations
        self.generation: Optional[int] = None


class ReplicaSet:
    """Fleet membership with per-replica circuit breakers.

    Active probing (:meth:`probe_once`, or the background thread
    :meth:`start`/:meth:`close` drive with ``probe_interval_s``) and
    passive per-request scoring (:meth:`record_success` /
    :meth:`record_failure` / :meth:`record_shed`) feed one state machine
    per replica — see the module docstring for the transition rules.  All
    clocks are injectable; probes do network I/O outside the lock.
    """

    def __init__(self, replicas: Sequence[str], transport, *,
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 1.0,
                 fail_threshold: int = 2,
                 passive_fail_threshold: int = 3,
                 open_cooldown_s: float = 2.0,
                 probe_tenants: Sequence[str] = (),
                 health_path: str = "/healthz",
                 slo_path: str = "/slo",
                 slo_max_age_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[_metrics.MetricsRegistry] = None):
        if fail_threshold < 1 or passive_fail_threshold < 1:
            raise ValueError("thresholds must be >= 1")
        if not replicas:
            raise ValueError("need at least one replica")
        self.transport = transport
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.fail_threshold = int(fail_threshold)
        self.passive_fail_threshold = int(passive_fail_threshold)
        self.open_cooldown_s = float(open_cooldown_s)
        self.probe_tenants = list(probe_tenants)
        self.health_path = health_path
        self.slo_path = slo_path
        self.slo_max_age_s = slo_max_age_s
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: Dict[str, _ReplicaState] = {
            str(r): _ReplicaState() for r in replicas}
        #: bounded log of ``(ts, replica, from_state, to_state, reason)``
        #: transitions — drills read detection/readmit latency off it
        self.state_changes: deque = deque(maxlen=1024)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        reg = registry if registry is not None else _metrics.default_registry()
        self.registry = reg
        self._m_state = reg.gauge(
            "svgd_fleet_replica_state",
            "replica circuit state: 0 closed, 1 half-open, 2 open")
        self._m_ejections = reg.counter(
            "svgd_fleet_ejections_total",
            "circuit-open transitions by reason")
        self._m_readmissions = reg.counter(
            "svgd_fleet_readmissions_total",
            "half-open trials that re-admitted a replica")
        # judged INSIDE begin_request's lock so an admit-then-eject race
        # can never count: only an admission granted while the circuit was
        # already open is a misroute (a selection bug), and that decision
        # and the state read happen under one lock acquisition
        self._m_misroutes = reg.counter(
            "svgd_fleet_misroutes_total",
            "admissions granted to a replica whose circuit was open "
            "(must stay 0)")
        for rid in self._replicas:
            self._m_state.set(0, replica=rid)

    # ---- state machine core (all under the lock) --------------------- #

    def _transition_locked(self, rid: str, to_state: str,
                           reason: str) -> None:
        st = self._replicas[rid]
        if st.state == to_state:
            return
        now = self._clock()
        self.state_changes.append((now, rid, st.state, to_state, reason))
        if to_state == OPEN:
            st.opened_at = now
            st.ejections += 1
            self._m_ejections.inc(reason=reason)
        if to_state == CLOSED and st.state == HALF_OPEN:
            self._m_readmissions.inc()
        st.state = to_state
        st.reason = reason
        if to_state == CLOSED:
            st.probe_failures = 0
            st.request_failures = 0
        self._m_state.set(_STATE_GAUGE[to_state], replica=rid)

    def _maybe_half_open_locked(self, rid: str) -> None:
        st = self._replicas[rid]
        if (st.state == OPEN
                and self._clock() - st.opened_at >= self.open_cooldown_s):
            self._transition_locked(rid, HALF_OPEN, "cooldown_elapsed")

    # ---- passive scoring (router-reported outcomes) ------------------ #

    def begin_request(self, rid: str,
                      load_factor: Optional[float] = None) -> bool:
        """Admission check + in-flight accounting for one forward attempt.
        False when the circuit is open, a half-open trial is already in
        flight, or (with ``load_factor``) the replica is past its bounded
        fair share of the fleet's in-flight load.  A True return MUST be
        paired with exactly one ``record_*`` call."""
        with self._lock:
            st = self._replicas.get(rid)
            if st is None:
                return False
            self._maybe_half_open_locked(rid)
            if st.state == OPEN:
                return False
            if st.state == HALF_OPEN and st.inflight > 0:
                return False  # one trial at a time — that's the point
            if load_factor is not None and st.state == CLOSED:
                admitted = [s for s in self._replicas.values()
                            if s.state != OPEN]
                total = sum(s.inflight for s in admitted)
                cap = max(1.0, math.ceil(
                    load_factor * (total + 1) / max(len(admitted), 1)))
                if st.inflight + 1 > cap:
                    return False  # bounded-load overflow to the next node
            if st.state == OPEN:  # pragma: no cover
                # assert-style invariant detector: unreachable while the
                # OPEN gate above stands, but if a future selection change
                # ever admits an ejected replica, this counts it at the
                # admission decision itself — under THIS lock acquisition,
                # so an admit-then-eject race can never false-positive the
                # fleet drill's zero-misroute gate
                self._m_misroutes.inc()
            st.inflight += 1
            return True

    def record_success(self, rid: str) -> None:
        with self._lock:
            st = self._replicas[rid]
            st.inflight = max(0, st.inflight - 1)
            st.probe_failures = 0
            st.request_failures = 0
            st.last_healthy = self._clock()
            if st.state == HALF_OPEN:
                self._transition_locked(rid, CLOSED, "trial_request_ok")

    def record_failure(self, rid: str, reason: str = "request") -> None:
        with self._lock:
            st = self._replicas[rid]
            st.inflight = max(0, st.inflight - 1)
            st.request_failures += 1
            if st.state == HALF_OPEN:
                self._transition_locked(rid, OPEN, f"trial_failed:{reason}")
            elif (st.state == CLOSED
                  and st.request_failures >= self.passive_fail_threshold):
                self._transition_locked(rid, OPEN, f"request_failures:{reason}")

    def record_shed(self, rid: str,
                    retry_after_s: Optional[float] = None) -> None:
        """A 429: the replica is alive and telling us it's loaded — release
        the in-flight slot, remember the backpressure window, do NOT touch
        the failure counters (sheds are load, not failure)."""
        with self._lock:
            st = self._replicas[rid]
            st.inflight = max(0, st.inflight - 1)
            st.last_healthy = self._clock()
            if retry_after_s:
                st.backpressure_until = self._clock() + retry_after_s
            if st.state == HALF_OPEN:
                # an overloaded replica is a live replica
                self._transition_locked(rid, CLOSED, "trial_shed_alive")

    # ---- active probing ---------------------------------------------- #

    def _probe_replica(self, rid: str) -> Tuple[bool, bool, str,
                                                Optional[int]]:
        """(health ok, draining, slo verdict, serving generation) —
        network I/O, NO lock.  The generation comes off the root
        ``/healthz`` doc (single-tenant replicas report it directly;
        multi-tenant docs carry it per tenant instead and report None
        here)."""
        draining = False
        generation: Optional[int] = None
        try:
            paths = [self.health_path] + [
                f"{self.health_path}/{t}" for t in self.probe_tenants]
            for path in paths:
                reply = self.transport.request(
                    rid, "GET", path, timeout_s=self.probe_timeout_s)
                doc = reply.json()
                if isinstance(doc, dict) and doc.get("status") == "draining":
                    return False, True, "unknown", None
                if reply.status != 200:
                    return False, False, "unknown", None
                if (isinstance(doc, dict) and path == self.health_path
                        and doc.get("generation_id") is not None):
                    generation = int(doc["generation_id"])
        except TransportError:
            return False, False, "unknown", None
        try:
            reply = self.transport.request(
                rid, "GET", self.slo_path, timeout_s=self.probe_timeout_s)
            verdict = classify_slo(reply.json(), now_s=self._clock(),
                                   max_age_s=self.slo_max_age_s)
        except TransportError:
            verdict = "unknown"
        return True, draining, verdict, generation

    def probe_once(self) -> Dict[str, str]:
        """One active sweep: probe every non-cooling replica, apply the
        transition rules, return ``{replica: state}`` after."""
        to_probe = []
        with self._lock:
            for rid in self._replicas:
                self._maybe_half_open_locked(rid)
                if self._replicas[rid].state != OPEN:
                    to_probe.append(rid)
        results = {rid: self._probe_replica(rid) for rid in to_probe}
        with self._lock:
            for rid, (ok, draining, verdict, generation) in results.items():
                st = self._replicas[rid]
                if draining:
                    # a deliberate signal, not a flaky probe: one strike
                    self._transition_locked(rid, OPEN, "draining")
                    continue
                if not ok:
                    st.probe_failures += 1
                    if st.state == HALF_OPEN:
                        self._transition_locked(rid, OPEN, "trial_probe_failed")
                    elif st.probe_failures >= self.fail_threshold:
                        self._transition_locked(rid, OPEN, "probe_failures")
                    continue
                if verdict == "burning":
                    st.probe_failures = 0
                    self._transition_locked(rid, OPEN, "slo_burn")
                    continue
                # healthy probe (slo healthy or unknown — unknown never
                # blocks a live health endpoint from keeping its circuit)
                st.probe_failures = 0
                st.last_healthy = self._clock()
                if generation is not None:
                    st.generation = generation
                if st.state == HALF_OPEN:
                    self._transition_locked(rid, CLOSED, "trial_probe_ok")
            return {rid: s.state for rid, s in self._replicas.items()}

    # ---- queries ------------------------------------------------------ #

    def state(self, rid: str) -> str:
        with self._lock:
            self._maybe_half_open_locked(rid)
            return self._replicas[rid].state

    def replica_ids(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def backpressured(self, rid: str) -> bool:
        with self._lock:
            st = self._replicas[rid]
            return self._clock() < st.backpressure_until

    def last_known_healthy(self, candidates: Optional[Sequence[str]] = None
                           ) -> Optional[Dict[str, Any]]:
        """Most recent healthy sighting among ``candidates`` (default all):
        the hint a 503 carries so clients know the outage is fresh."""
        with self._lock:
            best = None
            for rid in (candidates if candidates is not None
                        else self._replicas):
                st = self._replicas.get(rid)
                if st is None or st.last_healthy is None:
                    continue
                if best is None or st.last_healthy > best[1]:
                    best = (rid, st.last_healthy)
            if best is None:
                return None
            return {"replica": best[0],
                    "age_s": round(self._clock() - best[1], 3)}

    def retry_after_hint_s(self) -> float:
        """Seconds until the soonest open circuit may half-open — what a
        blanket 503's ``Retry-After`` should say."""
        with self._lock:
            now = self._clock()
            waits = [max(st.opened_at + self.open_cooldown_s - now, 0.0)
                     for st in self._replicas.values() if st.state == OPEN]
            return min(waits) if waits else 1.0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                rid: {"state": st.state, "reason": st.reason,
                      "inflight": st.inflight, "ejections": st.ejections,
                      "probe_failures": st.probe_failures,
                      "request_failures": st.request_failures,
                      "generation": st.generation,
                      "last_healthy_age_s": (
                          None if st.last_healthy is None
                          else round(self._clock() - st.last_healthy, 3))}
                for rid, st in self._replicas.items()
            }

    # ---- probe thread ------------------------------------------------- #

    def start(self) -> "ReplicaSet":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._probe_loop, name="fleet-prober", daemon=True)
            self._thread.start()
        return self

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self.probe_once()
            except Exception:  # a probe sweep must never kill the prober
                pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# --------------------------------------------------------------------- #
# metrics federation


class MetricsFederation:
    """Router-side metrics federation: scrape every replica's
    full-fidelity registry dump (``GET /metrics.dump``) and merge the
    **clamped per-replica deltas** into one fleet registry — the
    Prometheus-federation shape, built on our own registry instead of a
    scrape stack.

    - counters and histograms accumulate non-negative window deltas per
      replica (:func:`~dist_svgd_torch.telemetry.metrics.dump_delta`):
      merging is **exact** because every registry shares the fixed
      log-spaced bucket lattice, and a restarted replica's counter reset
      clamps to a zero delta (slo.py's window-reset discipline) so
      federated rates never go negative.  Every series lands twice —
      labelled ``replica=<id>`` and unlabelled (the **fleet rollup**: the
      sum over replicas);
    - gauges are last-write-wins under their ``replica=`` label only
      (summing instantaneous state encodings across processes is not
      meaningful; rates belong to counters);
    - a scrape failure (dead/partitioned replica, malformed dump,
      mismatched buckets) increments
      ``svgd_fleet_scrape_errors_total{replica=...}`` and leaves that
      replica's prior contribution standing — federation **degrades
      visibly, not silently**.  The ``replica`` label rides the shared
      cardinality guard, so a flapping fleet aggregates into the
      ``other`` rollup instead of growing the exposition without bound.

    One :meth:`scrape_once` sweep is serialized under the federation lock
    (two concurrent ``/metrics`` collections must not double-count one
    window) and its wall is observed into
    ``svgd_fleet_scrape_seconds`` — the ``federation_scrape_ms`` number
    the fleet drill rows carry.
    """

    def __init__(self, replica_set: "ReplicaSet", transport=None, *,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 fleet_registry: Optional[_metrics.MetricsRegistry] = None,
                 path: str = "/metrics.dump",
                 timeout_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.replica_set = replica_set
        self.transport = transport if transport is not None \
            else replica_set.transport
        self.path = path
        self.timeout_s = float(timeout_s)
        self._clock = clock
        #: The federated view: replica-labelled series + fleet rollups.
        #: Deliberately its OWN registry (never the process default) so
        #: scraped series cannot collide with the router's own.
        self.fleet_registry = (fleet_registry if fleet_registry is not None
                               else _metrics.MetricsRegistry())
        self._lock = threading.Lock()
        self._prev: Dict[str, dict] = {}
        self._scrapes = 0
        self._skips = 0
        self._last_wall_ms: Optional[float] = None
        self._monotone = True
        self._last_rollup: Dict[str, float] = {}
        reg = registry if registry is not None else _metrics.default_registry()
        self._m_errors = reg.counter(
            "svgd_fleet_scrape_errors_total",
            "replica /metrics.dump scrapes that failed "
            "(unreachable replica, malformed dump)")
        self._m_scrapes = reg.counter(
            "svgd_fleet_scrapes_total", "federation scrape sweeps")
        self._m_wall = reg.histogram(
            "svgd_fleet_scrape_seconds", "one federation sweep's wall")

    def _validate_delta(self, delta: dict) -> None:
        """Reject a delta the fleet registry could not ingest atomically —
        BEFORE any series is applied, so a bad dump never leaves the
        replica-labelled and rollup views half-updated."""
        for name, entry in delta.get("metrics", {}).items():
            if not _metrics._NAME_OK.match(str(name)):
                # the registry's own name gate, applied up front: ingest
                # hitting it MID-dump would leave earlier metrics applied
                raise ValueError(f"dump carries invalid metric name "
                                 f"{name!r}")
            kind = entry.get("kind")
            if kind not in ("counter", "gauge", "histogram"):
                raise ValueError(
                    f"dump entry {name!r} has unknown kind {kind!r}")
            existing = self.fleet_registry.get(name)
            if existing is not None and existing.kind != kind:
                raise ValueError(
                    f"dump entry {name!r} is a {kind}; the fleet registry "
                    f"holds a {existing.kind} under that name")
            for s in entry.get("series", []):
                labels = s.get("labels")
                if labels is not None and not isinstance(labels, dict):
                    raise ValueError(
                        f"{name!r} series labels must be an object")
            if kind in ("counter", "gauge"):
                for s in entry.get("series", []):
                    value = s.get("value", 0)
                    if not isinstance(value, (int, float)):
                        raise ValueError(
                            f"{kind} {name!r} has non-numeric value "
                            f"{value!r}")
                    if kind == "counter" and value < 0:
                        raise ValueError(
                            f"counter {name!r} delta went negative")
            elif kind == "histogram":
                dumped = entry.get("buckets")
                bounds = (tuple(dumped) if dumped is not None
                          else getattr(existing, "buckets",
                                       _metrics.LATENCY_BUCKETS_S))
                if (existing is not None
                        and tuple(bounds) != tuple(existing.buckets)):
                    raise ValueError(
                        f"histogram {name!r}: dump buckets do not match "
                        "the fleet lattice")
                for s in entry.get("series", []):
                    counts = s.get("counts", [])
                    if len(counts) != len(bounds) + 1:
                        raise ValueError(
                            f"histogram {name!r}: series has "
                            f"{len(counts)} bucket counts, "
                            f"lattice needs {len(bounds) + 1}")
                    if not all(isinstance(c, (int, float))
                               for c in counts) or not isinstance(
                                   s.get("sum", 0.0), (int, float)):
                        raise ValueError(
                            f"histogram {name!r} has non-numeric counts")

    def scrape_once(self) -> Dict[str, Any]:
        """One federation sweep; returns ``{"wall_ms", "scraped": [...],
        "skipped": [...], "errors": {replica: reason}}``.

        Replicas whose circuit is already OPEN are **skipped**, not
        scraped: their prior contribution stands either way, and paying
        ``timeout_s`` per known-dead replica on every ``/metrics``
        collection would stall a scraper ``dead × timeout`` seconds
        through a whole outage (the breaker's probes own readmission —
        scraping resumes the sweep after they re-close the circuit).
        Failures on replicas still believed healthy ARE counted — that's
        the visible-degradation window between a death and its
        detection."""
        with self._lock:
            t0 = self._clock()
            scraped: List[str] = []
            skipped: List[str] = []
            errors: Dict[str, str] = {}
            for rid in self.replica_set.replica_ids():
                if self.replica_set.state(rid) == OPEN:
                    skipped.append(rid)
                    continue
                try:
                    reply = self.transport.request(
                        rid, "GET", self.path, timeout_s=self.timeout_s)
                    if reply.status != 200:
                        raise TransportError(
                            f"{self.path} answered {reply.status}")
                    doc = reply.json()
                    if not isinstance(doc, dict) or "metrics" not in doc:
                        raise ValueError("reply is not a metrics dump")
                    delta = _metrics.dump_delta(self._prev.get(rid), doc)
                    # validate → ingest → only THEN advance the window:
                    # a rejected dump must leave the replica's prior
                    # contribution standing and its window un-consumed
                    # (advancing _prev on failure would silently drop the
                    # failed window's counts forever)
                    self._validate_delta(delta)
                    # replica-labelled series AND the unlabelled rollup;
                    # gauges only under their replica identity.  A
                    # replica's own SLO verdict mirrors (svgd_slo_*) stay
                    # replica-labelled ONLY: the router's fleet SLO
                    # engine writes the unlabelled {slo=...} series in
                    # this same registry, and rolling replica-local
                    # verdicts into it would conflate per-engine breach
                    # counts with the fleet verdict
                    self.fleet_registry.ingest(delta, labels={"replica": rid})
                    rollup = {"metrics": {
                        n: e for n, e in delta.get("metrics", {}).items()
                        if not n.startswith("svgd_slo_")}}
                    self.fleet_registry.ingest(rollup, skip_gauges=True)
                    self._prev[rid] = doc
                    scraped.append(rid)
                except Exception as e:
                    errors[rid] = f"{type(e).__name__}: {e}"
                    self._m_errors.inc(replica=rid)
            wall = self._clock() - t0
            self._scrapes += 1
            self._skips += len(skipped)
            self._last_wall_ms = wall * 1e3
            # monotonicity audit over the ROLLUP series (everything not
            # carrying the replica identity — the federated totals): an
            # assert-style invariant detector.  Add-only ingest plus
            # clamped deltas make a decrease unreachable today; if a
            # future change breaks either half, this flips the drill's
            # federation_monotone gate instead of silently shipping
            # negative rates
            with self.fleet_registry._lock:
                fed_metrics = dict(self.fleet_registry._metrics)
            for name, metric in fed_metrics.items():
                if not isinstance(metric, _metrics.Counter):
                    continue
                value = float(sum(
                    metric.value(**ls) for ls in metric.label_sets()
                    if "replica" not in ls))
                if value < self._last_rollup.get(name, 0.0):
                    self._monotone = False
                self._last_rollup[name] = value
        self._m_scrapes.inc()
        self._m_wall.observe(wall)
        return {"wall_ms": round(wall * 1e3, 3), "scraped": scraped,
                "skipped": skipped, "errors": errors}

    @property
    def scrapes(self) -> int:
        with self._lock:
            return self._scrapes

    @property
    def skips(self) -> int:
        """Cumulative open-circuit replicas skipped across sweeps."""
        with self._lock:
            return self._skips

    @property
    def monotone(self) -> bool:
        """False if any federated counter rollup ever decreased between
        sweeps (must stay True — clamping exists exactly for this)."""
        with self._lock:
            return self._monotone

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"scrapes": self._scrapes,
                   "skipped": self._skips,
                   "last_scrape_ms": (None if self._last_wall_ms is None
                                      else round(self._last_wall_ms, 3)),
                   "monotone": self._monotone}
        out["scrape_errors"] = {
            rid: self._m_errors.value(replica=rid)
            for rid in self.replica_set.replica_ids()
            if self._m_errors.value(replica=rid) > 0}
        return out


# --------------------------------------------------------------------- #
# consistent hashing


def _hash_point(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class _HashRing:
    """Consistent-hash ring with virtual nodes; static after construction
    (membership changes go through the circuit breaker, not the ring —
    a dead replica keeps its arc so tenants return home on re-admission)."""

    def __init__(self, replicas: Sequence[str], vnodes: int = 32):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        points: List[Tuple[int, str]] = []
        for rid in replicas:
            for v in range(vnodes):
                points.append((_hash_point(f"{rid}#{v}"), rid))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [r for _, r in points]
        self._n = len(set(replicas))

    def order(self, tenant: str) -> List[str]:
        """Every replica, ring-ordered from the tenant's hash point —
        element 0 is the tenant's home; the rest are its failover chain."""
        start = bisect.bisect_left(self._points, _hash_point(tenant))
        seen: List[str] = []
        for i in range(len(self._owners)):
            rid = self._owners[(start + i) % len(self._owners)]
            if rid not in seen:
                seen.append(rid)
                if len(seen) == self._n:
                    break
        return seen


# --------------------------------------------------------------------- #
# the router


class RouteResult:
    """Outcome of one routed request (the HTTP layer writes it verbatim)."""

    __slots__ = ("status", "headers", "body", "replica", "attempts",
                 "hedged", "outcome")

    def __init__(self, status, headers, body, replica=None, attempts=0,
                 hedged=False, outcome="served"):
        self.status = status
        self.headers = headers
        self.body = body
        self.replica = replica
        self.attempts = attempts
        self.hedged = hedged
        self.outcome = outcome

    def json(self) -> Any:
        try:
            return json.loads(self.body or b"null")
        except (ValueError, UnicodeDecodeError):
            return None


class FleetRouter:
    """Consistent-hash front door over a :class:`ReplicaSet` — see the
    module docstring for the full routing contract.

    Args:
        replicas: replica ids (with ``transport=None``, a dict
            ``{id: (host, port)}`` builds an :class:`HttpTransport`).
        transport: injectable transport (:class:`FakeTransport` in tests).
        vnodes / load_factor: consistent-hash ring shape and the
            bounded-load overflow factor (fair-share multiplier; ``None``
            disables overflow).
        max_retries: extra attempts after the first (connect/timeout/5xx
            only — never a 429).
        per_try_timeout_s / default_deadline_s: one attempt's transport
            budget and the whole request's default deadline (clients
            override per request via the ``X-Fleet-Deadline-S`` header).
        backoff: shared jittered :class:`Backoff` between retries
            (clamped to the remaining deadline).
        hedge / hedge_delay_s / hedge_min_delay_s: opt-in tail hedging;
            with ``hedge_delay_s=None`` the delay is the p99 of recent
            successful forwards (bounded window), clamped to
            ``[hedge_min_delay_s, per_try_timeout_s/2]``.
        replica_set: a pre-built :class:`ReplicaSet` (tests inject clocks
            through it); else one is built from ``probe_...`` kwargs.
    """

    def __init__(self, replicas, *,
                 transport=None,
                 vnodes: int = 32,
                 load_factor: Optional[float] = 2.0,
                 max_retries: int = 2,
                 per_try_timeout_s: float = 5.0,
                 default_deadline_s: float = 10.0,
                 backoff: Optional[Backoff] = None,
                 hedge: bool = False,
                 hedge_delay_s: Optional[float] = None,
                 hedge_min_delay_s: float = 0.01,
                 replica_set: Optional[ReplicaSet] = None,
                 probe_interval_s: float = 1.0,
                 probe_tenants: Sequence[str] = (),
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 slo_p99_ms: float = 100.0,
                 slo_min_interval_s: float = 5.0,
                 federation_timeout_s: float = 1.0,
                 host: str = "127.0.0.1",
                 port: Optional[int] = None):
        if isinstance(replicas, dict) and transport is None:
            transport = HttpTransport(replicas)
        ids = list(replicas)
        if transport is None and replica_set is not None:
            transport = replica_set.transport
        if transport is None:
            raise ValueError("pass transport= (or {id: (host, port)})")
        reg = registry if registry is not None else _metrics.default_registry()
        self.registry = reg
        self.replica_set = replica_set if replica_set is not None else (
            ReplicaSet(ids, transport,
                       probe_interval_s=probe_interval_s,
                       probe_tenants=probe_tenants,
                       probe_timeout_s=min(per_try_timeout_s, 1.0),
                       clock=clock, registry=reg))
        self.transport = (transport if replica_set is None
                          else replica_set.transport)
        self._ring = _HashRing(ids, vnodes=vnodes)
        self.load_factor = load_factor
        self.max_retries = int(max_retries)
        self.per_try_timeout_s = float(per_try_timeout_s)
        self.default_deadline_s = float(default_deadline_s)
        self.backoff = backoff if backoff is not None else Backoff(
            base_s=0.02, factor=2.0, max_s=1.0, jitter_frac=0.2)
        self.hedge = bool(hedge)
        self.hedge_delay_s = hedge_delay_s
        self.hedge_min_delay_s = float(hedge_min_delay_s)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._lat_window: deque = deque(maxlen=512)  # successful forward walls
        self._pool: Optional[ThreadPoolExecutor] = None
        if self.hedge:
            self._pool = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="fleet-hedge")

        self._m_requests = reg.counter(
            "svgd_fleet_requests_total", "routed requests by outcome")
        self._m_retries = reg.counter(
            "svgd_fleet_retries_total", "forward retries by failure reason")
        self._m_hedges = reg.counter(
            "svgd_fleet_hedges_total", "tail-hedged forwards")
        self._m_failovers = reg.counter(
            "svgd_fleet_failovers_total",
            "requests served by a non-home replica")
        self._m_latency = reg.histogram(
            "svgd_fleet_route_seconds", "end-to-end routed request wall")

        #: Metrics federation over the fleet: ``/metrics``
        #: scrapes-on-collect and serves the router's own series plus the
        #: per-replica-labelled + rollup federated view; ``/slo``
        #: evaluates the serving objectives over the *federated* window.
        self.federation = MetricsFederation(
            self.replica_set, self.transport, registry=reg,
            timeout_s=federation_timeout_s, clock=clock)
        self.slo_engine = default_serving_slos(
            self.federation.fleet_registry, p99_ms=slo_p99_ms,
            aggregate=True)
        #: The SLO objectives are stateful windows; N concurrent pollers
        #: (an alerting scraper on /slo + an operator looping /fleet)
        #: would slice one window into N slivers and make burn rates
        #: flap.  evaluate_slo() therefore caches the verdict for
        #: ``slo_min_interval_s`` — every consumer sees windows at least
        #: that wide no matter how many poll.
        self.slo_min_interval_s = float(slo_min_interval_s)
        self._slo_cache: Optional[Tuple[float, Dict[str, Any]]] = None

        self._httpd = None
        self._serve_thread = None
        if port is not None:
            predict_body.load()  # the front door reads tenants with it: built first
            self._httpd = _HTTPServer((host, port), self._make_handler())
            # ThreadingMixIn reads this off the SERVER instance (a class
            # attribute on the handler is a no-op): non-daemon handler
            # threads are what makes server_close() join in-flight
            # requests — the graceful part of graceful degradation
            self._httpd.daemon_threads = False

    # ---- candidate selection ----------------------------------------- #

    def order_for(self, tenant: str) -> List[str]:
        return self._ring.order(tenant)

    def _pick(self, order: Sequence[str], tried: set) -> Optional[str]:
        """First admitted candidate in ring order, by preference passes:
        untried + unbackpressured + within the load bound, then untried
        within the bound, then untried *ignoring* the bound (the bound is
        a placement preference — a healthy-but-busy replica beats a 503;
        real admission control is the replica's own 429), then anyone
        admitted (retry the same replica when it's all that's left)."""
        rs = self.replica_set
        passes = ((True, True, True), (True, False, True),
                  (True, False, False), (False, False, False))
        for skip_tried, skip_bp, bounded in passes:
            for rid in order:
                if (rid in tried) == skip_tried:
                    continue
                if skip_bp and rs.backpressured(rid):
                    continue
                if rs.begin_request(rid,
                                    self.load_factor if bounded else None):
                    return rid
        return None

    # ---- forwarding --------------------------------------------------- #

    def _forward(self, rid: str, method: str, path: str, body, headers,
                 timeout_s: float) -> Reply:
        """One transport attempt with outcome recording — every exit
        records exactly one outcome against the ``begin_request`` the
        caller acquired.  (Misroute detection lives in ``begin_request``,
        under the replica-set lock — re-checking the state here would race
        with a concurrent ejection of a legitimately admitted request.)"""
        rs = self.replica_set
        t0 = self._clock()
        try:
            reply = self.transport.request(rid, method, path, body=body,
                                           headers=headers,
                                           timeout_s=timeout_s)
        except ConnectError:
            rs.record_failure(rid, "connect")
            raise
        except RequestTimeout:
            rs.record_failure(rid, "timeout")
            raise
        except TransportError:
            rs.record_failure(rid, "transport")
            raise
        if reply.status == 429:
            rs.record_shed(rid, reply.retry_after_s())
        elif reply.status == 504:
            # the replica answered that the CALLER's deadline ran out: it
            # is alive, and the tight budget was ours — release the slot
            # without scoring a failure (ejecting healthy replicas on
            # short-deadline traffic would be self-inflicted)
            rs.record_success(rid)
        elif reply.status >= 500:
            rs.record_failure(rid, "5xx")
        else:
            rs.record_success(rid)
            with self._lock:
                self._lat_window.append(self._clock() - t0)
        return reply

    def _hedge_delay(self) -> float:
        if self.hedge_delay_s is not None:
            return self.hedge_delay_s
        with self._lock:
            lat = sorted(self._lat_window)
        if not lat:
            d = self.hedge_min_delay_s
        else:
            d = lat[min(len(lat) - 1, int(0.99 * (len(lat) - 1)))]
        return min(max(d, self.hedge_min_delay_s),
                   self.per_try_timeout_s / 2)

    def _attempt(self, rid: str, order, tried: set, method, path, body,
                 headers, timeout_s: float,
                 hedge_allowed: bool) -> Tuple[Reply, str, bool]:
        """One attempt, optionally tail-hedged.  Returns
        ``(reply, serving replica, hedged?)`` or raises TransportError
        (both legs failed / the only leg failed)."""
        if not (hedge_allowed and self.hedge and self._pool is not None):
            return self._forward(rid, method, path, body, headers,
                                 timeout_s), rid, False
        f1 = self._pool.submit(self._forward, rid, method, path, body,
                               headers, timeout_s)
        try:
            return f1.result(timeout=self._hedge_delay()), rid, False
        except FutureTimeout:
            pass  # primary is slow — hedge
        backup = self._pick(order, tried | {rid})
        if backup is None:
            try:
                return f1.result(timeout=timeout_s), rid, False
            except FutureTimeout:
                raise RequestTimeout(
                    f"attempt to {rid} outlived its {timeout_s:.3f}s budget"
                ) from None
        self._m_hedges.inc()
        f2 = self._pool.submit(self._forward, backup, method, path, body,
                               headers, timeout_s)
        futures = {f1: rid, f2: backup}
        pending = set(futures)
        last_exc: Optional[BaseException] = None
        deadline = self._clock() + timeout_s
        while pending:
            done, pending = futures_wait(
                pending, timeout=max(deadline - self._clock(), 0.01),
                return_when=FIRST_COMPLETED)
            if not done:
                break
            for f in done:
                exc = f.exception()
                if exc is None:
                    return f.result(), futures[f], True
                last_exc = exc
        if last_exc is not None:
            raise last_exc  # both legs failed — let the retry loop judge
        raise RequestTimeout(f"hedged attempt to {rid} timed out")

    # ---- the routed request ------------------------------------------ #

    def route(self, tenant: str, body: bytes,
              deadline_s: Optional[float] = None,
              method: str = "POST", path: str = "/predict",
              trace: Optional[str] = None) -> RouteResult:
        """Forward one request for ``tenant`` through the robustness kit.
        Never raises — every failure mode maps to a status code.

        ``trace`` is the request's cross-process trace id: taken from the
        client's ``X-Fleet-Trace`` header when present, minted here
        otherwise, and sent downstream on every attempt — the join key
        ``trace_report --stitch`` reassembles router→replica
        trees on."""
        trace_id = trace or _trace.mint_trace_id()
        t_start = self._clock()
        deadline = t_start + (deadline_s if deadline_s is not None
                              else self.default_deadline_s)
        order = self.order_for(tenant)
        tracer = _trace.get_tracer()
        tr0 = tracer.now() if tracer is not None else 0.0
        children: List[Tuple] = []
        tried: set = set()
        attempts = 0
        hedged_any = False
        result: Optional[RouteResult] = None
        last_failure = "unroutable"
        while attempts <= self.max_retries:
            remaining = deadline - self._clock()
            if remaining <= 0:
                result = self._error_result(
                    504, {"error": f"deadline exceeded after {attempts} "
                          "attempt(s)", "tenant": tenant},
                    outcome="deadline", attempts=attempts)
                break
            rid = self._pick(order, tried)
            if rid is None:
                break  # nobody admitted — graceful 503 below
            tried.add(rid)
            attempts += 1
            timeout_s = min(self.per_try_timeout_s, remaining)
            headers = {"Content-Type": "application/json",
                       DEADLINE_HEADER: f"{remaining:.3f}",
                       ATTEMPT_HEADER: str(attempts - 1),
                       TRACE_HEADER: trace_id}
            a0 = tracer.now() if tracer is not None else 0.0
            try:
                reply, served_by, was_hedged = self._attempt(
                    rid, order, tried, method, path, body, headers,
                    timeout_s, hedge_allowed=attempts == 1)
            except TransportError as e:
                a1 = tracer.now() if tracer is not None else 0.0
                if tracer is not None:
                    children.append(("fleet.attempt", a0, a1,
                                     {"n": attempts - 1, "replica": rid,
                                      "error": type(e).__name__,
                                      "trace": trace_id}))
                reason = ("connect" if isinstance(e, ConnectError)
                          else "timeout" if isinstance(e, RequestTimeout)
                          else "transport")
                last_failure = reason
                self._m_retries.inc(reason=reason)
                if attempts <= self.max_retries:  # another attempt follows
                    delay = min(self.backoff.delay_s(attempts),
                                max(deadline - self._clock(), 0.0))
                    if delay > 0:
                        self._sleep(delay)
                continue
            a1 = tracer.now() if tracer is not None else 0.0
            hedged_any = hedged_any or was_hedged
            if tracer is not None:
                children.append(("fleet.attempt", a0, a1,
                                 {"n": attempts - 1, "replica": served_by,
                                  "status": reply.status,
                                  "hedged": was_hedged,
                                  "trace": trace_id}))
                children.append(("fleet.forward", a0, a1,
                                 {"replica": served_by}))
            if reply.status == 429:
                # a shed is the replica protecting itself: pass the computed
                # Retry-After through and do NOT spend retries on it —
                # honoring the replica's number instead of generic backoff
                hdrs = {"Content-Type": "application/json"}
                ra = reply.retry_after_s()
                if ra is not None:
                    hdrs["Retry-After"] = format_retry_after(ra)
                result = RouteResult(429, hdrs, reply.body,
                                     replica=served_by, attempts=attempts,
                                     hedged=hedged_any, outcome="shed")
                break
            if reply.status == 504:
                # downstream echo of OUR propagated deadline: retrying
                # with even less budget is futile — answer honestly now
                result = RouteResult(
                    504, {"Content-Type": "application/json"}, reply.body,
                    replica=served_by, attempts=attempts,
                    hedged=hedged_any, outcome="deadline")
                break
            if reply.status >= 500:
                last_failure = "5xx"
                self._m_retries.inc(reason="5xx")
                if attempts <= self.max_retries:  # another attempt follows
                    ra = reply.retry_after_s()
                    delay = (ra if ra is not None
                             else self.backoff.delay_s(attempts))
                    delay = min(delay, max(deadline - self._clock(), 0.0))
                    if delay > 0:
                        self._sleep(delay)
                continue
            # 2xx / 4xx: a definitive answer — return it
            if served_by != order[0]:
                self._m_failovers.inc(tenant=tenant)
            result = RouteResult(
                reply.status,
                {"Content-Type": reply.headers.get(
                    "content-type", "application/json")},
                reply.body, replica=served_by, attempts=attempts,
                hedged=hedged_any,
                outcome="served" if reply.status < 400 else "client_error")
            break
        if result is None:
            ra = self.replica_set.retry_after_hint_s()
            hint = self.replica_set.last_known_healthy(order)
            result = self._error_result(
                503,
                {"error": f"no replica available for tenant {tenant!r} "
                 f"(last failure: {last_failure})",
                 "tenant": tenant,
                 "retry_after_s": round(ra, 3),
                 "last_known_healthy": hint},
                outcome="unroutable", attempts=attempts,
                extra_headers={"Retry-After": format_retry_after(ra)})
        self._m_requests.inc(outcome=result.outcome)
        wall = self._clock() - t_start
        self._m_latency.observe(wall)
        if tracer is not None:
            tr1 = tracer.now()
            tracer.lane_tree(
                "fleet.route", tr0, tr1,
                {"tenant": tenant, "status": result.status,
                 "attempts": attempts, "outcome": result.outcome,
                 "replica": result.replica, "trace": trace_id},
                children=children)
        return result

    def _error_result(self, status, payload, outcome, attempts,
                      extra_headers=None) -> RouteResult:
        return RouteResult(
            status,
            {"Content-Type": "application/json", **(extra_headers or {})},
            json.dumps(payload).encode(),
            attempts=attempts, outcome=outcome)

    # ---- fleet view ---------------------------------------------------- #

    def health(self) -> Dict[str, Any]:
        states = self.replica_set.stats()
        n_up = sum(1 for s in states.values() if s["state"] == CLOSED)
        return {
            "status": ("ok" if n_up else "degraded"),
            "role": "fleet-router",
            "replicas": states,
            "replicas_closed": n_up,
            "replicas_total": len(states),
        }

    def evaluate_slo(self, scrape: bool = True) -> Dict[str, Any]:
        """The fleet SLO verdict over the federated window, cached for
        ``slo_min_interval_s`` (see the constructor note: concurrent
        pollers must not slice the objectives' windows into slivers).
        ``scrape=False`` skips the federation sweep when the caller just
        ran one."""
        now = self._clock()
        with self._lock:
            cached = self._slo_cache
        if (cached is not None
                and now - cached[0] < self.slo_min_interval_s):
            return cached[1]
        if scrape:
            self.federation.scrape_once()
        doc = self.slo_engine.evaluate()
        with self._lock:
            self._slo_cache = (now, doc)
        return doc

    def fleet_status(self, scrape: bool = True) -> Dict[str, Any]:
        """One structured fleet-status document (served at ``/fleet``;
        ``tools/fleet_status.py`` renders it): breaker states, federation
        health, per-tenant fleet-wide request counts and latency
        percentiles from the **merged** histograms (the rollup series —
        no single replica could answer these), and the SLO verdicts over
        the federated window.  ``scrape=True`` runs one federation sweep
        first so the numbers are current."""
        scrape_info = self.federation.scrape_once() if scrape else None
        slo_doc = self.evaluate_slo(scrape=False)
        fed = self.federation.fleet_registry
        tenants: Dict[str, Any] = {}
        lat = fed.get("svgd_serve_request_latency_seconds")
        req = fed.get("svgd_serve_requests_total")
        if isinstance(lat, _metrics.Histogram):
            for labels in lat.label_sets():
                if "replica" in labels:
                    continue  # per-replica detail stays in /metrics
                name = labels.get("tenant", "") or "(default)"
                s = lat.summary(scale=1e3, **labels)
                tenants[name] = {
                    "requests": s["count"],
                    "p50_ms": s["p50"], "p99_ms": s["p99"],
                }
        if isinstance(req, _metrics.Counter):
            for labels in req.label_sets():
                if "replica" in labels:
                    continue
                name = labels.get("tenant", "") or "(default)"
                tenants.setdefault(name, {})["requests_total"] = (
                    req.value(**labels))
        # fleet-wide cost columns from the federated usage counters
        # (telemetry/usage.py; zero-filled absent — replicas without
        # metering simply contribute nothing)
        usage = _usage.usage_summary(fed)
        for name, row in usage["tenants"].items():
            tenants.setdefault(name, {}).update(
                device_seconds_total=row["device_seconds"],
                usage_rows_total=row["rows"],
            )
        doc = self.health()
        doc.update(
            ts=time.time(),
            federation=self.federation.stats(),
            tenants=tenants,
            slo=slo_doc,
        )
        if scrape_info is not None:
            doc["federation"]["last_sweep"] = scrape_info
        return doc

    # ---- HTTP front door ---------------------------------------------- #

    def _make_handler(self):
        router = self

        class Handler(_KeepAliveHandler):
            def _write_json(self, status, payload):
                self.send_reply(status, {"Content-Type": "application/json"},
                                json.dumps(payload).encode())

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    doc = router.health()
                    self._write_json(200 if doc["replicas_closed"] else 503,
                                     doc)
                elif path == "/replicas":
                    self._write_json(200, router.replica_set.stats())
                elif path == "/metrics":
                    # scrape-on-collect federation (the Prometheus
                    # federation convention): one sweep over the live
                    # replicas, then the router's own series plus the
                    # replica-labelled + rollup federated view in ONE
                    # document (names dedup toward the router's)
                    router.federation.scrape_once()
                    self.send_reply(
                        200,
                        {"Content-Type":
                         "text/plain; version=0.0.4; charset=utf-8"},
                        _metrics.combined_exposition(
                            router.registry,
                            router.federation.fleet_registry).encode())
                elif path == "/slo":
                    # the fleet SLO: the same declarative objectives the
                    # replicas evaluate locally, judged over the
                    # FEDERATED window — fleet-wide p99 for the fleet
                    # (verdict cached slo_min_interval_s against
                    # window-slicing by concurrent pollers)
                    self._write_json(200, router.evaluate_slo())
                elif path == "/fleet":
                    self._write_json(200, router.fleet_status())
                elif path == "/usage":
                    # fleet-wide cost-per-tenant: one federation sweep,
                    # then the usage summary over the MERGED registry —
                    # tenants/totals from the rollup series, per-replica
                    # breakdown from the replica-labelled ones
                    router.federation.scrape_once()
                    self._write_json(200, {
                        "metering": True,
                        **_usage.usage_summary(
                            router.federation.fleet_registry)})
                else:
                    self._write_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path.split("?", 1)[0] != "/predict":
                    self._write_json(404, {"error": f"no route {self.path}"})
                    return
                body = self.read_body()
                # JAX's doc.get("tenant") or "", read natively where the
                # body allows (no Python float built); the bytes forwarded
                # stay the client's
                tenant = predict_body.routing_key(body)
                deadline_s = None
                raw = self.headers.get(DEADLINE_HEADER)
                if raw:
                    try:
                        deadline_s = max(float(raw), 0.001)
                    except ValueError:
                        pass
                res = router.route(tenant, body, deadline_s=deadline_s,
                                   trace=self.headers.get(TRACE_HEADER))
                self.send_reply(res.status, res.headers, res.body)

        return Handler

    @property
    def url(self) -> Optional[str]:
        if self._httpd is None:
            return None
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "FleetRouter":
        """Start the probe thread and (when built with ``port=``) the HTTP
        front door."""
        tracer = _trace.get_tracer()
        if tracer is not None:
            # stitchers label this process's export off the tracer's
            # process header; an identity a drill already set wins
            tracer.set_process("router", "router", only_if_default=True)
        self.replica_set.start()
        if self._httpd is not None and self._serve_thread is None:
            self._serve_thread = threading.Thread(
                target=self._httpd.serve_forever, name="fleet-http",
                daemon=True)
            self._serve_thread.start()
        return self

    def shutdown(self) -> None:
        self.replica_set.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.close_idle()
            self._httpd.server_close()
            if self._serve_thread is not None:
                self._serve_thread.join(timeout=10)
                self._serve_thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        close = getattr(self.transport, "close", None)
        if close is not None:
            close()  # the transport's idle keep-alive connections

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
