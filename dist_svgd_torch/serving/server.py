"""Thin stdlib HTTP front end over the engine + batcher — or over a
multi-tenant :class:`~dist_svgd_torch.serving.registry.ModelRegistry`.

Counterpart of ``dist_svgd_tpu/serving/server.py`` (``PredictionServer``
and ``main``), with every route:

- ``POST /predict``      — ``{"inputs": [[...], ...]}`` → the engine's
  output dict as lists, plus this request's latency.  Against a registry,
  the body's ``"tenant"`` field routes to that tenant's engine (404 for an
  unknown tenant; omitted, it defaults to the registry's single tenant
  when there is exactly one, else 400);
- ``GET  /healthz``      — liveness + ensemble identity (503 while
  draining); against a registry, the aggregate plus one row per tenant,
  and ``GET /healthz/<tenant>`` the per-tenant detail;
- ``GET  /tenants``      — registry mode only: the tenant listing;
- ``GET  /metrics``      — Prometheus text exposition of the shared
  telemetry registry;
- ``GET  /metrics.dump`` — the full-fidelity registry dump;
- ``GET  /metrics.json`` — the JSON aggregate (batcher percentiles, engine
  ``stats()``, the server's request/error counts);
- ``GET  /slo``          — the declarative SLO engine's evaluation;
- ``GET  /usage``        — per-tenant cost accounting
  (``telemetry/usage.py:usage_summary``);
- ``GET  /autoscale``    — the adaptive-capacity controller's status
  (``serving/autoscale.py``: live lanes / coalescing window / quota
  scale, bounds, streaks, the recent decision log); 404 without one.

``ThreadingHTTPServer`` runs one thread per connection, parked on the
batcher's future while a request is in flight — the concurrency the
micro-batcher coalesces across.  Connections persist (HTTP/1.1
keep-alive, ``fleet._KeepAliveHandler``): a fleet router's pooled
connections each keep one handler thread, which ends after
:data:`~dist_svgd_torch.serving.fleet.IDLE_TIMEOUT_S` without a request.
Its listen backlog is :data:`LISTEN_BACKLOG`, not the standard library's 5:
with 5, a burst of a few dozen concurrent connections (the Covertype
self-test's 64) overflows the accept queue and clients see connection
resets.
Graceful drain on shutdown: advertise draining (every reply from then on
closes its connection), stop accepting, end the idle connections, finish
in-flight handlers, flush the batcher queue.

Run it with ``python -m dist_svgd_torch.serving.server --checkpoint DIR``
(the card; ``--device cpu`` for the plain path).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional, Union

import numpy as np

from dist_svgd_torch.serving.autoscale import AutoscaleController, AutoscalePolicy
from dist_svgd_torch.serving.batcher import MicroBatcher, Overloaded
from dist_svgd_torch.serving.engine import PredictiveEngine
from dist_svgd_torch.serving.fleet import (  # noqa: F401 (LISTEN_BACKLOG re-exported)
    LISTEN_BACKLOG,
    _HTTPServer,
    _KeepAliveHandler,
    format_retry_after,
)
from dist_svgd_torch.serving.registry import ModelRegistry
from dist_svgd_torch.telemetry import metrics as _metrics
from dist_svgd_torch.telemetry import trace as _trace


class PredictionServer:
    """HTTP serving front end.  ``port=0`` binds an ephemeral port (tests).

    The first argument is either a single :class:`PredictiveEngine`
    (single-tenant, unchanged behavior) or a :class:`ModelRegistry`
    (multi-tenant: the server rides the registry's shared batcher and
    routes ``/predict`` on the body's ``tenant`` field).

    The server owns its batcher unless one is passed in (single-tenant)
    or the registry owns it (multi-tenant); :meth:`shutdown` drains it
    either way (stop accepting → finish in-flight handlers → dispatch
    everything still queued).
    """

    def __init__(
        self,
        engine: Union[PredictiveEngine, ModelRegistry],
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch: int = 256,
        lanes: int = 1,
        max_wait_ms: float = 2.0,
        max_queue_rows: int = 8192,
        request_timeout_s: float = 30.0,
        logger=None,
        batcher: Optional[MicroBatcher] = None,
        registry: Optional[_metrics.MetricsRegistry] = None,
        slo=None,
        slo_p99_ms: float = 100.0,
        autoscale=None,
    ):
        if isinstance(engine, ModelRegistry):
            self.model_registry: Optional[ModelRegistry] = engine
            self.engine = None
            if batcher is not None:
                raise ValueError(
                    "a ModelRegistry brings its own shared batcher; "
                    "don't pass batcher="
                )
            # share the registry's metrics sink so /metrics exposes the
            # tenant-labelled series the tenants actually write
            self.registry = (registry if registry is not None
                             else engine.metrics)
            self.batcher = engine.batcher
        else:
            self.model_registry = None
            self.engine = engine
            self.registry = (registry if registry is not None
                             else _metrics.default_registry())
            self.batcher = batcher or MicroBatcher(
                engine.predict,
                max_batch=max_batch,
                lanes=lanes,
                max_wait_ms=max_wait_ms,
                max_queue_rows=max_queue_rows,
                logger=None,  # batch records would interleave with request
                              # records
                registry=self.registry,
            )
        self._logger = logger
        self._request_timeout_s = request_timeout_s
        self._lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._draining = False
        self._m_http = self.registry.counter(
            "svgd_http_requests_total", "HTTP requests by route and status")
        self._m_http_latency = self.registry.histogram(
            "svgd_http_request_seconds", "handler wall per /predict request")
        if slo is None:
            from dist_svgd_torch.telemetry.slo import default_serving_slos

            slo = default_serving_slos(self.registry, p99_ms=slo_p99_ms)
        #: The declarative SLO engine served at ``/slo`` (pass ``slo=`` to
        #: replace the default serve-p99/shed/error objective set).
        self.slo_engine = slo
        #: Optional :class:`~dist_svgd_torch.serving.autoscale.
        #: AutoscaleController`.  ``autoscale=True`` builds the default
        #: controller over this server's batcher (+ registry quotas in
        #: multi-tenant mode); a controller instance is used as-is.  The
        #: server starts it with :meth:`start` (unless it already runs)
        #: and stops it on :meth:`shutdown`; its status is served at
        #: ``/autoscale``.
        self.autoscale = None
        if autoscale:
            if autoscale is True:
                autoscale = AutoscaleController(
                    self.batcher, metrics=self.registry,
                    model_registry=self.model_registry,
                    policy=AutoscalePolicy(p99_target_ms=slo_p99_ms),
                )
            self.autoscale = autoscale
        self._started = time.time()

        server = self  # close over for the handler class

        class Handler(_KeepAliveHandler):
            def closing(self) -> bool:
                # a draining server ends every connection after its reply
                return server._draining or super().closing()

            def _reply(self, code: int, payload: Dict[str, Any],
                       headers: Optional[Dict[str, str]] = None) -> None:
                self.send_reply(code, {"Content-Type": "application/json",
                                       **(headers or {})},
                                json.dumps(payload).encode())

            def _reply_text(self, code: int, text: str,
                            content_type: str) -> None:
                self.send_reply(code, {"Content-Type": content_type},
                                text.encode())

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    doc = server.health()
                    # a draining server answers 503 so a fleet router stops
                    # routing here BEFORE the socket disappears
                    self._reply(503 if doc["status"] == "draining" else 200,
                                doc)
                elif path.startswith("/healthz/"):
                    name = path[len("/healthz/"):]
                    detail = server.tenant_health(name)
                    if detail is None:
                        self._reply(404, {"error": f"no tenant {name!r}"})
                    else:
                        self._reply(503 if detail["status"] == "draining"
                                    else 200, detail)
                elif path == "/tenants":
                    if server.model_registry is None:
                        self._reply(404, {"error": "single-tenant server: "
                                          "no /tenants route"})
                    else:
                        self._reply(
                            200,
                            {"tenants":
                             server.model_registry.health()["tenants"]})
                elif path == "/metrics":
                    # Prometheus text format 0.0.4 — what scrapers expect
                    self._reply_text(
                        200, server.registry.exposition(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/metrics.dump":
                    # full-fidelity registry dump (raw histogram bucket
                    # counts) — the fleet federation's scrape format:
                    # exact cross-replica merging needs buckets, which
                    # the Prometheus text above quantises into exposition
                    self._reply(200, server.registry.dump())
                elif path == "/metrics.json":
                    self._reply(200, server.metrics())
                elif path == "/slo":
                    self._reply(200, server.slo_engine.evaluate())
                elif path == "/usage":
                    self._reply(200, server.usage())
                elif path == "/autoscale":
                    if server.autoscale is None:
                        self._reply(404, {"error": "no autoscale "
                                          "controller on this server"})
                    else:
                        self._reply(200, server.autoscale.status())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/predict":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                t0 = time.perf_counter()
                # a fleet router propagates its remaining per-request
                # budget downstream — cap our own future-wait with it so a
                # doomed request releases its handler thread on time
                deadline_s = None
                raw = self.headers.get("X-Fleet-Deadline-S")
                if raw:
                    try:
                        deadline_s = max(float(raw), 1e-3)
                    except ValueError:
                        pass
                # the router's trace id: joins this replica's spans to the
                # router's fleet.route tree at stitch time
                trace_id = self.headers.get(_trace.TRACE_HEADER) or None
                with _trace.span("http.predict",
                                 {"trace": trace_id} if trace_id else None):
                    code, payload, rows, tenant, extra = server._predict(
                        self.read_body(), timeout_s=deadline_s,
                        trace=trace_id)
                wall = time.perf_counter() - t0
                payload.setdefault("latency_ms", round(wall * 1e3, 3))
                self._reply(code, payload, extra)
                tl = {} if tenant is None else {"tenant": tenant}
                server._m_http.inc(route="/predict", status=code, **tl)
                server._m_http_latency.observe(wall, **tl)
                if server._logger is not None:
                    server._logger.log(
                        route="/predict",
                        status=code,
                        rows=rows,
                        latency_ms=payload["latency_ms"],
                        **tl,
                    )

        self._httpd = _HTTPServer((host, port), Handler)
        # ThreadingMixIn reads daemon_threads off the SERVER instance (a
        # class attribute on the handler is a no-op): non-daemon handler
        # threads are what makes server_close() join in-flight requests —
        # the drain guarantee shutdown() documents
        self._httpd.daemon_threads = False
        self._serve_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #

    @property
    def address(self):
        """``(host, port)`` actually bound (resolves ``port=0``)."""
        return self._httpd.server_address

    @property
    def url(self) -> str:
        host, port = self.address[:2]
        return f"http://{host}:{port}"

    def _predict(self, body: bytes, timeout_s: Optional[float] = None,
                 trace: Optional[str] = None):
        """Returns ``(status_code, payload, rows, tenant, headers)``;
        never raises.  ``timeout_s`` (a router-propagated deadline) caps
        the future wait below the server's own ``request_timeout_s``;
        ``trace`` (the ``X-Fleet-Trace`` header) threads through to the
        batcher's request lane tree."""
        from concurrent.futures import CancelledError
        from concurrent.futures import TimeoutError as FuturesTimeout

        tenant = None
        # phase 1 — parse and validate the request (client errors → 400)
        try:
            doc = json.loads(body or b"null")
            inputs = doc["inputs"] if isinstance(doc, dict) else None
            if inputs is None:
                raise ValueError('body must be {"inputs": [[...], ...]}')
            x = np.asarray(inputs, dtype=np.float32)
            if x.ndim == 1:  # single row shorthand
                x = x[None, :]
            if self.model_registry is not None:
                tenant = doc.get("tenant")
                if tenant is None:
                    names = self.model_registry.tenant_names()
                    if len(names) != 1:
                        raise ValueError(
                            'multi-tenant server: body needs a "tenant" '
                            f"field (hosted: {names})"
                        )
                    tenant = names[0]
            elif isinstance(doc, dict) and doc.get("tenant") is not None:
                raise ValueError(
                    "single-tenant server: drop the \"tenant\" field"
                )
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            with self._lock:
                self._errors += 1
            return 400, {"error": str(e)}, 0, tenant, None
        # phase 2 — submit and resolve (server-side failures are NOT the
        # client's fault: 404 unknown tenant, 429 shed with Retry-After,
        # 503 retryable, 500 bugs)
        try:
            if self.model_registry is not None:
                try:
                    future = self.model_registry.submit(tenant, x,
                                                        trace=trace)
                except KeyError as e:
                    with self._lock:
                        self._errors += 1
                    return 404, {"error": str(e)}, 0, tenant, None
            else:
                future = self.batcher.submit(x, trace=trace)
            wait_s = self._request_timeout_s
            if timeout_s is not None:
                wait_s = min(wait_s, timeout_s)
            out = future.result(timeout=wait_s)
        except Overloaded as e:
            # a shed is load, not failure: 429 (not 503) so callers — the
            # fleet router above all — don't burn retries on it, with the
            # batcher's computed drain estimate as Retry-After
            with self._lock:
                self._errors += 1
            payload = {"error": str(e)}
            headers = None
            ra = getattr(e, "retry_after_s", None)
            if ra:
                payload["retry_after_s"] = round(ra, 3)
                headers = {"Retry-After": format_retry_after(ra)}
            return 429, payload, 0, tenant, headers
        except (KeyError, CancelledError) as e:
            # the tenant was removed (or the batcher cancelled) while the
            # request was queued: retryable server-side condition, not a
            # malformed request
            with self._lock:
                self._errors += 1
            return 503, {"error": f"request dropped: {e}"}, 0, tenant, None
        except ValueError as e:
            # the engine rejected the batch (e.g. feature-width mismatch
            # discovered at dispatch) — the request itself was bad
            with self._lock:
                self._errors += 1
            return 400, {"error": str(e)}, 0, tenant, None
        except FuturesTimeout:
            # the wait budget (usually a router-propagated deadline) ran
            # out: the CALLER's condition, not a replica fault — 504, so a
            # fleet router doesn't score it into ejecting a healthy
            # replica the way a 500 would
            with self._lock:
                self._errors += 1
            return 504, {"error": f"deadline exceeded after {wait_s:.3f}s "
                         "waiting for the batch"}, 0, tenant, None
        except Exception as e:  # dispatch failure
            with self._lock:
                self._errors += 1
            return 500, {"error": f"{type(e).__name__}: {e}"}, 0, tenant, None
        with self._lock:
            self._requests += 1
        payload = {"outputs": {k: v.tolist() for k, v in out.items()}}
        if tenant is not None:
            payload["tenant"] = tenant
        return 200, payload, x.shape[0], tenant, None

    def health(self) -> Dict[str, Any]:
        with self._lock:
            draining = self._draining
        if self.model_registry is not None:
            doc = self.model_registry.health()
            doc.update(lanes=self.batcher.lanes,
                       uptime_s=round(time.time() - self._started, 1))
            if draining:
                doc["status"] = "draining"
            return doc
        st = self.engine.stats()
        return {
            "status": "draining" if draining else "ok",
            "model": st["model"],
            "n_particles": st["n_particles"],
            "feature_dim": st["feature_dim"],
            "devices": st["plan"]["num_shards"],
            "lanes": self.batcher.lanes,
            # generation identity: which posterior generation
            # answers this replica's traffic — the fleet router's /fleet
            # doc and tools/fleet_status.py surface it per replica so a
            # mid-rollout fleet is inspectable at a glance
            "generation_id": st["generation_id"],
            "previous_generation_id": st["previous_generation_id"],
            "uptime_s": round(time.time() - self._started, 1),
        }

    def tenant_health(self, name: str) -> Optional[Dict[str, Any]]:
        """Per-tenant ``/healthz/<name>`` detail (None when unknown or on
        a single-tenant server — the route 404s)."""
        if self.model_registry is None:
            return None
        try:
            stats = self.model_registry.stats()["tenants"][name]
        except KeyError:
            return None
        with self._lock:
            draining = self._draining
        return {"status": "draining" if draining else "ok",
                "tenant": name, **stats}

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            server_side = {"http_requests": self._requests, "http_errors": self._errors}
        if self.model_registry is not None:
            return {**server_side, "registry": self.model_registry.stats()}
        return {**server_side, "batcher": self.batcher.stats(),
                "engine": self.engine.stats()}

    def usage(self) -> Dict[str, Any]:
        """The ``/usage`` document: per-tenant cost accounting.  Reads
        the active meter's registry when metering is enabled (the CLI
        enables it on this server's registry, making them the same);
        otherwise this server's registry, whose empty ``svgd_usage_*``
        series yield an empty tenant map."""
        from dist_svgd_torch.telemetry import usage as _usage

        meter = _usage.get_meter()
        reg = meter.registry if meter is not None else self.registry
        return {"metering": meter is not None,
                **_usage.usage_summary(reg)}

    # ------------------------------------------------------------------ #

    def start(self) -> "PredictionServer":
        """Serve in a background thread (returns self for chaining)."""
        tracer = _trace.get_tracer()
        if tracer is not None:
            # best-effort self-labelling for trace stitching: a drill/CLI
            # that already declared an identity wins (only_if_default)
            host, port = self.address[:2]
            tracer.set_process("replica", f"{host}:{port}",
                               only_if_default=True)
        if self._serve_thread is None:
            self._serve_thread = threading.Thread(
                target=self._httpd.serve_forever, name="http-serve", daemon=True
            )
            self._serve_thread.start()
        if self.autoscale is not None and self.autoscale._thread is None:
            self.autoscale.start()
        return self

    def serve_forever(self) -> None:
        """Blocking serve (the CLI path); KeyboardInterrupt drains."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def begin_drain(self) -> None:
        """Flip ``/healthz`` to 503 ``"draining"`` without closing anything
        — the drain *signal*, separable from the drain itself so a fleet
        router (probing health) stops routing here before the socket
        disappears."""
        with self._lock:
            self._draining = True

    def shutdown(self) -> None:
        """Graceful drain: advertise draining on ``/healthz`` FIRST (a
        router must see the 503 while the socket still answers — ordering
        pinned by test), then stop accepting, finish in-flight handlers,
        flush the batcher queue (and, in registry mode, stop the
        checkpoint scanner and close the registry)."""
        self.begin_drain()
        if self.autoscale is not None:
            # stop retuning first: a controller acting on a draining
            # batcher would race the close below
            self.autoscale.stop()
        self._httpd.shutdown()
        # the idle keep-alive connections end now, the busy ones after
        # their reply (Connection: close while draining)
        self._httpd.close_idle()
        self._httpd.server_close()  # joins non-daemon handler threads
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
            self._serve_thread = None
        if self.model_registry is not None:
            self.model_registry.close(drain=True)
        else:
            self.batcher.close(drain=True)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()


def main(argv=None):
    """``python -m dist_svgd_torch.serving.server --checkpoint <dir> ...``
    (the card; ``--device cpu`` for the plain path)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", action="append", default=None,
                    help="checkpoint dir, CheckpointManager root, or repeat "
                         "the flag with every per-process path of one "
                         "multi-host save (single-tenant mode)")
    ap.add_argument("--tenants-config", default=None, metavar="PATH",
                    help="multi-tenant mode: JSON list of tenant specs "
                         '[{"name": ..., "model": ..., "checkpoint": ..., '
                         '"quota_rows": ..., "watch": true, ...}]; extra '
                         "keys go to the tenant's engine. Mutually "
                         "exclusive with --checkpoint")
    ap.add_argument("--max-total-buckets", type=int, default=64,
                    help="multi-tenant mode: process-wide LRU bound on "
                         "compiled kernel buckets across tenants")
    ap.add_argument("--scan-interval-s", type=float, default=5.0,
                    help="multi-tenant mode: shared checkpoint-scanner "
                         "cadence over the watched tenant roots")
    ap.add_argument("--model", choices=("logreg", "bnn", "gmm"), default="logreg")
    ap.add_argument("--n-features", type=int, default=None,
                    help="BNN input width (required for --model bnn)")
    ap.add_argument("--n-hidden", type=int, default=50)
    ap.add_argument("--kde-bandwidth", type=float, default=1.0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--lanes", type=int, default=1,
                    help="batcher dispatch worker lanes over the shared "
                         "queue (N frontend lanes, one engine)")
    ap.add_argument("--shards", type=int, default=1,
                    help="devices to shard the served ensemble across (0 = "
                         "every visible device; 1 = single-device).  Falls "
                         "back to one device when the host has fewer"),
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (fails without CUDA)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default=None,
                    help="opt-in low-precision serve kernels (the "
                         "ensemble is stored+computed in this dtype; "
                         "request/response stay f32)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-queue-rows", type=int, default=8192)
    ap.add_argument("--autoscale", action="store_true",
                    help="run the SLO-burn-driven capacity controller "
                         "(serving/autoscale.py): retunes batcher lanes, "
                         "the coalescing window, and tenant quotas live; "
                         "status at /autoscale")
    ap.add_argument("--autoscale-lanes-max", type=int, default=4)
    ap.add_argument("--autoscale-wait-max-ms", type=float, default=16.0)
    ap.add_argument("--autoscale-p99-ms", type=float, default=100.0,
                    help="the latency objective the controller defends")
    ap.add_argument("--autoscale-interval-s", type=float, default=0.25)
    ap.add_argument("--request-log", default=None,
                    help="JSONL per-request record path (utils/metrics.py)")
    ap.add_argument("--trace-export", default=None, metavar="PATH",
                    help="enable the span tracer for this replica's "
                         "lifetime and export a Chrome trace here on "
                         "shutdown (the replica-side half of a fleet "
                         "stitch — tools/trace_report.py --stitch)")
    ap.add_argument("--replica-name", default=None,
                    help="process-identity name stamped into trace "
                         "exports (default host:port)")
    ap.add_argument("--warmup", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="build every padding bucket's program up to "
                         "max-batch before binding the port")
    ap.add_argument("--usage-metering", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="per-tenant cost accounting (telemetry/usage.py) "
                         "on this replica's registry: /usage locally, "
                         "federated svgd_usage_* series fleet-wide")
    args = ap.parse_args(argv)

    from dist_svgd_torch.parallel.plan import make_plan
    from dist_svgd_torch.utils.metrics import JsonlLogger

    if (args.checkpoint is None) == (args.tenants_config is None):
        ap.error("pass exactly one of --checkpoint or --tenants-config")
    logger = JsonlLogger(path=args.request_log) if args.request_log else None
    if args.tenants_config:
        with open(args.tenants_config) as fh:
            specs = json.load(fh)
        reg = ModelRegistry(
            max_total_buckets=args.max_total_buckets,
            max_batch=args.max_batch, lanes=args.lanes,
            max_wait_ms=args.max_wait_ms,
            max_queue_rows=args.max_queue_rows,
            scan_interval_s=args.scan_interval_s,
        )
        for spec in specs:
            spec = dict(spec)
            spec.setdefault("device", args.device)
            reg.add_tenant(spec.pop("name"), spec.pop("model"), **spec)
        if args.warmup:
            warmed = reg.warm()
            print(json.dumps({"warmup_buckets": warmed}), flush=True)
        reg.start_scanner()
        srv = PredictionServer(reg, host=args.host, port=args.port,
                               logger=logger)
    else:
        source = (args.checkpoint[0] if len(args.checkpoint) == 1
                  else args.checkpoint)
        # 0 = every visible device; more than the host has degrades to one
        # device (make_plan), as in JAX
        plan = make_plan(args.shards or None, device=args.device)
        engine = PredictiveEngine.from_checkpoint(
            source, args.model, n_features=args.n_features,
            n_hidden=args.n_hidden, kde_bandwidth=args.kde_bandwidth,
            max_bucket=args.max_batch, plan=plan, dtype=args.dtype,
        )
        if args.warmup:
            compiled = engine.warmup()
            print(json.dumps({"warmup_buckets": compiled}), flush=True)
        srv = PredictionServer(
            engine, host=args.host, port=args.port, max_batch=args.max_batch,
            lanes=args.lanes, max_wait_ms=args.max_wait_ms,
            max_queue_rows=args.max_queue_rows, logger=logger,
        )
    if args.usage_metering:
        from dist_svgd_torch.telemetry import usage as _usage_mod

        # meter the server's own registry so /metrics.dump carries the
        # svgd_usage_* series and the fleet federation picks them up
        _usage_mod.enable_usage(registry=srv.registry)
    if args.trace_export:
        from dist_svgd_torch import telemetry

        tracer = telemetry.enable()
        tracer.set_process(
            "replica",
            args.replica_name or f"{args.host}:{args.port}")
    if args.autoscale:
        srv.autoscale = AutoscaleController(
            srv.batcher, metrics=srv.registry,
            model_registry=srv.model_registry,
            policy=AutoscalePolicy(
                lanes_max=args.autoscale_lanes_max,
                max_wait_ms_max=args.autoscale_wait_max_ms,
                p99_target_ms=args.autoscale_p99_ms,
            ),
        ).start(args.autoscale_interval_s)
    print(json.dumps({"serving": srv.url, **srv.health()}), flush=True)
    try:
        srv.serve_forever()
    finally:
        if args.trace_export:
            tracer = telemetry.disable()
            if tracer is not None:
                tracer.export_chrome(args.trace_export)


if __name__ == "__main__":
    main()
