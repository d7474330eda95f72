"""HTTP serving app on the stdlib (the counterpart of
``recsys_tpu/serve/app.py``), with the same endpoint contract:

* ``GET  /``                — service banner
* ``GET  /health``          — health / readiness
* ``GET  /model/info``      — model metadata
* ``GET  /metrics``         — Prometheus text (request counts, latency)
* ``POST /recommend``       — ``{user_id, k}`` -> ranked items
* ``POST /recommend/batch`` — ``{user_ids, k}``
* ``POST /score``           — ``{user_id, item_ids}`` -> scores
* ``POST /admin/reload``    — hot-swap the bundle (off without a factory)

Status codes: 503 when the model is not loaded, 404 for an unknown
user / item on ``/score``, for unknown paths and for ``/admin/reload``
without a service factory, 413 for an oversized body, 422 for an invalid
payload, 500 otherwise (and for a reload whose load failed: the old
bundle stays live).

Compute is single-flight (one lock), or, for ``/recommend`` under a
:class:`~recsys_tpu_torch.serve.batcher.MicroBatcher`, one dispatcher
thread that scores the concurrent requests as one batch.
:func:`serve_forever` runs this threaded server or the asyncio one
(``serve/aio.py``), in one process or in ``workers`` forked processes
behind one ``SO_REUSEPORT`` port.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from recsys_tpu_torch.serve.batcher import MicroBatcher
from recsys_tpu_torch.serve.service import (
    RecommendationService, StubRecommendationService,
)
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

MAX_K = 100
# request hardening shared by both transports (threaded here, asyncio in
# serve/aio.py): a declared body over this is refused unread, a header
# flood drops the connection, and a client that trickles bytes is dropped
# after the read timeout
MAX_BODY_BYTES = 1 << 20
MAX_HEADER_LINES = 64
READ_TIMEOUT_S = 30.0
MAX_SCORE_ITEMS = 100
MAX_BATCH_USERS = 1024


class ValidationError(Exception):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValidationError(msg)


class Telemetry:
    """Request counters + latency histograms in Prometheus text format."""

    BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, float("inf"))
    # bounded label set: client-controlled paths aggregate under "other"
    KNOWN_PATHS = frozenset({
        "/", "/health", "/model/info", "/metrics", "/recommend",
        "/recommend/batch", "/score", "/admin/reload",
    })

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: Dict[Tuple[str, int], int] = {}
        self._hist: Dict[str, list] = {}
        self._hist_sum: Dict[str, float] = {}

    def observe(self, path: str, code: int, seconds: float) -> None:
        path = path.split("?", 1)[0]
        if path not in self.KNOWN_PATHS:
            path = "other"
        with self._lock:
            key = (path, code)
            self._requests[key] = self._requests.get(key, 0) + 1
            h = self._hist.setdefault(path, [0] * len(self.BUCKETS_S))
            for i, le in enumerate(self.BUCKETS_S):
                if seconds <= le:
                    h[i] += 1
                    break
            self._hist_sum[path] = self._hist_sum.get(path, 0.0) + seconds

    def render(self, batcher=None) -> str:
        """The counters and histograms; with ``batcher`` (a MicroBatcher or
        the asyncio coalescer) its batch counters too."""
        lines = ["# TYPE recsys_requests_total counter"]
        with self._lock:
            for (path, code), n in sorted(self._requests.items()):
                lines.append(
                    f'recsys_requests_total{{path="{path}",code="{code}"}} {n}')
            lines.append("# TYPE recsys_request_latency_seconds histogram")
            for path, h in sorted(self._hist.items()):
                cum = 0
                for i, le in enumerate(self.BUCKETS_S):
                    cum += h[i]
                    le_s = "+Inf" if le == float("inf") else f"{le:g}"
                    lines.append("recsys_request_latency_seconds_bucket"
                                 f'{{path="{path}",le="{le_s}"}} {cum}')
                lines.append(
                    f'recsys_request_latency_seconds_count{{path="{path}"}} {cum}')
                lines.append("recsys_request_latency_seconds_sum"
                             f'{{path="{path}"}} {self._hist_sum[path]:.6f}')
        if batcher is not None:
            st = batcher.stats()
            lines += [
                "# TYPE recsys_microbatch_batches_total counter",
                f"recsys_microbatch_batches_total {st['n_batches']}",
                "# TYPE recsys_microbatch_requests_total counter",
                f"recsys_microbatch_requests_total {st['n_requests']}",
                "# TYPE recsys_microbatch_max_batch gauge",
                f"recsys_microbatch_max_batch {st['max_batch_seen']}",
            ]
        return "\n".join(lines) + "\n"


class Api:
    """Transport-independent endpoint implementations; each handler
    returns ``(status_code, payload_dict)``.

    ``batcher``: a started :class:`MicroBatcher`; ``/recommend`` then
    goes through it, so concurrent requests share one batched scoring
    call. ``service_factory() -> loaded service``: turns on
    ``POST /admin/reload``, which builds a fresh service from the
    (possibly retrained) bundle and swaps it in atomically. The endpoint
    is unauthenticated: expose it on trusted networks only."""

    def __init__(self, service: Optional[RecommendationService], batcher=None,
                 service_factory=None):
        self.service = service
        self.batcher = batcher
        self.service_factory = service_factory
        self.telemetry = Telemetry()
        self._reload_lock = threading.Lock()
        self.reload_count = 0
        # single-flight compute: on the device backend one request's
        # launches at a time; on the host backend GIL-bound numpy, which
        # concurrent handler threads would only convoy. The micro-batcher
        # has its own single dispatcher for /recommend.
        self._compute_lock = threading.Lock()

    def admin_reload(self) -> Tuple[int, Dict]:
        if self.service_factory is None:
            return 404, {"detail": "not found"}
        with self._reload_lock:  # one reload at a time
            old_version = (self.service.get_model_info().get("bundle_mtime")
                           if self._ready() else None)
            try:
                new_service = self.service_factory()
            except Exception as e:  # a failed load keeps the old bundle live
                logger.exception("hot reload failed; the old bundle stays live")
                return 500, {"detail": f"reload failed: {e}"}
            new_batcher = None
            if self.batcher is not None:
                new_batcher = MicroBatcher(
                    new_service, max_batch=self.batcher.max_batch,
                    max_wait_ms=self.batcher.max_wait_s * 1000.0,
                    timeout_s=self.batcher.timeout_s).start()
            old_batcher = self.batcher
            # attribute stores are atomic: requests in flight finish on the
            # service and batcher they already read
            self.service = new_service
            self.batcher = new_batcher
            self.reload_count += 1
            if old_batcher is not None:
                old_batcher.stop()  # drains; stragglers get an error
            return 200, {
                "reloaded": True,
                "reload_count": self.reload_count,
                "previous_bundle_mtime": old_version,
                "model_info": new_service.get_model_info(),
            }

    def _ready(self) -> bool:
        return bool(self.service and self.service.is_ready())

    def root(self) -> Tuple[int, Dict]:
        return 200, {
            "service": "recsys_tpu_torch recommendation API",
            "version": "1.0.0",
            "endpoints": ["/health", "/model/info", "/metrics", "/recommend",
                          "/recommend/batch", "/score"],
        }

    def health(self) -> Tuple[int, Dict]:
        ready = self._ready()
        return 200, {
            "status": "healthy" if ready else "degraded",
            "model_loaded": ready,
            "model_version": self.service.model_version if ready else None,
        }

    def model_info(self) -> Tuple[int, Dict]:
        if not self._ready():
            return 503, {"detail": "Model not loaded"}
        return 200, self.service.get_model_info()

    def recommend(self, body: Dict) -> Tuple[int, Dict]:
        if not self._ready():
            return 503, {"detail": "Model not loaded"}
        _require(isinstance(body.get("user_id"), int), "user_id must be int")
        k = body.get("k", 10)
        _require(isinstance(k, int) and 1 <= k <= MAX_K,
                 f"k must be int in [1, {MAX_K}]")
        service, batcher = self.service, self.batcher
        if batcher is not None:
            recs = batcher.recommend(body["user_id"], k)
        else:
            with self._compute_lock:
                recs = service.recommend(body["user_id"], k)
        return 200, {
            "user_id": body["user_id"],
            "recommendations": recs,
            "count": len(recs),
            "model_version": service.model_version,
        }

    def recommend_batch(self, body: Dict) -> Tuple[int, Dict]:
        if not self._ready():
            return 503, {"detail": "Model not loaded"}
        users = body.get("user_ids")
        _require(
            isinstance(users, list) and 1 <= len(users) <= MAX_BATCH_USERS
            and all(isinstance(u, int) for u in users),
            f"user_ids must be a list of 1..{MAX_BATCH_USERS} ints",
        )
        k = body.get("k", 10)
        _require(isinstance(k, int) and 1 <= k <= MAX_K,
                 f"k must be int in [1, {MAX_K}]")
        with self._compute_lock:
            results = self.service.recommend_batch(users, k)
        return 200, {
            "results": results,
            "count": len(results),
            "model_version": self.service.model_version,
        }

    def score(self, body: Dict) -> Tuple[int, Dict]:
        if not self._ready():
            return 503, {"detail": "Model not loaded"}
        _require(isinstance(body.get("user_id"), int), "user_id must be int")
        items = body.get("item_ids")
        _require(
            isinstance(items, list) and 1 <= len(items) <= MAX_SCORE_ITEMS
            and all(isinstance(i, int) for i in items),
            f"item_ids must be a list of 1..{MAX_SCORE_ITEMS} ints",
        )
        try:
            with self._compute_lock:
                scores = self.service.score(body["user_id"], items)
        except ValueError as e:  # unknown user / item -> 404
            return 404, {"detail": str(e)}
        return 200, {
            "user_id": body["user_id"],
            "scores": scores,
            "model_version": self.service.model_version,
        }

    def dispatch(self, method: str, path: str,
                 body: Optional[Dict]) -> Tuple[int, Dict]:
        try:
            if method == "GET":
                if path == "/":
                    return self.root()
                if path == "/health":
                    return self.health()
                if path == "/model/info":
                    return self.model_info()
            elif method == "POST":
                if path == "/admin/reload":  # a body-less admin action
                    return self.admin_reload()
                if body is None:
                    return 422, {"detail": "invalid or missing JSON body"}
                if path == "/recommend":
                    return self.recommend(body)
                if path == "/recommend/batch":
                    return self.recommend_batch(body)
                if path == "/score":
                    return self.score(body)
            return 404, {"detail": "not found"}
        except ValidationError as e:
            return 422, {"detail": str(e)}
        except Exception as e:  # the 500 contract: the server keeps running
            logger.exception("internal error on %s %s", method, path)
            return 500, {"detail": f"internal error: {e}"}


def make_http_server(service: Optional[RecommendationService],
                     host: str = "0.0.0.0", port: int = 8000,
                     reuse_port: bool = False, batcher=None,
                     service_factory=None) -> ThreadingHTTPServer:
    """A threaded HTTP server over :class:`Api` (``port=0`` picks a free
    port; read it from ``server.server_address``). ``reuse_port`` binds
    with ``SO_REUSEPORT`` (forked workers share one port); ``batcher``
    and ``service_factory`` as :class:`Api` takes them."""
    api = Api(service, batcher=batcher, service_factory=service_factory)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive (Content-Length always sent)
        disable_nagle_algorithm = True
        # a client that trickles bytes or never sends its declared body
        # is dropped instead of pinning a handler thread
        timeout = READ_TIMEOUT_S

        def _send(self, code: int, data: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(data)

        def _respond(self, code: int, payload: Dict) -> None:
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, api.telemetry.render(batcher=api.batcher).encode(),
                           "text/plain; version=0.0.4")
                return
            t0 = time.perf_counter()
            code, payload = api.dispatch("GET", self.path, None)
            api.telemetry.observe(self.path, code, time.perf_counter() - t0)
            self._respond(code, payload)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = -1
            if length < 0:
                self._respond(422, {"detail": "malformed Content-Length"})
                self.close_connection = True
                return
            if length > MAX_BODY_BYTES:
                self._respond(413, {"detail": "body too large"})
                self.close_connection = True
                return
            try:
                raw = self.rfile.read(length) if length else b""
            except OSError:  # includes the socket read timeout
                self.close_connection = True
                return
            if len(raw) < length:  # client closed mid-body
                self.close_connection = True
                return
            try:
                body = json.loads(raw) if raw else None
            except json.JSONDecodeError:
                body = None
            t0 = time.perf_counter()
            code, payload = api.dispatch("POST", self.path, body)
            api.telemetry.observe(self.path, code, time.perf_counter() - t0)
            self._respond(code, payload)

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s - %s", self.address_string(), fmt % args)

    class Server(ThreadingHTTPServer):
        request_queue_size = 128  # the default backlog of 5 resets bursts

        def server_bind(self):
            if reuse_port:
                self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            super().server_bind()

    server = Server((host, port), Handler)
    server.api = api
    return server


def _serve_one(model_dir: str, host: str, port: int, reuse_port: bool, stub: bool,
               microbatch: int, microbatch_wait_ms: float, allow_reload: bool,
               server: str, device: DeviceLike, **service_kw) -> None:
    """One serving process: load, then serve until killed. A bundle that
    fails to load gives the degraded server (503s, and ``/admin/reload``
    when allowed); a card asked for and absent raises instead."""
    if stub:
        service: Optional[RecommendationService] = StubRecommendationService(device=device)
    else:
        if service_kw.get("backend") != "native":
            # a missing device is not a broken bundle: fail now, not with 503s
            resolve_device(device)

        def make_service() -> RecommendationService:
            return RecommendationService(model_dir, device=device, **service_kw).load()

        service = None
        try:
            service = make_service()
        except Exception:  # the startup-failure contract: serve 503s
            logger.exception("model load failed; serving in degraded mode (503s)")
    factory = make_service if (allow_reload and not stub) else None
    if server == "asyncio":
        from recsys_tpu_torch.serve.aio import AioHttpServer

        srv = AioHttpServer(service, host, port, reuse_port=reuse_port,
                            max_batch=microbatch or 256, max_wait_ms=microbatch_wait_ms,
                            service_factory=factory)
        logger.info("serving (asyncio) on %s:%d (model_dir=%s)", host, port, model_dir)
        srv.serve_forever()
        return
    batcher = None
    if microbatch > 0 and service is not None:
        batcher = MicroBatcher(service, max_batch=microbatch,
                               max_wait_ms=microbatch_wait_ms).start()
    http_server = make_http_server(service, host, port, reuse_port=reuse_port,
                                   batcher=batcher, service_factory=factory)
    logger.info("serving on %s:%d (model_dir=%s, microbatch=%d)", host, port, model_dir,
                microbatch)
    try:
        http_server.serve_forever()
    finally:
        http_server.server_close()


def _signal_all(pids, sig) -> None:
    for pid in pids:
        try:
            os.kill(pid, sig)
        except ProcessLookupError:
            pass


def serve_forever(model_dir: str, host: str = "0.0.0.0", port: int = 8000, *,
                  workers: int = 1, stub: bool = False, rerank_candidates: int = 0,
                  rerank_ctr_weight: float = 0.25, rerank_rating_weight: float = 0.0,
                  microbatch: int = 0, microbatch_wait_ms: float = 0.0,
                  backend: str = "auto", int8_catalog: bool = False,
                  allow_reload: bool = False, server: str = "threaded",
                  device: DeviceLike = "cuda",
                  exported_path: Optional[str] = None) -> int:
    """Load the inference bundle and serve until killed. If the bundle
    fails to load, the server still starts and answers 503s (the
    startup-failure contract); a card asked for and absent raises.

    ``workers > 1`` forks that many processes, each loading its own copy
    of the bundle after the fork and listening on the same port with
    ``SO_REUSEPORT``; the kernel spreads the connections. The parent
    touches no CUDA state before forking (a forked child cannot use a
    CUDA context its parent created), reaps the workers on SIGTERM or
    SIGINT and returns 0, and stops them all and returns 1 as soon as
    one exits with an error (a missing card, for instance)."""
    kw = dict(stub=stub, microbatch=microbatch, microbatch_wait_ms=microbatch_wait_ms,
              allow_reload=allow_reload, server=server, device=device, backend=backend,
              rerank_candidates=rerank_candidates, rerank_ctr_weight=rerank_ctr_weight,
              rerank_rating_weight=rerank_rating_weight, int8_catalog=int8_catalog,
              exported_path=exported_path)
    if workers <= 1:
        _serve_one(model_dir, host, port, reuse_port=False, **kw)
        return 0
    pids = set()
    for _ in range(workers):
        pid = os.fork()
        if pid == 0:  # the worker: never returns into the parent's code
            rc = 1
            try:
                _serve_one(model_dir, host, port, reuse_port=True, **kw)
                rc = 0
            except Exception:
                logger.exception("serving worker %d failed", os.getpid())
            finally:
                os._exit(rc)
        pids.add(pid)
    logger.info("forked %d serving workers on %s:%d", workers, host, port)
    stopping = []

    def _reap(signum, frame):
        stopping.append(signum)
        _signal_all(pids, signal.SIGTERM)

    signal.signal(signal.SIGTERM, _reap)
    signal.signal(signal.SIGINT, _reap)
    rc = 0
    while pids:
        try:
            pid, status = os.wait()
        except ChildProcessError:
            break
        pids.discard(pid)
        code = os.waitstatus_to_exitcode(status)
        if code != 0 and not stopping:
            logger.error("serving worker %d exited with %d; stopping the others", pid, code)
            rc = 1
            stopping.append(None)
            _signal_all(pids, signal.SIGTERM)
    return rc
