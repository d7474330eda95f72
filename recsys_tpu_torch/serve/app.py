"""HTTP serving app on the stdlib, one threaded worker (the counterpart
of ``recsys_tpu/serve/app.py``), with the same endpoint contract:

* ``GET  /``                — service banner
* ``GET  /health``          — health / readiness
* ``GET  /model/info``      — model metadata
* ``GET  /metrics``         — Prometheus text (request counts, latency)
* ``POST /recommend``       — ``{user_id, k}`` -> ranked items
* ``POST /recommend/batch`` — ``{user_ids, k}``
* ``POST /score``           — ``{user_id, item_ids}`` -> scores

Status codes: 503 when the model is not loaded, 404 for an unknown
user / item on ``/score`` and for unknown paths, 413 for an oversized
body, 422 for an invalid payload, 500 otherwise.

Compute is single-flight (one lock): the device runs one request's
kernels at a time, and ``/recommend/batch`` is the throughput path. The
micro-batcher, the asyncio transport, hot reload and forked workers are
not ported yet.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from recsys_tpu_torch.serve.service import (
    RecommendationService, StubRecommendationService,
)
from recsys_tpu_torch.utils.device import DeviceLike

logger = logging.getLogger(__name__)

MAX_K = 100
MAX_BODY_BYTES = 1 << 20
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
        "/recommend/batch", "/score",
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

    def render(self) -> str:
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
        return "\n".join(lines) + "\n"


class Api:
    """Transport-independent endpoint implementations; each handler
    returns ``(status_code, payload_dict)``."""

    def __init__(self, service: Optional[RecommendationService]):
        self.service = service
        self.telemetry = Telemetry()
        self._compute_lock = threading.Lock()

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
        with self._compute_lock:
            recs = self.service.recommend(body["user_id"], k)
        return 200, {
            "user_id": body["user_id"],
            "recommendations": recs,
            "count": len(recs),
            "model_version": self.service.model_version,
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
                     ) -> ThreadingHTTPServer:
    """A threaded HTTP server over :class:`Api` (``port=0`` picks a free
    port; read it from ``server.server_address``)."""
    api = Api(service)

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
                self._send(200, api.telemetry.render().encode(),
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

    return Server((host, port), Handler)


def serve_forever(model_dir: str, host: str = "0.0.0.0", port: int = 8000,
                  stub: bool = False, rerank_candidates: int = 0,
                  rerank_ctr_weight: float = 0.25,
                  rerank_rating_weight: float = 0.0,
                  int8_catalog: bool = False,
                  device: DeviceLike = "cuda", backend: str = "auto",
                  exported_path: Optional[str] = None) -> None:
    """Load the inference bundle and serve. If the model fails to load,
    the server still starts and answers 503s (the startup-failure
    contract)."""
    service: Optional[RecommendationService] = None
    if stub:
        service = StubRecommendationService(device=device)
    else:
        try:
            service = RecommendationService(
                model_dir, backend=backend, rerank_candidates=rerank_candidates,
                rerank_ctr_weight=rerank_ctr_weight,
                rerank_rating_weight=rerank_rating_weight,
                int8_catalog=int8_catalog, device=device, exported_path=exported_path,
            ).load()
        except Exception:
            logger.exception("model load failed; serving in degraded mode (503s)")
    server = make_http_server(service, host, port)
    logger.info("serving on %s:%d (model_dir=%s)", host, port, model_dir)
    try:
        server.serve_forever()
    finally:
        server.server_close()
