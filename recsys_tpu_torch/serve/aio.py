"""Asyncio HTTP frontend for the serving API (the counterpart of
``recsys_tpu/serve/aio.py``; ``python -m recsys_tpu_torch.serve
--server asyncio``).

One event-loop thread and nothing else:

* nonblocking HTTP/1.1 keep-alive parsing on asyncio streams;
* scoring runs synchronously in the loop: there is no thread handoff,
  and the loop's single thread is the single-flight policy the threaded
  server needs its compute lock for;
* loop-native coalescing of ``/recommend`` (:class:`LoopCoalescer`):
  requests that arrive while a batch is scored wait in the sockets'
  buffers, their callbacks run when the loop next turns, and
  ``loop.call_soon`` flushes all that one turn collected as one
  ``recommend_batch`` call. The batch size follows the load; a lone
  request flushes at once as a batch of one.

The endpoint contract, status codes, validation messages and request
hardening (``MAX_BODY_BYTES``, ``MAX_HEADER_LINES``, ``READ_TIMEOUT_S``)
are the threaded server's: both go through one
:class:`~recsys_tpu_torch.serve.app.Api`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Dict, List, Optional

from recsys_tpu_torch.serve.app import (
    MAX_BODY_BYTES, MAX_HEADER_LINES, MAX_K, READ_TIMEOUT_S, Api,
)

logger = logging.getLogger(__name__)

_REASONS = {200: "OK", 404: "Not Found", 413: "Payload Too Large",
            422: "Unprocessable Entity", 500: "Internal Server Error",
            503: "Service Unavailable"}


class LoopCoalescer:
    """Event-loop-native dynamic batching of single-user recommends.

    The policy of :class:`~recsys_tpu_torch.serve.batcher.MicroBatcher`
    (drain what is there, each request's ``k`` sliced from one
    ``max(k)`` scoring call, the same ``stats()`` for ``/metrics``), but
    scheduled by the event loop: no dispatcher thread, no handoff. Use
    it from the loop's thread only.
    """

    def __init__(self, service, max_batch: int = 256, max_wait_ms: float = 0.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.service = service
        self.max_batch = int(max_batch)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1000.0
        self._pending: List[tuple] = []  # (future, user_id, k)
        self._flush_scheduled = False
        self.n_batches = 0
        self.n_requests = 0
        self.max_seen_batch = 0

    async def recommend(self, user_id: int, k: int = 10) -> List[Dict]:
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((fut, int(user_id), int(k)))
        if not self._flush_scheduled:
            self._flush_scheduled = True
            if self.max_wait_s > 0.0:
                loop.call_later(self.max_wait_s, self._flush)
            else:
                # after every callback already queued this turn: every
                # connection whose bytes are here may join the batch
                loop.call_soon(self._flush)
        return await fut

    def _flush(self) -> None:
        self._flush_scheduled = False
        batch = self._pending[:self.max_batch]
        self._pending = self._pending[self.max_batch:]
        if self._pending:  # past max_batch: the next turn
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush)
        if not batch:
            return
        self.n_batches += 1
        self.n_requests += len(batch)
        self.max_seen_batch = max(self.max_seen_batch, len(batch))
        try:
            k_max = max(k for _, _, k in batch)
            rows = self.service.recommend_batch([u for _, u, _ in batch], k_max)
            for (fut, _, k), row in zip(batch, rows):
                if not fut.done():
                    fut.set_result(row["recommendations"][:k])
        except Exception as e:  # the loop keeps running; each caller raises it
            for fut, _, _ in batch:
                if not fut.done():
                    fut.set_exception(e)

    def stats(self) -> Dict:
        n = max(self.n_batches, 1)
        return {
            "n_batches": self.n_batches,
            "n_requests": self.n_requests,
            "mean_batch": self.n_requests / n,
            "max_batch_seen": self.max_seen_batch,
        }


class AioHttpServer:
    """Single-threaded asyncio HTTP/1.1 server over an :class:`Api`
    (``port=0`` picks a free port; ``bound_port`` has it once bound)."""

    def __init__(self, service, host: str = "0.0.0.0", port: int = 8000,
                 reuse_port: bool = False, max_batch: int = 256,
                 max_wait_ms: float = 0.0, service_factory=None):
        self.api = Api(service, batcher=None, service_factory=service_factory)
        self.host = host
        self.port = port
        self.reuse_port = reuse_port
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self.coalescer = (LoopCoalescer(service, max_batch=max_batch, max_wait_ms=max_wait_ms)
                          if service is not None else None)
        self.bound_port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopped: Optional[asyncio.Event] = None

    # ---- request handling -------------------------------------------
    async def _respond(self, writer, code: int, data: bytes,
                       content_type: str = "application/json", keep: bool = True) -> None:
        hdr = (f"HTTP/1.1 {code} {_REASONS.get(code, 'OK')}\r\n"
               f"Content-Type: {content_type}\r\n"
               f"Content-Length: {len(data)}\r\n"
               "Access-Control-Allow-Origin: *\r\n"
               + ("" if keep else "Connection: close\r\n") + "\r\n").encode("latin1")
        writer.write(hdr + data)
        await writer.drain()

    async def _handle_conn(self, reader, writer) -> None:
        try:
            while True:
                line = await asyncio.wait_for(reader.readline(), READ_TIMEOUT_S)
                if not line or line in (b"\r\n", b"\n"):
                    break
                try:
                    method, path, version = line.decode("latin1").split(" ", 2)
                except ValueError:
                    break
                # HTTP/1.0 closes by default, 1.1 keeps alive
                length, n_headers = 0, 0
                keep = "1.0" not in version
                while True:
                    h = await asyncio.wait_for(reader.readline(), READ_TIMEOUT_S)
                    if h in (b"\r\n", b"\n", b""):
                        break
                    n_headers += 1
                    if n_headers > MAX_HEADER_LINES:
                        return  # a header flood: drop the connection
                    name, _, val = h.decode("latin1").partition(":")
                    ln = name.strip().lower()
                    if ln == "content-length":
                        try:
                            length = int(val.strip())
                        except ValueError:
                            length = 0
                    elif ln == "connection" and val.strip().lower() == "close":
                        keep = False
                if length < 0:  # malformed; never readexactly(-1)
                    break
                if length > MAX_BODY_BYTES:
                    await self._respond(writer, 413,
                                        json.dumps({"detail": "body too large"}).encode(),
                                        keep=False)
                    break
                raw = (await asyncio.wait_for(reader.readexactly(length), READ_TIMEOUT_S)
                       if length else b"")
                path = path.split("?", 1)[0]
                try:
                    body = json.loads(raw) if raw else None
                except json.JSONDecodeError:
                    body = None

                if method == "GET" and path == "/metrics":
                    data = self.api.telemetry.render(batcher=self.coalescer).encode()
                    await self._respond(writer, 200, data, "text/plain; version=0.0.4", keep)
                    if not keep:
                        break
                    continue

                t0 = time.perf_counter()
                code, payload = await self._dispatch(method, path, body)
                self.api.telemetry.observe(path, code, time.perf_counter() - t0)
                await self._respond(writer, code, json.dumps(payload).encode(), keep=keep)
                if not keep:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError,
                asyncio.TimeoutError, asyncio.LimitOverrunError, ValueError):
            # a line over the stream's 64 KiB limit, a closed or slow
            # client: drop the connection quietly
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):  # the peer is already gone
                pass

    async def _dispatch(self, method, path, body):
        """``Api.dispatch`` with the coalesced ``/recommend`` path."""
        api = self.api
        if (method == "POST" and path == "/recommend" and self.coalescer is not None
                and body is not None and api.service is not None and api.service.is_ready()):
            # Api.recommend's validation, message for message
            if not isinstance(body.get("user_id"), int):
                return 422, {"detail": "user_id must be int"}
            k = body.get("k", 10)
            if not (isinstance(k, int) and 1 <= k <= MAX_K):
                return 422, {"detail": f"k must be int in [1, {MAX_K}]"}
            service = api.service
            try:
                recs = await self.coalescer.recommend(body["user_id"], k)
            except Exception as e:  # the 500 contract
                logger.exception("internal error on POST /recommend")
                return 500, {"detail": f"internal error: {e}"}
            return 200, {
                "user_id": body["user_id"],
                "recommendations": recs,
                "count": len(recs),
                "model_version": service.model_version,
            }
        code, payload = api.dispatch(method, path, body)
        if path == "/admin/reload" and code == 200:
            # the reload swapped api.service: retarget the coalescer, or
            # create it where the server started degraded
            if self.coalescer is None:
                self.coalescer = LoopCoalescer(api.service, max_batch=self._max_batch,
                                               max_wait_ms=self._max_wait_ms)
            else:
                self.coalescer.service = api.service
        return code, payload

    # ---- lifecycle ---------------------------------------------------
    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stopped = asyncio.Event()
        server = await asyncio.start_server(
            self._handle_conn, self.host, self.port,
            reuse_port=self.reuse_port or None, backlog=128)
        self.bound_port = server.sockets[0].getsockname()[1]
        logger.info("asyncio serving on %s:%d", self.host, self.bound_port)
        try:
            await self._stopped.wait()
        finally:
            # open keep-alive connections are cancelled as asyncio.run ends
            server.close()

    def serve_forever(self) -> None:
        """Serve in this thread until :meth:`shutdown`."""
        asyncio.run(self._main())

    def shutdown(self) -> None:
        """Stop :meth:`serve_forever` from another thread."""
        self._loop.call_soon_threadsafe(self._stopped.set)
