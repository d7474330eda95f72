"""Dynamic request micro-batching for the serving layer (the counterpart
of ``recsys_tpu/serve/batcher.py``).

:class:`MicroBatcher` coalesces concurrent single-user ``recommend``
calls into one ``recommend_batch`` call. On the device backend each
single-user request otherwise pays the whole host overhead of a scoring
call (the tower, the top-k and rerank launches and their copies) behind
the HTTP layer's compute lock; a batch pays it once.

Scheduling policy, *drain-what's-there*:

* when the dispatcher is idle and a request arrives, it is served at
  once (no added latency at low load);
* while a batch is in flight, new arrivals queue up and the next
  dispatch takes all of them (up to ``max_batch``), so the batch size
  follows the load;
* ``max_wait_ms > 0`` holds the first request of a batch that long to
  let more arrive, trading p50 latency for larger batches.

Per-request ``k`` may differ: the batch is scored once at ``max(k)`` and
each response is sliced to its own ``k`` (the first ``k`` of a
top-``k_max`` ranking is the top ``k``).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("user_id", "k", "event", "result", "exc")

    def __init__(self, user_id: int, k: int):
        self.user_id = user_id
        self.k = k
        self.event = threading.Event()
        self.result: Optional[List[Dict]] = None
        self.exc: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent ``recommend`` calls into batched scoring.

    Thread-safe; ``recommend`` blocks the calling (handler) thread until
    its batch completes. Start and stop the dispatcher explicitly, or use
    it as a context manager.
    """

    def __init__(self, service, max_batch: int = 256,
                 max_wait_ms: float = 0.0, timeout_s: float = 30.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.service = service
        self.max_batch = int(max_batch)
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1000.0
        self.timeout_s = float(timeout_s)
        self._queue: deque[_Pending] = deque()
        self._cond = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # observability: dispatches, requests, the largest batch
        self.n_batches = 0
        self.n_requests = 0
        self.max_seen_batch = 0

    # ---- lifecycle --------------------------------------------------
    def start(self) -> "MicroBatcher":
        with self._cond:
            if self._running:
                return self
            if self._thread is not None and self._thread.is_alive():
                raise RuntimeError("previous micro-batcher dispatcher has not exited")
            self._running = True
        self._thread = threading.Thread(target=self._loop, name="microbatcher", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if self._thread.is_alive():
                # the dispatcher is stuck in a backend call: keep the handle
                # so that a later start() cannot run two dispatchers at once
                logger.warning("micro-batcher dispatcher did not exit within 5 s; "
                               "restart refused until it does")
            else:
                self._thread = None
        # fail the stragglers rather than hang their handler threads
        with self._cond:
            while self._queue:
                p = self._queue.popleft()
                p.exc = RuntimeError("micro-batcher stopped")
                p.event.set()

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- request path ----------------------------------------------
    def recommend(self, user_id: int, k: int = 10) -> List[Dict]:
        """Single-user recommend with ``RecommendationService.recommend``'s
        contract (cold-start fallback included), scored in the next
        micro-batch."""
        p = _Pending(int(user_id), int(k))
        with self._cond:
            if not self._running:
                raise RuntimeError("micro-batcher not started")
            self._queue.append(p)
            self._cond.notify_all()
        if not p.event.wait(self.timeout_s):
            # withdraw the request, so that an abandoned entry takes no
            # slot of a later batch during a backend stall
            with self._cond:
                try:
                    self._queue.remove(p)
                    abandoned = True
                except ValueError:
                    # already dequeued: completed since the wait expired, or
                    # in flight in the backend
                    abandoned = not p.event.is_set()
            if abandoned:
                raise TimeoutError("micro-batch dispatch timed out")
        if p.exc is not None:
            raise p.exc
        return p.result

    # ---- dispatcher -------------------------------------------------
    def _take_batch(self) -> List[_Pending]:
        """Block until work exists; then linger up to ``max_wait_s`` for
        the batch to grow, and pop at most ``max_batch``."""
        with self._cond:
            # untimed: every producer and stop() notify under this lock
            while self._running and not self._queue:
                self._cond.wait()
            if not self._running:
                return []
            if self.max_wait_s > 0.0:
                deadline = time.monotonic() + self.max_wait_s
                while len(self._queue) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0.0 or not self._running:
                        break
                    self._cond.wait(remaining)
            batch = []
            while self._queue and len(batch) < self.max_batch:
                batch.append(self._queue.popleft())
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                with self._cond:
                    if not self._running:
                        return
                continue
            self._process(batch)

    def _process(self, batch: List[_Pending]) -> None:
        with self._cond:  # /metrics reads the stats from handler threads
            self.n_batches += 1
            self.n_requests += len(batch)
            self.max_seen_batch = max(self.max_seen_batch, len(batch))
        try:
            k_max = max(p.k for p in batch)
            rows = self.service.recommend_batch([p.user_id for p in batch], k_max)
            for p, row in zip(batch, rows):
                p.result = row["recommendations"][:p.k]
        except Exception as e:  # the dispatcher keeps running; each caller raises it
            for p in batch:
                p.exc = e
        finally:
            for p in batch:
                p.event.set()

    def stats(self) -> Dict:
        with self._cond:
            n = max(self.n_batches, 1)
            return {
                "n_batches": self.n_batches,
                "n_requests": self.n_requests,
                "mean_batch": self.n_requests / n,
                "max_batch_seen": self.max_seen_batch,
            }
