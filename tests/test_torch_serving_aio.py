"""The asyncio frontend of the port (``serve/aio.py``) held to the
contract of ``tests/test_serving_aio.py``, on the CPU: the same
(status, payload) as the threaded server for one request matrix (both
transports over one service), the request hardening of both transports,
keep-alive, loop-native coalescing with its ``/metrics`` series, the
degraded start (503) and its coalescer created by ``/admin/reload``.
Coalesced answers equal direct ones in ids and order, scores within 1e-6
(another batch size sums the products in another order).
"""

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from recsys_tpu_torch.serve.aio import AioHttpServer, LoopCoalescer
from recsys_tpu_torch.serve.app import READ_TIMEOUT_S, make_http_server
from recsys_tpu_torch.serve.service import RecommendationService
from test_torch_serving_batcher import ITEM_RAW, USER_RAW, served  # noqa: F401


def _start_aio(service, **kw):
    srv = AioHttpServer(service, host="127.0.0.1", port=0, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    for _ in range(400):
        if srv.bound_port:
            return srv, t
        time.sleep(0.025)
    raise RuntimeError("the asyncio server did not bind")


def _stop_aio(srv, t):
    srv.shutdown()
    t.join(10)
    assert not t.is_alive()


def _req(port, method, path, body=None, conn=None):
    c = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    payload = json.dumps(body) if body is not None else None
    headers = {"Content-Type": "application/json"} if payload else {}
    c.request(method, path, body=payload, headers=headers)
    r = c.getresponse()
    data = r.read()
    out = (r.status, json.loads(data) if r.getheader("Content-Type", "").startswith(
        "application/json") else data.decode())
    if conn is None:
        c.close()
    return out


@pytest.fixture(scope="module")
def aio_server(served):  # noqa: F811
    svc, _ = served
    srv, t = _start_aio(svc)
    yield srv
    _stop_aio(srv, t)


@pytest.fixture(scope="module")
def threaded_server(served):  # noqa: F811
    svc, _ = served
    srv = make_http_server(svc, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture(params=["aio", "threaded"])
def any_server_port(request, aio_server, threaded_server):
    """Both transports clear the same hardening bar."""
    if request.param == "aio":
        return aio_server.bound_port
    return threaded_server.server_address[1]


def test_hardening_oversized_body_rejected_unbuffered(any_server_port):
    s = socket.create_connection(("127.0.0.1", any_server_port), timeout=10)
    try:
        s.sendall(b"POST /recommend HTTP/1.1\r\nContent-Length: 99999999\r\n\r\n")
        assert b"413" in s.recv(4096).split(b"\r\n", 1)[0]
    finally:
        s.close()


def test_hardening_survives_garbage_and_half_requests(any_server_port):
    for payload in (b"NONSENSE\r\n\r\n",
                    b"POST /recommend HTTP/1.1\r\nContent-Length: 50\r\n\r\n{\"unfinished",
                    b"POST /recommend HTTP/1.1\r\nContent-Length: -1\r\n\r\n"):
        s = socket.create_connection(("127.0.0.1", any_server_port), timeout=10)
        s.sendall(payload)
        s.close()
    code, body = _req(any_server_port, "POST", "/recommend",
                      {"user_id": int(USER_RAW[0]), "k": 2})
    assert code == 200 and len(body["recommendations"]) == 2


def test_aio_drops_a_header_flood(aio_server):
    from recsys_tpu_torch.serve.app import MAX_HEADER_LINES

    s = socket.create_connection(("127.0.0.1", aio_server.bound_port), timeout=10)
    try:
        s.sendall(b"GET /health HTTP/1.1\r\n"
                  + b"".join(b"X-H%d: 1\r\n" % i for i in range(MAX_HEADER_LINES + 1))
                  + b"\r\n")
        assert s.recv(4096) == b""  # closed without an answer
    finally:
        s.close()
    assert _req(aio_server.bound_port, "GET", "/health")[0] == 200


def test_threaded_read_timeout_configured(threaded_server):
    """socketserver applies ``timeout`` to each connection, so a trickling
    client cannot pin a handler thread past READ_TIMEOUT_S (the 30 s wait
    itself is not run here)."""
    assert threaded_server.RequestHandlerClass.timeout == READ_TIMEOUT_S


def test_aio_contract_matches_threaded(aio_server, threaded_server):
    """The same requests give the same (status, payload) on both
    transports over one service."""
    uid, item = int(USER_RAW[0]), int(ITEM_RAW[0])
    matrix = [
        ("GET", "/", None),
        ("GET", "/health", None),
        ("GET", "/model/info", None),
        ("POST", "/recommend", {"user_id": uid, "k": 5}),
        ("POST", "/recommend", {"user_id": "1", "k": 5}),        # 422
        ("POST", "/recommend", {"user_id": uid, "k": 0}),        # 422
        ("POST", "/recommend", {"user_id": 99_999, "k": 3}),     # cold start
        ("POST", "/recommend/batch", {"user_ids": [uid], "k": 3}),
        ("POST", "/recommend/batch", {"user_ids": "x"}),         # 422
        ("POST", "/score", {"user_id": uid, "item_ids": [item]}),
        ("POST", "/score", {"user_id": 99_999, "item_ids": [item]}),  # 404
        ("POST", "/nope", {"x": 1}),                             # 404
        ("POST", "/admin/reload", None),                         # 404 (no factory)
    ]
    for method, path, body in matrix:
        a = _req(aio_server.bound_port, method, path, body)
        b = _req(threaded_server.server_address[1], method, path, body)
        assert a == b, (method, path, a, b)


def test_aio_keep_alive_reuses_connection(aio_server):
    conn = http.client.HTTPConnection("127.0.0.1", aio_server.bound_port, timeout=10)
    try:
        for _ in range(5):
            code, body = _req(aio_server.bound_port, "POST", "/recommend",
                              {"user_id": int(USER_RAW[1]), "k": 3}, conn=conn)
            assert code == 200 and len(body["recommendations"]) == 3
    finally:
        conn.close()


def test_aio_coalesces_concurrent_recommends(aio_server, served):  # noqa: F811
    """Concurrent requests are all answered, as the service answers them
    directly, through the loop coalescer; /metrics shows its counters."""
    svc, _ = served
    before = aio_server.coalescer.stats()["n_requests"]
    n, results, lock = 32, {}, threading.Lock()

    def one(i):
        uid = int(USER_RAW[i % len(USER_RAW)])
        code, body = _req(aio_server.bound_port, "POST", "/recommend", {"user_id": uid, "k": 4})
        with lock:
            results[i] = (code, uid, body.get("recommendations", []))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert len(results) == n
    for code, uid, recs in results.values():
        want = svc.recommend(uid, 4)
        assert code == 200 and [r["item_id"] for r in recs] == [r["item_id"] for r in want]
        np.testing.assert_allclose([r["score"] for r in recs], [r["score"] for r in want],
                                   rtol=0, atol=1e-6)
    st = aio_server.coalescer.stats()
    assert st["n_requests"] - before == n and st["n_batches"] >= 1
    code, text = _req(aio_server.bound_port, "GET", "/metrics")
    assert code == 200 and "recsys_microbatch_requests_total" in text


def test_loop_coalescer_batches_one_turn_and_passes_errors():
    """Requests made in one loop turn go out as one batch, each sliced to
    its own k; a backend error reaches every caller of the batch."""
    import asyncio

    calls = []

    class Service:
        def recommend_batch(self, user_ids, k):
            calls.append((list(user_ids), k))
            if -1 in user_ids:
                raise RuntimeError("backend exploded")
            return [{"recommendations": [{"item_id": u * 10 + j} for j in range(k)]}
                    for u in user_ids]

    async def main():
        co = LoopCoalescer(Service(), max_batch=3)
        got = await asyncio.gather(*(co.recommend(u, k) for u, k in ((1, 2), (2, 4), (3, 1),
                                                                     (4, 2))))
        errs = await asyncio.gather(co.recommend(-1, 2), co.recommend(5, 2),
                                    return_exceptions=True)
        return co, got, errs

    co, got, errs = asyncio.run(main())
    assert calls[:2] == [([1, 2, 3], 4), ([4], 2)]  # max_batch 3: the rest next turn
    assert [len(r) for r in got] == [2, 4, 1, 2] and got[1][3] == {"item_id": 23}
    assert all(isinstance(e, RuntimeError) for e in errs)
    assert co.stats()["max_batch_seen"] == 3 and co.stats()["n_requests"] == 6
    with pytest.raises(ValueError):
        LoopCoalescer(Service(), max_batch=0)


def test_aio_degraded_mode_503():
    srv, t = _start_aio(None)
    try:
        code, body = _req(srv.bound_port, "POST", "/recommend", {"user_id": 1, "k": 3})
        assert code == 503 and body["detail"] == "Model not loaded"
        code, body = _req(srv.bound_port, "GET", "/health")
        assert code == 200 and body["status"] == "degraded"
    finally:
        _stop_aio(srv, t)


def test_aio_degraded_start_gains_coalescer_on_reload(served):  # noqa: F811
    """A server that starts degraded creates its loop coalescer when
    /admin/reload brings a service up, and a second reload retargets it."""
    _, d = served
    srv, t = _start_aio(None, service_factory=lambda: RecommendationService(
        d, backend="native").load(), max_batch=16)
    try:
        assert srv.coalescer is None
        assert _req(srv.bound_port, "POST", "/recommend", {"user_id": 1, "k": 3})[0] == 503
        code, body = _req(srv.bound_port, "POST", "/admin/reload")
        assert code == 200 and body["reloaded"]
        assert srv.coalescer is not None and srv.coalescer.max_batch == 16
        uid = int(USER_RAW[0])
        code, body = _req(srv.bound_port, "POST", "/recommend", {"user_id": uid, "k": 3})
        assert code == 200 and len(body["recommendations"]) == 3
        assert srv.coalescer.stats()["n_requests"] == 1
        coalescer = srv.coalescer
        assert _req(srv.bound_port, "POST", "/admin/reload")[0] == 200
        assert srv.coalescer is coalescer and coalescer.service is srv.api.service
    finally:
        _stop_aio(srv, t)


def test_aio_negative_content_length_closes_cleanly(aio_server):
    s = socket.create_connection(("127.0.0.1", aio_server.bound_port), timeout=10)
    s.sendall(b"POST /recommend HTTP/1.1\r\nContent-Length: -1\r\n\r\n")
    s.close()
    code, _ = _req(aio_server.bound_port, "POST", "/recommend",
                   {"user_id": int(USER_RAW[0]), "k": 2})
    assert code == 200
