"""The serving contracts of ``tests/test_serving.py`` on the port, on the
CPU: the micro-batcher (it matches direct calls, it batches, it passes
errors on, it withdraws a request that timed out, it stops), HTTP through
the batcher with its ``/metrics`` series, hot reload (404 without a
factory, a swap that changes results and a restore that brings them
back, with the micro-batcher, recovering a degraded start, a failed load
keeping the old bundle), the rerank through the batched path, forked
workers behind one port, and the serve CLI: its flags, ``--backend
native`` with the default ``--device cuda`` on a machine without a card,
and a missing card under ``--device cuda`` exiting non-zero (with one
worker and with two) instead of serving 503s.

Services run the device backend with ``device="cpu"`` (the kernels'
plain versions) where the JAX tests use ``backend="device"``, and
``backend="native"`` where they use it. A batched answer and a direct one
of the same service have the same ids in order and scores within 1e-6
(fp32 products summed in another order at another batch size).
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from recsys_tpu_torch.config import ModelConfig, RecsysConfig
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.serve.app import make_http_server
from recsys_tpu_torch.serve.batcher import MicroBatcher
from recsys_tpu_torch.serve.service import RecommendationService, StubRecommendationService
from recsys_tpu_torch.train.checkpoint import save_inference_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_USERS, N_ITEMS = 40, 90
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(32, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0)
USER_RAW = np.arange(1, N_USERS + 1) * 7
ITEM_RAW = np.arange(1, N_ITEMS + 1) * 3


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port-written bundle (random weights from a seed) and its service
    on the CPU -> (service, bundle dir)."""
    d = str(tmp_path_factory.mktemp("torch_batcher") / "bundle")
    cfg = RecsysConfig(model=ModelConfig(**MODEL_KW))
    params = MultiTaskModel.init(torch.Generator().manual_seed(4), cfg.model,
                                 N_USERS, N_ITEMS, "cpu")
    index = RetrievalIndex.build(params["towers"], cfg.model, N_ITEMS, ITEM_RAW, device="cpu")
    save_inference_bundle(d, params["towers"], cfg, USER_RAW, ITEM_RAW, index=index,
                          full_params=params)
    return RecommendationService(d, device="cpu").load(), d


def _req(port, method, path, body=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            ctype = r.headers["Content-Type"]
            return r.status, json.loads(raw) if ctype.startswith("application/json") \
                else raw.decode()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _start(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server.server_address[1]


def _stop(server):
    server.shutdown()
    server.server_close()


def _ids(recs):
    return [r["item_id"] for r in recs]


def _same(got, want):
    assert _ids(got) == _ids(want) and [r["rank"] for r in got] == [r["rank"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                               rtol=0, atol=1e-6)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- the micro-batcher -----------------------------------------------

def test_microbatcher_matches_direct_recommend(served):
    """Concurrent requests through the batcher return what a direct
    recommend does, with mixed k and the cold-start fallback."""
    svc, _ = served
    jobs = [(int(u), 3 + (i % 4)) for i, u in enumerate(USER_RAW[:12])] + [(99_999, 5)]
    expected = {(u, k): svc.recommend(u, k) for u, k in jobs}
    results, lock = {}, threading.Lock()
    with MicroBatcher(svc, max_batch=8, max_wait_ms=5.0) as mb:
        def worker(u, k):
            r = mb.recommend(u, k)
            with lock:
                results[(u, k)] = r

        threads = [threading.Thread(target=worker, args=j) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        stats = mb.stats()
    assert stats["n_requests"] == len(jobs) and stats["max_batch_seen"] <= 8
    assert results.keys() == expected.keys()
    for key, recs in results.items():
        assert len(recs) == key[1]
        _same(recs, expected[key])


def test_microbatcher_actually_batches():
    """With a slow backend under concurrent load, requests coalesce: far
    fewer recommend_batch calls than requests."""
    svc = StubRecommendationService(n_users=100, n_items=50, dim=8, device="cpu")
    calls = {"n": 0}
    orig = svc.recommend_batch

    def slow_batch(user_ids, k):
        calls["n"] += 1
        time.sleep(0.02)  # hold the dispatcher so that the queue builds up
        return orig(user_ids, k)

    svc.recommend_batch = slow_batch
    n = 32
    with MicroBatcher(svc, max_batch=64) as mb:
        threads = [threading.Thread(target=mb.recommend, args=(i % 50 + 1, 5))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        stats = mb.stats()
    assert stats["n_requests"] == n
    assert calls["n"] < n / 2, f"no coalescing: {calls['n']} calls for {n} requests"
    assert stats["max_batch_seen"] > 1


def test_microbatcher_error_and_stop():
    svc = StubRecommendationService(n_users=10, n_items=20, dim=8, device="cpu")

    def boom(user_ids, k):
        raise RuntimeError("backend exploded")

    svc.recommend_batch = boom
    mb = MicroBatcher(svc).start()
    with pytest.raises(RuntimeError, match="backend exploded"):
        mb.recommend(1, 5)
    mb.stop()
    with pytest.raises(RuntimeError, match="not started"):
        mb.recommend(1, 5)
    assert mb._thread is None


def test_microbatcher_timeout_withdraws_the_request():
    """A request that times out in the queue is withdrawn (no later batch
    scores it), and one in flight raises TimeoutError too."""
    svc = StubRecommendationService(n_users=10, n_items=20, dim=8, device="cpu")
    entered, release = threading.Event(), threading.Event()
    orig = svc.recommend_batch

    def stuck(user_ids, k):
        entered.set()
        release.wait(30)
        return orig(user_ids, k)

    svc.recommend_batch = stuck
    mb = MicroBatcher(svc, timeout_s=0.3).start()
    errors = []

    def first():
        try:
            mb.recommend(1, 5)
        except TimeoutError as e:
            errors.append(e)

    t = threading.Thread(target=first)
    t.start()
    assert entered.wait(10)
    with pytest.raises(TimeoutError):
        mb.recommend(2, 5)  # queued behind the stuck batch
    assert len(mb._queue) == 0
    t.join(10)
    assert not t.is_alive() and len(errors) == 1
    release.set()
    mb.stop()
    assert mb.stats()["n_requests"] == 1  # the withdrawn request was never dispatched


def test_http_recommend_via_microbatcher(served):
    """/recommend through the batcher keeps the response contract, and
    /metrics shows the batcher's series."""
    svc, _ = served
    uid = int(USER_RAW[0])
    with MicroBatcher(svc, max_batch=32) as mb:
        server = make_http_server(svc, host="127.0.0.1", port=0, batcher=mb)
        port = _start(server)
        try:
            code, body = _req(port, "POST", "/recommend", {"user_id": uid, "k": 5})
            assert code == 200 and body["count"] == 5
            assert [r["rank"] for r in body["recommendations"]] == [1, 2, 3, 4, 5]
            _same(body["recommendations"], svc.recommend(uid, 5))
            code, _ = _req(port, "POST", "/recommend", {"user_id": uid, "k": 0})
            assert code == 422  # validation never reaches the batcher
            code, text = _req(port, "GET", "/metrics")
            assert code == 200
            assert "recsys_microbatch_batches_total 1" in text
            assert "recsys_microbatch_requests_total 1" in text
            assert "recsys_microbatch_max_batch 1" in text
            assert 'recsys_requests_total{path="/recommend",code="200"} 1' in text
        finally:
            _stop(server)
    assert mb.stats()["n_requests"] == 1


# ---- hot reload --------------------------------------------------------

def _negate_index(d):
    """A retrain stand-in: the catalog's embeddings negated (every
    ranking reverses), the artifact's schema kept. -> the original bytes."""
    path = os.path.join(d, "index.npz")
    with open(path, "rb") as f:
        original = f.read()
    with np.load(path) as z:
        idx = {k: z[k] for k in z.files}
    idx["item_embeddings"] = -idx["item_embeddings"]
    np.savez(path, **idx)
    return original


def test_admin_hot_reload(served, tmp_path):
    """404 without a factory; the swap changes live results; a restore
    and a second reload bring them back; a failed load answers 500 and
    keeps the old bundle live."""
    svc, d0 = served
    server0 = make_http_server(svc, host="127.0.0.1", port=0)
    port0 = _start(server0)
    try:
        assert _req(port0, "POST", "/admin/reload", {})[0] == 404
    finally:
        _stop(server0)

    d = str(tmp_path / "bundle")
    shutil.copytree(d0, d)
    broken = []

    def factory():
        if broken:
            raise FileNotFoundError("bundle half written")
        return RecommendationService(d, backend="native").load()

    server = make_http_server(factory(), host="127.0.0.1", port=0, service_factory=factory)
    port = _start(server)
    uid = int(USER_RAW[0])
    try:
        code, before = _req(port, "POST", "/recommend", {"user_id": uid, "k": 5})
        assert code == 200
        original = _negate_index(d)
        code, rep = _req(port, "POST", "/admin/reload", {})
        assert code == 200 and rep["reloaded"] and rep["reload_count"] == 1
        assert rep["model_info"]["ready"] and "native" in rep["model_info"]["backend"]
        code, after = _req(port, "POST", "/recommend", {"user_id": uid, "k": 5})
        assert code == 200
        assert _ids(before["recommendations"]) != _ids(after["recommendations"])
        with open(os.path.join(d, "index.npz"), "wb") as f:
            f.write(original)
        code, rep = _req(port, "POST", "/admin/reload", {})
        assert code == 200 and rep["reload_count"] == 2
        code, again = _req(port, "POST", "/recommend", {"user_id": uid, "k": 5})
        assert again["recommendations"] == before["recommendations"]
        broken.append(True)
        code, rep = _req(port, "POST", "/admin/reload", {})
        assert code == 500 and "reload failed" in rep["detail"]
        code, still = _req(port, "POST", "/recommend", {"user_id": uid, "k": 5})
        assert code == 200 and still["recommendations"] == before["recommendations"]
        code, text = _req(port, "GET", "/metrics")
        assert 'recsys_requests_total{path="/admin/reload",code="200"} 2' in text
    finally:
        _stop(server)


def test_admin_hot_reload_with_microbatcher(served):
    """The reload swaps the micro-batcher too: a fresh dispatcher with the
    same settings on the new service; the old one stopped."""
    _, d = served

    def factory():
        return RecommendationService(d, backend="native").load()

    first = factory()
    batcher = MicroBatcher(first, max_batch=32, max_wait_ms=1.0, timeout_s=7.0).start()
    server = make_http_server(first, host="127.0.0.1", port=0, batcher=batcher,
                              service_factory=factory)
    port = _start(server)
    uid = int(USER_RAW[1])
    try:
        code, body = _req(port, "POST", "/recommend", {"user_id": uid, "k": 3})
        assert code == 200
        code, _ = _req(port, "POST", "/admin/reload", {})
        assert code == 200
        assert not batcher._running and batcher._thread is None
        new = server.api.batcher
        assert new is not batcher and new.service is server.api.service is not first
        assert (new.max_batch, new.max_wait_s, new.timeout_s) == (32, 0.001, 7.0)
        code, again = _req(port, "POST", "/recommend", {"user_id": uid, "k": 3})
        assert code == 200
        _same(again["recommendations"], body["recommendations"])
        assert new.stats()["n_requests"] == 1
    finally:
        _stop(server)
        server.api.batcher.stop()


def test_admin_reload_recovers_degraded_server(served, tmp_path):
    """A server that started degraded (no bundle yet) answers 503, a
    reload that still finds no bundle 500, and one that finds it 200."""
    _, d = served
    staged = str(tmp_path / "late_bundle")

    def factory():
        return RecommendationService(staged, backend="native").load()

    server = make_http_server(None, host="127.0.0.1", port=0, service_factory=factory)
    port = _start(server)
    uid = int(USER_RAW[0])
    try:
        assert _req(port, "POST", "/recommend", {"user_id": uid, "k": 3})[0] == 503
        assert _req(port, "POST", "/admin/reload", {})[0] == 500
        shutil.copytree(d, staged)
        code, rep = _req(port, "POST", "/admin/reload", {})
        assert code == 200 and rep["model_info"]["ready"]
        assert rep["previous_bundle_mtime"] is None
        code, body = _req(port, "POST", "/recommend", {"user_id": uid, "k": 3})
        assert code == 200 and len(body["recommendations"]) == 3
        code, body = _req(port, "GET", "/health")
        assert code == 200 and body["model_loaded"]
    finally:
        _stop(server)


def test_rerank_runs_through_batched_path(served):
    """Under the micro-batcher, concurrent rerank requests coalesce into
    batched _rerank calls ([Q, C] with Q > 1), and the results equal
    direct single-user recommends."""
    _, d = served
    rr = RecommendationService(d, backend="native", rerank_candidates=20).load()
    assert rr._rerank_active() and rr._fast_rerank is not None
    seen_q = []
    orig = rr._rerank

    def spy(dense_uids, scores, idx, k):
        seen_q.append(np.asarray(idx).shape[0])
        return orig(dense_uids, scores, idx, k)

    rr._rerank = spy
    uids = list(rr.user_id_map)[:12]
    direct = {u: _ids(rr.recommend(u, 5)) for u in uids}
    seen_q.clear()
    results, lock = {}, threading.Lock()
    with MicroBatcher(rr, max_batch=64, max_wait_ms=30.0) as mb:
        def worker(u):
            res = mb.recommend(u, 5)
            with lock:
                results[u] = _ids(res)

        threads = [threading.Thread(target=worker, args=(u,)) for u in uids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    assert results == direct
    assert max(seen_q) > 1, f"rerank never saw a multi-user batch (Q sizes: {seen_q})"


# ---- processes and the CLI ------------------------------------------------

def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def _wait_healthy(port, proc, seconds=90):
    deadline = time.time() + seconds
    while time.time() < deadline and proc.poll() is None:
        try:
            return _req(port, "GET", "/health", timeout=5)
        except OSError:
            time.sleep(0.3)
    return None


def _serve_cli(args):
    return subprocess.Popen([sys.executable, "-m", "recsys_tpu_torch.serve", *args],
                            cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, start_new_session=True)


def _kill_tree(proc):
    try:
        os.killpg(proc.pid, signal.SIGTERM)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)


def test_multiworker_serving_subprocess():
    """--workers 2 forks SO_REUSEPORT processes behind one port; SIGTERM to
    the parent reaps the whole tree."""
    port = _free_port()
    proc = _serve_cli(["--stub", "--device", "cpu", "--workers", "2", "--host", "127.0.0.1",
                       "--port", str(port)])
    try:
        health = _wait_healthy(port, proc)
        assert health is not None and health[0] == 200, "the workers never became healthy"
        for _ in range(6):
            code, body = _req(port, "POST", "/recommend", {"user_id": 1, "k": 3})
            assert code == 200 and body["count"] == 3
        proc.send_signal(signal.SIGTERM)  # the parent alone: it reaps its workers
        assert proc.wait(timeout=30) == 0
        with pytest.raises(OSError):
            _req(port, "GET", "/health", timeout=5)
    finally:
        if proc.poll() is None:
            _kill_tree(proc)


@pytest.mark.parametrize("server", ["threaded", "asyncio"])
def test_serve_cli_native_backend_microbatch_and_reload(served, server, tmp_path):
    """``--backend native`` serves with the default ``--device cuda`` on a
    machine without a card, through the micro-batcher or the asyncio
    coalescer, and reloads."""
    _, d0 = served
    d = str(tmp_path / "bundle")
    shutil.copytree(d0, d)
    port = _free_port()
    proc = _serve_cli(["--model_dir", d, "--backend", "native", "--rerank_candidates", "20",
                       "--microbatch", "16", "--microbatch_wait_ms", "1", "--allow_reload",
                       "--server", server, "--host", "127.0.0.1", "--port", str(port)])
    try:
        health = _wait_healthy(port, proc)
        assert health is not None and health[1]["model_loaded"], proc.stderr
        code, info = _req(port, "GET", "/model/info")
        assert "native" in info["backend"] and info["fast_rerank"]
        uid = int(USER_RAW[5])
        code, body = _req(port, "POST", "/recommend", {"user_id": uid, "k": 4})
        want = RecommendationService(d, backend="native", rerank_candidates=20).load()
        assert code == 200
        _same(body["recommendations"], want.recommend(uid, 4))
        assert _req(port, "POST", "/admin/reload", {})[0] == 200
        code, text = _req(port, "GET", "/metrics")
        assert "recsys_microbatch_requests_total" in text
    finally:
        _kill_tree(proc)


@pytest.mark.parametrize("workers", [1, 2])
def test_missing_card_exits_nonzero(served, workers):
    """``--device cuda`` (the default) where there is no card: the CLI
    exits non-zero, from the parent or from a forked worker, and never
    answers /health (a missing card is not a degraded bundle)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, d = served
    port = _free_port()
    proc = _serve_cli(["--model_dir", d, "--workers", str(workers), "--host", "127.0.0.1",
                       "--port", str(port)])
    try:
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            _kill_tree(proc)
    assert rc != 0
    assert "CUDA is not available" in proc.stderr.read().decode()
    with pytest.raises(OSError):
        _req(port, "GET", "/health", timeout=5)


_LIGHT_CLI_PROBE = r"""
import os, sys, types
import recsys_tpu_torch.serve.__main__ as cli
assert "numpy" not in sys.modules and "torch" not in sys.modules
seen = {}
def fake_serve_forever(*args, **kw):
    seen.update(kw, numpy="numpy" in sys.modules, omp=os.environ.get("OMP_NUM_THREADS"))
    return 0
sys.modules["recsys_tpu_torch.serve.app"] = types.SimpleNamespace(
    serve_forever=fake_serve_forever)
assert cli.main(["--stub", "--workers", "3", "--microbatch", "8", "--server", "asyncio",
                 "--allow_reload", "--backend", "native"]) == 0
assert seen["omp"] == "1" and not seen["numpy"], seen
assert (seen["workers"], seen["microbatch"], seen["server"], seen["allow_reload"],
        seen["backend"], seen["microbatch_wait_ms"]) == (3, 8, "asyncio", True, "native", 0.0)
print("ok")
"""


def test_cli_sets_worker_env_before_numpy_loads():
    """The CLI imports nothing that loads numpy or torch before it has
    parsed the flags and set the BLAS thread counts of forked workers."""
    env = {k: v for k, v in _env().items() if not k.endswith("_NUM_THREADS")}
    out = subprocess.run([sys.executable, "-c", _LIGHT_CLI_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_flags_match_the_jax_script(monkeypatch):
    """Every flag of scripts/serve.py, with its choices and default; every
    backend, ``sharded`` too, reaches the server."""
    import argparse
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_serve", os.path.join(REPO, "scripts",
                                                                           "serve.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    from recsys_tpu_torch.serve import __main__ as port_cli

    def parser_of(main):
        captured = {}

        def parse_args(self, argv=None):
            captured["parser"] = self
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = parse_args
        try:
            with pytest.raises(SystemExit):
                main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return {a.dest: a for a in captured["parser"]._actions if a.dest != "help"}

    port, jax_flags = parser_of(port_cli.main), parser_of(jax_cli.main)
    assert set(jax_flags) <= set(port)
    for dest, a in jax_flags.items():
        assert port[dest].default == a.default, dest
        assert port[dest].choices == a.choices or list(port[dest].choices) == list(a.choices), dest
    from recsys_tpu_torch.serve import BACKENDS, app

    seen = []
    monkeypatch.setattr(app, "serve_forever", lambda *a, **kw: seen.append(kw["backend"]) or 0)
    switch = sys.getswitchinterval()  # the one-worker CLI shortens it
    try:
        for backend in BACKENDS:
            assert port_cli.main(["--backend", backend]) == 0
    finally:
        sys.setswitchinterval(switch)
    assert seen == list(BACKENDS) == list(jax_flags["backend"].choices)
