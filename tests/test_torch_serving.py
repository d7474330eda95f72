"""Serving parity of the PyTorch port with the JAX package, on the CPU.

* A bundle written by either package loads and serves in the other, and
  one ``config.json`` loads in both.
* ``recommend``, ``recommend_batch`` (two-stage, ``rerank_candidates=20``)
  and ``score`` agree with the JAX service (``backend="device"``) on the
  same bundle: the same item ids in the same order, scores to 1e-5
  (fp32; the mixed-precision towers round at the same points in both).
* The HTTP status-code contract of ``tests/test_serving.py`` holds
  against the port's server.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.retrieval.scorer import RetrievalIndex as JaxRetrievalIndex
from recsys_tpu.serve.service import RecommendationService as JaxService
from recsys_tpu.train.checkpoint import save_inference_bundle as jax_save_bundle
from recsys_tpu_torch.config import ModelConfig, RecsysConfig
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.serve.app import make_http_server
from recsys_tpu_torch.serve.service import RecommendationService, StubRecommendationService
from recsys_tpu_torch.train.checkpoint import save_inference_bundle

N_USERS, N_ITEMS = 40, 90
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(32, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0,
                use_pallas_dcn=True)
USER_RAW = np.arange(1, N_USERS + 1) * 7
ITEM_RAW = np.arange(1, N_ITEMS + 1) * 3


def _jax_bundle(path):
    cfg = JaxRecsysConfig(model=JaxModelConfig(**MODEL_KW))
    params = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(1), cfg.model,
                                              N_USERS, N_ITEMS))
    index = JaxRetrievalIndex.build(params["towers"], cfg.model, N_ITEMS, ITEM_RAW)
    jax_save_bundle(str(path), params["towers"], cfg, USER_RAW, ITEM_RAW,
                    index=index, full_params=params)
    return str(path)


def _torch_bundle(path):
    cfg = RecsysConfig(model=ModelConfig(**MODEL_KW))
    params = MultiTaskModel.init(torch.Generator().manual_seed(1), cfg.model,
                                 N_USERS, N_ITEMS, "cpu")
    index = RetrievalIndex.build(params["towers"], cfg.model, N_ITEMS, ITEM_RAW,
                                 device="cpu")
    save_inference_bundle(str(path), params["towers"], cfg, USER_RAW, ITEM_RAW,
                          index=index, full_params=params)
    return str(path)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serving")
    return {"jax": _jax_bundle(root / "jax"), "torch": _torch_bundle(root / "torch")}


def _same_recs(a, b):
    assert [r["item_id"] for r in a] == [r["item_id"] for r in b]
    assert [r["rank"] for r in a] == [r["rank"] for r in b]
    np.testing.assert_allclose([r["score"] for r in a], [r["score"] for r in b],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("rerank", [0, 20])
def test_services_agree_on_bundle(bundles, writer, rerank):
    d = bundles[writer]
    port = RecommendationService(d, rerank_candidates=rerank, device="cpu").load()
    ref = JaxService(d, backend="device", rerank_candidates=rerank).load()
    for uid in (int(USER_RAW[0]), int(USER_RAW[17]), 99999):
        _same_recs(port.recommend(uid, k=10), ref.recommend(uid, k=10))
    users = [int(u) for u in USER_RAW[::3]] + [123456]
    got, want = port.recommend_batch(users, k=5), ref.recommend_batch(users, k=5)
    assert [r["status"] for r in got] == [r["status"] for r in want]
    for a, b in zip(got, want):
        _same_recs(a["recommendations"], b["recommendations"])
    items = [int(i) for i in ITEM_RAW[:4]]
    np.testing.assert_allclose(
        [s["score"] for s in port.score(int(USER_RAW[3]), items)],
        [s["score"] for s in ref.score(int(USER_RAW[3]), items)], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        port.score(99999, items)
    with pytest.raises(ValueError):
        port.score(int(USER_RAW[0]), [5])


def test_config_json_loads_in_both_packages(bundles):
    port_cfg = RecsysConfig.load(f"{bundles['jax']}/config.json")
    jax_cfg = JaxRecsysConfig.load(f"{bundles['torch']}/config.json")
    assert port_cfg.to_dict() == JaxRecsysConfig.load(
        f"{bundles['jax']}/config.json").to_dict()
    assert jax_cfg.to_dict() == RecsysConfig.load(
        f"{bundles['torch']}/config.json").to_dict()
    assert RecsysConfig().to_dict() == JaxRecsysConfig().to_dict()


def test_unported_options_raise(bundles):
    # every backend of the JAX package is ported: "sharded" serves from a
    # one-rank mesh here, as the device backend does
    sharded = RecommendationService(bundles["jax"], backend="sharded", device="cpu").load()
    device = RecommendationService(bundles["jax"], device="cpu").load()
    _same_recs(sharded.recommend(int(USER_RAW[4]), k=10), device.recommend(int(USER_RAW[4]), k=10))
    with pytest.raises(ValueError, match="unknown backend"):
        RecommendationService(bundles["jax"], backend="tpu", device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError):
            RecommendationService(bundles["jax"])
    # the host backend asks for no device
    assert RecommendationService(bundles["jax"], backend="native").device.type == "cpu"


def test_stub_service_deterministic():
    a = StubRecommendationService(n_users=10, n_items=20, dim=8, device="cpu")
    b = StubRecommendationService(n_users=10, n_items=20, dim=8, device="cpu")
    assert a.recommend(1, k=5) == b.recommend(1, k=5)
    assert len(a.score(1, [1, 2])) == 2 and a.get_model_info()["ready"] is True


# ---- HTTP contract ----------------------------------------------------

def _req(port, method, path, body=None, raw=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _serve(service):
    server = make_http_server(service, host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t


def test_http_endpoints(bundles):
    svc = RecommendationService(bundles["jax"], rerank_candidates=20, device="cpu").load()
    server, t = _serve(svc)
    port = server.server_address[1]
    uid, iid = int(USER_RAW[0]), int(ITEM_RAW[0])
    try:
        def call(method, path, body=None, raw=None):
            code, data = _req(port, method, path, body, raw)
            return code, (json.loads(data) if data.startswith(b"{") else data)

        code, body = call("GET", "/health")
        assert code == 200 and body["status"] == "healthy" and body["model_loaded"]
        code, body = call("GET", "/")
        assert code == 200 and "endpoints" in body
        code, body = call("GET", "/model/info")
        assert code == 200 and body["n_users"] == N_USERS and body["n_items"] == N_ITEMS
        code, body = call("POST", "/recommend", {"user_id": uid, "k": 5})
        assert code == 200 and body["count"] == 5 and body["user_id"] == uid
        code, body = call("POST", "/recommend/batch", {"user_ids": [uid, 99999], "k": 3})
        assert code == 200 and body["count"] == 2
        assert [r["status"] for r in body["results"]] == ["ok", "cold_start"]
        code, body = call("POST", "/score", {"user_id": uid, "item_ids": [iid]})
        assert code == 200 and len(body["scores"]) == 1
        assert call("POST", "/score", {"user_id": 123456, "item_ids": [iid]})[0] == 404
        assert call("POST", "/recommend", {"user_id": uid, "k": 0})[0] == 422
        assert call("POST", "/recommend", {"user_id": uid, "k": 101})[0] == 422
        assert call("POST", "/recommend", raw=b"not json")[0] == 422
        assert call("GET", "/nope")[0] == 404
        code, text = call("GET", "/metrics")
        assert code == 200 and b'recsys_requests_total{path="/recommend",code="200"} 1' in text
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_http_not_ready_503():
    server, t = _serve(None)
    port = server.server_address[1]
    try:
        code, body = _req(port, "GET", "/health")
        assert code == 200 and json.loads(body)["status"] == "degraded"
        assert _req(port, "POST", "/recommend", {"user_id": 1, "k": 5})[0] == 503
        assert _req(port, "GET", "/model/info")[0] == 503
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_serve_cli_subprocess(bundles):
    """``python -m recsys_tpu_torch.serve`` loads a bundle on the CPU and
    answers, and SIGTERM stops it."""
    import os
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "recsys_tpu_torch.serve", "--model_dir",
         bundles["torch"], "--device", "cpu", "--host", "127.0.0.1",
         "--port", str(port), "--rerank_candidates", "20"],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.time() + 60
        code = None
        while time.time() < deadline and code is None:
            try:
                code, body = _req(port, "GET", "/health")
            except OSError:
                time.sleep(0.2)
        assert code == 200 and json.loads(body)["model_loaded"]
        code, body = _req(port, "POST", "/recommend", {"user_id": int(USER_RAW[2]), "k": 4})
        assert code == 200 and json.loads(body)["count"] == 4
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode is not None
