"""The port's exported retrieve artifact (``torch.export``) against the
port's exact route and the JAX package's ``jax.export`` artifact, on the
CPU: the bundle fingerprint, batches of any size from one artifact, the
metadata, the service's ``backend="exported"`` (its refusals of a rebuilt
bundle and of a k past the exported one) and the export and serve CLIs.

Tolerances: scores to 1e-5 (fp32 products in another order); ids equal
except among scores within 1e-5 of a row's k-th score (ties).
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.retrieval.scorer import RetrievalIndex as JaxRetrievalIndex
from recsys_tpu.serve import export as jax_export
from recsys_tpu.train.checkpoint import save_inference_bundle as jax_save_bundle
from recsys_tpu_torch import export as export_cli
from recsys_tpu_torch.config import ModelConfig, RecsysConfig
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.serve import export
from recsys_tpu_torch.serve.service import RecommendationService
from recsys_tpu_torch.train.checkpoint import save_inference_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_USERS, N_ITEMS, K = 50, 300, 20
TOL = 1e-5
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(32, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0)
USER_RAW = np.arange(1, N_USERS + 1) * 5
ITEM_RAW = np.arange(1, N_ITEMS + 1) * 2


def _jax_bundle(path):
    cfg = JaxRecsysConfig(model=JaxModelConfig(**MODEL_KW))
    params = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(2), cfg.model,
                                              N_USERS, N_ITEMS))
    index = JaxRetrievalIndex.build(params["towers"], cfg.model, N_ITEMS, ITEM_RAW)
    jax_save_bundle(str(path), params["towers"], cfg, USER_RAW, ITEM_RAW, index=index,
                    full_params=params)
    return str(path)


def _torch_bundle(path, seed=2):
    cfg = RecsysConfig(model=ModelConfig(**MODEL_KW))
    params = MultiTaskModel.init(torch.Generator().manual_seed(seed), cfg.model,
                                 N_USERS, N_ITEMS, "cpu")
    index = RetrievalIndex.build(params["towers"], cfg.model, N_ITEMS, ITEM_RAW,
                                 device="cpu")
    save_inference_bundle(str(path), params["towers"], cfg, USER_RAW, ITEM_RAW,
                          index=index, full_params=params)
    return str(path)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A JAX-written bundle with both packages' artifacts of top-K beside
    it (``retrieve.pt2`` and ``retrieve.hlo``)."""
    d = _jax_bundle(tmp_path_factory.mktemp("export") / "bundle")
    meta = export.export_retrieve(d, os.path.join(d, export.DEFAULT_ARTIFACT), k=K,
                                  device="cpu")
    jax_meta = jax_export.export_retrieve(d, os.path.join(d, "retrieve.hlo"), k=K)
    return {"dir": d, "meta": meta, "jax_meta": jax_meta}


def _same_topk(got, want, what):
    """scores [Q, k] to TOL; ids equal beyond ties."""
    (gs, gi), (ws, wi) = got, want
    assert gs.shape == ws.shape and gi.shape == wi.shape, what
    np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL, err_msg=what)
    for q in range(gs.shape[0]):
        boundary = ws[q, -1] + TOL
        assert set(gi[q][gs[q] > boundary]) <= set(wi[q]), f"{what}: row {q}"
        assert set(wi[q][ws[q] > boundary]) <= set(gi[q]), f"{what}: row {q}"


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bundle_fingerprint_matches_jax(writer, tmp_path):
    d = (_jax_bundle if writer == "jax" else _torch_bundle)(tmp_path / writer)
    assert export.bundle_fingerprint(d) == jax_export.bundle_fingerprint(d)
    assert len(export.bundle_fingerprint(d)) == 64


def test_export_metadata_has_the_jax_keys(exported):
    meta, jax_meta = exported["meta"], exported["jax_meta"]
    assert meta.keys() == jax_meta.keys()
    assert meta["k"] == K and meta["platforms"] == ["cpu", "cuda"]
    assert meta["calling_convention"] == jax_meta["calling_convention"]
    assert meta["source_fingerprint"] == jax_meta["source_fingerprint"]
    path = os.path.join(exported["dir"], export.DEFAULT_ARTIFACT)
    assert meta["bytes"] == os.path.getsize(path)
    with open(path + ".json") as f:
        assert json.load(f) == meta


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_exported_artifact_matches_exact_route_and_jax_artifact(exported, batch):
    """One artifact answers any batch; its top-k is the port service's
    exact route's and the JAX artifact's."""
    d = exported["dir"]
    ids = (np.arange(batch) * 7) % N_USERS
    fn = export.load_exported(os.path.join(d, export.DEFAULT_ARTIFACT), "cpu")
    got = fn(ids)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert got[0].shape == got[1].shape == (batch, K)
    exact = RecommendationService(d, device="cpu").load()._retrieve(ids, K)
    _same_topk(got, exact, f"exact route, batch {batch}")
    jax_fn = jax_export.load_exported(os.path.join(d, "retrieve.hlo"))
    _same_topk(got, jax_fn(ids.astype(np.int32)), f"JAX artifact, batch {batch}")


def test_exported_backend_serves_and_checks_k(exported):
    d = exported["dir"]
    svc = RecommendationService(d, backend="exported", device="cpu").load()
    ref = RecommendationService(d, device="cpu").load()
    info = svc.get_model_info()
    assert "exported" in info["backend"] and "export" in info["search"]
    users = [int(u) for u in USER_RAW[::4]] + [123_456]
    for a, b in zip(svc.recommend_batch(users, k=10), ref.recommend_batch(users, k=10)):
        assert a["status"] == b["status"]
        np.testing.assert_allclose([r["score"] for r in a["recommendations"]],
                                   [r["score"] for r in b["recommendations"]], atol=TOL)
    reranked = RecommendationService(d, backend="exported", rerank_candidates=K,
                                     device="cpu").load()
    assert len(reranked.recommend(int(USER_RAW[3]), k=10)) == 10
    with pytest.raises(ValueError, match="exported top-k"):
        svc.recommend(int(USER_RAW[0]), k=K + 1)
    with pytest.raises(ValueError, match="exported top-k"):
        RecommendationService(d, backend="exported", rerank_candidates=K + 1,
                              device="cpu").load()


def test_exported_backend_refuses_a_rebuilt_bundle(tmp_path):
    d = _torch_bundle(tmp_path / "b")
    path = str(tmp_path / "art" / "r.pt2")
    export.export_retrieve(d, path, k=5, device="cpu")
    RecommendationService(d, backend="exported", exported_path=path, device="cpu").load()
    index = RetrievalIndex.load(os.path.join(d, "index.npz"), "cpu")
    RetrievalIndex(index.item_embeddings_np[::-1].copy(), index.item_raw_ids[::-1].copy(),
                   device="cpu").save(os.path.join(d, "index.npz"))
    with pytest.raises(ValueError, match="different bundle"):
        RecommendationService(d, backend="exported", exported_path=path,
                              device="cpu").load()


def test_export_cli_writes_the_default_artifact(tmp_path, capsys):
    d = _torch_bundle(tmp_path / "b", seed=4)
    assert export_cli.main(["--model_dir", d, "--k", "7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    with open(os.path.join(d, "retrieve.pt2.json")) as f:
        assert json.load(f) == printed
    assert printed["k"] == 7 and os.path.exists(os.path.join(d, "retrieve.pt2"))
    scores, idx = export.load_exported(os.path.join(d, "retrieve.pt2"), "cpu")([0, 1])
    assert scores.shape == idx.shape == (2, 7)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError):
            export_cli.main(["--model_dir", d])
        with pytest.raises(RuntimeError):
            export.load_exported(os.path.join(d, "retrieve.pt2"))


def _get(port, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if body is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_serve_cli_takes_the_exported_backend(exported, tmp_path):
    """``python -m recsys_tpu_torch.serve --backend exported
    --exported_path`` answers, and so does ``--backend sharded`` (a
    one-rank mesh without a launcher), with the device route's answer."""
    d = exported["dir"]
    want = RecommendationService(d, device="cpu").load().recommend(int(USER_RAW[2]), 4)
    for backend, extra in (("exported", ["--exported_path",
                                         os.path.join(d, export.DEFAULT_ARTIFACT)]),
                           ("sharded", [])):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        proc = subprocess.Popen(
            [sys.executable, "-m", "recsys_tpu_torch.serve", "--model_dir", d, "--device",
             "cpu", "--host", "127.0.0.1", "--port", str(port), "--backend", backend, *extra],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        try:
            deadline, info = time.time() + 60, None
            while time.time() < deadline and info is None:
                try:
                    info = _get(port, "/model/info")[1]
                except OSError:
                    time.sleep(0.2)
            assert info is not None and backend in info["backend"]
            code, body = _get(port, "/recommend", {"user_id": int(USER_RAW[2]), "k": 4})
            assert code == 200 and body["count"] == 4
            assert [r["item_id"] for r in body["recommendations"]] == \
                [r["item_id"] for r in want]
            np.testing.assert_allclose([r["score"] for r in body["recommendations"]],
                                       [r["score"] for r in want], rtol=0, atol=1e-5)
        finally:
            proc.terminate()
            proc.wait(timeout=30)
        assert proc.returncode is not None
