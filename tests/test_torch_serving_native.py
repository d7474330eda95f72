"""The port's host serving backend against the JAX package's, on the CPU.

* The numpy towers, trunk and heads (``_tower_np``, ``_trunk_np``,
  ``_head_np``) of ``backend="native"`` against the JAX service's on one
  bundle: 1e-5.
* ``_FastRerank.logits``, both heads, with and without engineered dense
  features, against JAX ``_FastRerank.logits`` (1e-5) and against the
  port's exact per-pair host path (rtol 1e-4, atol 1e-5, the JAX test's);
  its self-check refusing an exact function that disagrees; the rating
  weight moving the score, the fast and exact paths agreeing.
* ``backend="native"`` ``recommend``, ``recommend_batch`` (rerank 20) and
  ``score`` against JAX ``backend="native"``: the same ids in order,
  scores within 1e-5; it loads with the default ``device="cuda"`` on a
  machine without a card.
* ``backend="exported"`` with rerank reranks on the host as the JAX
  exported backend does: the same ids in order, scores within 1e-5.

The plain bundle has ``tests/test_torch_serving.py``'s widths; the dense
one adds the 33 engineered features (side tables) of
``tests/test_torch_dense_features.py``, fitted on ``tiny_bundle``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.data import features as jax_features
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.retrieval.scorer import RetrievalIndex as JaxRetrievalIndex
from recsys_tpu.serve import export as jax_export
from recsys_tpu.serve.service import RecommendationService as JaxService
from recsys_tpu.train.checkpoint import save_inference_bundle as jax_save_bundle
from recsys_tpu_torch.serve import export
from recsys_tpu_torch.serve.service import RecommendationService, _FastRerank

TOL = 1e-5
N_USERS, N_ITEMS = 40, 90
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(32, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0, use_pallas_dcn=True)
N_FEATURES = 33  # the engineered features with the MovieLens side tables
K_EXPORT = 30


def _write(path, cfg, n_users, n_items, user_raw, item_raw, feature_state=None, seed=1):
    params = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(seed), cfg.model,
                                              n_users, n_items))
    index = JaxRetrievalIndex.build(params["towers"], cfg.model, n_items, item_raw)
    jax_save_bundle(str(path), params["towers"], cfg, user_raw, item_raw, index=index,
                    full_params=params, feature_state=feature_state)
    d = str(path)
    export.export_retrieve(d, os.path.join(d, export.DEFAULT_ARTIFACT), k=K_EXPORT,
                           device="cpu")
    jax_export.export_retrieve(d, os.path.join(d, "retrieve.hlo"), k=K_EXPORT)
    return d


@pytest.fixture(scope="module")
def bundles(tmp_path_factory, tiny_bundle):
    """Two JAX-written bundles with both packages' exported artifacts:
    ``plain`` (no features) and ``dense`` (33 features fitted on
    ``tiny_bundle``) -> {name: (dir, raw user ids, raw item ids)}."""
    root = tmp_path_factory.mktemp("serving_native")
    user_raw = np.arange(1, N_USERS + 1) * 7
    item_raw = np.arange(1, N_ITEMS + 1) * 3
    plain = _write(root / "plain", JaxRecsysConfig(model=JaxModelConfig(**MODEL_KW)),
                   N_USERS, N_ITEMS, user_raw, item_raw)
    eng = jax_features.make_engineer(tiny_bundle, N_FEATURES)
    eng.fit_transform_splits(tiny_bundle)
    cfg = JaxRecsysConfig(model=JaxModelConfig(**dict(MODEL_KW, dense_features=N_FEATURES)))
    n_users, n_items = int(tiny_bundle["meta/n_users"]), int(tiny_bundle["meta/n_movies"])
    d_user_raw = tiny_bundle["meta/user_raw_ids"]
    d_item_raw = tiny_bundle["meta/movie_raw_ids"]
    dense = _write(root / "dense", cfg, n_users, n_items, d_user_raw, d_item_raw,
                   feature_state=eng.state_dict(), seed=3)
    return {"plain": (plain, user_raw, item_raw), "dense": (dense, d_user_raw, d_item_raw)}


def _services(d, **kw):
    """(the port's native service, the JAX package's native service)."""
    return (RecommendationService(d, backend="native", **kw).load(),
            JaxService(d, backend="native", **kw).load())


def _same_recs(a, b):
    assert [r["item_id"] for r in a] == [r["item_id"] for r in b]
    assert [r["rank"] for r in a] == [r["rank"] for r in b]
    np.testing.assert_allclose([r["score"] for r in a], [r["score"] for r in b],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["plain", "dense"])
def test_numpy_towers_trunk_and_heads_match_jax(bundles, kind):
    d, _, _ = bundles[kind]
    port, ref = _services(d, rerank_candidates=20)
    rng = np.random.default_rng(0)
    n_u, n_i = len(port.user_id_map), len(port.item_id_map)
    uids, iids = rng.integers(0, n_u, 50), rng.integers(0, n_i, 50)
    for table, tower, ids in (("user_table", "user_tower", uids),
                              ("item_table", "item_tower", iids)):
        np.testing.assert_allclose(
            port._tower_np(port._model_np["towers"], table, tower, ids),
            ref._tower_np(ref.model_params["towers"], table, tower, ids), rtol=0, atol=TOL)
    np.testing.assert_allclose(port._user_embedding_np(uids), ref._user_embedding_np(uids),
                               rtol=0, atol=TOL)
    dense = port._dense_features(uids, iids)
    assert (dense is None) == (kind == "plain")
    feat = port._trunk_np(uids, iids, dense)
    np.testing.assert_allclose(feat, ref._trunk_np(uids, iids, dense), rtol=0, atol=TOL)
    for head in ("ctr_head", "rating_head"):
        np.testing.assert_allclose(port._head_np(feat, head), ref._head_np(feat, head),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(port._heads_exact_for_check(uids, iids),
                               ref._heads_exact_for_check(uids, iids), rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["plain", "dense"])
def test_fast_rerank_logits_match_jax_and_the_exact_path(bundles, kind):
    d, _, _ = bundles[kind]
    port, ref = _services(d, rerank_candidates=20)
    assert port._fast_rerank is not None and port._fast_rerank.ok
    assert ref._fast_rerank is not None
    assert bool(port._fast_rerank.pair_idx) == (kind == "dense")
    rng = np.random.default_rng(7)
    n_u, n_i = len(port.user_id_map), len(port.item_id_map)
    uids, cands = rng.integers(0, n_u, 40), rng.integers(0, n_i, (40, 12))
    got = port._fast_rerank.logits(uids, cands)
    want = ref._fast_rerank.logits(uids, cands)
    exact = port._heads_exact_for_check(np.repeat(uids, 12), cands.reshape(-1))
    for head in range(2):
        np.testing.assert_allclose(got[head], want[head], rtol=0, atol=TOL)
        np.testing.assert_allclose(got[head], exact[:, head].reshape(40, 12),
                                   rtol=1e-4, atol=1e-5)
    ctr, rating = port._fast_rerank.logits(uids, cands, need_rating=False)
    assert rating is None
    np.testing.assert_array_equal(ctr, got[0])
    np.testing.assert_array_equal(port._fast_rerank.ctr_logits(uids, cands), got[0])


def test_fast_rerank_self_check_refuses_mismatch(bundles):
    """An exact function that disagrees (a column that is not separable)
    makes build() return None, so the exact path serves."""
    d, _, _ = bundles["dense"]
    port = RecommendationService(d, backend="native", rerank_candidates=20).load()
    bad = _FastRerank.build(
        port._model_np, port.config.model, port.feature_engineer,
        len(port.user_id_map), len(port.item_id_map), port._tower_np,
        lambda u, i: np.full(len(u), 1e6, np.float32))
    assert bad is None
    good = _FastRerank.build(
        port._model_np, port.config.model, port.feature_engineer,
        len(port.user_id_map), len(port.item_id_map), port._tower_np,
        port._ctr_exact_for_check)  # a ctr-only exact function is checked on ctr
    assert good is not None and good.ok


@pytest.mark.parametrize("kind", ["plain", "dense"])
def test_rerank_rating_weight_wired_and_paths_agree(bundles, kind):
    """The rating weight moves the combined score, and the fast path and
    the exact per-pair fallback give the same ranking."""
    d, _, _ = bundles[kind]
    rr = RecommendationService(d, backend="native", rerank_candidates=20,
                               rerank_ctr_weight=0.1, rerank_rating_weight=0.25).load()
    rr0 = RecommendationService(d, backend="native", rerank_candidates=20,
                                rerank_ctr_weight=0.1).load()
    rng = np.random.default_rng(4)
    n_u, n_i = len(rr.user_id_map), len(rr.item_id_map)
    uids = rng.integers(0, n_u, 8)
    cands = rng.integers(0, n_i, (8, 20))
    scores = rng.normal(size=(8, 20)).astype(np.float32)
    s_fast, i_fast = rr._rerank(uids, scores, cands, 10)
    s_ctr_only, _ = rr0._rerank(uids, scores, cands, 10)
    assert not np.allclose(s_fast, s_ctr_only)
    rr._fast_rerank = None  # the exact per-pair fallback
    s_exact, i_exact = rr._rerank(uids, scores, cands, 10)
    np.testing.assert_array_equal(i_fast, i_exact)
    np.testing.assert_allclose(s_fast, s_exact, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["plain", "dense"])
@pytest.mark.parametrize("rerank", [0, 20])
def test_native_backend_matches_jax(bundles, kind, rerank):
    d, user_raw, item_raw = bundles[kind]
    # the default device="cuda" is not asked for by the host backend
    port = RecommendationService(d, backend="native", rerank_candidates=rerank,
                                 rerank_rating_weight=0.25).load()
    ref = JaxService(d, backend="native", rerank_candidates=rerank,
                     rerank_rating_weight=0.25).load()
    assert port.device.type == "cpu" and port._rerank_active() == bool(rerank)
    info = port.get_model_info()
    assert "native" in info["backend"] and "host" in info["search"]
    assert info["fast_rerank"] == bool(rerank)
    for uid in (int(user_raw[0]), int(user_raw[17]), 99_999):
        _same_recs(port.recommend(uid, k=10), ref.recommend(uid, k=10))
    users = [int(u) for u in user_raw[::3]] + [123_456]
    got, want = port.recommend_batch(users, k=5), ref.recommend_batch(users, k=5)
    assert [r["status"] for r in got] == [r["status"] for r in want]
    for a, b in zip(got, want):
        _same_recs(a["recommendations"], b["recommendations"])
    items = [int(i) for i in item_raw[:4]]
    for normalized in (False, True):
        np.testing.assert_allclose(
            [s["score"] for s in port.score(int(user_raw[3]), items, normalized)],
            [s["score"] for s in ref.score(int(user_raw[3]), items, normalized)],
            rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        port.score(99_999, items)


def test_native_backend_ignores_int8_catalog(bundles):
    d, user_raw, _ = bundles["plain"]
    port = RecommendationService(d, backend="native", int8_catalog=True).load()
    ref = RecommendationService(d, backend="native").load()
    assert port._search_route() == "native"
    _same_recs(port.recommend(int(user_raw[5]), k=10), ref.recommend(int(user_raw[5]), k=10))


@pytest.mark.parametrize("kind", ["plain", "dense"])
def test_exported_rerank_matches_jax_exported_backend(bundles, kind):
    """The exported backend reranks on the host through _FastRerank, as
    the JAX package's does: the same ids in order, scores within 1e-5."""
    d, user_raw, _ = bundles[kind]
    port = RecommendationService(d, backend="exported", rerank_candidates=20,
                                 device="cpu").load()
    ref = JaxService(d, backend="exported", rerank_candidates=20).load()
    assert port._fast_rerank is not None
    users = [int(u) for u in user_raw[:12]] + [777_777]
    got, want = port.recommend_batch(users, k=10), ref.recommend_batch(users, k=10)
    for a, b in zip(got, want):
        assert a["status"] == b["status"]
        _same_recs(a["recommendations"], b["recommendations"])
    _same_recs(port.recommend(users[1], k=7), ref.recommend(users[1], k=7))


def test_device_backend_builds_no_fast_rerank(bundles):
    d, _, _ = bundles["plain"]
    svc = RecommendationService(d, rerank_candidates=20, device="cpu").load()
    assert svc._rerank_active() and svc._fast_rerank is None
    assert svc.get_model_info()["fast_rerank"] is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            RecommendationService(d, backend="device")
