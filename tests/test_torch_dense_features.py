"""Engineered dense features in the port against the JAX package, on the
CPU: ``FeatureEngineer`` (fit, transform, the scaler, its state crossing
between the packages both ways), ``make_engineer``'s width check,
``MultiTaskModel.loss`` with a dense column, ``Trainer.train`` with dense
features (its bundle served with rerank by the JAX service, and a JAX
trained bundle served by the port), ``evaluate`` / ``two_stage_evaluate``
and the evaluate CLI, and the train CLI's feature flags.

Tolerances:
* features: 1e-6 absolute (the same float64 numpy operations; the
  standardized matrix is fp32, clipped at 10 train-sigmas);
* loss and gradients: as ``test_torch_train_model.py`` (rtol 1e-5 on the
  values, 1e-5 of each leaf's scale on the gradients);
* served rankings: as ``test_torch_serving.py`` (equal ids, scores to
  1e-5);
* evaluation: as ``test_torch_eval_seen.py`` (ranking metrics to rtol
  1e-6, RMSE and AUC to 1e-5).
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from recsys_tpu.config import EvalConfig as JaxEvalConfig
from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.config import TrainConfig as JaxTrainConfig
from recsys_tpu.data import features as jax_features
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.retrieval import evaluator as jax_ev
from recsys_tpu.serve import export as jax_export
from recsys_tpu.serve.service import RecommendationService as JaxService
from recsys_tpu.train.checkpoint import load_feature_engineer as jax_load_engineer
from recsys_tpu.train.trainer import Trainer as JaxTrainer
from recsys_tpu_torch import evaluate as eval_cli
from recsys_tpu_torch.config import EvalConfig, ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.data import features
from recsys_tpu_torch.retrieval import evaluator
from recsys_tpu_torch.serve.service import RecommendationService
from recsys_tpu_torch.train.checkpoint import load_feature_engineer, params_from_numpy
from recsys_tpu_torch.train.trainer import Trainer
from test_torch_eval_seen import _assert_reports_equal
from test_torch_train_model import _batch, _check_loss_both, _configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_TOL = 1e-6
# the engineered width without and with the MovieLens side tables
WIDTHS = {False: 29, True: 33}
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(24, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0, use_pallas_dcn=True)


def _engineers(bundle, side: bool):
    return (jax_features.make_engineer(bundle, WIDTHS[side]),
            features.make_engineer(bundle, WIDTHS[side]))


@pytest.mark.parametrize("side", [False, True])
def test_feature_engineer_matches_jax(tiny_bundle, side):
    jeng, teng = _engineers(tiny_bundle, side)
    want, got = jeng.fit_transform_splits(tiny_bundle), teng.fit_transform_splits(tiny_bundle)
    assert teng.feature_names() == jeng.feature_names()
    assert len(teng.feature_names()) == WIDTHS[side]
    for split in ("train", "val", "test"):
        assert got[split].dtype == np.float32 and got[split].shape == want[split].shape
        np.testing.assert_allclose(got[split], want[split], rtol=0, atol=FEAT_TOL)
    uid, mid = tiny_bundle["test/user_id"], tiny_bundle["test/movie_id"]
    now = np.full(len(uid), teng.t_ref)
    assert teng.t_ref == jeng.t_ref
    np.testing.assert_allclose(teng.transform_scaled(uid, mid, now),
                               jeng.transform_scaled(uid, mid, now), rtol=0, atol=FEAT_TOL)


@pytest.mark.parametrize("side", [False, True])
def test_feature_state_crosses_packages(tiny_bundle, side, tmp_path):
    """A features.npz written by either package loads in the other and
    gives the same scaled features."""
    jeng, teng = _engineers(tiny_bundle, side)
    jeng.fit_transform_splits(tiny_bundle)
    teng.fit_transform_splits(tiny_bundle)
    for writer, eng in (("jax", jeng), ("torch", teng)):
        os.makedirs(tmp_path / writer)
        np.savez(tmp_path / writer / "features.npz", **eng.state_dict())
    from_jax = load_feature_engineer(str(tmp_path / "jax"))
    from_port = jax_load_engineer(str(tmp_path / "torch"))
    uid, mid = tiny_bundle["val/user_id"], tiny_bundle["val/movie_id"]
    ts = tiny_bundle["val/timestamp"].astype(np.float64)
    want = jeng.transform_scaled(uid, mid, ts)
    np.testing.assert_allclose(from_jax.transform_scaled(uid, mid, ts), want, atol=FEAT_TOL)
    np.testing.assert_allclose(from_port.transform_scaled(uid, mid, ts), want, atol=FEAT_TOL)
    assert from_jax.feature_names() == from_port.feature_names() == jeng.feature_names()
    stale = dict(teng.state_dict(), version=np.int64(1))
    with pytest.raises(ValueError, match="version"):
        features.FeatureEngineer.from_state(stale)


def test_make_engineer_rejects_a_wrong_width(tiny_bundle):
    for make in (jax_features.make_engineer, features.make_engineer):
        with pytest.raises(ValueError, match="dense_features=30 matches no"):
            make(tiny_bundle, 30)
    no_side = {k: v for k, v in tiny_bundle.items() if k != "meta/user_gender"}
    with pytest.raises(ValueError, match="dense_features=33 matches no"):
        features.make_engineer(no_side, 33)


@pytest.mark.parametrize("mixed", [False, True])
def test_multitask_loss_with_dense_features_matches_jax(mixed):
    """Loss and every gradient with a dense column in the DCN input, from
    the JAX init carried across by ``params_from_numpy``, dropout 0."""
    f = 7
    jcfg, tcfg = _configs(mixed_precision=mixed, dense_features=f, use_flash_ce=False)
    batch = _batch(seed=5)
    batch["dense"] = np.random.default_rng(6).standard_normal((len(batch["rating"]), f)
                                                              ).astype(np.float32)
    _check_loss_both(jcfg, tcfg, batch)


def _recs_equal(a, b):
    assert [r["item_id"] for r in a] == [r["item_id"] for r in b]
    np.testing.assert_allclose([r["score"] for r in a], [r["score"] for r in b],
                               rtol=1e-5, atol=1e-5)


def _serve_both(serving, users, rerank=20):
    port = RecommendationService(serving, rerank_candidates=rerank, device="cpu").load()
    ref = JaxService(serving, backend="device", rerank_candidates=rerank).load()
    assert port.model_params is not None and port.feature_engineer is not None
    for a, b in zip(port.recommend_batch(users, k=10), ref.recommend_batch(users, k=10)):
        assert a["status"] == b["status"]
        _recs_equal(a["recommendations"], b["recommendations"])
    _recs_equal(port.recommend(users[0], k=5), ref.recommend(users[0], k=5))


def _run_cfgs(dense: int, epochs: int = 1):
    kw = dict(MODEL_KW, dense_features=dense)
    train = dict(batch_size=256, epochs=epochs, learning_rate=5e-3)
    ev = dict(topk=(5, 10), eval_batch_size=256)
    return (JaxRecsysConfig(model=JaxModelConfig(**kw), train=JaxTrainConfig(**train),
                            eval=JaxEvalConfig(**ev)),
            RecsysConfig(model=ModelConfig(**kw), train=TrainConfig(**train),
                         eval=EvalConfig(**ev)))


def test_trainer_with_dense_features_serves_in_both_packages(tiny_bundle, tmp_path):
    """``Trainer.train`` with the side-table features: the dense column
    reaches every step, the final evaluation and the bundle's
    features.npz, which the JAX service reranks with as the port's does."""
    _, tcfg = _run_cfgs(WIDTHS[True], epochs=2)
    out = str(tmp_path / "run")
    tr = Trainer(tcfg, out, device="cpu")
    report = tr.train(tiny_bundle)
    with open(os.path.join(out, "detailed_metrics.json")) as f:
        hist = json.load(f)["epochs"]
    assert all(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"]) for e in hist)
    assert np.isfinite(report["rating_rmse"]) and 0 <= report["recall@10"] <= 1
    serving = os.path.join(out, "serving")
    eng = load_feature_engineer(serving)
    assert len(eng.feature_names()) == WIDTHS[True]
    # the final evaluation used the trained engineer's val features
    want = evaluator.evaluate(tr.final_state.params, tcfg.model, tiny_bundle, "val",
                              tcfg.eval, seed=tcfg.train.seed)
    assert report["rating_rmse"] == pytest.approx(want["rating_rmse"], rel=1e-6)
    _serve_both(serving, [int(u) for u in tiny_bundle["meta/user_raw_ids"][:6]] + [999_999])


def test_jax_trained_dense_bundle_serves_in_the_port(tiny_bundle, tmp_path):
    jcfg, _ = _run_cfgs(WIDTHS[False])
    out = str(tmp_path / "jax_run")
    JaxTrainer(jcfg, out).train(tiny_bundle)
    serving = os.path.join(out, "serving")
    assert os.path.exists(os.path.join(serving, "features.npz"))
    _serve_both(serving, [int(u) for u in tiny_bundle["meta/user_raw_ids"][10:16]])
    # without its features.npz the bundle serves retrieval only, as in JAX
    os.remove(os.path.join(serving, "features.npz"))
    port = RecommendationService(serving, rerank_candidates=20, device="cpu").load()
    assert port.model_params is None and not port._rerank_active()
    assert len(port.recommend(int(tiny_bundle["meta/user_raw_ids"][0]), k=5)) == 5


@pytest.fixture(scope="module")
def dense_params(tiny_bundle):
    cfg = JaxModelConfig(**dict(MODEL_KW, dense_features=WIDTHS[True]))
    n_users, n_items = int(tiny_bundle["meta/n_users"]), int(tiny_bundle["meta/n_movies"])
    return cfg, jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(8), cfg, n_users, n_items))


@pytest.mark.parametrize("given", [True, False])
def test_evaluate_with_dense_features_matches_jax(tiny_bundle, dense_params, given):
    """``evaluate(dense=...)`` and ``two_stage_evaluate(engineer=...)``,
    with the features given or fitted inside from the bundle."""
    jcfg, jp = dense_params
    tcfg = ModelConfig(**dict(MODEL_KW, dense_features=WIDTHS[True]))
    tp = params_from_numpy(jp, "cpu")
    ecfg = dict(topk=(5, 10), eval_sample=300, filter_seen=True, eval_batch_size=128)
    dense = eng = jeng = None
    if given:
        jeng, eng = _engineers(tiny_bundle, True)
        jdense = jeng.fit_transform_splits(tiny_bundle)["test"]
        dense = eng.fit_transform_splits(tiny_bundle)["test"]
    want = jax_ev.evaluate(jp, jcfg, tiny_bundle, "test", JaxEvalConfig(**ecfg), seed=3,
                           dense=jdense if given else None)
    got = evaluator.evaluate(tp, tcfg, tiny_bundle, "test", EvalConfig(**ecfg), seed=3,
                             dense=dense)
    _assert_reports_equal(got, want)
    want = jax_ev.two_stage_evaluate(jp, jcfg, tiny_bundle, "test", n_cand=20,
                                     engineer=jeng, max_rows=300)
    got = evaluator.two_stage_evaluate(tp, tcfg, tiny_bundle, "test", n_cand=20,
                                       engineer=eng, max_rows=300)
    _assert_reports_equal(got, want)


def _load_jax_evaluate_script():
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_script_dense", os.path.join(REPO, "scripts", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_cli_with_dense_features_matches_jax_script(tiny_bundle, dense_params,
                                                             tmp_path):
    """The evaluate CLI takes the bundle's features.npz, as
    ``scripts/evaluate.py`` does, and writes the same report."""
    from recsys_tpu.retrieval.scorer import RetrievalIndex as JaxIndex
    from recsys_tpu.train.checkpoint import save_inference_bundle as jax_save

    jcfg, jp = dense_params
    jeng, _ = _engineers(tiny_bundle, True)
    jeng.fit_transform_splits(tiny_bundle)
    model_dir, data = str(tmp_path / "serving"), str(tmp_path / "bundle.npz")
    n_items = int(tiny_bundle["meta/n_movies"])
    jax_save(model_dir, jp["towers"], JaxRecsysConfig(model=jcfg),
             tiny_bundle["meta/user_raw_ids"], tiny_bundle["meta/movie_raw_ids"],
             index=JaxIndex.build(jp["towers"], jcfg, n_items, tiny_bundle["meta/movie_raw_ids"]),
             full_params=jp, feature_state=jeng.state_dict())
    np.savez(data, **tiny_bundle)
    args = ["--data", data, "--model_dir", model_dir, "--split", "test", "--filter_seen",
            "--rerank_candidates", "20", "--eval_sample", "200", "--topk", "5", "10"]
    assert _load_jax_evaluate_script().main(args + ["--output", str(tmp_path / "j.json")]) == 0
    assert eval_cli.main(args + ["--output", str(tmp_path / "p.json"), "--device", "cpu"]) == 0
    with open(tmp_path / "j.json") as f:
        want = json.load(f)
    with open(tmp_path / "p.json") as f:
        got = json.load(f)
    _assert_reports_equal(got, want)


def test_the_cli_path_runs_on_the_cpu(tmp_path, capsys):
    """preprocess -> train with dense and side features -> evaluate
    (rerank, seen-filtered) -> export -> the exported backend reranking
    with features, each through its ``python -m recsys_tpu_torch.*``
    entry point with ``--device cpu``. The exported backend reranks on the
    host (``_FastRerank``, fp32), as the JAX package's exported backend
    does: held against it, ids equal and scores to 1e-5."""
    from recsys_tpu_torch import export as export_cli
    from recsys_tpu_torch import preprocess as prep_cli
    from recsys_tpu_torch.train import __main__ as train_cli
    from test_torch_data import _write_raw

    raw, data = str(tmp_path / "raw"), str(tmp_path / "b.npz")
    run, report = str(tmp_path / "run"), str(tmp_path / "eval.json")
    _write_raw(raw)
    assert prep_cli.main(["--data_dir", raw, "--output", data,
                          "--synthetic_ratings", "4000"]) == 0
    assert train_cli.main([
        "--data", data, "--output_dir", run, "--use_dense_features", "--use_side_features",
        "--embedding_dim", "16", "--cross_layers", "2", "--batch_size", "256",
        "--epochs", "1", "--device", "cpu", "--set", "model.user_tower_dims=[16]",
        "--set", "model.item_tower_dims=[16]", "--set", "model.dnn_dims=[16,8]"]) == 0
    serving = os.path.join(run, "serving")
    with open(os.path.join(serving, "config.json")) as f:
        assert json.load(f)["model"]["dense_features"] == WIDTHS[True]
    assert eval_cli.main(["--data", data, "--model_dir", serving, "--filter_seen",
                          "--rerank_candidates", "20", "--device", "cpu",
                          "--output", report]) == 0
    with open(report) as f:
        assert 0 <= json.load(f)["two_stage_recall@10"] <= 1
    capsys.readouterr()
    assert export_cli.main(["--model_dir", serving, "--k", "20", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["k"] == 20
    svc = RecommendationService(serving, backend="exported", rerank_candidates=20,
                                device="cpu").load()
    jax_export.export_retrieve(serving, os.path.join(serving, "retrieve.hlo"), k=20)
    ref = JaxService(serving, backend="exported", rerank_candidates=20).load()
    assert svc._fast_rerank is not None and ref._fast_rerank is not None
    user = int(np.load(data)["meta/user_raw_ids"][3])
    _recs_equal(svc.recommend(user, k=10), ref.recommend(user, k=10))


def test_two_stage_evaluate_without_features_needs_no_timestamps(tiny_bundle):
    """Only a dense-feature model reads the split's timestamps: a bundle
    without them (as ``chip_smoke.py`` writes) still evaluates."""
    cfg = ModelConfig(**MODEL_KW)
    jp = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(9), JaxModelConfig(**MODEL_KW),
                                          int(tiny_bundle["meta/n_users"]),
                                          int(tiny_bundle["meta/n_movies"])))
    tp = params_from_numpy(jp, "cpu")
    bare = {k: v for k, v in tiny_bundle.items() if not k.endswith("/timestamp")}
    got = evaluator.two_stage_evaluate(tp, cfg, bare, "val", n_cand=20, max_rows=200)
    want = evaluator.two_stage_evaluate(tp, cfg, tiny_bundle, "val", n_cand=20, max_rows=200)
    assert got == want
