"""Seen-filtered and two-stage evaluation of the PyTorch port against the
JAX package, on the CPU: ``SeenIndex``, ``evaluate(filter_seen=True)``
through the per-batch mask and through over-retrieval (dense and
blockwise), ``two_stage_evaluate`` (the DCN rerank on the JAX side runs
its Pallas kernel in interpret mode: ``use_pallas_dcn=True``), the
trainer's final evaluation under ``filter_seen``, and
``python -m recsys_tpu_torch.evaluate`` against ``scripts/evaluate.py``.

Tolerances, as ``test_torch_train_loop.py``: equal top-k ids, so ranking
metrics to rtol 1e-6; RMSE and AUC to rtol 1e-5.
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
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.retrieval import evaluator as jax_ev
from recsys_tpu.retrieval.scorer import RetrievalIndex as JaxRetrievalIndex
from recsys_tpu.train.checkpoint import save_inference_bundle as jax_save_bundle
from recsys_tpu_torch import evaluate as eval_cli
from recsys_tpu_torch.config import EvalConfig, ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.retrieval import evaluator, scorer
from recsys_tpu_torch.train.checkpoint import params_from_numpy
from recsys_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(24, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0, use_pallas_dcn=True)


def _assert_reports_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v, k
            continue
        rtol = 1e-5 if k in ("rating_rmse", "ctr_auc") else 1e-6
        assert got[k] == pytest.approx(float(v), rel=rtol), k


@pytest.fixture(scope="module")
def jax_params(tiny_bundle):
    cfg = JaxModelConfig(**MODEL_KW)
    n_users, n_items = int(tiny_bundle["meta/n_users"]), int(tiny_bundle["meta/n_movies"])
    return jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(4), cfg, n_users, n_items))


def test_seen_index_matches_jax(tiny_bundle):
    args = (tiny_bundle["train/user_id"], tiny_bundle["train/movie_id"],
            int(tiny_bundle["meta/n_users"]), int(tiny_bundle["meta/n_movies"]))
    want, got = jax_ev.SeenIndex(*args), evaluator.SeenIndex(*args)
    assert got.max_seen == want.max_seen > 0
    for name in ("keys", "items", "indptr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    users = tiny_bundle["val/user_id"][:50]
    np.testing.assert_array_equal(got.batch_mask(users), want.batch_mask(users))
    rng = np.random.default_rng(0)
    cand = np.stack([rng.permutation(args[3])[:60] for _ in users])
    scores = -np.sort(-rng.standard_normal(cand.shape), axis=1).astype(np.float32)
    np.testing.assert_array_equal(got.contains(users[:, None], cand),
                                  want.contains(users[:, None], cand))
    for a, b in zip(got.filter_topk(users, cand, 10, scores),
                    want.filter_topk(users, cand, 10, scores)):
        np.testing.assert_array_equal(a, b)
    empty = evaluator.SeenIndex(np.zeros(0, np.int32), np.zeros(0, np.int32), 3, 5)
    assert empty.max_seen == 0 and not empty.contains(np.array([1]), np.array([2])).any()


# the over-retrieve branch at topk 300: k + max_seen passes 256, so the
# port's exact top-k takes the dense product, or, with the dense-scores
# cap patched low, the blockwise scan
_BRANCHES = {"batch_mask": (False, False), "over_retrieve": (True, False),
             "over_retrieve_blockwise": (True, True)}


@pytest.mark.parametrize("score_norm", ["cosine", "dot"])
@pytest.mark.parametrize("branch", sorted(_BRANCHES))
def test_evaluate_filter_seen_matches_jax(tiny_bundle, jax_params, monkeypatch, branch,
                                          score_norm):
    over, blockwise = _BRANCHES[branch]
    if over:
        monkeypatch.setattr(jax_ev, "_BATCH_MASK_LIMIT", 0)
        monkeypatch.setattr(evaluator, "_BATCH_MASK_LIMIT", 0)
    if blockwise:
        monkeypatch.setattr(scorer, "_DENSE_SCORES_CAP", 1)
    dense_calls = scorer.topk_scores.calls
    kw = dict(topk=(5, 10, 300) if over else (5, 10, 50), eval_batch_size=128,
              score_norm=score_norm, eval_sample=300, filter_seen=True)
    cfg = JaxModelConfig(**MODEL_KW)
    want = jax_ev.evaluate(jax_params, cfg, tiny_bundle, "val", JaxEvalConfig(**kw), seed=3)
    got = evaluator.evaluate(params_from_numpy(jax_params, "cpu"), ModelConfig(**MODEL_KW),
                             tiny_bundle, "val", EvalConfig(**kw), seed=3)
    _assert_reports_equal(got, want)
    assert (scorer.topk_scores.calls > dense_calls) == (over and not blockwise)
    # filtering changes the report: unfiltered, seen items are recommended
    plain = evaluator.evaluate(params_from_numpy(jax_params, "cpu"), ModelConfig(**MODEL_KW),
                               tiny_bundle, "val", EvalConfig(**dict(kw, filter_seen=False)),
                               seed=3)
    assert plain["coverage"] != got["coverage"] or plain["recall@5"] != got["recall@5"]


@pytest.mark.parametrize("n_cand,over", [(20, False), (200, True), (20, True)])
def test_two_stage_evaluate_matches_jax(tiny_bundle, jax_params, monkeypatch, n_cand, over):
    if over:
        monkeypatch.setattr(jax_ev, "_BATCH_MASK_LIMIT", 0)
        monkeypatch.setattr(evaluator, "_BATCH_MASK_LIMIT", 0)
    cfg = JaxModelConfig(**MODEL_KW)
    want = jax_ev.two_stage_evaluate(jax_params, cfg, tiny_bundle, "val", n_cand=n_cand,
                                     rating_weight=0.5)
    got = evaluator.two_stage_evaluate(params_from_numpy(jax_params, "cpu"),
                                       ModelConfig(**MODEL_KW), tiny_bundle, "val",
                                       n_cand=n_cand, rating_weight=0.5)
    _assert_reports_equal(got, want)
    assert got["two_stage_candidates"] == n_cand


def test_trainer_final_evaluate_honours_filter_seen(tiny_bundle, tmp_path):
    cfg = RecsysConfig(model=ModelConfig(**MODEL_KW),
                       train=TrainConfig(batch_size=256, epochs=1, learning_rate=5e-3),
                       eval=EvalConfig(topk=(5, 10), eval_batch_size=256, filter_seen=True))
    tr = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    report = tr.train(tiny_bundle)
    want = evaluator.evaluate(tr.final_state.params, cfg.model, tiny_bundle, "val",
                              cfg.eval, seed=cfg.train.seed)
    unfiltered = evaluator.evaluate(tr.final_state.params, cfg.model, tiny_bundle, "val",
                                    EvalConfig(topk=(5, 10), eval_batch_size=256),
                                    seed=cfg.train.seed)
    for k in ("recall@10", "ndcg@10", "coverage"):
        assert report[k] == pytest.approx(want[k], rel=1e-6), k
    assert any(report[k] != unfiltered[k] for k in ("recall@10", "ndcg@10", "coverage"))


def _load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_script", os.path.join(REPO, "scripts", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_cli_matches_jax_script(tiny_bundle, jax_params, tmp_path, capsys):
    n_items = int(tiny_bundle["meta/n_movies"])
    cfg = JaxRecsysConfig(model=JaxModelConfig(**MODEL_KW))
    index = JaxRetrievalIndex.build(jax_params["towers"], cfg.model, n_items,
                                    tiny_bundle["meta/movie_raw_ids"])
    model_dir = str(tmp_path / "serving")
    jax_save_bundle(model_dir, jax_params["towers"], cfg, tiny_bundle["meta/user_raw_ids"],
                    tiny_bundle["meta/movie_raw_ids"], index=index, full_params=jax_params)
    data = str(tmp_path / "bundle.npz")
    np.savez(data, **tiny_bundle)
    args = ["--data", data, "--model_dir", model_dir, "--split", "test", "--filter_seen",
            "--rerank_candidates", "20", "--eval_sample", "200", "--topk", "5", "10"]
    assert _load_jax_script().main(args + ["--output", str(tmp_path / "jax.json")]) == 0
    assert eval_cli.main(args + ["--output", str(tmp_path / "port.json"),
                                 "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.split("\n}\n")[-2] + "\n}")
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    _assert_reports_equal(got, want)
    assert printed["split"] == "test" and "two_stage_recall@10" in printed
    with pytest.raises(SystemExit):  # a bundle without model.npz
        os.remove(os.path.join(model_dir, "model.npz"))
        eval_cli.main(args + ["--device", "cpu"])


def test_evaluate_cli_refuses_dense_features(tiny_bundle, tmp_path, capsys):
    """A model with dense features evaluates only with the engineer it was
    trained with: a bundle without features.npz is refused, as by
    ``scripts/evaluate.py``, and with it the CLI runs
    (``test_torch_dense_features.py`` holds its report against JAX's)."""
    from recsys_tpu_torch.data.features import make_engineer
    from recsys_tpu_torch.models.multitask import MultiTaskModel
    from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
    from recsys_tpu_torch.train.checkpoint import save_inference_bundle

    import torch

    cfg = RecsysConfig(model=ModelConfig(**dict(MODEL_KW, dense_features=29)))
    n_users, n_items = int(tiny_bundle["meta/n_users"]), int(tiny_bundle["meta/n_movies"])
    params = MultiTaskModel.init(torch.Generator().manual_seed(0), cfg.model, n_users,
                                 n_items, "cpu")
    index = RetrievalIndex.build(params["towers"], cfg.model, n_items,
                                 tiny_bundle["meta/movie_raw_ids"], device="cpu")
    model_dir, data = str(tmp_path / "serving"), str(tmp_path / "bundle.npz")
    save_inference_bundle(model_dir, params["towers"], cfg, tiny_bundle["meta/user_raw_ids"],
                          tiny_bundle["meta/movie_raw_ids"], index=index, full_params=params)
    np.savez(data, **tiny_bundle)
    argv = ["--data", data, "--model_dir", model_dir, "--device", "cpu",
            "--eval_sample", "100", "--topk", "5"]
    with pytest.raises(SystemExit):
        eval_cli.main(argv)
    assert "no features.npz" in capsys.readouterr().err
    eng = make_engineer(tiny_bundle, 29)
    eng.fit_transform_splits(tiny_bundle)
    np.savez(os.path.join(model_dir, "features.npz"), **eng.state_dict())
    assert eval_cli.main(argv + ["--output", str(tmp_path / "r.json")]) == 0
    with open(tmp_path / "r.json") as f:
        assert np.isfinite(json.load(f)["rating_rmse"])
