"""The port's training loop against the JAX package's, on the CPU: the
dense train step over 20 steps, the offline evaluator, ``Trainer.train``
end to end (its serving bundle served by both packages), the CLI (its
config against the JAX CLI's for one argv, ``--resume``), the
preemption checkpoint and resume, the explicit-negatives and streaming
modes through ``Trainer.train``, and the modes that are not ported.

Tolerances:
* 20-step trajectory, fp32: losses to rtol = 1e-5 and params to
  atol = 1e-5 (sums in another order, compounded over the steps);
* 20-step trajectory, mixed precision: losses to rtol = 1e-4 and params
  to atol = 2 * 2**-8 * lr / sqrt(0.1) = 4.9e-4 at ``_LR``: a one-ulp
  bf16 flip of a gradient element (see ``test_torch_train_model.py``)
  moves that step's adagrad update, at most lr / sqrt(0.1) while the
  accumulator is near its start, by 2**-8 of itself; two such flips of
  one element are allowed over the 20 steps (the largest move of a param
  is about 1.3, so this is still 4e-4 of it);
* evaluation metrics (plain, seen-filtered and two-stage): equal top-k
  ids, so equal ranking metrics (rtol 1e-6); RMSE and AUC to rtol 1e-5.
"""

import argparse
import csv
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import EvalConfig as JaxEvalConfig
from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.config import TrainConfig as JaxTrainConfig
from recsys_tpu.parallel.mesh import make_mesh
from recsys_tpu.retrieval.evaluator import evaluate as jax_evaluate
from recsys_tpu.retrieval.evaluator import two_stage_evaluate as jax_two_stage_evaluate
from recsys_tpu.serve.service import RecommendationService as JaxService
from recsys_tpu.train.trainer import Trainer as JaxTrainer
from scripts import train as jax_cli
from recsys_tpu_torch.config import (DataConfig, EvalConfig, MeshConfig, ModelConfig,
                                     RecsysConfig, TrainConfig)
from recsys_tpu_torch.retrieval import evaluator
from recsys_tpu_torch.serve.service import RecommendationService
from recsys_tpu_torch.train import __main__ as cli
from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
from recsys_tpu_torch.train.optimizer import leaves_with_paths
from recsys_tpu_torch.train.trainer import Trainer

N_USERS, N_ITEMS, B, N_STEPS = 30, 40, 64, 20
_LR = 0.02
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(24, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0)


def _cfgs(mixed=True, **train_kw):
    model_kw = dict(MODEL_KW, mixed_precision=mixed)
    train_kw = dict(dict(batch_size=B, learning_rate=_LR), **train_kw)
    return (JaxRecsysConfig(model=JaxModelConfig(use_pallas_dcn=True, **model_kw),
                            train=JaxTrainConfig(**train_kw)),
            RecsysConfig(model=ModelConfig(**model_kw), train=TrainConfig(**train_kw)))


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, N_ITEMS + 1)
    out = []
    for _ in range(N_STEPS):
        movie = rng.choice(N_ITEMS, B, p=pop / pop.sum()).astype(np.int32)
        rating = rng.integers(1, 6, B).astype(np.float32)
        out.append({"user_id": rng.integers(0, N_USERS, B).astype(np.int32),
                    "movie_id": movie, "rating": rating,
                    "y_implicit": (rating >= 4).astype(np.float32),
                    "log_q": np.log(pop[movie] / pop.sum()).astype(np.float32)})
    return out


@pytest.mark.parametrize("mixed", [False, True])
def test_train_step_trajectory_matches_jax(mixed, tmp_path):
    """20 dense steps (loss, gradients, adagrad with clipping) from the JAX
    init, carried into the port by the weight bridge, on the same batches."""
    jcfg, tcfg = _cfgs(mixed, clipnorm=1.0)
    cw = (1.4, 0.8)
    jtr = JaxTrainer(jcfg, str(tmp_path / "jax"), mesh_ctx=make_mesh(devices=jax.devices()[:1]))
    jstate = jtr.init_state(N_USERS, N_ITEMS, 0)
    tr = Trainer(tcfg, str(tmp_path / "port"), device="cpu")
    state = tr.state_from_params(params_from_numpy(jax.device_get(jstate.params), "cpu"), 0)
    jstep = jax.jit(jtr._step_core(cw, False))
    step = tr.make_train_step(cw)
    jloss, tloss = [], []
    for batch in _batches():
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tm = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        jloss.append(float(jm["loss"]))
        tloss.append(float(tm["loss"]))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4 if mixed else 1e-5)
    tol = 2 * 2.0 ** -8 * _LR / 0.1 ** 0.5 if mixed else 1e-5
    assert state.step == int(jstate.step) == N_STEPS
    want = dict(leaves_with_paths(jax.device_get(jstate.params)))
    start = dict(leaves_with_paths(params_to_numpy(
        tr.state_from_params(params_from_numpy(jax.device_get(
            jtr.init_state(N_USERS, N_ITEMS, 0).params), "cpu"), 0).params)))
    moved = 0.0
    for path, got in leaves_with_paths(params_to_numpy(state.params)):
        np.testing.assert_allclose(got, want[path], rtol=0, atol=tol, err_msg="/".join(path))
        moved = max(moved, float(np.abs(want[path] - start[path]).max()))
    assert moved > 50 * tol  # the params did move, well past the tolerance
    for path, got in leaves_with_paths(params_to_numpy(state.opt_state)):
        w = dict(leaves_with_paths(jax.device_get(jstate.opt_state)))[path]
        np.testing.assert_allclose(got, w, rtol=tol, atol=tol, err_msg="/".join(path))


@pytest.mark.parametrize("score_norm", ["cosine", "dot"])
def test_evaluate_matches_jax(tiny_bundle, score_norm):
    jcfg, tcfg = _cfgs()
    n_users, n_items = int(tiny_bundle["meta/n_users"]), int(tiny_bundle["meta/n_movies"])
    from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask

    jp = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(4), jcfg.model, n_users, n_items))
    kw = dict(topk=(5, 10, 50), eval_batch_size=128, score_norm=score_norm, eval_sample=300)
    want = jax_evaluate(jp, jcfg.model, tiny_bundle, "val", JaxEvalConfig(**kw), seed=3)
    got = evaluator.evaluate(params_from_numpy(jp, "cpu"), tcfg.model, tiny_bundle, "val",
                             EvalConfig(**kw), seed=3)
    assert got.keys() == want.keys()
    for k, v in want.items():
        rtol = 1e-5 if k in ("rating_rmse", "ctr_auc") else 1e-6
        assert got[k] == pytest.approx(float(v), rel=rtol), k
    # seen-filtered evaluation and the two-stage evaluation agree as well
    kw["filter_seen"] = True
    want = jax_evaluate(jp, jcfg.model, tiny_bundle, "val", JaxEvalConfig(**kw), seed=3)
    got = evaluator.evaluate(params_from_numpy(jp, "cpu"), tcfg.model, tiny_bundle, "val",
                             EvalConfig(**kw), seed=3)
    assert got.keys() == want.keys()
    for k, v in want.items():
        rtol = 1e-5 if k in ("rating_rmse", "ctr_auc") else 1e-6
        assert got[k] == pytest.approx(float(v), rel=rtol), k
    want = jax_two_stage_evaluate(jp, jcfg.model, tiny_bundle, "val", n_cand=20)
    got = evaluator.two_stage_evaluate(params_from_numpy(jp, "cpu"), tcfg.model,
                                       tiny_bundle, "val", n_cand=20)
    assert got == pytest.approx(want, rel=1e-6)


def _small_run_cfg(**train_kw):
    # use_pallas_dcn=True, saved in the bundle's config.json, sends the
    # JAX service down the cross-stack branch whose numerics the port runs
    return RecsysConfig(
        model=ModelConfig(**dict(MODEL_KW, dropout_rate=0.2, use_pallas_dcn=True)),
        train=TrainConfig(**dict(dict(batch_size=256, epochs=3, learning_rate=5e-3),
                                 **train_kw)),
        eval=EvalConfig(topk=(5, 10), eval_batch_size=256))


def test_trainer_trains_end_to_end_and_both_packages_serve_it(tiny_bundle, tmp_path):
    out = str(tmp_path / "run")
    report = Trainer(_small_run_cfg(), out, device="cpu").train(tiny_bundle)
    with open(os.path.join(out, "detailed_metrics.json")) as f:
        hist = json.load(f)["epochs"]
    assert [e["epoch"] for e in hist] == [0, 1, 2]
    assert all(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"]) for e in hist)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    assert metrics["recall@10"] == pytest.approx(report["recall@10"])
    assert metrics["epochs_run"] == 3
    steps = len(tiny_bundle["train/user_id"]) // 256
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "best"] + sorted(f"ckpt_{steps * e}" for e in (1, 2, 3))
    serving = os.path.join(out, "serving")
    port = RecommendationService(serving, rerank_candidates=20, device="cpu").load()
    ref = JaxService(serving, backend="device", rerank_candidates=20).load()
    users = [int(u) for u in tiny_bundle["meta/user_raw_ids"][:6]]
    for a, b in zip(port.recommend_batch(users, k=10), ref.recommend_batch(users, k=10)):
        assert [r["item_id"] for r in a["recommendations"]] == \
            [r["item_id"] for r in b["recommendations"]]
        np.testing.assert_allclose([r["score"] for r in a["recommendations"]],
                                   [r["score"] for r in b["recommendations"]],
                                   rtol=1e-5, atol=1e-5)


def test_trainer_item_bias_starts_at_log_frequency(tiny_bundle, tmp_path):
    """With logQ on, item_bias starts at the log train frequency (the OOV
    row at the smallest); training moves it from there."""
    tr = Trainer(_small_run_cfg(epochs=0), str(tmp_path / "r"), device="cpu")
    tr.train(tiny_bundle)
    n_items = int(tiny_bundle["meta/n_movies"])
    pop = np.bincount(tiny_bundle["train/movie_id"], minlength=n_items).astype(np.float32)
    want = np.log(np.maximum(pop, 0.5) / len(tiny_bundle["train/movie_id"]))
    bias = tr.final_state.params["towers"]["item_bias"].detach().numpy()
    np.testing.assert_allclose(bias[:n_items], want, rtol=1e-6)
    assert bias[n_items] == pytest.approx(want.min())


def test_preemption_checkpoint_then_resume(tiny_bundle, tmp_path, monkeypatch):
    """SIGUSR1 during an epoch: the trainer checkpoints at the epoch's end
    and stops; a rerun with ``train.resume`` continues from that step."""
    out = str(tmp_path / "run")
    tr = Trainer(_small_run_cfg(), out, device="cpu")
    end_epoch = tr.writer.end_epoch

    def end_epoch_with_signal(epoch, logs):
        if epoch == 0:
            os.kill(os.getpid(), signal.SIGUSR1)
        return end_epoch(epoch, logs)

    monkeypatch.setattr(tr.writer, "end_epoch", end_epoch_with_signal)
    report = tr.train(tiny_bundle)
    assert report["preempted"] and report["epochs_run"] == 1
    steps = len(tiny_bundle["train/user_id"]) // 256
    assert report["resume_step"] == steps
    assert signal.getsignal(signal.SIGUSR1) is not None  # handler restored
    resumed = Trainer(_small_run_cfg(resume=True), out, device="cpu")
    report = resumed.train(tiny_bundle)
    assert resumed.final_state.step == 3 * steps
    assert report["epochs_run"] == 3 and "recall@10" in report


_UNPORTED = {
    "debug_nans": (lambda: RecsysConfig(train=TrainConfig(debug_nans=True)),
                   "item 7, debug and profile"),
    "profile": (lambda: RecsysConfig(train=TrainConfig(profile=True)),
                "item 7, debug and profile"),
}


@pytest.mark.parametrize("mode", sorted(_UNPORTED))
def test_unported_modes_raise(mode, tmp_path):
    make_cfg, item = _UNPORTED[mode]
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1: {item}"):
        Trainer(make_cfg(), str(tmp_path), device="cpu")


@pytest.mark.parametrize("axis", ["model_axis", "data_axis"])
def test_a_mesh_axis_without_a_mesh_raises(axis, tmp_path):
    """A model (or data) axis of 2 asks for a mesh: without one (no process
    group, no ``mesh_ctx``) the trainer refuses, and never trains
    replicated on one device instead."""
    cfg = RecsysConfig(mesh=MeshConfig(**{axis: 2, "embedding_sharding": "rows"}))
    with pytest.raises(ValueError, match=f"mesh.{axis}=2 needs a mesh"):
        Trainer(cfg, str(tmp_path), device="cpu")


# the modes that raised before explicit negatives and the streaming path
# were ported: each trains, on the path and step the JAX trainer takes
_NEGATIVE_AND_STREAMING_MODES = {
    "explicit negatives": (dict(negative_sampling="hard"), {}, "resident"),
    "sparse updates": (dict(negative_sampling="mixed"), dict(sparse_table_updates=True),
                       "resident"),
    "CBNS cache": (dict(negative_sampling="mined"), dict(negative_cache=512), "resident"),
    "streaming input": ({}, dict(device_resident_data=False, stream_chunk_steps=4),
                        "streaming"),
}


@pytest.mark.parametrize("mode", sorted(_NEGATIVE_AND_STREAMING_MODES))
def test_negative_and_streaming_modes_train(mode, tiny_bundle, tmp_path):
    """Explicit negatives take the dense step, even with sparse updates
    asked for; the cache composes with them; "mined" trains on a caller's
    table; the streaming path trains step for step like the resident one
    (only the batch order differs)."""
    data_kw, train_kw, path = _NEGATIVE_AND_STREAMING_MODES[mode]
    cfg = _small_run_cfg(epochs=1, **train_kw).replace(
        data=DataConfig(num_hard_negatives=2, num_random_negatives=3, **data_kw))
    tr = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    if cfg.data.negative_sampling == "mined":
        n_items = int(tiny_bundle["meta/n_movies"])
        tr.mined_table = np.random.default_rng(0).integers(
            0, n_items, (int(tiny_bundle["meta/n_users"]), 6))
    report = tr.train(tiny_bundle)
    steps = len(tiny_bundle["train/user_id"]) // 256
    assert tr.data_path == path
    assert tr.step_counts == {"dense": steps, "sparse": 0}
    assert np.isfinite(report["recall@10"])
    if train_kw.get("negative_cache"):
        assert (tr.final_state.extras["ids"] >= 0).all()  # the FIFO filled up
    if cfg.data.negative_sampling == "mined":
        tr2 = Trainer(cfg, str(tmp_path / "no_table"), device="cpu")
        with pytest.raises(ValueError, match="mined table"):
            tr2.train(tiny_bundle)


def test_unported_data_sizes_raise(tiny_bundle, tmp_path):
    """A split above ``device_data_limit_mb`` trains on the streaming
    path, as in the JAX trainer; "auto" takes the sparse table updates
    above the table threshold, and the dense step below it."""
    tr = Trainer(_small_run_cfg(device_data_limit_mb=0, epochs=1), str(tmp_path / "a"),
                 device="cpu")
    report = tr.train(tiny_bundle)
    assert tr.data_path == "streaming" and np.isfinite(report["recall@10"])
    steps = len(tiny_bundle["train/user_id"]) // 256
    assert tr.final_state.step == steps
    tr = Trainer(_small_run_cfg(epochs=1), str(tmp_path / "b"), device="cpu")
    tr.SPARSE_AUTO_THRESHOLD = 10
    tr.train(tiny_bundle)
    assert tr.step_counts == {"dense": 0, "sparse": steps}
    tr = Trainer(_small_run_cfg(epochs=1), str(tmp_path / "c"), device="cpu")
    tr.train(tiny_bundle)
    assert tr.step_counts == {"dense": steps, "sparse": 0}


def test_trainer_without_a_device_asks_for_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(RecsysConfig(), str(tmp_path))


def test_cli_trains_on_the_cpu_and_rejects_other_flags(tiny_bundle, tmp_path, capsys):
    data = str(tmp_path / "bundle.npz")
    np.savez(data, **tiny_bundle)
    out = str(tmp_path / "run")
    assert cli.main(["--data", data, "--output_dir", out, "--embedding_dim", "16",
                     "--cross_layers", "2", "--batch_size", "256", "--epochs", "1",
                     "--retrieval_loss", "flash", "--device", "cpu",
                     "--set", "model.user_tower_dims=[32, 16]",
                     "--set", "model.item_tower_dims=[16]",
                     "--set", "eval.topk=[5, 10]"]) == 0
    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    assert saved["model"]["use_flash_ce"] is True
    assert saved["model"]["user_tower_dims"] == [32, 16]
    assert os.path.exists(os.path.join(out, "serving", "index.npz"))
    with pytest.raises(SystemExit):
        cli.main(["--data", data, "--mesh_model", "2"])
    with pytest.raises(SystemExit):
        cli.main(["--data", data, "--set", "train.no_such_field=1"])
    assert "no_such_field" in capsys.readouterr().err


class _Parsed(Exception):
    pass


def _jax_cli_args(argv, monkeypatch) -> argparse.Namespace:
    """The namespace that ``scripts/train.py``'s parser makes of ``argv``
    (its ``main`` stops right after parsing)."""
    parse = argparse.ArgumentParser.parse_args
    got = {}

    def parse_and_stop(self, args=None, namespace=None):
        got["ns"] = parse(self, args, namespace)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_and_stop)
        with pytest.raises(_Parsed):
            jax_cli.main(argv)
    return got["ns"]


_SHARED_ARGVS = {
    "defaults": ["--data", "x.npz"],
    "every new flag": ["--data", "x.npz", "--resume", "--no-bf16", "--eval_sample", "100",
                       "--softmax_temperature", "0.5", "--distributed_strategy", "mesh",
                       "--per_replica_negatives"],
    "bf16, global negatives": ["--bf16", "--global_negatives", "--distributed_strategy",
                               "mirrored", "--eval_sample", "0", "--softmax_temperature",
                               "0.07", "--embedding_dim", "32", "--retrieval_loss", "flash",
                               "--batch_size", "512"],
    "last flag wins": ["--no-bf16", "--bf16", "--per_replica_negatives", "--global_negatives",
                       "--per_replica_negatives", "--distributed_strategy", "none",
                       "--eval_sample", "5000", "--resume", "--seed", "7"],
    "mode flags at their defaults": ["--data", "x.npz", "--negative_sampling", "random",
                                     "--num_hard_negatives", "20", "--num_random_negatives",
                                     "30", "--model_parallel", "1", "--embedding_sharding",
                                     "replicated", "--lookup_strategy", "xla"],
    "dense features": ["--data", "x.npz", "--use_dense_features"],
    "dense and side features": ["--use_side_features", "--use_dense_features",
                                "--embedding_dim", "128", "--cross_layers", "3"],
    "negative counts": ["--negative_sampling", "random", "--num_hard_negatives", "7",
                        "--num_random_negatives", "9", "--model_parallel", "1",
                        "--embedding_sharding", "replicated", "--lookup_strategy", "xla"],
    "hard negatives": ["--data", "x.npz", "--negative_sampling", "hard",
                       "--num_hard_negatives", "4"],
    "mixed negatives": ["--negative_sampling", "mixed", "--num_hard_negatives", "3",
                        "--num_random_negatives", "11", "--batch_size", "512"],
    "mined negatives": ["--negative_sampling", "mined", "--mined_from", "runs/phase1/serving",
                        "--num_hard_negatives", "10", "--num_random_negatives", "5"],
    "mined_from alone": ["--mined_from", "some/dir"],
}


@pytest.mark.parametrize("name", sorted(_SHARED_ARGVS))
def test_cli_config_matches_the_jax_cli(name, monkeypatch):
    """One argv that both CLIs accept gives one config.json: the flags'
    names, defaults and mappings are the JAX CLI's."""
    argv = _SHARED_ARGVS[name]
    want = jax_cli.build_config(_jax_cli_args(argv, monkeypatch)).to_json()
    assert cli.build_config(cli.build_parser().parse_args(argv)).to_json() == want


@pytest.mark.parametrize("argv", [
    ["--model_parallel", "2"],
    ["--model_parallel", "2", "--embedding_sharding", "rows", "--lookup_strategy", "psum"],
    ["--model_parallel", "4", "--embedding_sharding", "rows", "--lookup_strategy", "a2a",
     "--set", "mesh.lookup_capacity_factor=1.5"],
    ["--embedding_sharding", "rows", "--lookup_strategy", "a2a"]])
def test_cli_row_flags_reach_the_config_of_the_jax_cli(argv, monkeypatch):
    """The row-sharding flags (and ``--set mesh.lookup_capacity_factor``,
    which ``scripts/train.py``'s ``main`` applies after ``build_config``)
    give the ``config.json`` of ``scripts/train.py`` for the same argv."""
    argv = ["--data", "missing.npz"] + argv
    args = _jax_cli_args(argv, monkeypatch)
    want = jax_cli.build_config(args)
    if args.overrides:
        want = want.replace(**cli.parse_overrides(args.overrides))
    assert cli.build_config(cli.build_parser().parse_args(argv)).to_json() == want.to_json()


def test_cli_resume_reaches_the_trainer_and_unported_flags_stay_errors(tiny_bundle, tmp_path):
    """``--resume`` continues the run in ``--output_dir`` from its newest
    checkpoint (the second run trains only the epoch the first left), and
    a flag whose mode is not ported is still refused."""
    data = str(tmp_path / "bundle.npz")
    np.savez(data, **tiny_bundle)
    out = str(tmp_path / "run")
    argv = ["--data", data, "--output_dir", out, "--embedding_dim", "16", "--cross_layers",
            "1", "--batch_size", "256", "--no-bf16", "--eval_sample", "100",
            "--softmax_temperature", "0.5", "--per_replica_negatives", "--device", "cpu",
            "--set", "model.user_tower_dims=[16]", "--set", "model.item_tower_dims=[16]"]

    def epochs_logged():
        with open(os.path.join(out, "training_log.csv")) as f:
            return [int(float(row["epoch"])) for row in csv.DictReader(f)]

    assert cli.main(argv + ["--epochs", "1"]) == 0
    assert epochs_logged() == [0]
    assert cli.main(argv + ["--epochs", "2", "--resume"]) == 0
    assert epochs_logged() == [1]
    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    assert saved["train"]["resume"] is True and saved["train"]["global_negatives"] is False
    assert saved["model"]["mixed_precision"] is False
    assert saved["model"]["softmax_temperature"] == 0.5
    assert saved["eval"]["eval_sample"] == 100
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f)["epochs_run"] == 2
    with pytest.raises(SystemExit):
        cli.main(["--data", data, "--use_wandb"])
    with pytest.raises(SystemExit, match="requires --use_dense_features"):
        cli.main(["--data", data, "--use_side_features"])
