"""The port's streaming input path against the JAX package's, on the CPU:
the ``Batcher`` (train and padded val batches, per-process slices, two
epochs), ``_prefetch`` and the placer, the streaming ``Trainer.train``
with mixed negatives and mid-epoch checkpoints at ``stream_chunk_steps``
1 and 5 against the JAX streaming run from the same init, the port's
chunked run against its own per-step run, and the train CLI on the
streaming path with mixed and then mined negatives.

Tolerances:
* the Batcher: bit-equal batches and masks;
* the streaming run against JAX (fp32): final params to atol 1e-5, the
  train and val losses logged per epoch to rtol 1e-5 (the trajectory
  test's tolerances, ``test_train_step_trajectory_matches_jax``); the same
  step count and the same mid-epoch checkpoint steps;
* chunked against per-step (the port alone): params to atol 1e-5 (the
  same steps in the same order; only the metrics' sums are grouped
  otherwise).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.config import DataConfig as JaxDataConfig
from recsys_tpu.config import EvalConfig as JaxEvalConfig
from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.config import TrainConfig as JaxTrainConfig
from recsys_tpu.data.pipeline import Batcher as JaxBatcher
from recsys_tpu.parallel.mesh import make_mesh
from recsys_tpu.train.trainer import Trainer as JaxTrainer
from recsys_tpu_torch.config import DataConfig, EvalConfig, ModelConfig, RecsysConfig, TrainConfig
from recsys_tpu_torch.data.features import FeatureEngineer
from recsys_tpu_torch.data.pipeline import TRAIN_COLS, Batcher
from recsys_tpu_torch.train import __main__ as cli
from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
from recsys_tpu_torch.train.optimizer import leaves_with_paths
from recsys_tpu_torch.train.trainer import Trainer, _Placer, _prefetch

MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32,), item_tower_dims=(32,),
                cross_layers=2, dnn_dims=(16,), dropout_rate=0.0, mixed_precision=False)
B = 256


@pytest.mark.parametrize("split", ["train", "val"])
def test_batcher_is_bit_equal_to_jax(tiny_bundle, split):
    """Train batches (the tail dropped) and val batches (the tail padded,
    with its mask), whole and as two processes' slices, over two epochs."""
    kw = dict(batch_size=128, seed=9, columns=TRAIN_COLS + ("age_at_rating",))
    if split == "val":
        kw.update(shuffle=False, drop_remainder=False)
    for proc in ({}, dict(process_index=0, process_count=2),
                 dict(process_index=1, process_count=2)):
        got = Batcher(tiny_bundle, split, **kw, **proc)
        want = JaxBatcher(tiny_bundle, split, **kw, **proc)
        assert got.steps_per_epoch == want.steps_per_epoch > 0
        for epoch in (0, 1):
            pairs = list(zip(got.epoch(epoch), want.epoch(epoch), strict=True))
            assert len(pairs) == want.steps_per_epoch
            for a, b in pairs:
                assert a.keys() == b.keys()
                assert ("mask" in a) == (split == "val")
                for k in b:
                    assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if split == "train":
            first = [next(iter(got.epoch(e)))["user_id"] for e in (0, 1)]
            assert not np.array_equal(*first)  # a new order each epoch
    with pytest.raises(ValueError, match="divide"):
        Batcher(tiny_bundle, split, batch_size=5, process_count=2)


def test_prefetch_places_two_ahead_and_the_cpu_placer_is_plain():
    placed = []
    gen = _prefetch(iter(range(5)), lambda x: placed.append(x) or 10 * x)
    assert next(gen) == 0 and placed == [0, 1]
    assert list(gen) == [10, 20, 30, 40] and placed == [0, 1, 2, 3, 4]
    placer = _Placer(torch.device("cpu"))
    batch = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": np.ones(2, np.float32)}
    out = placer.ready(placer(batch))
    assert out.keys() == batch.keys() and all(t.device.type == "cpu" for t in out.values())
    for k, v in batch.items():
        np.testing.assert_array_equal(out[k].numpy(), v)


def _stream_cfgs(**train_kw):
    train_kw = dict(dict(batch_size=B, epochs=1, learning_rate=5e-3, log_every_steps=1,
                         device_resident_data=False), **train_kw)
    data_kw = dict(negative_sampling="mixed", num_hard_negatives=2, num_random_negatives=3)
    eval_kw = dict(topk=(5, 10), eval_batch_size=B)
    return (JaxRecsysConfig(model=JaxModelConfig(use_pallas_dcn=True, **MODEL_KW),
                            data=JaxDataConfig(**data_kw), train=JaxTrainConfig(**train_kw),
                            eval=JaxEvalConfig(**eval_kw)),
            RecsysConfig(model=ModelConfig(**MODEL_KW), data=DataConfig(**data_kw),
                         train=TrainConfig(**train_kw), eval=EvalConfig(**eval_kw)))


def _record_saves(trainer, into: list):
    save = trainer.ckpt.save

    def recording(step, state, metrics=None, is_best=False):
        into.append((int(np.asarray(step)), dict(metrics or {})))
        return save(step, state, metrics=metrics, is_best=is_best)

    trainer.ckpt.save = recording


def _epoch_logs(out_dir):
    with open(os.path.join(out_dir, "detailed_metrics.json")) as f:
        return json.load(f)["epochs"]


@pytest.mark.parametrize("chunk", [1, 5])
def test_streaming_train_matches_jax(tiny_bundle, tmp_path, chunk):
    """Mixed negatives, a checkpoint every 3 steps (so chunks of at most
    3), from the JAX init injected through ``state_from_params``."""
    jcfg, tcfg = _stream_cfgs(stream_chunk_steps=chunk, checkpoint_every_steps=3)
    n_users, n_items = int(tiny_bundle["meta/n_users"]), int(tiny_bundle["meta/n_movies"])
    jtr = JaxTrainer(jcfg, str(tmp_path / "jax"), mesh_ctx=make_mesh(devices=jax.devices()[:1]))
    init = jax.device_get(jtr.init_state(n_users, n_items, tcfg.train.seed).params)
    tr = Trainer(tcfg, str(tmp_path / "port"), device="cpu")
    tr.init_state = lambda n_u, n_i, seed: tr.state_from_params(params_from_numpy(init, "cpu"),
                                                                seed)
    jsaves, tsaves = [], []
    _record_saves(jtr, jsaves)
    _record_saves(tr, tsaves)
    jtr.train(tiny_bundle)
    tr.train(tiny_bundle)
    assert tr.data_path == "streaming"
    steps = len(tiny_bundle["train/user_id"]) // B
    assert tr.final_state.step == int(np.asarray(jtr.final_state.step)) == steps
    assert tr.step_counts == {"dense": steps, "sparse": 0}
    mid = [(s, m) for s, m in tsaves if "mid_epoch" in m]
    assert mid == [(s, m) for s, m in jsaves if "mid_epoch" in m]
    assert [s for s, _ in mid] == list(range(3, steps + 1, 3))
    want = dict(leaves_with_paths(jax.device_get(jtr.final_state.params)))
    start = dict(leaves_with_paths(init))
    moved = 0.0
    for path, got in leaves_with_paths(params_to_numpy(tr.final_state.params)):
        np.testing.assert_allclose(got, want[path], rtol=0, atol=1e-5, err_msg="/".join(path))
        if path[-1] != "item_bias":  # starts at the log frequency, not the init
            moved = max(moved, float(np.abs(got - start[path]).max()))
    assert moved > 50 * 1e-5  # the params did move, well past the tolerance
    for a, b in zip(_epoch_logs(tmp_path / "port"), _epoch_logs(tmp_path / "jax"),
                    strict=True):
        for k in ("train_loss", "train_retrieval_loss", "val_loss", "val_rating_mse"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), k


def test_stream_chunks_match_the_port_per_step_run(tiny_bundle, tmp_path):
    """``stream_chunk_steps`` changes the transfers only: 5-step chunks
    (two a epoch, then a 2-step tail) reach the per-step run's params over
    two epochs, here with hard negatives and the engineered dense
    features as a streamed column."""
    f = FeatureEngineer.n_features(with_genres=True)
    runs = {}
    for chunk in (1, 5):
        _, cfg = _stream_cfgs(epochs=2, stream_chunk_steps=chunk)
        cfg = cfg.replace(**{"model.dense_features": f, "data.negative_sampling": "hard"})
        tr = Trainer(cfg, str(tmp_path / f"k{chunk}"), device="cpu")
        report = tr.train(tiny_bundle)
        assert np.isfinite(report["recall@10"]) and tr.data_path == "streaming"
        runs[chunk] = tr
    assert runs[1].final_state.step == runs[5].final_state.step == 2 * (
        len(tiny_bundle["train/user_id"]) // B)
    want = dict(leaves_with_paths(params_to_numpy(runs[1].final_state.params)))
    for path, got in leaves_with_paths(params_to_numpy(runs[5].final_state.params)):
        np.testing.assert_allclose(got, want[path], rtol=0, atol=1e-5, err_msg="/".join(path))
    assert os.path.exists(tmp_path / "k5" / "serving" / "features.npz")


def test_cli_streams_mixed_then_mined_negatives(tiny_bundle, tmp_path):
    """The train CLI on the streaming path (``--set
    train.device_resident_data=false``) with mixed negatives and mid-epoch
    checkpoints, then ``--negative_sampling mined --mined_from`` that
    run's serving bundle, resident."""
    data = str(tmp_path / "bundle.npz")
    np.savez(data, **tiny_bundle)
    common = ["--data", data, "--embedding_dim", "16", "--cross_layers", "1",
              "--batch_size", str(B), "--epochs", "1", "--no-bf16", "--device", "cpu",
              "--num_hard_negatives", "2", "--num_random_negatives", "3",
              "--set", "model.user_tower_dims=[16]", "--set", "model.item_tower_dims=[16]",
              "--set", "eval.topk=[5, 10]"]
    first = str(tmp_path / "mixed")
    assert cli.main(common + ["--output_dir", first, "--negative_sampling", "mixed",
                              "--set", "train.device_resident_data=false",
                              "--set", "train.checkpoint_every_steps=4",
                              "--set", "train.keep_checkpoints=10"]) == 0
    steps = len(tiny_bundle["train/user_id"]) // B
    ckpts = sorted(int(n[5:]) for n in os.listdir(os.path.join(first, "checkpoints"))
                   if n.startswith("ckpt_"))
    assert ckpts == sorted(set(range(4, steps + 1, 4)) | {steps})
    with open(os.path.join(first, "checkpoints", "ckpt_4", "metrics.json")) as f:
        assert json.load(f) == {"mid_epoch": 0.0}
    second = str(tmp_path / "mined")
    assert cli.main(common + ["--output_dir", second, "--negative_sampling", "mined",
                              "--mined_from", os.path.join(first, "serving"),
                              "--set", "model.explicit_negatives_weight=0.1",
                              "--set", "data.mined_pool_size=6"]) == 0
    with open(os.path.join(second, "config.json")) as f:
        saved = json.load(f)
    assert saved["data"]["negative_sampling"] == "mined"
    assert saved["data"]["mined_from"] == os.path.join(first, "serving")
    with open(os.path.join(second, "metrics.json")) as f:
        assert np.isfinite(json.load(f)["recall@10"])
    assert os.path.exists(os.path.join(second, "serving", "index.npz"))
