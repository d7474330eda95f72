"""Parity of the port's optimizer, checkpoints, ranking metrics and metric
writer with the JAX package, on the CPU.

Tolerances: the optimizers and the schedule run the same fp32 arithmetic
in the same order per element, so params, slots and learning rates agree
to rtol = 1e-6 (atol = 1e-7: XLA may fuse ``p - lr * g / (sqrt(a) + eps)``
into other roundings); the global norm sums the leaves in another order
(rtol = 1e-6). Checkpoints, metrics and the writer's files are compared
exactly.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.retrieval.metrics import RankingMetrics as JaxRankingMetrics
from recsys_tpu.train import checkpoint as jax_ckpt
from recsys_tpu.train import optimizer as JO
from recsys_tpu.utils.metrics_io import MetricWriter as JaxMetricWriter
from recsys_tpu_torch.config import RecsysConfig, TrainConfig
from recsys_tpu_torch.retrieval.metrics import RankingMetrics
from recsys_tpu_torch.train import checkpoint as ckpt
from recsys_tpu_torch.train import optimizer as O
from recsys_tpu_torch.utils.metrics_io import MetricWriter


def _tree(rng):
    return {"towers": {"user_table": rng.standard_normal((7, 4)).astype(np.float32),
                       "item_bias": rng.standard_normal(5).astype(np.float32)},
            "dcn": {"cross": {"layer_0": {"w": rng.standard_normal(6).astype(np.float32)}}},
            "ctr_head": {"b": rng.standard_normal(1).astype(np.float32)}}


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got, want, rtol=1e-6, atol=1e-7):
    for (path, g), (_, w) in zip(O.leaves_with_paths(got), O.leaves_with_paths(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("name", ["adagrad", "adam"])
@pytest.mark.parametrize("clipnorm,lr_ranking", [(0.0, None), (0.5, 3e-2)])
def test_optimizer_updates_match_jax(name, clipnorm, lr_ranking):
    """Five updates of the configured optimizer (schedule with warmup and
    staircase decay, optional clipping and ranking-LR split) on the same
    gradients; the port updates its tensors in place."""
    cfg = TrainConfig(optimizer=name, learning_rate=1e-2, clipnorm=clipnorm,
                      learning_rate_ranking=lr_ranking, warmup_steps=2, lr_decay_steps=3,
                      lr_decay_rate=0.5)
    rng = np.random.default_rng(0)
    jparams = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jopt, topt = JO.make_optimizer(cfg), O.make_optimizer(cfg)
    jstate = jopt.init(jparams)
    tparams = _to_torch(jparams)
    tstate = topt.init(tparams)
    for step, g in enumerate(grads):
        jparams, jstate = jopt.update(g, jstate, jparams, jnp.asarray(step, jnp.int32))
        topt.update(_to_torch(g), tstate, tparams, step)
    _close(tparams, jax.device_get(jparams))
    _close(tstate, jax.device_get(jstate))


def test_adagrad_starts_its_accumulator_at_0_1():
    opt = O.adagrad(lambda step: 1.0)
    p = {"w": torch.zeros(3)}
    state = opt.init(p)
    torch.testing.assert_close(state["accum"]["w"], torch.full((3,), 0.1))
    opt.update({"w": torch.ones(3)}, state, p, 0)
    torch.testing.assert_close(p["w"], torch.full((3,), -1.0 / (1.1 ** 0.5 + 1e-7)))


@pytest.mark.parametrize("staircase,warmup", [(True, 0), (False, 0), (True, 4)])
def test_schedule_matches_jax(staircase, warmup):
    j = JO.exponential_decay(3e-3, 5, 0.9, staircase, warmup)
    t = O.exponential_decay(3e-3, 5, 0.9, staircase, warmup)
    for step in range(0, 23):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step, jnp.int32))),
                                   rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.1, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(1))
    _close(O.clip_by_global_norm(_to_torch(g), max_norm),
           jax.device_get(JO.clip_by_global_norm(g, max_norm)))
    zero = {"w": torch.zeros(4)}  # the norm floor keeps zeros finite
    torch.testing.assert_close(O.clip_by_global_norm(zero, 1.0)["w"], torch.zeros(4))


def test_ranking_lr_scale_marks_the_ranking_stack():
    cfg = TrainConfig(learning_rate=1e-3, learning_rate_ranking=4e-3)
    scale = O.ranking_lr_scale(cfg)
    assert scale(("dcn", "cross", "layer_0", "w")) == pytest.approx(4.0)
    assert scale(("ctr_head", "b")) == pytest.approx(4.0)
    assert scale(("towers", "user_table")) == 1.0
    assert O.ranking_lr_scale(TrainConfig()) is None
    with pytest.raises(ValueError, match="unknown optimizer"):
        O.make_optimizer(TrainConfig(optimizer="sgd"))


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_manager_keeps_n_and_best(tmp_path, async_save):
    mgr = ckpt.CheckpointManager(str(tmp_path / "c"), keep=2, async_save=async_save)
    state = lambda s: {"params": {"w": torch.full((3,), float(s))}, "step": np.int64(s)}
    for s in (10, 20, 30, 40):
        mgr.save(s, state(s), metrics={"val_loss": 1.0 / s}, is_best=(s == 20))
    mgr.close()
    # keep-2 plus the best
    assert mgr.all_steps() == [20, 30, 40]
    assert mgr.best_step() == 20
    step, tree = mgr.restore_latest()
    assert step == 40 and int(tree["step"]) == 40
    np.testing.assert_array_equal(tree["params"]["w"], np.full(3, 40.0, np.float32))
    assert mgr.restore_best()[0] == 20
    with open(tmp_path / "c" / "ckpt_30" / "metrics.json") as f:
        assert json.load(f) == {"val_loss": pytest.approx(1 / 30)}
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path / "c"))


def test_checkpoints_cross_between_packages(tmp_path):
    """The npz layout is the JAX package's: each package restores the
    other's checkpoint."""
    rng = np.random.default_rng(2)
    tree = {"params": _tree(rng), "step": np.int64(7)}
    ckpt.CheckpointManager(str(tmp_path / "port")).save(7, _to_torch(tree))
    step, got = jax_ckpt.CheckpointManager(str(tmp_path / "port"),
                                           use_orbax=False).restore_latest()
    assert step == 7
    _close(got["params"], tree["params"], rtol=0, atol=0)
    jax_ckpt.CheckpointManager(str(tmp_path / "jax"), use_orbax=False).save(7, tree)
    step, got = ckpt.CheckpointManager(str(tmp_path / "jax")).restore_latest()
    assert step == 7 and int(got["step"]) == 7
    _close(got["params"], tree["params"], rtol=0, atol=0)


def test_ranking_metrics_match_jax():
    rng = np.random.default_rng(3)
    preds = rng.integers(0, 60, (200, 20))
    truth = np.where(rng.random(200) < 0.5, preds[np.arange(200), rng.integers(0, 20, 200)],
                     rng.integers(0, 60, 200))
    got = RankingMetrics.full_report(preds, truth, topk=(1, 5, 20, 50), catalog_size=60)
    want = JaxRankingMetrics.full_report(preds, truth, topk=(1, 5, 20, 50), catalog_size=60)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_metric_writer_writes_the_jax_artifacts(tmp_path):
    logs = [{"train_loss": 2.0, "val_loss": 1.5}, {"train_loss": 1.0, "val_loss": 1.2}]
    cfg = RecsysConfig()
    dirs = {}
    for name, cls in (("port", MetricWriter), ("jax", JaxMetricWriter)):
        w = cls(str(tmp_path / name), tensorboard=False)  # the TB sink: test_torch_debug.py
        w.write_config(cfg)
        for epoch, entry in enumerate(logs):
            w.start_epoch()
            w.end_epoch(epoch, entry)
        w.write_final_metrics({"recall@10": 0.25})
        w.close()
        dirs[name] = tmp_path / name
    for d in dirs.values():
        assert sorted(os.listdir(d)) >= ["config.json", "detailed_metrics.json",
                                          "metrics.json", "training_log.csv"]
    with open(dirs["port"] / "training_log.csv") as f:
        port_rows = list(csv.DictReader(f))
    with open(dirs["jax"] / "training_log.csv") as f:
        jax_rows = list(csv.DictReader(f))
    assert [r["train_loss"] for r in port_rows] == [r["train_loss"] for r in jax_rows]
    assert set(port_rows[0]) <= set(jax_rows[0])
    for name in ("metrics.json", "config.json"):
        with open(dirs["port"] / name) as a, open(dirs["jax"] / name) as b:
            assert json.load(a) == json.load(b), name
