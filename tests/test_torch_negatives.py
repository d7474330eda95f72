"""The port's explicit negatives against the JAX package's, on the CPU:
``NegativeSampler`` (its fit, ``sample_batch`` for every strategy over
consecutive calls, ``sample_negatives``), ``mine_hard_negatives`` (the
rank window, the seen filter, the tiny-catalog clamp),
``MultiTaskModel.loss`` with ``neg_item_ids``, and 20 train steps with fed
negatives against the JAX ``Trainer._step_core(cw, True)``.

Tolerances:
* the sampler: bit-equal (the same numpy draws in the same order);
* mined tables: equal ids, except where two items tie: a differing id
  must score within 1e-5 of max|score| of the id it replaces;
* the loss with negatives: as ``test_torch_train_model.py`` (values to
  rtol 1e-5; gradients to 1e-5 * |want| + 1e-5 * max|want|, and under
  mixed precision up to 10% of a leaf one bf16 ulp of its scale beyond);
* the 20-step trajectory: as ``test_train_step_trajectory_matches_jax``
  (fp32: losses rtol 1e-5, params atol 1e-5; mixed precision: losses
  rtol 1e-4, params atol 4.9e-4).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.data.negative_sampling import NegativeSampler as JaxSampler
from recsys_tpu.data.negative_sampling import mine_hard_negatives as jax_mine
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.parallel.mesh import make_mesh
from recsys_tpu.train.trainer import Trainer as JaxTrainer
from test_torch_train_loop import _LR, N_ITEMS, N_STEPS, N_USERS, _batches, _cfgs
from test_torch_train_model import CLASS_WEIGHTS, _batch, _configs, assert_grads_close
from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.data.negative_sampling import NegativeSampler, mine_hard_negatives
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.retrieval.scorer import materialize_item_embeddings
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
from recsys_tpu_torch.train.optimizer import leaves_with_paths
from recsys_tpu_torch.train.trainer import Trainer

STRATEGIES = ("random", "hard", "mixed", "mined")


def _fit_both(bundle, strategy, num_hard=3, num_random=4, seed=5):
    n_items = int(bundle["meta/n_movies"])
    args = (bundle["train/user_id"], bundle["train/movie_id"], n_items)
    got = NegativeSampler(strategy, num_hard, num_random, seed=seed).fit(*args)
    want = JaxSampler(strategy, num_hard, num_random, seed=seed).fit(*args)
    if strategy == "mined":
        table = np.random.default_rng(1).integers(
            0, n_items, (int(bundle["meta/n_users"]), 7)).astype(np.int32)
        got.set_mined(table)
        want.set_mined(table)
    return got, want


def test_sampler_fit_matches_jax(tiny_bundle):
    got, want = _fit_both(tiny_bundle, "mixed")
    np.testing.assert_array_equal(got.item_popularity, want.item_popularity)
    np.testing.assert_array_equal(got._pop_order, want._pop_order)
    assert got.user_seen.keys() == want.user_seen.keys()
    for u, seen in want.user_seen.items():
        np.testing.assert_array_equal(got.user_seen[u], seen)
    got._build_hard_cache()
    want._build_hard_cache()
    np.testing.assert_array_equal(got._hard_cache, want._hard_cache)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sample_batch_is_bit_equal_to_jax(tiny_bundle, strategy):
    """Three consecutive batches, then per-user draws, from one stream."""
    got, want = _fit_both(tiny_bundle, strategy)
    assert got.n_negatives() == want.n_negatives()
    users = tiny_bundle["train/user_id"]
    for i in range(3):
        uids = users[i * 64:(i + 1) * 64]
        a, b = got.sample_batch(uids), want.sample_batch(uids)
        assert a.dtype == b.dtype == np.int32 and a.shape == (64, want.n_negatives())
        np.testing.assert_array_equal(a, b)
    for u in users[:5]:
        np.testing.assert_array_equal(got.sample_negatives(u), want.sample_negatives(u))


@pytest.mark.parametrize("num_hard, num_random", [(2, 0), (40, 3)])
def test_sample_batch_edge_counts_match_jax(tiny_bundle, num_hard, num_random):
    """No uniform tail, and a mined pool narrower than ``num_hard``."""
    for strategy in STRATEGIES:
        got, want = _fit_both(tiny_bundle, strategy, num_hard, num_random)
        uids = tiny_bundle["train/user_id"][:32]
        np.testing.assert_array_equal(got.sample_batch(uids), want.sample_batch(uids))


def _mine_cfgs():
    kw = dict(embedding_dim=8, user_tower_dims=(16,), item_tower_dims=(16,),
              mixed_precision=False)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _jax_towers(bundle, seed=0):
    jcfg, _ = _mine_cfgs()
    params = JaxMultiTask.init(jax.random.PRNGKey(seed), jcfg, int(bundle["meta/n_users"]),
                               int(bundle["meta/n_movies"]))
    # a spread-out item bias, so the mined ranks depend on it
    towers = jax.device_get(params["towers"])
    towers["item_bias"] = np.random.default_rng(seed).normal(
        0, 0.3, towers["item_bias"].shape).astype(np.float32)
    return towers


def _scores(towers, cfg, bundle):
    """[n_users, n_items] retrieval logits of the port, as mining ranks them."""
    tp = params_from_numpy(towers, "cpu")
    n_users, n_items = int(bundle["meta/n_users"]), int(bundle["meta/n_movies"])
    with torch.inference_mode():
        u = TwoTower.user_embed(tp, torch.arange(n_users), cfg)
        v = materialize_item_embeddings(tp, cfg, n_items)
        return (u @ v.T + tp["item_bias"][:n_items]).numpy()


@pytest.mark.parametrize("skip_top", [0, 3])
def test_mine_hard_negatives_matches_jax(tiny_bundle, skip_top):
    jcfg, cfg = _mine_cfgs()
    towers = _jax_towers(tiny_bundle)
    want = jax_mine(towers, jcfg, tiny_bundle, m=7, batch=32, skip_top=skip_top)
    got = mine_hard_negatives(towers, cfg, tiny_bundle, m=7, batch=32, skip_top=skip_top,
                              device="cpu")
    assert got.dtype == np.int32 and got.shape == want.shape == (
        int(tiny_bundle["meta/n_users"]), 7)
    scores = _scores(towers, cfg, tiny_bundle)
    tol = 1e-5 * np.abs(scores).max()
    rows, cols = np.nonzero(got != want)
    for r, c in zip(rows, cols):  # ties only
        assert abs(scores[r, got[r, c]] - scores[r, want[r, c]]) <= tol, (r, c)
    assert len(rows) <= got.size // 100
    # seen items are never mined, and the window is the deeper mine's tail
    train_u, train_i = tiny_bundle["train/user_id"], tiny_bundle["train/movie_id"]
    for u in range(got.shape[0]):
        assert not set(got[u].tolist()) & set(train_i[train_u == u].tolist()), u
    deep = mine_hard_negatives(towers, cfg, tiny_bundle, m=10, batch=64, device="cpu")
    np.testing.assert_array_equal(got, deep[:, skip_top:skip_top + 7])


def test_mine_hard_negatives_clamps_a_tiny_catalog(tiny_bundle, caplog):
    jcfg, cfg = _mine_cfgs()
    towers = _jax_towers(tiny_bundle, seed=1)
    n_items = int(tiny_bundle["meta/n_movies"])
    kw = dict(m=n_items + 5, batch=32, skip_top=n_items + 3)
    want = jax_mine(towers, jcfg, tiny_bundle, **kw)
    with caplog.at_level(logging.WARNING, logger="recsys_tpu_torch.data.negative_sampling"):
        got = mine_hard_negatives(towers, cfg, tiny_bundle, device="cpu", **kw)
    assert got.shape == want.shape == (int(tiny_bundle["meta/n_users"]), n_items)
    assert any("clamps the requested ranks" in r.getMessage() for r in caplog.records)
    # the whole catalog, best first: each row a permutation of the items
    assert all(len(set(row.tolist())) == n_items for row in got)
    s = NegativeSampler("mined", 3, 4, seed=0).fit(
        tiny_bundle["train/user_id"], tiny_bundle["train/movie_id"], n_items).set_mined(got)
    assert s.sample_batch(tiny_bundle["train/user_id"][:16]).shape == (16, 7)


def _loss_with_negs(jcfg, tcfg, batch, neg):
    jp = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(0), jcfg, N_USERS, N_ITEMS))
    (_, jm), jg = jax.value_and_grad(JaxMultiTask.loss, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
        class_weights=CLASS_WEIGHTS, neg_item_ids=jnp.asarray(neg))
    tp = params_from_numpy(jp, "cpu")
    paths, leaves = zip(*leaves_with_paths(tp))
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tm = MultiTaskModel.loss(tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()},
                                    train=True, class_weights=CLASS_WEIGHTS,
                                    neg_item_ids=torch.as_tensor(neg))
    tg = torch.autograd.grad(tloss, leaves, allow_unused=True)
    return jm, dict(leaves_with_paths(jax.device_get(jg))), tm, dict(zip(paths, tg))


@pytest.mark.filterwarnings("ignore:use_flash_ce")
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("path", ["xla", "flash"])
def test_loss_with_negatives_matches_jax(path, mixed):
    """Value and every gradient with [B, 6] negatives (ids past the catalog
    read the OOV row), weight 0.7, on the dense and flash in-batch paths."""
    setting = {"xla": False, "flash": True}[path]
    jcfg, tcfg = _configs(mixed_precision=mixed, use_flash_ce=setting,
                          explicit_negatives_weight=0.7)
    batch = _batch(seed=5)
    neg = np.random.default_rng(6).integers(0, N_ITEMS + 2, (len(batch["user_id"]), 6))
    jm, jg, tm, tg = _loss_with_negs(jcfg, tcfg, batch, neg.astype(np.int32))
    for k in ("loss", "retrieval_loss", "rating_mse", "ctr_bce", "l2"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # the explicit term moved the loss: it is really in there
    _, plain = MultiTaskModel.loss(params_from_numpy(jax.device_get(JaxMultiTask.init(
        jax.random.PRNGKey(0), jcfg, N_USERS, N_ITEMS)), "cpu"), tcfg,
        {k: torch.as_tensor(v) for k, v in batch.items()}, train=True,
        class_weights=CLASS_WEIGHTS)
    assert float(tm["retrieval_loss"].detach()) > float(plain["retrieval_loss"].detach()) + 0.1
    assert tg.keys() == jg.keys()
    for p, want in jg.items():
        got = torch.zeros_like(torch.as_tensor(want)) if tg[p] is None else tg[p]
        assert_grads_close(got.numpy(), want, mixed, "/".join(p))


_TRAJECTORIES = {
    "fp32": dict(mixed=False),
    "mixed precision": dict(mixed=True),
    "sparse asked, cache on": dict(mixed=False, sparse_table_updates=True, negative_cache=128),
}


@pytest.mark.parametrize("case", sorted(_TRAJECTORIES))
def test_train_step_trajectory_with_negatives_matches_jax(case, tmp_path):
    """20 steps with fed [B, 5] negatives from the JAX init, carried over
    by the weight bridge; sparse updates asked for still take the dense
    step (explicit negatives force it, as in JAX), and the CBNS cache
    composes with the negatives."""
    kw = dict(_TRAJECTORIES[case])
    mixed = kw.pop("mixed")
    jcfg, tcfg = _cfgs(mixed, clipnorm=1.0, **kw)
    cw = (1.4, 0.8)
    jtr = JaxTrainer(jcfg, str(tmp_path / "jax"), mesh_ctx=make_mesh(devices=jax.devices()[:1]))
    jstate = jtr.init_state(N_USERS, N_ITEMS, 0)
    tr = Trainer(tcfg, str(tmp_path / "port"), device="cpu")
    state = tr.state_from_params(params_from_numpy(jax.device_get(jstate.params), "cpu"), 0)
    jstep = jax.jit(jtr._step_core(cw, True))
    step = tr.make_train_step(cw, True)
    rng = np.random.default_rng(9)
    jloss, tloss = [], []
    for batch in _batches():
        batch["neg_ids"] = rng.integers(0, N_ITEMS, (len(batch["user_id"]), 5)).astype(np.int32)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, tm = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
        jloss.append(float(jm["loss"]))
        tloss.append(float(tm["loss"]))
    assert tr.step_counts == {"dense": N_STEPS, "sparse": 0}
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4 if mixed else 1e-5)
    tol = 2 * 2.0 ** -8 * _LR / 0.1 ** 0.5 if mixed else 1e-5
    assert state.step == int(jstate.step) == N_STEPS
    want = dict(leaves_with_paths(jax.device_get(jstate.params)))
    for path, got in leaves_with_paths(params_to_numpy(state.params)):
        np.testing.assert_allclose(got, want[path], rtol=0, atol=tol, err_msg="/".join(path))
    if kw.get("negative_cache"):
        np.testing.assert_array_equal(state.extras["ids"].numpy(),
                                      np.asarray(jstate.extras["ids"]))
