"""Parity of the port's training-mode model and loss library with the JAX
package, on the CPU at small width: ``MultiTaskModel.loss`` (value and
the gradient of every parameter) on the three retrieval-loss paths, in
fp32 and under mixed precision; the single losses; the path policy;
dropout and the L2 penalty.

Params come from the JAX ``MultiTaskModel.init`` and cross through the
weight bridge; batches come from a numpy seed; dropout is 0 (the two
packages' random streams differ).

Tolerances:
* loss values: rtol = 1e-5 (fp32 sums in another order);
* gradients, fp32: |err| <= 1e-5 * |want| + 1e-5 * max|want| per leaf
  (summation order only);
* gradients, mixed precision: the same bound. Both packages take every
  product of bf16 operands in fp32 and round each gradient to bf16 at the
  same points, so only summation order differs; but a sum that lands on
  the other side of a bf16 rounding boundary flips that intermediate by
  one bf16 ulp (2**-8 relative), which moves each gradient it feeds by
  one ulp of one of its terms: up to 10% of a leaf may miss the bound by
  at most one bf16 ulp at the top of the leaf's range (2**-8 * max|want|);
* the dense path's bf16-logits branch (``bf16_retrieval_logits``): the
  value to 1e-5; the gradients to 2**-4 of each leaf's largest
  magnitude. Its logsumexp subtracts the bf16 row max, whose gradient is
  minus a bf16 row sum of the rounded softmax: zero in exact arithmetic,
  rounding noise in both packages, and rounded in another order by each
  (and, at tied maxima, sent to one column by PyTorch and split by JAX).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.models import layers as JL
from recsys_tpu.models import losses as JLoss
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.models import losses
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.train.checkpoint import params_from_numpy
from recsys_tpu_torch.train.optimizer import leaves_with_paths

N_USERS, N_ITEMS, B = 30, 40, 64
BF16_ULP = 2.0 ** -8
CLASS_WEIGHTS = (1.7, 0.6)


def _configs(**overrides):
    kw = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(24,),
              cross_layers=3, dnn_dims=(16, 8), dropout_rate=0.0)
    kw.update(overrides)
    # use_pallas_dcn=True: the JAX branch whose numerics the port follows
    return JaxModelConfig(use_pallas_dcn=True, **kw), ModelConfig(**kw)


def _batch(seed=1, b=B):
    rng = np.random.default_rng(seed)
    return {"user_id": rng.integers(0, N_USERS, b).astype(np.int32),
            # 40 items in 64 rows: many accidental hits
            "movie_id": rng.integers(0, N_ITEMS, b).astype(np.int32),
            "rating": rng.integers(1, 6, b).astype(np.float32),
            "y_implicit": (rng.random(b) > 0.6).astype(np.float32),
            "mask": (rng.random(b) > 0.1).astype(np.float32),
            "log_q": (-rng.random(b) * 4).astype(np.float32)}


def assert_grads_close(got, want, mixed: bool, what: str = ""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    bound = 1e-5 * np.abs(want) + 1e-5 * scale
    err = np.abs(got - want)
    miss = err > bound
    if not mixed:
        assert not miss.any(), f"{what}: max err {err.max()} (scale {scale})"
        return
    assert miss.sum() <= max(1, want.size // 10), f"{what}: {miss.sum()} elements off"
    assert (err <= bound + BF16_ULP * scale).all(), f"{what}: beyond one bf16 ulp"


def _loss_both(jcfg, tcfg, batch, seed=0):
    jp = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(seed), jcfg, N_USERS, N_ITEMS))
    (jloss, jmetrics), jgrads = jax.value_and_grad(JaxMultiTask.loss, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
        class_weights=CLASS_WEIGHTS)
    tp = params_from_numpy(jp, "cpu")
    paths, leaves = zip(*leaves_with_paths(tp))
    for leaf in leaves:
        leaf.requires_grad_(True)
    tloss, tmetrics = MultiTaskModel.loss(
        tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()}, train=True,
        class_weights=CLASS_WEIGHTS)
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    tgrads = {p: (torch.zeros_like(leaf) if g is None else g)
              for p, leaf, g in zip(paths, leaves, tgrads)}
    return (jmetrics, dict(leaves_with_paths(jax.device_get(jgrads)))), (tmetrics, tgrads)


def _check_loss_both(jcfg, tcfg, batch, grad_scale_tol=None):
    (jm, jg), (tm, tg) = _loss_both(jcfg, tcfg, batch)
    for k in ("loss", "retrieval_loss", "rating_mse", "ctr_bce", "l2"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert tg.keys() == jg.keys()
    for path, want in jg.items():
        if grad_scale_tol is None:
            assert_grads_close(tg[path].numpy(), want, tcfg.mixed_precision, "/".join(path))
        else:
            want = np.asarray(want)
            err = np.abs(tg[path].numpy() - want).max()
            assert err <= grad_scale_tol * np.abs(want).max(), "/".join(path)


@pytest.mark.filterwarnings("ignore:use_flash_ce")
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("path", ["xla", "flash", "chunked"])
def test_multitask_loss_and_grads_match_jax(path, mixed):
    """Value and every parameter's gradient, on the dense, flash and
    chunked retrieval paths (the port's flash path runs the kernels'
    plain versions on the CPU, JAX its Pallas kernels in interpret mode)."""
    setting = {"xla": False, "flash": True, "chunked": "chunked"}[path]
    jcfg, tcfg = _configs(mixed_precision=mixed, use_flash_ce=setting)
    assert losses.resolve_retrieval_loss(setting, B, B, "cpu") == path
    _check_loss_both(jcfg, tcfg, _batch())


_ABLATIONS = {
    "temperature_no_hit_mask": dict(softmax_temperature=0.5, accidental_hit_mask=False),
    "no_item_bias": dict(use_item_bias=False),
    "no_residual_flash": dict(tower_residual=False, use_flash_ce=True,
                              bf16_retrieval_logits=True),
}


@pytest.mark.filterwarnings("ignore:use_flash_ce")
@pytest.mark.parametrize("case", sorted(_ABLATIONS))
def test_multitask_loss_options_match_jax(case):
    jcfg, tcfg = _configs(**_ABLATIONS[case])
    _check_loss_both(jcfg, tcfg, _batch(seed=2))


def test_multitask_loss_bf16_logits_branch_matches_jax():
    """The dense path with bf16 logits (taken from 8,192 candidates under
    ``bf16_retrieval_logits="auto"``), forced on at B = 64."""
    jcfg, tcfg = _configs(bf16_retrieval_logits=True)
    _check_loss_both(jcfg, tcfg, _batch(seed=2), grad_scale_tol=2.0 ** -4)


def test_multitask_loss_mask_ids_and_oov_bias_clip():
    """``mask_ids`` drives accidental-hit masking in place of the movie
    ids, and movie ids past the bias table clip to its last row."""
    jcfg, tcfg = _configs()
    batch = _batch(seed=3)
    batch["mask_ids"] = batch["movie_id"] % 5
    batch["movie_id"] = batch["movie_id"] + 3  # some past n_items: the OOV row
    _check_loss_both(jcfg, tcfg, batch)


def test_loss_raises_for_unported_arguments():
    """A custom ``lookup`` (the row-sharded tables' collective lookups) is
    not ported and names its ROADMAP item; a data axis runs (the data-
    parallel step, ``tests/test_torch_dp_train.py``) but needs the mesh
    context that resolves it."""
    _, tcfg = _configs()
    tp = MultiTaskModel.init(torch.Generator().manual_seed(0), tcfg, N_USERS, N_ITEMS, "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    with pytest.raises(NotImplementedError, match="item 8c, row-sharded tables"):
        MultiTaskModel.loss(tp, tcfg, batch, lookup=lambda table, ids: table[ids])
    with pytest.raises(ValueError, match="needs the mesh_ctx"):
        MultiTaskModel.loss(tp, tcfg, batch, data_axis="data")
    for fn in (losses.in_batch_softmax, losses.in_batch_softmax_chunked):
        with pytest.raises(ValueError, match="needs the mesh_ctx"):
            fn(torch.zeros(4, 2), torch.zeros(4, 2), axis_name="data")
    with pytest.raises(ValueError, match="needs the mesh_ctx"):
        losses.weighted_bce_logits(torch.zeros(4), torch.zeros(4), axis_name="data")


def test_single_losses_match_jax():
    rng = np.random.default_rng(4)
    n = 200
    pred, target = rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)
    logits = (rng.standard_normal(n) * 3).astype(np.float32)
    labels = (rng.random(n) > 0.7).astype(np.float32)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    t = torch.as_tensor
    j = jnp.asarray
    np.testing.assert_allclose(float(losses.mse(t(pred), t(target), mask=t(mask))),
                               float(JLoss.mse(j(pred), j(target), mask=j(mask))), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.weighted_bce_logits(t(logits), t(labels), 2.5, 0.7, mask=t(mask))),
        float(JLoss.weighted_bce_logits(j(logits), j(labels), 2.5, 0.7, mask=j(mask))),
        rtol=1e-6)
    assert losses.balanced_class_weights(labels) == pytest.approx(
        JLoss.balanced_class_weights(labels), rel=1e-12)
    scores = np.round(rng.standard_normal(n), 1).astype(np.float32)  # with ties
    np.testing.assert_allclose(float(losses.auc(t(scores), t(labels))),
                               float(JLoss.auc(j(scores), j(labels))), rtol=1e-6)
    assert float(losses.auc(t(scores), t(np.zeros(n, np.float32)))) == 0.5
    u = rng.standard_normal((8, 6)).astype(np.float32)
    pos = rng.standard_normal((8, 6)).astype(np.float32)
    negs = rng.standard_normal((8, 3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.sampled_softmax_explicit(t(u), t(pos), t(negs))),
        float(JLoss.sampled_softmax_explicit(j(u), j(pos), j(negs))), rtol=1e-5)


@pytest.mark.parametrize("extra", [False, True])
def test_in_batch_softmax_chunked_matches_jax(extra):
    """The chunked loss with a ragged final chunk of extra candidates."""
    rng = np.random.default_rng(5)
    b, d = 24, 8
    u, v = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    ids = rng.integers(0, 9, b).astype(np.int32)
    log_q = (-rng.random(b) * 3).astype(np.float32)
    x = ((rng.standard_normal((13, d)).astype(np.float32), rng.integers(0, 9, 13).astype(np.int32),
          rng.standard_normal(13).astype(np.float32)) if extra else None)
    jval, jg = jax.value_and_grad(
        lambda a, c: JLoss.in_batch_softmax_chunked(
            a, c, item_ids=jnp.asarray(ids), log_q=jnp.asarray(log_q), chunk_size=8,
            extra_candidates=None if x is None else tuple(map(jnp.asarray, x))),
        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    tu, tv = (torch.tensor(a, requires_grad=True) for a in (u, v))
    loss = losses.in_batch_softmax_chunked(
        tu, tv, item_ids=torch.as_tensor(ids), log_q=torch.as_tensor(log_q), chunk_size=8,
        extra_candidates=None if x is None else tuple(map(torch.as_tensor, x)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    assert_grads_close(tu.grad.numpy(), jg[0], False, "du")
    assert_grads_close(tv.grad.numpy(), jg[1], False, "dv")


@pytest.mark.parametrize("n_cand,cap_gb", [(4096, 8.0), (8192, 8.0), (8192, 1e-4)])
@pytest.mark.parametrize("setting", ["auto", True, False, "chunked"])
def test_resolve_retrieval_loss_rekeys_the_tpu_gate_to_cuda(setting, n_cand, cap_gb):
    """The port's policy on "cuda" is the JAX package's on "tpu"; every
    other platform keeps the JAX package's non-TPU policy. (Both warn in
    the regimes they call losing; the warnings are not compared.)"""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for mine, theirs in (("cuda", "tpu"), ("cpu", "cpu")):
            got = losses.resolve_retrieval_loss(setting, n_cand, n_cand, mine, cap_gb)
            want = JLoss.resolve_retrieval_loss(setting, n_cand, n_cand, theirs, cap_gb)
            assert got == want, (mine, setting, n_cand, cap_gb)
    assert losses._FLASH_MIN_CANDIDATES == JLoss._FLASH_MIN_CANDIDATES == 8192


def test_dropout_scales_kept_elements_and_skips_the_last_layer():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 50)
    y = L.dropout(g, x, 0.2)
    kept = y != 0
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert abs(kept.float().mean().item() - 0.8) < 0.02  # 10,000 Bernoulli(0.8) draws
    p = L.init_mlp(torch.Generator().manual_seed(1), [50, 30, 20], "cpu")
    train = L.mlp(p, x, dropout_rate=0.5, train=True, generator=torch.Generator().manual_seed(2))
    assert not torch.equal(train, L.mlp(p, x))
    # one layer: it is the last one, so train mode drops nothing
    p1 = {"layer_0": p["layer_0"]}
    torch.testing.assert_close(
        L.mlp(p1, x, dropout_rate=0.5, train=True, generator=torch.Generator()),
        L.mlp(p1, x))
    with pytest.raises(ValueError, match="Generator"):
        L.mlp(p, x, dropout_rate=0.5, train=True)


def test_train_mode_dropout_draws_from_the_generator():
    """The same generator seed gives the same masks; dropout 0 in train
    mode equals inference mode."""
    _, tcfg = _configs(dropout_rate=0.3)
    tp = MultiTaskModel.init(torch.Generator().manual_seed(0), tcfg, N_USERS, N_ITEMS, "cpu")
    ids = torch.as_tensor(_batch()["user_id"]), torch.as_tensor(_batch()["movie_id"])
    run = lambda seed: MultiTaskModel.apply(
        tp, tcfg, *ids, train=True, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(5), run(5), run(6)
    torch.testing.assert_close(a.rating_pred, b.rating_pred)
    assert not torch.equal(a.rating_pred, c.rating_pred)
    _, tcfg0 = _configs(dropout_rate=0.0)
    torch.testing.assert_close(
        MultiTaskModel.apply(tp, tcfg0, *ids, train=True, generator=torch.Generator()).ctr_logit,
        MultiTaskModel.apply(tp, tcfg0, *ids).ctr_logit)


def test_l2_penalty_matches_jax():
    jcfg, _ = _configs()
    jp = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(3), jcfg, N_USERS, N_ITEMS))
    tp = params_from_numpy(jp, "cpu")
    np.testing.assert_allclose(float(L.l2_penalty(tp, 1e-3)),
                               float(JL.l2_penalty(jp, 1e-3)), rtol=1e-6)
    # w leaves only: a tree of biases costs nothing
    assert float(L.l2_penalty({"a": {"b": torch.ones(3)}}, 1.0)) == 0.0
