"""Parity of the PyTorch port's model forward with the JAX package, on
the CPU at small width.

Params come from the JAX ``MultiTaskModel.init`` and cross into the port
through the weight bridge; ids and inputs come from a numpy seed.

Tolerances:
* fp32 (``mixed_precision=False``): rtol = atol = 1e-5, summation order
  being the only difference;
* ``mixed_precision=True`` with the JAX kernel branch of the cross stack
  (``use_pallas_dcn=True``): both packages round at the same points, so
  the same 1e-5 holds, plus one bf16 ulp (2**-8 relative) where an fp32
  result that differs in its last bits rounds to a neighbouring bf16;
* ``mixed_precision=True`` against the JAX XLA branch, which runs the
  cross stack in bf16 while the port runs it in fp32: the largest
  difference must stay under 2**-5 of the largest magnitude (four bf16
  ulps at the top of the range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.models.dcn import DeepCrossNetwork as JaxDCN
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.models.towers import TwoTower as JaxTwoTower
from recsys_tpu.ops.pallas.dcn_cross import dcn_cross_fused
from recsys_tpu_torch.config import ModelConfig
from recsys_tpu_torch.models import layers as L
from recsys_tpu_torch.models.dcn import DeepCrossNetwork
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.ops.dcn_cross import dcn_cross, dcn_cross_reference
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy

N_USERS, N_ITEMS = 30, 40
BF16_ULP = 2.0 ** -8


def _configs(**overrides):
    kw = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(24,),
              cross_layers=3, dnn_dims=(16, 8), dropout_rate=0.0)
    kw.update(overrides)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _params(jcfg, seed=0):
    jp = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(seed), jcfg,
                                          N_USERS, N_ITEMS))
    return jp, params_from_numpy(jp, "cpu")


def _ids(seed=1, n=64):
    rng = np.random.default_rng(seed)
    # includes negative and out-of-vocabulary ids: both clip
    return rng.integers(-2, N_USERS + 5, n), rng.integers(-2, N_ITEMS + 5, n)


def _close(got, want, bf16_ulps=0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5 + bf16_ulps * BF16_ULP, atol=1e-5)


def test_bridge_round_trip_keeps_layout():
    jcfg, _ = _configs()
    jp, tp = _params(jcfg)
    back = params_to_numpy(tp)
    assert back.keys() == jp.keys()
    w = back["towers"]["user_tower"]["layer_0"]["w"]
    assert w.shape == (16, 32)  # dense w stays [in, out]
    np.testing.assert_array_equal(w, jp["towers"]["user_tower"]["layer_0"]["w"])
    np.testing.assert_array_equal(back["dcn"]["cross"]["layer_2"]["b"],
                                  jp["dcn"]["cross"]["layer_2"]["b"])


@pytest.mark.parametrize("mixed", [False, True])
def test_tower_embeddings_match_jax(mixed):
    jcfg, tcfg = _configs(mixed_precision=mixed)
    jp, tp = _params(jcfg)
    uid, iid = _ids()
    ju = JaxTwoTower.user_embed(jp["towers"], jnp.asarray(uid), jcfg)
    jv = JaxTwoTower.item_embed(jp["towers"], jnp.asarray(iid), jcfg)
    tu, tv = TwoTower.apply(tp["towers"], tcfg, torch.as_tensor(uid),
                            torch.as_tensor(iid))
    _close(tu.numpy(), ju)
    _close(tv.numpy(), jv)


@pytest.mark.parametrize("mixed", [False, True])
def test_multitask_apply_matches_jax(mixed):
    # use_pallas_dcn=True: the JAX branch whose numerics the port follows
    jcfg, tcfg = _configs(mixed_precision=mixed, use_pallas_dcn=True)
    jp, tp = _params(jcfg)
    uid, iid = _ids()
    jo = JaxMultiTask.apply(jp, jcfg, jnp.asarray(uid), jnp.asarray(iid))
    to = MultiTaskModel.apply(tp, tcfg, torch.as_tensor(uid), torch.as_tensor(iid))
    ulps = 1 if mixed else 0
    _close(to.rating_pred.numpy(), jo.rating_pred, ulps)
    _close(to.ctr_logit.numpy(), jo.ctr_logit, ulps)
    _close(to.user_embedding.numpy(), jo.user_embedding)
    _close(to.item_embedding.numpy(), jo.item_embedding)


@pytest.mark.parametrize("mixed", [False, True])
def test_dcn_apply_matches_jax_kernel_branch(mixed):
    jcfg, tcfg = _configs(mixed_precision=mixed, use_pallas_dcn=True)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(2).standard_normal((37, 32)).astype(np.float32)
    want = JaxDCN.apply(jp["dcn"], jnp.asarray(x), jcfg)
    got = DeepCrossNetwork.apply(tp["dcn"], torch.as_tensor(x), tcfg)
    _close(got.numpy(), want, 1 if mixed else 0)


def test_dcn_apply_vs_jax_xla_branch_bf16():
    """The JAX XLA branch runs the cross stack in bf16; the port runs
    it in fp32 whatever use_pallas_dcn says (documented in ROADMAP)."""
    jcfg, tcfg = _configs(mixed_precision=True, use_pallas_dcn=False)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(3).standard_normal((37, 32)).astype(np.float32)
    want = np.asarray(JaxDCN.apply(jp["dcn"], jnp.asarray(x), jcfg))
    got = DeepCrossNetwork.apply(tp["dcn"], torch.as_tensor(x), tcfg).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -5 * np.abs(want).max()
    jo = JaxMultiTask.apply(jp, jcfg, *map(jnp.asarray, _ids()))
    to = MultiTaskModel.apply(tp, tcfg, *map(torch.as_tensor, _ids()))
    for name in ("rating_pred", "ctr_logit"):
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        assert np.abs(a - b).max() <= 2.0 ** -5 * np.abs(a).max(), name


@pytest.mark.parametrize("n,f,n_layers", [(37, 24, 3), (64, 256, 3), (5, 40, 1)])
def test_dcn_cross_reference_matches_fused(n, f, n_layers):
    """The plain version (what the CUDA kernel is held against on the
    card) against the JAX Pallas kernel in interpret mode, ragged n."""
    rng = np.random.default_rng(n + f)
    x0 = rng.standard_normal((n, f)).astype(np.float32)
    w = (rng.standard_normal((n_layers, f)) * f ** -0.5).astype(np.float32)
    b = rng.standard_normal((n_layers, f)).astype(np.float32) * 0.1
    want = np.asarray(dcn_cross_fused(jnp.asarray(x0), jnp.asarray(w), jnp.asarray(b)))
    got = dcn_cross_reference(*map(torch.as_tensor, (x0, w, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # on CPU tensors the wrapper is the plain version and counts no launch
    before = dcn_cross.launches
    np.testing.assert_array_equal(dcn_cross(*map(torch.as_tensor, (x0, w, b))).numpy(), got)
    assert dcn_cross.launches == before


def test_model_init_layout_matches_jax():
    """The port's own init draws from a torch.Generator but yields the
    JAX package's tree: same keys, same shapes."""
    jcfg, tcfg = _configs()
    jp, _ = _params(jcfg)
    tp = params_to_numpy(MultiTaskModel.init(torch.Generator().manual_seed(0), tcfg,
                                             N_USERS, N_ITEMS, "cpu"))
    shapes = jax.tree_util.tree_map(np.shape, jp)
    assert jax.tree_util.tree_map(np.shape, tp) == shapes


_INIT_ENTRY_POINTS = {
    "MultiTaskModel.init": lambda g, cfg: MultiTaskModel.init(g, cfg, N_USERS, N_ITEMS),
    "TwoTower.init": lambda g, cfg: TwoTower.init(g, cfg, N_USERS, N_ITEMS),
    "DeepCrossNetwork.init": lambda g, cfg: DeepCrossNetwork.init(g, cfg, 32),
    "layers.init_mlp": lambda g, cfg: L.init_mlp(g, [16, 8, 4]),
    "layers.init_dense": lambda g, cfg: L.init_dense(g, 16, 8),
    "layers.glorot": lambda g, cfg: L.glorot(g, (16, 8)),
    "RetrievalIndex.build": lambda g, cfg: RetrievalIndex.build(
        TwoTower.init(g, cfg, N_USERS, N_ITEMS, "cpu"), cfg, N_ITEMS,
        np.arange(N_ITEMS)),
}


@pytest.mark.parametrize("entry", sorted(_INIT_ENTRY_POINTS))
def test_init_defaults_to_the_card_and_raises_without_one(entry, monkeypatch):
    """With no device given, every init entry point asks for the card: on
    a machine without one it raises instead of building on the CPU."""
    _, tcfg = _configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _INIT_ENTRY_POINTS[entry](torch.Generator().manual_seed(0), tcfg)


def test_index_build_refuses_params_on_another_device():
    _, tcfg = _configs()
    towers = TwoTower.init(torch.Generator().manual_seed(0), tcfg, N_USERS, N_ITEMS,
                           "cpu")
    towers = {**towers, "item_table": towers["item_table"].to("meta")}
    with pytest.raises(ValueError, match="tower params lie on meta"):
        RetrievalIndex.build(towers, tcfg, N_ITEMS, np.arange(N_ITEMS), device="cpu")
