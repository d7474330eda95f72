"""Large-catalog retrieval of the PyTorch port against the JAX package, on
the CPU: the group-max sieve (``blockmax_topk``, whose JAX kernel runs in
interpret mode), the blockwise scans (fp32, bf16 and int8),
``quantize_rows``, every ``RetrievalIndex.search`` mode, ``exact_topk``
above the dense-scores cap, and the service's int8 and approximate
routes.

Tolerances: scores to 1e-5 (fp32 sums of the same products in another
order; bf16 products are exact in fp32); ids equal except among equal
scores; int8 codes bit-equal and scales to 1e-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.ops.pallas.topk_flash import blockmax_topk as jax_blockmax_topk
from recsys_tpu.ops.topk import blockwise_topk as jax_blockwise_topk
from recsys_tpu.ops.topk import blockwise_topk_int8 as jax_blockwise_topk_int8
from recsys_tpu.ops.topk import quantize_rows as jax_quantize_rows
from recsys_tpu.retrieval.scorer import RetrievalIndex as JaxRetrievalIndex
from recsys_tpu.retrieval.scorer import topk_scores as jax_topk_scores
from recsys_tpu.serve.service import RecommendationService as JaxService
from recsys_tpu.train.checkpoint import save_inference_bundle as jax_save_bundle
from recsys_tpu_torch.ops import topk_flash
from recsys_tpu_torch.ops.topk import blockwise_topk, blockwise_topk_int8, quantize_rows
from recsys_tpu_torch.ops.topk_flash import (
    NEG_INF, blockmax_group_max, blockmax_group_max_reference, blockmax_group_size,
    blockmax_groups_per_block, blockmax_plan, blockmax_topk,
)
from recsys_tpu_torch.retrieval import scorer
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex, exact_topk
from recsys_tpu_torch.serve import __main__ as serve_cli
from recsys_tpu_torch.serve import app as serve_app
from recsys_tpu_torch.serve.service import RecommendationService

TOL = 1e-5


def _data(q=5, n=3001, d=24, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((q, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


def _assert_same_topk(got, want, full):
    """Scores to TOL; each returned id carries its score in ``full`` (the
    [Q, N] scores of the same operands); no id twice among real slots;
    ids equal to the reference's except among equal scores."""
    gs, gi = (np.asarray(t) for t in got)
    ws, wi = (np.asarray(t) for t in want)
    assert gs.shape == ws.shape
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    real = gs > NEG_INF / 2
    np.testing.assert_array_equal(real, ws > NEG_INF / 2)
    picked = np.take_along_axis(full, np.where(real, gi, 0), axis=1)
    np.testing.assert_allclose(picked[real], gs[real], rtol=TOL, atol=TOL)
    for row_i, row_real, row_s, want_i in zip(gi, real, gs, wi):
        assert len(set(row_i[row_real].tolist())) == int(row_real.sum())
        # outside the scores tied with the row's last real one, the ids agree
        clear = row_real & (row_s > row_s[row_real][-1] + TOL)
        assert set(row_i[clear].tolist()) <= set(want_i.tolist())


def _normalized(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("k", [1, 10, 200])
def test_blockmax_topk_matches_jax(k, bf16):
    """The plain sieve against the JAX kernel (interpret mode) at a ragged
    N = 3,001 with groups of 128."""
    u, v = _data()
    want = jax_blockmax_topk(jnp.asarray(u), jnp.asarray(v), k, group=128,
                             block_items=1024, bf16=bf16, interpret=True)
    got = blockmax_topk(torch.as_tensor(u), torch.as_tensor(v), k, group=128, bf16=bf16)
    un, vn = _normalized(u), _normalized(v)
    if bf16:
        un, vn = _bf16(un), _bf16(vn)
    _assert_same_topk(got, want, un @ vn.T)
    assert got[1].dtype == torch.long
    assert topk_flash.blockmax_group_max.launches == 0  # CPU tensors: no kernel


def test_blockmax_topk_default_group_and_k_beyond_catalog():
    u, v = _data(q=3, n=4000, d=16, seed=2)
    want = jax_blockmax_topk(jnp.asarray(u), jnp.asarray(v), 10, interpret=True)
    got = blockmax_topk(torch.as_tensor(u), torch.as_tensor(v), 10)
    _assert_same_topk(got, want, _bf16(_normalized(u)) @ _bf16(_normalized(v)).T)
    # fewer real groups than k: the JAX wrapper pads its group count to
    # whole 8-group blocks and, once the real groups are taken, picks group
    # 0 again (every remaining maximum ties at -1e30), repeating its items;
    # the port counts real groups only and equals the exact top-k
    u, v = _data(q=3, n=300, d=16, seed=2)
    full = _bf16(_normalized(u)) @ _bf16(_normalized(v)).T
    want_i = np.argsort(-full, axis=1, kind="stable")[:, :10]
    got = blockmax_topk(torch.as_tensor(u), torch.as_tensor(v), 10)
    _assert_same_topk(got, (np.take_along_axis(full, want_i, axis=1), want_i), full)
    gs, gi = blockmax_topk(torch.as_tensor(u), torch.as_tensor(v[:7]), 12)
    assert gs.shape == (3, 12)
    assert bool((gs[:, 7:] == NEG_INF).all()) and bool((gi[:, 7:] == 0).all())
    assert sorted(gi[0, :7].tolist()) == list(range(7))


@pytest.mark.parametrize("n,group,dtype", [
    (3001, 128, torch.float32), (3001, 512, torch.bfloat16), (100, 128, torch.float32),
    (1024, 256, torch.bfloat16), (70, 1, torch.float32),
])
def test_blockmax_group_max_reference_matches_numpy(n, group, dtype):
    u, v = _data(q=7, n=n, d=40, seed=n)
    uu, vv = torch.as_tensor(u).to(dtype), torch.as_tensor(v).to(dtype)
    got = blockmax_group_max_reference(uu, vv, group).numpy()
    full = uu.float().numpy().astype(np.float64) @ vv.float().numpy().astype(np.float64).T
    want = np.stack([full[:, g:g + group].max(axis=1) for g in range(0, n, group)], axis=1)
    assert got.shape == (7, -(-n // group)) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the CPU wrapper takes the plain version and counts no launch
    np.testing.assert_array_equal(blockmax_group_max(uu, vv, group).numpy(), got)


def test_blockmax_kernel_plan():
    """What surrounds the CUDA kernel, checked on the CPU: the JAX group
    size, and blocks of whole groups with at least 512 items of work."""
    assert blockmax_group_size(1 << 20) == 512
    assert blockmax_group_size(300) == 384 and blockmax_group_size(100) == 128
    assert blockmax_group_size(100, group=64) == 64
    for g in (1, 64, 128, 384, 512, 1000):
        gpb = blockmax_groups_per_block(g)
        assert gpb >= 1 and (gpb * g >= 512 or gpb == 1)
    with pytest.raises(ValueError):
        blockmax_group_max(torch.zeros(2, 4), torch.zeros(3, 4), 0)


@pytest.mark.parametrize("q_n", [1, 17, 64, 4096])
@pytest.mark.parametrize("group", [128, 384, 512])
@pytest.mark.parametrize("n", [300, 1000, 1 << 20])
def test_blockmax_plan_covers_every_query_tile_and_group_once(n, group, q_n):
    """The tensor-core kernel's grid, checked on the CPU: a 16-row query
    tile at Q <= 16 and 64 above (fp32 always 64), whole groups per block,
    and blocks that cover every (query tile, group) exactly once, as the
    kernel maps block b to query tile b % n_qtiles and chunk b //
    n_qtiles."""
    n_sm = 132
    p = blockmax_plan(q_n, n, group, True, n_sm)
    assert p.tq == (16 if q_n <= 16 else 64)
    assert blockmax_plan(q_n, n, group, False, n_sm).tq == 64
    n_groups = -(-n // group)
    assert p.n_qtiles * p.tq >= q_n > (p.n_qtiles - 1) * p.tq
    assert 1 <= p.groups_per_block <= blockmax_groups_per_block(group)
    blocks = np.arange(p.n_qtiles * p.n_chunks)
    qt, first = blocks % p.n_qtiles, (blocks // p.n_qtiles) * p.groups_per_block
    hits = np.zeros((p.n_qtiles, n_groups), np.int64)
    for j in range(p.groups_per_block):
        real = first + j < n_groups
        np.add.at(hits, (qt[real], (first + j)[real]), 1)
    assert (hits == 1).all()
    # fewer groups a block only where whole ones would leave the card thin
    if p.groups_per_block < blockmax_groups_per_block(group):
        assert p.n_qtiles * -(-n_groups // (p.groups_per_block + 1)) < 2 * n_sm


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("k", [10, 300])
def test_blockwise_topk_matches_jax(k, approx):
    u, v = _data(n=1001)
    want = jax_blockwise_topk(jnp.asarray(u), jnp.asarray(v), k, block_size=256,
                              approx=approx)
    got = blockwise_topk(torch.as_tensor(u), torch.as_tensor(v), k, block_size=256,
                         approx=approx)
    un, vn = _normalized(u), _normalized(v)
    if approx:
        un, vn = _bf16(un), _bf16(vn)
    _assert_same_topk(got, want, un @ vn.T)


def test_blockwise_topk_pads_past_the_catalog_as_jax():
    u, v = _data(q=2, n=5, d=8, seed=3)
    ws, _ = jax_blockwise_topk(jnp.asarray(u), jnp.asarray(v), 9, block_size=4)
    gs, gi = blockwise_topk(torch.as_tensor(u), torch.as_tensor(v), 9, block_size=4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=TOL, atol=TOL)
    assert bool((gs[:, 5:] == NEG_INF).all())
    assert sorted(gi[0, :5].tolist()) == list(range(5))


def test_quantize_rows_bit_equal():
    _, v = _data(n=500, d=40, seed=5)
    v[3] = 0.0  # an all-zero row takes the 1e-12 floor
    v[4, :3] = [0.5, -0.5, 1.5]
    jq, js = jax_quantize_rows(jnp.asarray(v))
    tq, ts = quantize_rows(torch.as_tensor(v))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


@pytest.mark.parametrize("k,d", [(1, 24), (10, 24), (300, 24), (10, 1100)])
def test_blockwise_topk_int8_matches_jax(k, d):
    """d = 1,100 passes the fp32-exact width (1,040): the products run in fp64."""
    u, v = _data(n=1001, d=d, seed=6)
    jq, js = jax_quantize_rows(jnp.asarray(_normalized(v)))
    want = jax_blockwise_topk_int8(jnp.asarray(u), jq, js, k, block_size=256, approx=False)
    tq, ts = quantize_rows(torch.as_tensor(_normalized(v)))
    got = blockwise_topk_int8(torch.as_tensor(u), tq, ts, k, block_size=256)
    uq, us = quantize_rows(torch.as_tensor(u))
    full = (uq.double() @ tq.double().T).float() * (us[:, None] * ts[None, :])
    _assert_same_topk(got, want, full.numpy())


_MODES = {
    "approx": {"approx": True},
    "block_size": {"block_size": 64},
    "int8": {"int8": True},
    "int8_refine4": {"int8": True, "refine_factor": 4},
    "flash": {"flash": True},
}


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_search_modes_match_jax(mode, normalize):
    u, v = _data(q=7, n=333, d=16, seed=9)
    raw = np.arange(333) * 3 + 1
    kw = _MODES[mode]
    want = JaxRetrievalIndex(v, raw, normalize).search(jnp.asarray(u), 10, **kw)
    got = RetrievalIndex(v, raw, normalize, device="cpu").search(u, 10, **kw)
    un, vn = (_normalized(u), _normalized(v)) if normalize else (u, v)
    if mode in ("approx", "flash"):  # both score bf16 operands, as JAX does
        full = _bf16(un) @ _bf16(vn).T
    elif mode == "int8":
        uq, us = quantize_rows(torch.as_tensor(un))
        tq, ts = quantize_rows(torch.as_tensor(vn))
        full = ((uq.double() @ tq.double().T).float()
                * (us[:, None] * ts[None, :])).numpy()
    else:
        full = un @ vn.T
    _assert_same_topk(got, want, full)


def test_search_caches_the_bf16_and_int8_catalogs():
    u, v = _data(q=2, n=100, d=8)
    idx = RetrievalIndex(v, np.arange(100), device="cpu")
    idx.search(u, 5, approx=True)
    idx.search(u, 5, int8=True)
    bf16, int8 = idx._device_embs_bf16, idx._int8
    assert bf16.dtype == torch.bfloat16 and int8[0].dtype == torch.int8
    idx.search(u, 5, approx=True)
    idx.search(u, 5, int8=True, refine_factor=2)
    assert idx._device_embs_bf16 is bf16 and idx._int8 is int8


@pytest.mark.parametrize("normalize,bias", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("k", [257, 400])
def test_exact_topk_above_the_cap_is_blockwise(monkeypatch, k, normalize, bias):
    """k > 256 above a cap patched low: the blockwise scan (never the dense
    scores), equal to the dense top-k of both packages."""
    u, v = _data(q=6, n=3001, d=24, seed=11)
    b = np.random.default_rng(12).standard_normal(3001).astype(np.float32) if bias else None
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs["block_size"])
        return blockwise_topk(*args, **kwargs)

    monkeypatch.setattr(scorer, "_DENSE_SCORES_CAP", 6 * 3001 * 4 - 1)
    monkeypatch.setattr(scorer, "blockwise_topk", counted)
    dense = scorer.topk_scores.calls
    got = exact_topk(torch.as_tensor(u), torch.as_tensor(v), k, normalize=normalize,
                     item_bias=None if b is None else torch.as_tensor(b))
    assert calls == [scorer._EXACT_BLOCK] and scorer.topk_scores.calls == dense
    want = jax_topk_scores(jnp.asarray(u), jnp.asarray(v), k, normalize,
                           None if b is None else jnp.asarray(b))
    un, vn = (_normalized(u), _normalized(v)) if normalize else (u, v)
    full = un @ vn.T + (0 if b is None else b[None, :])
    _assert_same_topk(got, want, full)
    # at the cap itself the dense product still serves
    monkeypatch.setattr(scorer, "_DENSE_SCORES_CAP", 6 * 3001 * 4)
    exact_topk(torch.as_tensor(u), torch.as_tensor(v), k, normalize=normalize)
    assert scorer.topk_scores.calls == dense + 1 and len(calls) == 1


# ---- the service's large-catalog routes -------------------------------------

N_USERS, N_ITEMS = 40, 900
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(32, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0, use_pallas_dcn=True)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("large_catalog") / "bundle")
    cfg = JaxRecsysConfig(model=JaxModelConfig(**MODEL_KW))
    params = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(3), cfg.model,
                                              N_USERS, N_ITEMS))
    index = JaxRetrievalIndex.build(params["towers"], cfg.model, N_ITEMS,
                                    np.arange(1, N_ITEMS + 1) * 3)
    jax_save_bundle(path, params["towers"], cfg, np.arange(1, N_USERS + 1) * 7,
                    np.arange(1, N_ITEMS + 1) * 3, index=index, full_params=params)
    return path


def _same_recs(a, b):
    assert [r["item_id"] for r in a] == [r["item_id"] for r in b]
    np.testing.assert_allclose([r["score"] for r in a], [r["score"] for r in b],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("rerank", [0, 20])
@pytest.mark.parametrize("route", ["int8", "approx"])
def test_service_routes_match_jax(bundle, route, rerank):
    kw = ({"int8_catalog": True} if route == "int8"
          else {"approx_search_threshold": N_ITEMS - 1})
    port = RecommendationService(bundle, rerank_candidates=rerank, device="cpu", **kw).load()
    ref = JaxService(bundle, backend="device", rerank_candidates=rerank, **kw).load()
    assert port._search_route() == route
    assert ("int8" if route == "int8" else "blockmax") in port.get_model_info()["search"]
    users = [7 * i for i in range(1, 13)] + [999_999]
    for a, b in zip(port.recommend_batch(users, k=10), ref.recommend_batch(users, k=10)):
        assert a["status"] == b["status"]
        _same_recs(a["recommendations"], b["recommendations"])
    _same_recs(port.recommend(14, 5), ref.recommend(14, 5))


def test_service_routes_by_catalog_size(bundle):
    port = RecommendationService(bundle, device="cpu").load()
    assert port._search_route() == "exact"  # 900 items <= 1M
    port.approx_search_threshold = N_ITEMS - 1
    assert port._search_route() == "approx"
    port.approx_search_threshold = 0  # 0 disables the sieve
    assert port._search_route() == "exact"
    assert "flash" in port.get_model_info()["search"]


def test_serve_cli_passes_int8_catalog(monkeypatch, bundle):
    """``--int8_catalog`` reaches the service that the server loads."""
    seen = {}

    class FakeServer:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            seen["served"] = True

        def server_close(self):
            pass

    def fake_make_http_server(service, host, port, **kw):
        seen["service"] = service
        return FakeServer()

    monkeypatch.setattr(serve_app, "make_http_server", fake_make_http_server)
    assert serve_cli.main(["--model_dir", bundle, "--int8_catalog", "--device", "cpu",
                           "--port", "0"]) == 0
    assert seen["served"] and seen["service"].int8_catalog is True
    assert seen["service"].is_ready() and seen["service"]._search_route() == "int8"
