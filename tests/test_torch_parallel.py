"""The port's mesh, collectives, sharded top-k and sharded serving on
gloo ranks, against the JAX package on its 8-device virtual CPU mesh.

One module-scoped world of 4 gloo ranks (``tests/torch_parallel_worker.py``,
started by ``subprocess`` on a ``FileStore``) makes two meshes,
``model_parallel=4`` (1 x 4) and ``model_parallel=2`` (2 x 2), and
computes every case; each test compares one case with the JAX function
on the same seeded numpy inputs and a mesh with the same ``model`` axis
(the JAX ``data`` axis is larger: its answers are global arrays, the
port's are each rank's). Tolerances: the collectives equal or within
1e-6; the ring and sharded top-k rtol 1e-5, ids equal; ``ShardedIndex``
(fp32 over 77 rows, padded, with k beyond one shard's rows; int8) and
the sharded service atol 1e-5, ids equal.

``test_two_rank_http_serving`` serves ``/recommend`` over HTTP from two
gloo ranks (``tests/torch_sharded_serve_worker.py``) and holds the
answers against the one-rank service. The tests at the end run a
one-rank mesh in the test process, as a process without a launcher
does.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.ops.topk import blockwise_topk_int8 as jax_blockwise_int8
from recsys_tpu.ops.topk import make_ring_topk as jax_ring_topk
from recsys_tpu.ops.topk import quantize_rows as jax_quantize_rows
from recsys_tpu.parallel import collectives as jcoll
from recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recsys_tpu.parallel.sharding import batch_sharding, rows_sharding
from recsys_tpu.parallel.sharding import shard_batch as jax_shard_batch
from recsys_tpu.retrieval.scorer import RetrievalIndex as JaxRetrievalIndex
from recsys_tpu.retrieval.scorer import l2_normalize as jax_l2_normalize
from recsys_tpu.retrieval.scorer import make_sharded_topk as jax_sharded_topk
from recsys_tpu.retrieval.scorer import topk_scores as jax_topk_scores
from recsys_tpu.serve.service import RecommendationService as JaxService
from recsys_tpu.train.checkpoint import save_inference_bundle as jax_save_bundle
from recsys_tpu_torch.ops.topk import blockwise_topk_int8, quantize_rows
from recsys_tpu_torch.parallel import mesh as port_mesh
from recsys_tpu_torch.parallel.sharding import pad_to_multiple
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex, l2_normalize
from recsys_tpu_torch.serve.service import RecommendationService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MODEL = {"m4": 4, "m2": 2}  # each port mesh's model axis
N_USERS, N_ITEMS = 40, 90
MODEL_KW = dict(embedding_dim=16, user_tower_dims=(32, 16), item_tower_dims=(32, 16),
                cross_layers=2, dnn_dims=(16, 8), dropout_rate=0.0, use_pallas_dcn=True)
USER_RAW = np.arange(1, N_USERS + 1) * 7
ITEM_RAW = np.arange(1, N_ITEMS + 1) * 3
SERVICE_UIDS = [int(u) for u in USER_RAW[[0, 5, 17, 33, 2]]] + [99999]
JOIN_TIMEOUT_S = 120


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    exchange_x = np.zeros((4, 8), np.int32)
    for s in range(4):
        for c in range(4):
            exchange_x[s, 2 * c:2 * c + 2] = s * 100 + c
    # each of 4 shards' top 5 of 16 items (global ids) for 4 queries
    items, queries = rng.normal(size=(64, 16)).astype(f32), rng.normal(size=(4, 16)).astype(f32)
    shard_scores = np.einsum("qd,snd->sqn", queries, items.reshape(4, 16, 16))
    merge_i = np.argsort(-shard_scores, axis=-1, kind="stable")[..., :5]
    merge_s = np.take_along_axis(shard_scores, merge_i, axis=-1)
    return {
        "merge_items": items, "merge_queries": queries,
        "merge_s": merge_s, "merge_i": merge_i + 16 * np.arange(4)[:, None, None],
        "allreduce_x": rng.normal(size=(2, 2)).astype(f32),
        "allreduce_tree_a": rng.normal(size=(2, 3)).astype(f32),
        "allreduce_tree_b": rng.normal(size=(2, 2, 2)).astype(f32),
        "gather_x": rng.normal(size=(4, 2, 3)).astype(f32),
        "exchange_x": exchange_x,
        "ring_x": rng.normal(size=(4, 3)).astype(f32),
        "tie_scores": np.ones((4, 4), f32),
        "batch_x": np.arange(16, dtype=np.int32),
        "batch_y": rng.normal(size=(16, 4)).astype(f32),
        "chunk": rng.normal(size=(3, 16, 2)).astype(f32),
        "topk_u": rng.normal(size=(8, 16)).astype(f32),
        "topk_v": rng.normal(size=(64, 16)).astype(f32),
        "index_fp32_items": rng.normal(size=(77, 16)).astype(f32),
        "index_fp32_q": rng.normal(size=(5, 16)).astype(f32),
        "index_int8_items": rng.normal(size=(77, 32)).astype(f32),
        "index_int8_q": rng.normal(size=(6, 32)).astype(f32),
        "index_tiny_items": rng.normal(size=(3, 16)).astype(f32),
        "index_tiny_q": rng.normal(size=(2, 16)).astype(f32),
        "service_uids": np.asarray(SERVICE_UIDS),
    }


def _jax_bundle(path) -> str:
    cfg = JaxRecsysConfig(model=JaxModelConfig(**MODEL_KW))
    params = jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(3), cfg.model,
                                              N_USERS, N_ITEMS))
    index = JaxRetrievalIndex.build(params["towers"], cfg.model, N_ITEMS, ITEM_RAW)
    jax_save_bundle(str(path), params["towers"], cfg, USER_RAW, ITEM_RAW,
                    index=index, full_params=params)
    return str(path)


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_ranks(script: str, world: int, args_of) -> None:
    """Start ``world`` ranks of ``script`` and wait for all of them; a rank
    that fails or outlasts JOIN_TIMEOUT_S fails the caller with every
    rank's output."""
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", script),
                               *map(str, args_of(r))],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0] * world, "\n".join(o[-3000:] for o in outs)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case of the 4-rank world -> {"inputs", "bundle", "ranks":
    [(arrays, records)] by rank}."""
    root = tmp_path_factory.mktemp("torch_parallel")
    inputs = _inputs()
    np.savez(root / "inputs.npz", **inputs)
    bundle = _jax_bundle(root / "bundle")
    out = root / "out"
    out.mkdir()
    _run_ranks("torch_parallel_worker.py", WORLD,
               lambda r: (r, WORLD, root / "store", root / "inputs.npz", bundle, out))
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(out / f"rank{r}.json") as f:
            ranks.append((arrays, json.load(f)))
    return {"inputs": inputs, "bundle": bundle, "ranks": ranks}


def _coords(rank: int, name: str):
    """(data_index, model_index) of ``rank`` on a port mesh."""
    return divmod(rank, MODEL[name])


def _jax_ctx(model: int):
    return jax_make_mesh(model_parallel=model)


# ---- the mesh --------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODEL))
def test_mesh_shapes_and_coordinates(world, name):
    """The JAX mesh's fields and bookkeeping (``test_parallel.py``
    ``test_mesh_shapes``), with ranks laid out (data, model): the
    ``model`` axis is adjacent ranks."""
    mp = MODEL[name]
    jctx = _jax_ctx(mp)
    for r, (_, rec) in enumerate(world["ranks"]):
        m = rec[f"mesh_{name}"]
        di, mi = _coords(r, name)
        assert (m["n_model"], m["n_data"], m["n_devices"]) == (mp, WORLD // mp, WORLD)
        assert m["coordinates"] == [di, mi] and m["axis_index"] == [di, mi]
        assert m["axis_size"] == [WORLD // mp, mp] and m["device"] == "cpu"
        assert m["model_ranks"] == [di * mp + j for j in range(mp)]
        assert m["data_ranks"] == [j * mp + mi for j in range(WORLD // mp)]
        assert m["local_batch_64"] == 64 // (WORLD // mp)
        assert jctx.n_model == mp and jctx.local_batch(64) == 64 // jctx.n_data
    # 9 rows do not split over the 2 x 2 mesh's data axis (nor 10 over JAX's 4)
    assert "not divisible by data axis 2" in world["ranks"][0][1]["mesh_m2"]["local_batch_9"]
    assert world["ranks"][0][1]["mesh_m4"]["local_batch_9"] is None
    with pytest.raises(ValueError, match="not divisible by data axis 4"):
        _jax_ctx(2).local_batch(10)


def test_mesh_errors_match_jax(world):
    """The same validation as JAX ``make_mesh``, on every rank."""
    for _, rec in world["ranks"]:
        errs = rec["mesh_errors"]
        assert errs["mp3"] == "4 devices not divisible by model_parallel=3"
        assert errs["dp3_mp2"] == "data_parallel(3) * model_parallel(2) != 4"
        assert errs["mp0"] == "model_parallel must be >= 1"
    with pytest.raises(ValueError, match="not divisible by model_parallel=3"):
        jax_make_mesh(model_parallel=3)
    with pytest.raises(ValueError, match=r"data_parallel\(3\) \* model_parallel\(2\)"):
        jax_make_mesh(model_parallel=2, data_parallel=3)
    with pytest.raises(ValueError, match="model_parallel must be >= 1"):
        jax_make_mesh(model_parallel=0)


# ---- collectives -------------------------------------------------------------

def _shard_map(ctx, body, in_specs, out_specs):
    return jax.shard_map(body, mesh=ctx.mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def test_allreduce_mean_matches_jax(world):
    """``allreduce_mean`` over ``data`` (the 2 x 2 mesh's two rows)."""
    x = world["inputs"]["allreduce_x"]
    jctx = jax_make_mesh(model_parallel=4)  # data axis of 2, as the port's
    want = np.asarray(_shard_map(jctx, lambda v: jcoll.allreduce_mean({"g": v})["g"],
                                 P("data", None), P(None, None))(x))
    for arrays, _ in world["ranks"]:
        np.testing.assert_allclose(arrays["allreduce_mean"], want, rtol=0, atol=1e-6)


def test_allreduce_sum_over_model_matches_jax(world):
    """``allreduce_sum`` of a nested tree over ``model``; the inputs are
    left as they were."""
    a, b = world["inputs"]["allreduce_tree_a"], world["inputs"]["allreduce_tree_b"]
    jctx = _jax_ctx(2)
    fn = _shard_map(jctx, lambda a, b: tuple(
        jax.tree.leaves(jcoll.allreduce_sum({"a": a, "b": [b]}, axis="model"))),
        (P("model", None), P("model", None, None)), (P(None, None), P(None, None, None)))
    want_a, want_b = (np.asarray(o)[0] for o in fn(a, b))
    for r, (arrays, _) in enumerate(world["ranks"]):
        np.testing.assert_allclose(arrays["allreduce_sum_a"], want_a, rtol=0, atol=1e-6)
        np.testing.assert_allclose(arrays["allreduce_sum_b"], want_b, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(arrays["allreduce_sum_input_a"],
                                      a[_coords(r, "m2")[1]])


def test_gather_rows_matches_jax(world):
    x = world["inputs"]["gather_x"]
    fn = _shard_map(_jax_ctx(4), jcoll.gather_rows, P("model", None), P(None, None))
    want = np.asarray(fn(x.reshape(8, 3)))
    for arrays, _ in world["ranks"]:
        np.testing.assert_array_equal(arrays["gather_rows"], want)


def test_exchange_matches_jax(world):
    """Shard i's chunk j ends up on shard j as chunk i
    (``test_parallel.py::test_exchange_all_to_all`` at 4 shards)."""
    x = world["inputs"]["exchange_x"]
    fn = _shard_map(_jax_ctx(4), lambda v: jcoll.exchange(v[0])[None],
                    P("model", None), P("model", None))
    want = np.asarray(fn(x))
    for r, (arrays, _) in enumerate(world["ranks"]):
        np.testing.assert_array_equal(arrays["exchange"], want[r])
        for c in range(4):
            assert (arrays["exchange"][2 * c:2 * c + 2] == c * 100 + r).all()


@pytest.mark.parametrize("case", ["1", "3", "m2"])
def test_ring_shift_matches_jax(world, case):
    """``ring_shift`` sends to ``(i + shift) % n`` (``ppermute``)."""
    x = world["inputs"]["ring_x"]
    model, shift = (2, 1) if case == "m2" else (4, int(case))
    fn = _shard_map(_jax_ctx(model), lambda v: jcoll.ring_shift(v, shift=shift),
                    P("model", None), P("model", None))
    want = np.asarray(fn(x[:model]))
    key = "ring_shift_m2" if case == "m2" else f"ring_shift_{shift}"
    for r, (arrays, _) in enumerate(world["ranks"]):
        mi = r % model
        np.testing.assert_array_equal(arrays[key], want[mi])
        np.testing.assert_array_equal(arrays[key], x[(mi - shift) % model])


def test_merge_topk_matches_jax_and_dense(world):
    """Each shard's top 5 with global ids (the same candidates for both
    packages), merged over 4 shards: the dense top 5
    (``test_parallel.py::test_merge_topk_matches_dense``)."""
    inp = world["inputs"]
    items, queries = inp["merge_items"], inp["merge_queries"]

    def body(s, i):
        return jcoll.merge_topk(s[0], i[0], 5)

    js, ji = _shard_map(_jax_ctx(4), body, (P("model"), P("model")), (P(), P()))(
        inp["merge_s"], inp["merge_i"])
    dense = np.einsum("qd,nd->qn", queries, items)
    for arrays, _ in world["ranks"]:
        np.testing.assert_array_equal(arrays["merge_topk_scores"], np.asarray(js))
        np.testing.assert_array_equal(arrays["merge_topk_ids"], np.asarray(ji))
        np.testing.assert_array_equal(arrays["merge_topk_ids"],
                                      np.argsort(-dense, axis=1, kind="stable")[:, :5])


def test_merge_topk_keeps_jax_tie_order(world):
    """Equal scores merge in shard order, lower positions first, as
    ``lax.top_k`` orders them."""
    ties = world["inputs"]["tie_scores"]

    def body(s):
        ids = jnp.arange(4) + 10 * jcoll.axis_index("model")
        return jcoll.merge_topk(s, ids[None], 6)

    js, ji = _shard_map(_jax_ctx(4), body, P("model", None), (P(), P()))(ties)
    for arrays, _ in world["ranks"]:
        np.testing.assert_array_equal(arrays["merge_ties_scores"], np.asarray(js)[0])
        np.testing.assert_array_equal(arrays["merge_ties_ids"], np.asarray(ji)[0])
    np.testing.assert_array_equal(np.asarray(ji)[0], [0, 1, 2, 3, 10, 11])


# ---- batch placement -----------------------------------------------------------

def test_shard_batch_gives_each_rank_its_data_slice(world):
    """The JAX placement splits axis 0 over ``data``; a rank holds its
    slice (``test_parallel.py::test_shard_batch_placement``)."""
    batch = {"x": world["inputs"]["batch_x"], "y": world["inputs"]["batch_y"]}
    placed = jax_shard_batch(_jax_ctx(2), batch)
    assert placed["x"].sharding.spec == P("data")
    whole = {k: np.asarray(v) for k, v in placed.items()}
    for r, (arrays, _) in enumerate(world["ranks"]):
        di = _coords(r, "m2")[0]
        np.testing.assert_array_equal(arrays["shard_batch_x"], whole["x"][di * 8:(di + 1) * 8])
        np.testing.assert_array_equal(arrays["shard_batch_y"], whole["y"][di * 8:(di + 1) * 8])


def test_shard_batch_chunk_splits_axis_one(world):
    chunk = world["inputs"]["chunk"]
    for r, (arrays, _) in enumerate(world["ranks"]):
        di = _coords(r, "m2")[0]
        np.testing.assert_array_equal(arrays["shard_batch_chunk"], chunk[:, di * 8:(di + 1) * 8])


def test_pad_to_multiple_matches_jax():
    from recsys_tpu.parallel.sharding import pad_to_multiple as jax_pad

    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    for axis, multiple in ((0, 4), (1, 2), (0, 5)):
        got, want = pad_to_multiple(x, multiple, axis, fill=-1), jax_pad(x, multiple, axis, -1)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


# ---- ring and sharded top-k ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODEL))
@pytest.mark.parametrize("normalize", [True, False])
def test_ring_topk_matches_jax(world, name, normalize):
    """``make_ring_topk`` against JAX's on a mesh with the same ``model``
    axis (``test_ops.py::test_ring_topk_matches_dense`` and
    ``_unnormalized``): each rank's data slice of the queries."""
    u, v = world["inputs"]["topk_u"], world["inputs"]["topk_v"]
    k = 6 if normalize else 3
    jctx = _jax_ctx(MODEL[name])
    ring = jax_ring_topk(jctx, k, normalize=normalize)
    js, ji = (np.asarray(o) for o in ring(jax.device_put(u, batch_sharding(jctx, 2)),
                                          jax.device_put(v, rows_sharding(jctx))))
    if normalize:
        ds, di_ = jax_topk_scores(jnp.asarray(u), jnp.asarray(v), k)
        np.testing.assert_array_equal(ji, np.asarray(di_))
    q_loc = u.shape[0] // (WORLD // MODEL[name])
    for r, (arrays, _) in enumerate(world["ranks"]):
        rows = slice(_coords(r, name)[0] * q_loc, (_coords(r, name)[0] + 1) * q_loc)
        np.testing.assert_allclose(arrays[f"ring_{name}_{normalize}_s"], js[rows], rtol=1e-5)
        np.testing.assert_array_equal(arrays[f"ring_{name}_{normalize}_i"], ji[rows])


@pytest.mark.parametrize("name", sorted(MODEL))
def test_sharded_topk_matches_jax(world, name):
    """``make_sharded_topk`` against JAX's
    (``test_retrieval.py::test_sharded_topk_matches_single_device``):
    every rank returns the whole [Q, k]."""
    u, v = world["inputs"]["topk_u"], world["inputs"]["topk_v"]
    fn = jax_sharded_topk(_jax_ctx(MODEL[name]), 6, normalize=True)
    js, ji = (np.asarray(o) for o in fn(jnp.asarray(u), jnp.asarray(v)))
    for arrays, _ in world["ranks"]:
        np.testing.assert_allclose(arrays[f"sharded_{name}_s"], js, rtol=1e-5)
        np.testing.assert_array_equal(arrays[f"sharded_{name}_i"], ji)


# ---- ShardedIndex ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODEL))
@pytest.mark.parametrize("k", [10, 25])
def test_sharded_index_fp32_matches_jax(world, name, k):
    """77 rows padded to the shard multiple (80 over 4 shards: 3 pad rows;
    78 over 2), k = 25 beyond a shard's 20 rows
    (``test_retrieval.py::test_sharded_index_matches_dense``)."""
    items, q = world["inputs"]["index_fp32_items"], world["inputs"]["index_fp32_q"]
    jsh = JaxRetrievalIndex(items, np.arange(77)).shard(_jax_ctx(MODEL[name]))
    js, ji = jsh.search(q, k)
    rows = -(-77 // MODEL[name])
    for r, (arrays, rec) in enumerate(world["ranks"]):
        mi = _coords(r, name)[1]
        assert rec[f"index_fp32_{name}_shard"] == [rows, min(77, (mi + 1) * rows) - mi * rows]
        s, i = arrays[f"index_fp32_{name}_k{k}_s"], arrays[f"index_fp32_{name}_k{k}_i"]
        assert s.shape == (5, k)
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(i, ji)
        assert (i < 77).all()  # pad rows never surface


@pytest.mark.parametrize("name", sorted(MODEL))
def test_sharded_index_smaller_than_its_shards_matches_jax(world, name):
    """3 rows over 4 shards (rank 3 holds no real row) and over 2: k = 4
    passes the catalog, and the candidates past it score -inf under the
    pad rows' ids, as under JAX's mask."""
    items, q = world["inputs"]["index_tiny_items"], world["inputs"]["index_tiny_q"]
    js, ji = JaxRetrievalIndex(items, np.arange(3)).shard(_jax_ctx(MODEL[name])).search(q, 4)
    assert np.isneginf(js[:, 3]).all() and np.isfinite(js[:, :3]).all()
    for arrays, _ in world["ranks"]:
        np.testing.assert_allclose(arrays[f"index_tiny_{name}_s"], js, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(arrays[f"index_tiny_{name}_i"], ji)


@pytest.mark.parametrize("name", sorted(MODEL))
def test_sharded_index_int8_matches_jax(world, name):
    """int8 shards: equal to JAX's sharded int8 search and to the
    single-device int8 scan over the same normalized rows, both packages
    (``test_retrieval.py::test_sharded_index_int8``)."""
    items, q = world["inputs"]["index_int8_items"], world["inputs"]["index_int8_q"]
    from recsys_tpu.retrieval.scorer import ShardedIndex as JaxShardedIndex

    js, ji = JaxShardedIndex(JaxRetrievalIndex(items, np.arange(77)), _jax_ctx(MODEL[name]),
                             int8=True).search(q, 10)
    iq, isc = jax_quantize_rows(jax_l2_normalize(jnp.asarray(items)))
    rs, ri = jax_blockwise_int8(jax_l2_normalize(jnp.asarray(q)), iq, isc, 10, block_size=64,
                                approx=False)
    pq, psc = quantize_rows(l2_normalize(torch.from_numpy(items)))
    ps, pi = blockwise_topk_int8(l2_normalize(torch.from_numpy(q)), pq, psc, 10, block_size=64)
    for arrays, _ in world["ranks"]:
        s, i = arrays[f"index_int8_{name}_k10_s"], arrays[f"index_int8_{name}_k10_i"]
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(s, np.asarray(rs), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(i, np.asarray(ri))
        np.testing.assert_allclose(s, ps.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(i, pi.numpy())
        assert (i < 77).all()


# ---- the sharded service -----------------------------------------------------------

def _same_recs(got, want):
    assert [r["item_id"] for r in got] == [r["item_id"] for r in want]
    assert [r["rank"] for r in got] == [r["rank"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                               rtol=0, atol=1e-5)


def _same_service(rec, want_one, want_batch):
    for uid, recs in rec["one"].items():
        _same_recs(recs, want_one(int(uid)))
    want = want_batch(SERVICE_UIDS)
    assert [r["status"] for r in rec["batch"]] == [r["status"] for r in want]
    assert rec["batch"][-1]["status"] == "cold_start"  # the unknown user
    for got, w in zip(rec["batch"], want):
        assert got["user_id"] == w["user_id"]
        _same_recs(got["recommendations"], w["recommendations"])


@pytest.mark.parametrize("label", ["default", "m2", "int8"])
def test_sharded_service_matches_jax_sharded(world, label):
    """``backend="sharded"`` (retrieval only) on one bundle against JAX's
    ``backend="sharded"`` on a mesh with the same ``model`` axis, cold
    start included (``test_serving.py::test_sharded_backend_serving``);
    the default mesh puts every rank on ``model``."""
    model = 2 if label == "m2" else 4
    ref = JaxService(world["bundle"], backend="sharded", int8_catalog=label == "int8",
                     mesh_ctx=jax_make_mesh(model_parallel=model)).load()
    for _, rec in world["ranks"]:
        got = rec[f"service_{label}"]
        assert got["mesh"] == [WORLD // model, model]
        assert got["info"] == "recsys_tpu_torch sharded scorer (cpu)"
        _same_service(got, lambda u: ref.recommend(u, 7), lambda us: ref.recommend_batch(us, 5))


@pytest.mark.parametrize("label, rerank", [("default", 0), ("m2", 0), ("m2_rerank", 20)])
def test_sharded_service_matches_the_device_backend(world, label, rerank):
    """The sharded backend answers as the port's ``backend="device"``
    (exact top-k at every catalog size), also with the rerank, which runs
    as on the device backend; JAX's ``backend="device"`` gives the same."""
    port = RecommendationService(world["bundle"], backend="device", device="cpu",
                                 rerank_candidates=rerank).load()
    ref = JaxService(world["bundle"], backend="device", rerank_candidates=rerank).load()
    for _, rec in world["ranks"]:
        got = rec[f"service_{label}"]
        _same_service(got, lambda u: port.recommend(u, 7), lambda us: port.recommend_batch(us, 5))
        _same_service(got, lambda u: ref.recommend(u, 7), lambda us: ref.recommend_batch(us, 5))


# ---- HTTP across two ranks -----------------------------------------------------------

def test_two_rank_http_serving(world, tmp_path):
    """``/recommend`` over real HTTP from a catalog row-sharded over two
    gloo ranks: rank 0 serves and relays each user id to rank 1 by
    ``broadcast`` (``test_multihost.py::test_two_process_sharded_serving``);
    the answers equal the one-rank service's on the same bundle."""
    out_json = tmp_path / "answers.json"
    uids = SERVICE_UIDS[:5]
    _run_ranks("torch_sharded_serve_worker.py", 2,
               lambda r: (r, 2, tmp_path / "store", world["bundle"], out_json,
                          json.dumps(uids)))
    got = json.loads(out_json.read_text())
    ref = RecommendationService(world["bundle"], backend="device", device="cpu").load()
    for u in uids:
        body = got[str(u)]
        assert body["user_id"] == u and body["count"] == 5
        _same_recs(body["recommendations"], ref.recommend(u, 5))


# ---- one rank in this process ----------------------------------------------------------

def test_one_rank_mesh_without_a_launcher(monkeypatch):
    """No launcher: ``make_mesh`` starts a one-rank group (gloo on the
    CPU) and takes it again; the card is asked for by default."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    port_mesh.maybe_initialize_distributed("cpu")  # nothing to join
    ctx = port_mesh.make_mesh(device="cpu")
    assert (ctx.n_data, ctx.n_model, ctx.coordinates) == (1, 1, (0, 0))
    assert port_mesh.make_mesh(model_parallel=1, data_parallel=1, device="cpu") is ctx
    assert port_mesh.world_size("cpu") == 1
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        port_mesh.make_mesh(model_parallel=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_mesh.make_mesh()


@pytest.mark.parametrize("int8", [False, True])
def test_one_rank_sharded_service_in_process(world, int8):
    """``backend="sharded"`` without a mesh or a launcher serves from a
    one-rank mesh: equal to the device backend, and with int8 shards to
    JAX's sharded int8 search on one shard."""
    # the sharded route is exact at every catalog size: never the sieve
    svc = RecommendationService(world["bundle"], backend="sharded", device="cpu",
                                int8_catalog=int8, approx_search_threshold=10).load()
    assert svc._search_route() == "sharded"
    assert (svc.mesh_ctx.n_data, svc.mesh_ctx.n_model) == (1, 1)
    assert svc.get_model_info()["search"].startswith("catalog row-sharded")
    if int8:
        ref = JaxService(world["bundle"], backend="sharded", int8_catalog=True,
                         mesh_ctx=jax_make_mesh(model_parallel=1)).load()
    else:
        ref = RecommendationService(world["bundle"], backend="device", device="cpu").load()
    _same_service({"one": {str(u): svc.recommend(u, 7) for u in SERVICE_UIDS[:4]},
                   "batch": svc.recommend_batch(SERVICE_UIDS, 5)},
                  lambda u: ref.recommend(u, 7), lambda us: ref.recommend_batch(us, 5))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_maybe_initialize_distributed_joins_the_launchers_group(tmp_path):
    """Under torchrun's variables a process joins the launcher's group
    (gloo on the CPU), and the default sharded mesh spans its ranks."""
    code = ("from recsys_tpu_torch.parallel import mesh\n"
            "mesh.maybe_initialize_distributed('cpu')\n"
            "import torch.distributed as dist\n"
            "ctx = mesh.make_mesh(model_parallel=mesh.world_size('cpu'), data_parallel=1,"
            " device='cpu')\n"
            "print(dist.get_backend(), dist.get_world_size(), ctx.n_model)\n"
            "mesh.shutdown()\n")
    env = _env()
    env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=JOIN_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split() == ["gloo", "1", "1"]
