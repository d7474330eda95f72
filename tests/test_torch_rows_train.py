"""The port's row-sharded training (``Trainer`` on a ``(data, model)`` mesh
with ``embedding_sharding="rows"``: the psum and a2a lookups inside the
dense and the sparse step, the CBNS cache, explicit negatives, the
overflow counter, ``Trainer.train``, resume, ``dryrun_multichip``, the
row-sharded checkpoint that no host holds whole, and the train CLI) on
gloo ranks, against the JAX package.

One module-scoped pair of worlds (``tests/torch_rows_train_worker.py``,
started by ``subprocess`` on ``FileStore``s, ``OMP_NUM_THREADS=1``, every
join bounded): 4 ranks train every step case on a 2 x 2 or 1 x 4 mesh
from the JAX-initialised params of ``tests/test_trainer_spmd.py``'s
fixture (63 users, 127 items, so no row is padded; global B = 64,
embedding 16, one cross layer, fp32, class weights (1.25, 0.85)), then
``Trainer.train`` on the 2 x 2 mesh; 2 ranks run the train CLI on a
synthesized bundle. The JAX references are computed while the ranks run:
the replicated GSPMD step on 8 devices (under global negatives it does not
depend on the mesh), and the JAX rows step on a 1 x 4 mesh of
``jax.devices()[:4]`` where the case depends on the mesh (the padded
tables, the overflow count). Tolerances are JAX's own: params rtol 2e-4 /
atol 2e-5 on every leaf, losses rtol 1e-4; the cache's losses 2e-4 and
its FIFO's ids equal; ``Trainer.train``'s per-epoch losses 1e-3 of the
one-card run (JAX's rows against replicated), resume and the CLI 1e-4.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

from recsys_tpu.config import EvalConfig as JaxEvalConfig
from recsys_tpu.config import MeshConfig as JaxMeshConfig
from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.config import TrainConfig as JaxTrainConfig
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recsys_tpu.parallel.sharding import shard_batch as jax_shard_batch
from recsys_tpu.serve.service import RecommendationService as JaxService
from recsys_tpu.train.trainer import Trainer as JaxTrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_rows_train_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, CLI_WORLD = worker.WORLD, 2
N_USERS, N_ITEMS, B = worker.N_USERS, worker.N_ITEMS, worker.B
JOIN_TIMEOUT_S = 240
# port case -> the JAX run it is held against (params and losses)
JAX_REFERENCE = {"xla": "global", "psum": "global", "a2a": "global", "a2a_m4": "global",
                 "flash": "global", "psum_noclip": "global_noclip",
                 "a2a_noclip": "global_noclip", "a2a_m4_noclip": "global_noclip",
                 "negatives": "negatives", "sparse_psum": "global", "sparse_a2a": "global",
                 "sparse_psum_noclip": "global_noclip", "sparse_a2a_noclip": "global_noclip",
                 "cache_dense": "cache_dense", "cache_sparse": "cache_sparse",
                 "padded": "padded"}
# JAX run -> (model_parallel, devices, train overrides, steps, negatives, batches, users,
#             capacity factor)
JAX_RUNS = {
    "global": (1, 8, {}, 3, False, "b", N_USERS, 2.0),
    "global_noclip": (1, 8, {"clipnorm": 0.0}, 3, False, "b", N_USERS, 2.0),
    "negatives": (1, 8, {}, 2, True, "b", N_USERS, 2.0),
    "cache_dense": (1, 8, {"negative_cache": 2 * B}, 3, False, "b", N_USERS, 2.0),
    "cache_sparse": (1, 8, {"negative_cache": 2 * B, "sparse_table_updates": True}, 3, False,
                     "b", N_USERS, 2.0),
    "padded": (4, 4, {}, 3, False, "p", worker.PAD_USERS, 2.0),
    "skew": (4, 4, {}, 1, False, "skew", N_USERS, 1.0),
}


def _jax_cfg(model_parallel, train_over, capacity):
    rows = model_parallel > 1
    return JaxRecsysConfig(
        model=JaxModelConfig(**worker.MODEL),
        train=JaxTrainConfig(**{"batch_size": B, "epochs": 1, **train_over}),
        mesh=JaxMeshConfig(model_axis=model_parallel,
                           embedding_sharding="rows" if rows else "replicated",
                           lookup_strategy="a2a" if rows else "xla",
                           lookup_capacity_factor=capacity),
        eval=JaxEvalConfig(topk=(10,)))


def _batches(seed=0, n_users=N_USERS):
    """``tests/test_trainer_spmd.py``'s batches (users below ``n_users``)."""
    rng = np.random.default_rng(seed)
    return [{"user_id": rng.integers(0, n_users, B).astype(np.int32),
             "movie_id": rng.integers(0, N_ITEMS, B).astype(np.int32),
             "rating": rng.uniform(1, 5, B).astype(np.float32),
             "y_implicit": (rng.random(B) > 0.4).astype(np.float32),
             "log_q": np.full(B, -np.log(N_ITEMS), np.float32)} for _ in range(3)]


def _skew():
    """``test_a2a_overflow_counter_and_survival``'s batch: every id on shard 0."""
    b = _batches(seed=0)[0]
    b["user_id"][:] = 0
    b["movie_id"][:] = np.arange(B) % 8
    return b


def _negs():
    rng = np.random.default_rng(5)
    return [rng.integers(0, N_ITEMS, (B, 4)).astype(np.int32) for _ in range(2)]


def _params0(n_users=N_USERS, rows_multiple=1):
    return jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(3), JaxModelConfig(**worker.MODEL),
                                            n_users, N_ITEMS, rows_multiple))


def _batch_sets():
    return {"b": _batches(), "p": _batches(seed=1, n_users=worker.PAD_USERS), "skew": [_skew()]}


def _jax_run(name, out_dir):
    """-> {"params", "metrics" (per step), "cache"} of JAX run ``name``."""
    mp, n_dev, train_over, n_steps, negs, bkey, n_users, cap = JAX_RUNS[name]
    ctx = jax_make_mesh(model_parallel=mp, devices=jax.devices()[:n_dev])
    trainer = JaxTrainer(_jax_cfg(mp, train_over, cap), output_dir=str(out_dir / f"jax_{name}"),
                         mesh_ctx=ctx)
    state = trainer.init_state(n_users, N_ITEMS, seed=3)
    trainer._state_for_shape = state
    batches = _batch_sets()[bkey][:n_steps]
    if negs:
        batches = [{**b, "neg_ids": n} for b, n in zip(batches, _negs())]
    step = trainer.make_train_step(class_weights=worker.CLASS_WEIGHTS, example_batch=batches[0],
                                   use_explicit_negs=negs)
    metrics = []
    for b in batches:
        state, m = step(state, jax_shard_batch(ctx, b))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    cache = None if state.extras is None else jax.device_get(state.extras)
    return {"params": jax.device_get(state.params), "metrics": metrics, "cache": cache}


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(world, args_of):
    return [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                           "torch_rows_train_worker.py"),
                              *map(str, args_of(r))],
                             cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _join(procs) -> None:
    """Wait for every rank, reading their output as it comes; a rank that
    fails or outlasts JOIN_TIMEOUT_S fails the caller with every rank's
    output."""
    outs = [[] for _ in procs]
    readers = [threading.Thread(target=lambda p=p, o=o: o.append(p.stdout.read()), daemon=True)
               for p, o in zip(procs, outs)]
    for t in readers:
        t.start()
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for t in readers:
            t.join(timeout=30)
    assert [p.returncode for p in procs] == [0] * len(procs), \
        "\n".join("".join(o)[-3000:] for o in outs)


def _load(out, world):
    ranks = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        ranks.append((arrays, json.loads((out / f"rank{r}.json").read_text())))
    return ranks


@pytest.fixture(scope="module")
def world(tmp_path_factory, tiny_bundle):
    """Both worlds and the JAX runs, computed while the ranks run ->
    {"steps": [(arrays, records)] by rank, "jax": {name: run}, ...}."""
    root = tmp_path_factory.mktemp("torch_rows_train")
    inputs = {f"params/{k}": v for k, v in worker._flat(_params0()).items()}
    inputs.update({f"params_pad/{k}": v for k, v in
                   worker._flat(_params0(worker.PAD_USERS, rows_multiple=4)).items()})
    sets = _batch_sets()
    for i in range(3):
        inputs.update({f"b{i}/{k}": v for k, v in sets["b"][i].items()})
        inputs.update({f"p{i}/{k}": v for k, v in sets["p"][i].items()})
    inputs.update({f"skew/{k}": v for k, v in sets["skew"][0].items()})
    for i, n in enumerate(_negs()):
        inputs[f"neg{i}"] = n
    inputs.update({f"bundle/{k}": v for k, v in tiny_bundle.items()})
    np.savez(root / "inputs.npz", **inputs)
    np.savez(root / "bundle.npz", **tiny_bundle)
    steps_out, cli_out = root / "steps", root / "cli"
    steps_out.mkdir()
    cli_out.mkdir()
    procs = _start(WORLD, lambda r: (r, WORLD, root / "store", root / "inputs.npz", steps_out,
                                     "steps"))
    procs += _start(CLI_WORLD, lambda r: (r, CLI_WORLD, root / "cli_store",
                                          root / "bundle.npz", cli_out, "cli"))
    try:
        runs = {name: _jax_run(name, root) for name in JAX_RUNS}
        ctx = jax_make_mesh(model_parallel=4, devices=jax.devices()[:4])
        pad = JaxTrainer(_jax_cfg(4, {}, 2.0), output_dir=str(root / "jax_pad_init"),
                         mesh_ctx=ctx).init_state(worker.PAD_USERS, N_ITEMS, seed=0)
        pad_shapes = {k: list(np.shape(v)) for k, v in
                      worker._flat(jax.device_get(pad.params)).items()}
    finally:
        _join(procs)
    return {"steps": _load(steps_out, WORLD), "cli": cli_out, "root": root, "jax": runs,
            "jax_pad_shapes": pad_shapes}


def _tree_close(arrays, prefix, want, rtol=2e-4, atol=2e-5):
    flat = worker._flat(want)
    assert sorted(k for k in arrays if k.startswith(prefix)) == sorted(prefix + k for k in flat)
    for k, v in flat.items():
        np.testing.assert_allclose(arrays[prefix + k], np.asarray(v), rtol=rtol, atol=atol,
                                   err_msg=f"leaf {k} diverged")


def _same_on_every_rank(ranks, prefix):
    """The whole (gathered) leaves under ``prefix`` are rank 0's, bit for bit."""
    a0 = ranks[0][0]
    for arrays, _ in ranks[1:]:
        for k in a0:
            if k.startswith(prefix):
                np.testing.assert_array_equal(arrays[k], a0[k], err_msg=k)


# ---- the step against the JAX package ------------------------------------

@pytest.mark.parametrize("case", sorted(JAX_REFERENCE))
def test_rows_steps_match_jax(world, case):
    """The case's steps on 4 ranks against its JAX run: every leaf after
    the last step (the tables gathered whole), every step's loss; the
    ranks end with the same bits; the sparse cases took the sparse step.
    The clip-off cases catch a gradient scaled by n_model or 1/n_model
    (``test_rows_lookup_strategies_match_replicated``,
    ``test_rows_model4_a2a_matches_replicated``,
    ``test_spmd_step_with_explicit_negatives``,
    ``test_spmd_step_flash_ce_global_negatives``,
    ``test_spmd_sparse_updates_match_replicated``)."""
    ref = world["jax"][JAX_REFERENCE[case]]
    ranks = world["steps"]
    _same_on_every_rank(ranks, f"{case}/")
    arrays, rec = ranks[0]
    _tree_close(arrays, f"{case}/params/", ref["params"])
    want = [m["loss"] for m in ref["metrics"]]
    np.testing.assert_allclose(rec[case]["losses"], want, rtol=1e-4)
    mp, strategy, _, train_over, n_steps = worker.CASES[case][:5]
    sparse = train_over.get("sparse_table_updates", False)
    assert rec[case]["step_counts"]["sparse" if sparse else "dense"] == n_steps
    n_rows = {"user_table": (worker.PAD_USERS if case == "padded" else N_USERS) + 1,
              "item_table": N_ITEMS + 1}
    for _, r in ranks:  # each rank holds its rows only
        for k, shape in r[case]["shard_shapes"].items():
            assert shape == [-(-n_rows[k] // mp) * mp // mp, 16], (k, shape)
    if strategy == "a2a" and case != "skew":
        assert rec[case]["overflow"] == [0.0] * n_steps  # capacity factor 2 headroom


def test_cache_composes_with_the_rows_a2a_step(world):
    """The CBNS cache through the a2a step, dense and sparse: the losses
    within 2e-4 of the JAX GSPMD step's, the FIFO's ids equal, its rows and
    corrections as JAX's test holds them
    (``test_negative_cache.py::test_cache_composes_with_spmd_a2a_step``)."""
    arrays, rec = world["steps"][0]
    for case in ("cache_dense", "cache_sparse"):
        ref = world["jax"][case]
        np.testing.assert_allclose(rec[case]["losses"], [m["loss"] for m in ref["metrics"]],
                                   rtol=2e-4)
        np.testing.assert_array_equal(arrays[f"{case}/cache/ids"], ref["cache"]["ids"])
        np.testing.assert_allclose(arrays[f"{case}/cache/corr"], ref["cache"]["corr"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(arrays[f"{case}/cache/emb"], ref["cache"]["emb"],
                                   rtol=2e-3, atol=1e-4)
        assert (arrays[f"{case}/cache/ids"][-2 * B:] >= 0).all()


def test_a2a_overflow_counter_and_survival(world):
    """Every id on shard 0 at capacity factor 1 on the 1 x 4 mesh: the
    overflow is counted, JAX's count on a 1 x 4 mesh, and the step's loss
    stays finite and equal to JAX's (zero rows on both sides). The params
    are not compared: the zero rows give logits of exactly 0 at init, where
    the two packages' BCE takes different subgradients (ROADMAP Queue 3)."""
    ref = world["jax"]["skew"]["metrics"][0]
    assert ref["lookup_overflow"] > 0
    for _, rec in world["steps"]:
        assert rec["skew"]["overflow"] == [ref["lookup_overflow"]]
        np.testing.assert_allclose(rec["skew"]["losses"], [ref["loss"]], rtol=1e-4)


def test_padded_tables_match_jax_init_state(world):
    """62 users on 4 model ranks: the tables and ``item_bias`` padded to 64
    and 128 rows, the shapes of JAX's ``init_state`` with ``rows_multiple``
    (the step itself is held by ``test_rows_steps_match_jax[padded]``)."""
    want = world["jax_pad_shapes"]
    assert want["towers/user_table"] == [64, 16] and want["towers/item_bias"] == [128]
    for _, rec in world["steps"]:
        assert rec["init_pad_shapes"] == want


def test_sparse_per_replica_negatives_match_dense(world):
    """Per-replica negatives on the 2 x 2 mesh: the sparse step lands on
    the dense step's params (``test_spmd_sparse_per_replica_negatives``)."""
    arrays, rec = world["steps"][0]
    want = {k[len("per_replica_dense/params/"):]: v for k, v in arrays.items()
            if k.startswith("per_replica_dense/params/")}
    _tree_close(arrays, "per_replica_sparse/params/", worker._unflatten(want, ""))
    assert all(np.isfinite(rec["per_replica_sparse"]["losses"]))
    assert abs(rec["per_replica_dense"]["losses"][0] - rec["a2a"]["losses"][0]) > 1e-3


def test_sparse_lazy_adam_keeps_untouched_rows(world):
    """Sparse lazy Adam on the row-sharded tables: finite losses, and the
    user rows that no batch touched keep their init values bit for bit
    (``test_spmd_sparse_lazy_adam_runs_on_sharded_tables``)."""
    arrays, rec = world["steps"][0]
    assert all(np.isfinite(rec["sparse_lazy_adam"]["losses"]))
    touched = np.unique(np.concatenate([b["user_id"] for b in _batches()]))
    untouched = np.setdiff1d(np.arange(N_USERS), touched)
    assert len(untouched) > 0
    got = arrays["sparse_lazy_adam/params/towers/user_table"][untouched]
    np.testing.assert_array_equal(got, _params0()["towers"]["user_table"][untouched])
    moved = arrays["sparse_lazy_adam/params/towers/user_table"][touched]
    assert not np.array_equal(moved, _params0()["towers"]["user_table"][touched])


def test_sparse_step_on_shards_that_own_no_row(world):
    """The skewed batch (every id on shard 0) through the sparse lazy-Adam
    step on the 1 x 4 mesh, where shards 1 to 3 own none of the step's
    rows: every leaf equals the same step on one device (the port's own,
    replicated), and every row that no id touched keeps its init bits."""
    import torch

    from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
    from recsys_tpu_torch.train.trainer import Trainer

    _, _, model_over, train_over, _, _, _, _ = worker.CASES["sparse_skew"]
    cfg = worker.configs(1, "xla", model_over, train_over).replace(
        **{"mesh.embedding_sharding": "replicated"})
    tr = Trainer(cfg, str(world["root"] / "sparse_skew_one_device"), device="cpu")
    state = tr.state_from_params(params_from_numpy(_params0(), "cpu"), 3)
    batch = {k: torch.from_numpy(v) for k, v in _skew().items()}
    state, metrics = tr.make_train_step(worker.CLASS_WEIGHTS)(state, batch)
    want = params_to_numpy(state.params)
    arrays, rec = world["steps"][0]
    _same_on_every_rank(world["steps"], "sparse_skew/")
    _tree_close(arrays, "sparse_skew/params/", want)
    np.testing.assert_allclose(rec["sparse_skew"]["losses"], [float(metrics["loss"])],
                               rtol=1e-4)
    assert rec["sparse_skew"]["overflow"] == [0.0]
    init = _params0()["towers"]
    for key, touched in (("user_table", [0]), ("item_table", list(range(8)))):
        got = arrays[f"sparse_skew/params/towers/{key}"]
        rest = np.setdiff1d(np.arange(got.shape[0]), touched)
        np.testing.assert_array_equal(got[rest], init[key][rest], err_msg=key)


# ---- Trainer.train, resume, dryrun ------------------------------------------

def _epochs(run_dir):
    with open(os.path.join(run_dir, "detailed_metrics.json")) as f:
        return json.load(f)["epochs"]


@pytest.fixture(scope="module")
def one_card_run(world, tiny_bundle):
    """``TRAIN_RUNS["train_a2a"]``'s config with replicated tables on one
    device (the control)."""
    from recsys_tpu_torch.train.trainer import Trainer

    cfg = worker.configs(1, "xla", {}, {}, train=worker.TRAIN).replace(
        **{"mesh.embedding_sharding": "replicated"})
    out = world["root"] / "one_card"
    Trainer(cfg, str(out), device="cpu").train(tiny_bundle)
    return out


@pytest.mark.parametrize("run", ["train_a2a", "train_a2a_sparse"])
def test_trainer_end_to_end_rows_a2a(world, tiny_bundle, run):
    """``Trainer.train`` two epochs on the 2 x 2 mesh (a2a, dense and
    sparse): finite recall, rank 0 wrote the bundle with the padded tables,
    and both packages serve it with the same rankings
    (``test_trainer_end_to_end_rows_a2a[_sparse]``)."""
    from recsys_tpu_torch.serve.service import RecommendationService

    rec = world["steps"][0][1]["train"][run]
    assert np.isfinite(rec["report"]["recall@10"])
    if "eval_every_epochs" in worker.TRAIN_RUNS[run][0]:  # rank 0's, broadcast
        assert all(np.isfinite(e["val_recall@10"]) for e in _epochs(rec["dir"]))
    steps = len(tiny_bundle["train/user_id"]) // worker.TRAIN_BATCH
    assert rec["step_counts"] == {"dense": 0 if "sparse" in run else 2 * steps,
                                  "sparse": 2 * steps if "sparse" in run else 0}
    serving = os.path.join(rec["dir"], "serving")
    with np.load(os.path.join(serving, "encoder.npz")) as z:
        n_users = int(tiny_bundle["meta/n_users"])
        assert z["user_table"].shape[0] == -(-(n_users + 1) // 2) * 2
    port = RecommendationService(serving, device="cpu").load()
    ref = JaxService(serving, backend="device").load()
    users = [int(u) for u in tiny_bundle["meta/user_raw_ids"][:6]]
    for a, b in zip(port.recommend_batch(users, k=10), ref.recommend_batch(users, k=10)):
        assert [r["item_id"] for r in a["recommendations"]] == \
            [r["item_id"] for r in b["recommendations"]]
        np.testing.assert_allclose([r["score"] for r in a["recommendations"]],
                                   [r["score"] for r in b["recommendations"]],
                                   rtol=1e-5, atol=1e-5)


def test_only_rank_0_holds_the_whole_tables(world, tiny_bundle):
    """``Trainer.train``'s periodic evaluation and bundle take the tables
    from ``_host_whole``: rank 0 gets each table whole, as host arrays;
    every other rank gets None and so never holds a whole table; no rank
    all-gathers over ``model``. The checkpoints stream the tables and
    their slots instead, so no optimizer slot is ever gathered whole."""
    def pad(n):  # the OOV row, then up to a multiple of the 2 model ranks
        return -(-(n + 1) // 2) * 2

    rows = {"user_table": pad(int(tiny_bundle["meta/n_users"])),
            "item_table": pad(int(tiny_bundle["meta/n_movies"]))}
    n_calls = None
    for r, (_, rec) in enumerate(world["steps"]):
        w = rec["train"]["whole_tables"]
        assert w["model_all_gathers"] == 0
        # every rank called it as often: once an evaluation
        n_calls = n_calls or len(w["host_whole"])
        assert len(w["host_whole"]) == n_calls > 0
        slots = set()
        for got in w["host_whole"]:
            if r:
                assert got is None
                continue
            for path, (kind, shape) in got.items():
                assert kind == "ndarray" and shape == [rows[path.split("/")[-1]], 16], path
                slots.add(path.split("/")[0])
        if r == 0:
            assert slots == {"towers"}
    for run in ("train_a2a", "train_a2a_sparse"):
        ckpts = os.listdir(os.path.join(world["steps"][0][1]["train"][run]["dir"], "checkpoints"))
        assert "best" in ckpts and len(ckpts) > 1


def test_rows_training_matches_replicated(world, one_card_run):
    """The rows run's per-epoch losses within 1e-3 of the one-card
    replicated run's (the same global batches)
    (``test_trainer.py::test_sharded_embedding_training_matches_replicated``)."""
    got = _epochs(world["steps"][0][1]["train"]["train_a2a"]["dir"])
    want = _epochs(one_card_run)
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want] == [0, 1]
    for g, w in zip(got, want):
        for k in ("train_loss", "val_loss", "val_rating_mse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=k)
        assert g["train_lookup_overflow"] == 0.0


def test_a2a_overflow_warns_operator(world):
    """Capacity factor 0.02 on the bundle's skewed ids: the epoch's
    overflow is above 0 and the warning names ``lookup_capacity_factor``
    (``test_a2a_overflow_warns_operator``)."""
    rec = world["steps"][0][1]["train"]["train_overflow"]
    msgs = [m for m in rec["warnings"] if "overflow" in m]
    assert msgs and "lookup_capacity_factor" in msgs[0]
    assert _epochs(rec["dir"])[0]["train_lookup_overflow"] > 0


def test_resume_on_the_rows_mesh_matches_the_uninterrupted_run(world):
    """One epoch, then ``resume`` to two on the 2 x 2 mesh: every rank keeps
    its rows of the restored whole tables, the replicas' checksum (shards
    skipped) is logged, and the resumed epoch equals the uninterrupted
    run's within 1e-4."""
    train = world["steps"][0][1]["train"]
    resumed = _epochs(train["train_resume_2"]["dir"])
    full = _epochs(train["train_a2a"]["dir"])
    assert [e["epoch"] for e in resumed] == [1]
    assert np.isfinite(resumed[0]["replica_checksum"])
    for k in ("train_loss", "val_loss", "val_rating_mse"):
        np.testing.assert_allclose(resumed[0][k], full[1][k], rtol=0, atol=1e-4, err_msg=k)
    assert train["train_resume_2"]["final_step"] == train["train_a2a"]["final_step"]


# ---- the row-sharded checkpoint ------------------------------------------------

def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_streamed_checkpoint_equals_the_whole_gather_and_jax_reads_it(world):
    """The ``a2a`` case's state after one step on the 2 x 2 mesh, saved by
    the streaming writer, equals leaf for leaf the npz that the whole-table
    gather (``_host_whole``) wrote on rank 0, tables and adagrad slots
    whole and padded; the JAX package's npz restore reads it to the same
    leaves."""
    from recsys_tpu.train.checkpoint import CheckpointManager as JaxManager

    rec = world["steps"][0][1]["ckpt"]
    got = _npz(rec["path"])
    want = _npz(world["root"] / "steps" / "ckpt_whole.npz")
    assert sorted(got) == sorted(want)
    assert {"params/towers/user_table", "opt_state/accum/towers/item_table"} <= set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax_state = JaxManager(os.path.dirname(os.path.dirname(rec["path"])),
                           use_orbax=False).restore(rec["step"])
    for k, v in worker._flat(jax_state).items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)


def test_each_rank_restores_its_rows_reading_only_them(world):
    """Each of the 4 ranks restores the streamed checkpoint with its row
    ranges: its table and slot leaves equal ``shard_rows`` of the whole
    (rows ``[m V / 2, (m + 1) V / 2)`` for model index m), the other leaves
    equal the whole; and it reads no more of the file than its rows, the
    whole leaves and every header (the file less its arrays' bytes)."""
    recs = [rec for _, rec in world["steps"]]
    whole = _npz(recs[0]["ckpt"]["path"])
    size = os.path.getsize(recs[0]["ckpt"]["path"])
    headers = size - sum(v.nbytes for v in whole.values())
    for r, (arrays, rec) in enumerate(world["steps"]):
        m = rec["coords"]["2"][1]
        ranges = rec["ckpt"]["ranges"]
        assert sorted(ranges) == sorted(k for k in whole if k.endswith(("user_table",
                                                                         "item_table")))
        own = 0
        for k, v in whole.items():
            got = arrays[f"ckpt/restored/{k}"]
            if k in ranges:
                n = v.shape[0] // 2
                assert ranges[k] == [m * n, (m + 1) * n]
                v = v[m * n:(m + 1) * n]
            np.testing.assert_array_equal(got, v, err_msg=f"rank {r} {k}")
            own += v.nbytes
        assert own < sum(v.nbytes for v in whole.values())
        assert own <= rec["ckpt"]["bytes_read"] <= own + headers, r


def test_rank_0_streams_the_table_one_chunk_at_a_time(world):
    """A 2 MiB table row-sharded over 2 model ranks, saved in 64 KiB chunks:
    rank 0's Python allocations during the save peak under one round of
    chunks (n_model of them) and far under the table, while the whole
    gather of the same shards allocates the table; the streamed member
    loads whole with ``np.load``, equal to the table."""
    rec = world["steps"][0][1]["ckpt"]
    n_bytes = worker.CKPT_ROWS * worker.CKPT_DIM * 4
    assert rec["save_peak"] <= 2 * worker.CKPT_CHUNK_BYTES + (64 << 10) < n_bytes // 4
    assert rec["gather_peak"] >= n_bytes
    got = _npz(rec["big_path"])["params/towers/user_table"]
    np.testing.assert_array_equal(
        got, np.arange(n_bytes // 4, dtype=np.float32).reshape(worker.CKPT_ROWS, -1))


def test_row_restore_refuses_a_compressed_member_and_a_range_outside(tmp_path):
    """``restore(rows=...)`` reads rows in place only from a stored member
    and inside the table: a compressed npz or a range past its rows
    raises ``ValueError`` (the whole restore still reads either file)."""
    from recsys_tpu_torch.train.checkpoint import CheckpointManager

    table = np.arange(24, dtype=np.float32).reshape(6, 4)
    manager = CheckpointManager(str(tmp_path))
    for step, save in ((1, np.savez), (2, np.savez_compressed)):
        os.makedirs(tmp_path / f"ckpt_{step}")
        save(tmp_path / f"ckpt_{step}" / "state.npz", **{"params/towers/user_table": table})
    got = manager.restore(1, rows={"params/towers/user_table": (2, 5)})
    np.testing.assert_array_equal(got["params"]["towers"]["user_table"], table[2:5])
    with pytest.raises(ValueError, match="outside its 6 rows"):
        manager.restore(1, rows={"params/towers/user_table": (4, 7)})
    with pytest.raises(ValueError, match="is compressed"):
        manager.restore(2, rows={"params/towers/user_table": (0, 3)})
    np.testing.assert_array_equal(manager.restore(2)["params"]["towers"]["user_table"], table)


def test_dryrun_multichip(world):
    """``dryrun_multichip`` on the 4-rank world: a 2 x 2 mesh, row-sharded
    tables through the a2a lookup, one finite step."""
    for _, rec in world["steps"]:
        d = rec["dryrun"]
        assert (d["n_data"], d["n_model"]) == (2, 2)
        assert np.isfinite(d["loss"]) and d["lookup_overflow"] == 0.0


# ---- the train CLI ----------------------------------------------------------

def test_two_rank_cli_model_parallel_a2a_matches_replicated(world):
    """``main`` with ``--model_parallel 2 --embedding_sharding rows
    --lookup_strategy a2a`` on 2 ranks trains on the 1 x 2 mesh: each
    epoch's losses equal the 2-rank replicated CLI's within 1e-4, rank 0
    wrote the bundle (``test_multihost.py::test_two_process_model_parallel_a2a``)."""
    rows, rep = world["cli"] / "cli_rows", world["cli"] / "cli_replicated"
    got, want = _epochs(rows), _epochs(rep)
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want] == [0, 1]
    for g, w in zip(got, want):
        for k in ("train_loss", "train_retrieval_loss", "val_loss", "val_ctr_bce"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=k)
    assert (rows / "serving" / "index.npz").exists()
    cfg = json.loads((rows / "config.json").read_text())["mesh"]
    assert (cfg["model_axis"], cfg["embedding_sharding"], cfg["lookup_strategy"]) == \
        (2, "rows", "a2a")
