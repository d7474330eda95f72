"""The port's data-parallel training (``Trainer`` on a ``(data, 1)`` mesh,
the loss's global and per-replica negatives, the replica checks, the train
CLI in a process group) on gloo ranks, against the JAX package.

One module-scoped pair of worlds (``tests/torch_dp_train_worker.py``,
started by ``subprocess`` on ``FileStore``s, ``OMP_NUM_THREADS=1``, every
join bounded): 4 ranks at B_local = 16 train every step case from the
JAX-initialised params of ``tests/test_trainer_spmd.py``'s fixture
(63 users, 127 items, global B = 64, embedding 16, one cross layer, fp32,
class weights (1.25, 0.85)), and 2 ranks run the train CLI's ``main`` on
a synthesized bundle. The JAX side is its 8-device virtual CPU mesh (the
GSPMD step, replicated tables) or its composed reference where the
per-replica scope depends on the number of ranks. Tolerances are JAX's
own: params rtol 2e-4 / atol 2e-5 on every leaf after the case's steps,
losses rtol 1e-4; the one-step loss of global negatives and the
per-replica step rtol 1e-5 (params 1e-5 / 1e-6); the CLI's per-epoch
losses 1e-4.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys_tpu.config import EvalConfig as JaxEvalConfig
from recsys_tpu.config import ModelConfig as JaxModelConfig
from recsys_tpu.config import RecsysConfig as JaxRecsysConfig
from recsys_tpu.config import TrainConfig as JaxTrainConfig
from recsys_tpu.models.multitask import MultiTaskModel as JaxMultiTask
from recsys_tpu.parallel.mesh import make_mesh as jax_make_mesh
from recsys_tpu.parallel.sharding import shard_batch as jax_shard_batch
from recsys_tpu.train.trainer import Trainer as JaxTrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dp_train_worker as worker  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, CLI_WORLD = worker.WORLD, 2
N_USERS, N_ITEMS, B = worker.N_USERS, worker.N_ITEMS, worker.B
JOIN_TIMEOUT_S = 150
# port case -> the JAX GSPMD run it is held against (the same config, but
# flash: the XLA baseline, as test_spmd_step_flash_ce_global_negatives)
JAX_REFERENCE = {"global": "global", "global_noclip": "global_noclip", "flash": "global",
                 "negatives": "negatives", "cache_dense": "cache_dense",
                 "cache_sparse": "cache_sparse", "sparse_adagrad": "sparse_adagrad",
                 "sparse_noclip": "sparse_noclip", "sparse_adam": "sparse_adam"}


def _jax_cfg(model_over=None, train_over=None):
    return JaxRecsysConfig(model=JaxModelConfig(**{**worker.MODEL, **(model_over or {})}),
                           train=JaxTrainConfig(**{**worker.TRAIN, **(train_over or {})}),
                           eval=JaxEvalConfig(topk=(10,)))


def _batches(n_steps=3, seed=0):
    """``tests/test_trainer_spmd.py``'s batches."""
    rng = np.random.default_rng(seed)
    return [{"user_id": rng.integers(0, N_USERS, B).astype(np.int32),
             "movie_id": rng.integers(0, N_ITEMS, B).astype(np.int32),
             "rating": rng.uniform(1, 5, B).astype(np.float32),
             "y_implicit": (rng.random(B) > 0.4).astype(np.float32),
             "log_q": np.full(B, -np.log(N_ITEMS), np.float32)} for _ in range(n_steps)]


def _negs():
    rng = np.random.default_rng(5)
    return [rng.integers(0, N_ITEMS, (B, 4)).astype(np.int32) for _ in range(2)]


def _params0():
    return jax.device_get(JaxMultiTask.init(jax.random.PRNGKey(3), _jax_cfg().model,
                                            N_USERS, N_ITEMS))


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(world, args_of):
    return [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                           "torch_dp_train_worker.py"),
                              *map(str, args_of(r))],
                             cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _join(procs) -> None:
    """Wait for every rank; a rank that fails or outlasts JOIN_TIMEOUT_S
    fails the caller with every rank's output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0] * len(procs), \
        "\n".join(o[-3000:] for o in outs)


def _load(out, world):
    ranks = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(out / f"rank{r}.json") as f:
            ranks.append((arrays, json.load(f)))
    return ranks


@pytest.fixture(scope="module")
def world(tmp_path_factory, tiny_bundle):
    """Both worlds, run beside each other -> {"steps": [(arrays, records)]
    by rank, "cli": the CLI world's output dir, "bundle": its bundle}."""
    root = tmp_path_factory.mktemp("torch_dp_train")
    inputs = {f"params/{k}": v for k, v in worker._flat(_params0()).items()}
    for i, b in enumerate(_batches()):
        inputs.update({f"b{i}/{k}": v for k, v in b.items()})
    for i, n in enumerate(_negs()):
        inputs[f"neg{i}"] = n
    np.savez(root / "inputs.npz", **inputs)
    np.savez(root / "bundle.npz", **tiny_bundle)
    steps_out, cli_out = root / "steps", root / "cli"
    steps_out.mkdir()
    cli_out.mkdir()
    procs = _start(WORLD, lambda r: (r, WORLD, root / "store", root / "inputs.npz", steps_out,
                                     "steps"))
    procs += _start(CLI_WORLD, lambda r: (r, CLI_WORLD, root / "cli_store",
                                          root / "bundle.npz", cli_out, "cli"))
    _join(procs)
    return {"steps": _load(steps_out, WORLD), "cli": cli_out, "bundle": root / "bundle.npz",
            "cli_ranks": _load(cli_out, CLI_WORLD), "root": root}


@pytest.fixture(scope="module")
def jax_run(world):
    """-> ``run(name)``: (params, per-step losses, cache or None) of the JAX
    GSPMD step on 8 devices (replicated tables) for case ``name``'s config,
    each config run once."""
    runs = {}

    def run(name):
        if name not in runs:
            runs[name] = _jax_steps(name, world["root"])
        return runs[name]

    return run


def _jax_steps(name, out_dir):
    """-> (params, per-step losses, cache or None) of the JAX GSPMD step."""
    model_over, train_over, n_steps, negs = worker.CASES[name]
    ctx = jax_make_mesh(model_parallel=1)
    assert ctx.n_data == 8
    trainer = JaxTrainer(_jax_cfg(model_over, train_over),
                         output_dir=str(out_dir / f"jax_{name}"), mesh_ctx=ctx)
    state = trainer.init_state(N_USERS, N_ITEMS, seed=3)
    trainer._state_for_shape = state
    batches = _batches()[:n_steps]
    if negs:
        batches = [{**b, "neg_ids": n} for b, n in zip(batches, _negs())]
    step = trainer.make_train_step(class_weights=worker.CLASS_WEIGHTS,
                                   example_batch=batches[0], use_explicit_negs=negs)
    losses = []
    for b in batches:
        state, metrics = step(state, jax_shard_batch(ctx, b))
        losses.append(float(metrics["loss"]))
    cache = None if state.extras is None else jax.device_get(state.extras)
    return jax.device_get(state.params), losses, cache


def _tree_close(arrays, prefix, want, rtol=2e-4, atol=2e-5):
    flat = worker._flat(want)
    assert sorted(k for k in arrays if k.startswith(prefix)) == sorted(prefix + k for k in flat)
    for k, v in flat.items():
        np.testing.assert_allclose(arrays[prefix + k], np.asarray(v), rtol=rtol, atol=atol,
                                   err_msg=f"leaf {k} diverged")


def _replicated(ranks, prefix):
    """Every rank's leaves under ``prefix`` are rank 0's, bit for bit."""
    a0 = ranks[0][0]
    for arrays, _ in ranks[1:]:
        for k in a0:
            if k.startswith(prefix):
                np.testing.assert_array_equal(arrays[k], a0[k], err_msg=k)


# ---- the step against the JAX package ------------------------------------

def test_global_negatives_loss_matches_one_device_on_the_whole_batch(world):
    """The mesh step's loss (each rank's slice, candidates gathered) equals
    JAX ``MultiTaskModel.loss`` of one device on the whole batch
    (``test_global_negatives_match_single_device_concat``)."""
    cfg = _jax_cfg()
    want, _ = JaxMultiTask.loss(_params0(), cfg.model,
                                {k: jnp.asarray(v) for k, v in _batches()[0].items()},
                                train=True, class_weights=worker.CLASS_WEIGHTS)
    for _, rec in world["steps"]:
        np.testing.assert_allclose(rec["global"]["losses"][0], float(want), rtol=1e-5)


@pytest.mark.parametrize("case", sorted(JAX_REFERENCE))
def test_steps_match_the_jax_gspmd_step(world, jax_run, case):
    """The case's steps on 4 ranks against the JAX GSPMD step on 8 devices
    (the global batch's loss, replicated tables): every leaf after the
    last step, every step's loss, the CBNS FIFO where there is one; the
    ranks' params are bitwise equal; the sparse cases took the sparse step."""
    params, losses, cache = jax_run(JAX_REFERENCE[case])
    ranks = world["steps"]
    _replicated(ranks, f"{case}/")
    arrays, rec = ranks[0]
    _tree_close(arrays, f"{case}/params/", params)
    np.testing.assert_allclose(rec[case]["losses"], losses, rtol=1e-4)
    if cache is not None:
        _tree_close(arrays, f"{case}/cache/", cache)
        assert (arrays[f"{case}/cache/ids"][-3 * B:] >= 0).all()  # filled: 3 batches
    sparse = worker.CASES[case][1].get("sparse_table_updates", False)
    assert rec[case]["step_counts"]["sparse" if sparse else "dense"] == worker.CASES[case][2]


def test_per_replica_negatives_match_the_composed_reference(world):
    """``global_negatives=False`` on 4 ranks: the retrieval softmax of each
    rank's [16, 16] block, the MSE and BCE of the global batch. One step
    equals JAX's composed reference at n = 4
    (``test_per_replica_negatives_semantics``: the full-batch loss with its
    retrieval term replaced by the mean of the 4 local-block terms, one
    optimizer step), and differs from the global-negatives loss."""
    from recsys_tpu.train.optimizer import make_optimizer

    cfg = _jax_cfg(train_over={"global_negatives": False})
    params0 = _params0()
    full = {k: jnp.asarray(v) for k, v in _batches()[0].items()}
    b_local = B // WORLD

    def composed(params):
        l_full, m_full = JaxMultiTask.loss(params, cfg.model, full, train=True,
                                           class_weights=worker.CLASS_WEIGHTS)
        retr_local = 0.0
        for s in range(WORLD):
            local = {k: v[s * b_local:(s + 1) * b_local] for k, v in full.items()}
            _, m_s = JaxMultiTask.loss(params, cfg.model, local, train=True,
                                       class_weights=worker.CLASS_WEIGHTS)
            retr_local = retr_local + m_s["retrieval_loss"] / WORLD
        return l_full + cfg.model.retrieval_weight * (retr_local - m_full["retrieval_loss"])

    loss, grads = jax.jit(jax.value_and_grad(composed))(params0)
    opt = make_optimizer(cfg.train)
    want, _ = opt.update(grads, opt.init(params0), params0, jnp.zeros((), jnp.int32))
    ranks = world["steps"]
    _replicated(ranks, "per_replica/")
    for arrays, rec in ranks:
        got = rec["per_replica"]["losses"][0]
        np.testing.assert_allclose(got, float(loss), rtol=1e-5)
        assert abs(got - rec["global"]["losses"][0]) > 1e-3
        _tree_close(arrays, "per_replica/params/", jax.device_get(want), rtol=1e-5, atol=1e-6)


def test_cache_refusals_match_jax(world):
    """The cache under per-replica negatives on several ranks, and a cache
    that is not a multiple of the global batch, are refused with JAX's
    messages (``test_cache_rejects_per_replica_scope_and_batch_multiple``)."""
    want = {}
    for label, over in (("per_replica", {"negative_cache": 2 * B, "global_negatives": False}),
                        ("not_multiple", {"negative_cache": 100})):
        tr = JaxTrainer(_jax_cfg(train_over=over), output_dir=str(world["root"] / "jax_err"),
                        mesh_ctx=jax_make_mesh(model_parallel=1))
        tr._state_for_shape = tr.init_state(N_USERS, N_ITEMS, seed=0)
        with pytest.raises(ValueError) as e:
            tr.make_train_step(class_weights=(1.0, 1.0), example_batch=_batches(1)[0],
                               use_explicit_negs=False)
        want[label] = str(e.value)
    assert "per-replica" in want["per_replica"] and "multiple" in want["not_multiple"]
    for _, rec in world["steps"]:
        assert rec["cache_errors"] == want


# ---- replication, dropout and the collectives --------------------------------

def test_dropout_masks_differ_per_rank_and_params_stay_replicated(world):
    """Dropout 0.3: each rank draws its own stream (data index 0 the
    one-card stream); after 2 steps (profiled: each holds two
    ``train.exchange`` spans) ``assert_replicated`` passes on every rank,
    and one ulp on one element of rank 1 makes it raise on every rank."""
    ranks = world["steps"]
    draws = [a["dropout_draw"] for a, _ in ranks]
    np.testing.assert_array_equal(draws[0], ranks[0][0]["dropout_draw_one_card"])
    for i in range(WORLD):
        for j in range(i + 1, WORLD):
            assert not np.array_equal(draws[i], draws[j])
    sums = {rec["dropout_checksum"] for _, rec in ranks}
    assert len(sums) == 1 and np.isfinite(sums.pop())
    assert [rec["exchange_spans"] for _, rec in ranks] == [4] * WORLD
    for _, rec in ranks:
        assert rec["nudged"] is not None and "replica desync detected" in rec["nudged"]
        assert "bit checksums" in rec["nudged"]


def test_all_gather_rows_and_the_flat_allreduce(world):
    """``all_gather_rows``: every rank's rows in rank order; its backward
    gives each rank the SUM over ranks of the cotangent of its own rows.
    ``allreduce_mean_flat``: the mean of each tensor, inputs left as they
    were. Closed forms, exact."""
    base = np.arange(3 * WORLD * 2, dtype=np.float32).reshape(3 * WORLD, 2)
    x = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r for r in range(WORLD)]
    for r, (arrays, _) in enumerate(world["steps"]):
        np.testing.assert_array_equal(arrays["gather_fwd"], np.concatenate(x))
        want = base[3 * r:3 * (r + 1)] * sum(s + 1 for s in range(WORLD))
        np.testing.assert_array_equal(arrays["gather_bwd"], want)
        np.testing.assert_array_equal(arrays["flat_a"], np.full((2, 3), (WORLD + 1) / 2))
        np.testing.assert_array_equal(arrays["flat_b"],
                                      np.arange(4, dtype=np.float32) * (WORLD + 1) / 2)
        np.testing.assert_array_equal(arrays["flat_input_a"], np.full((2, 3), r + 1.0))


# ---- the train CLI in a process group ----------------------------------------

def _epochs(run_dir):
    with open(os.path.join(run_dir, "detailed_metrics.json")) as f:
        return json.load(f)["epochs"]


@pytest.fixture(scope="module")
def one_rank_run(world, tmp_path_factory):
    """The same CLI argv on one rank without a launcher (the control)."""
    from recsys_tpu_torch.train import __main__ as cli

    out = tmp_path_factory.mktemp("torch_dp_one_rank") / "run"
    cli.main(["--data", str(world["bundle"]), "--output_dir", str(out), "--epochs", "2"]
             + worker.CLI_ARGV)
    return out


def test_two_rank_cli_matches_one_rank(world, one_rank_run):
    """``main`` on 2 ranks of a group trains data-parallel: each epoch's
    train and val losses equal the one-rank run's within 1e-4
    (``test_multihost.py::test_two_process_training_end_to_end``)."""
    got, want = _epochs(world["cli"] / "cli_full_r0"), _epochs(one_rank_run)
    assert [e["epoch"] for e in got] == [e["epoch"] for e in want] == [0, 1]
    for g, w in zip(got, want):
        for k in ("train_loss", "train_retrieval_loss", "val_loss", "val_ctr_bce"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=k)


def test_cli_rank_zero_alone_writes_and_the_bundle_serves(world):
    """Rank 0 writes ``metrics.json``, ``detailed_metrics.json``,
    ``checkpoints/`` and ``serving/``; rank 1 writes nothing; the bundle
    serves; ``main`` leaves the group its caller started."""
    from recsys_tpu_torch.serve.service import RecommendationService

    r0, r1 = world["cli"] / "cli_full_r0", world["cli"] / "cli_full_r1"
    for f in ("metrics.json", "detailed_metrics.json", "training_log.csv",
              "serving/index.npz", "serving/model.npz"):
        assert (r0 / f).exists(), f
    assert any((r0 / "checkpoints").iterdir())
    assert not r1.exists()
    metrics = json.loads((r0 / "metrics.json").read_text())
    assert metrics["epochs_run"] == 2 and np.isfinite(metrics["recall@10"])
    svc = RecommendationService(str(r0 / "serving"), device="cpu").load()
    uid = int(json.loads((r0 / "serving" / "vocabs.json").read_text())["users"][0])
    assert len(svc.recommend(uid, 5)) == 5
    for _, rec in world["cli_ranks"]:
        assert rec["dist_still_up"] is True


def test_cli_resume_on_two_ranks_matches_the_uninterrupted_run(world):
    """One epoch on 2 ranks, then ``--resume`` to 2 with
    ``replication_check_every_epochs=1``: every rank restores the same
    checkpoint, the replicas' checksum is logged, and the resumed epoch
    equals the uninterrupted 2-rank run's within 1e-4
    (``test_multihost.py::test_two_process_checkpoint_resume``)."""
    resumed = _epochs(world["cli"] / "cli_resume")
    full = _epochs(world["cli"] / "cli_full_r0")
    assert [e["epoch"] for e in resumed] == [1]
    assert np.isfinite(resumed[0]["replica_checksum"])
    for k in ("train_loss", "val_loss", "val_rating_mse"):
        np.testing.assert_allclose(resumed[0][k], full[1][k], rtol=0, atol=1e-4, err_msg=k)
