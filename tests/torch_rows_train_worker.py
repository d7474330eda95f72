"""One gloo rank of the port's row-sharded training tests
(``test_torch_rows_train.py``).

Two worlds of these run beside each other. In mode ``steps`` the test
starts ``WORLD`` ranks, each with its rank, a ``FileStore`` path, the
inputs (an npz: the JAX-initialised params under ``params/`` and, padded
for 62 users on 4 model ranks, under ``params_pad/``; three global batches
under ``b<i>/``, padded-case batches under ``p<i>/``, a skewed batch under
``skew/``, explicit negatives under ``neg<i>``; the training bundle under
``bundle/``) and an output directory. Every rank joins the group, makes
the 2 x 2 and 1 x 4 meshes, trains every case of ``CASES`` from the same
params on its ``data`` slice of each global batch (each case is a
collective: the same order on every rank), then the ``Trainer.train``
runs of ``TRAIN_RUNS`` on the 2 x 2 mesh and ``dryrun_multichip``. In mode
``cli`` two ranks run the train CLI's ``main`` on the bundle, row-sharded
(``--model_parallel 2 --embedding_sharding rows --lookup_strategy a2a``)
and replicated. Each rank writes ``<out>/rank<r>.npz`` (arrays) and
``<out>/rank<r>.json`` (the rest).

Usage:
  python tests/torch_rows_train_worker.py <rank> <world> <store> <inputs> <out> steps|cli
"""

import json
import logging
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLD = 4
N_USERS, N_ITEMS = 63, 127
PAD_USERS = 62  # rows(62) = 63 pads to 64 on 4 model ranks
B = 64
CLASS_WEIGHTS = (1.25, 0.85)
MODEL = dict(embedding_dim=16, cross_layers=1, dropout_rate=0.0, mixed_precision=False)
# name -> (model_parallel, lookup_strategy, model overrides, train overrides,
#          steps, explicit negatives, params prefix, batch prefix)
CASES = {
    "xla": (2, "xla", {}, {}, 3, False, "params", "b"),
    "psum": (2, "psum", {}, {}, 3, False, "params", "b"),
    "a2a": (2, "a2a", {}, {}, 3, False, "params", "b"),
    "a2a_m4": (4, "a2a", {}, {}, 3, False, "params", "b"),
    "psum_noclip": (2, "psum", {}, {"clipnorm": 0.0}, 3, False, "params", "b"),
    "a2a_noclip": (2, "a2a", {}, {"clipnorm": 0.0}, 3, False, "params", "b"),
    "a2a_m4_noclip": (4, "a2a", {}, {"clipnorm": 0.0}, 3, False, "params", "b"),
    "negatives": (2, "a2a", {}, {}, 2, True, "params", "b"),
    "flash": (2, "a2a", {"use_flash_ce": True}, {}, 3, False, "params", "b"),
    "sparse_psum": (2, "psum", {}, {"sparse_table_updates": True}, 3, False, "params", "b"),
    "sparse_a2a": (2, "a2a", {}, {"sparse_table_updates": True}, 3, False, "params", "b"),
    "sparse_psum_noclip": (2, "psum", {}, {"sparse_table_updates": True, "clipnorm": 0.0},
                           3, False, "params", "b"),
    "sparse_a2a_noclip": (2, "a2a", {}, {"sparse_table_updates": True, "clipnorm": 0.0},
                          3, False, "params", "b"),
    "per_replica_sparse": (2, "a2a", {}, {"sparse_table_updates": True,
                                          "global_negatives": False}, 3, False, "params", "b"),
    "per_replica_dense": (2, "a2a", {}, {"global_negatives": False}, 3, False, "params", "b"),
    "sparse_lazy_adam": (2, "a2a", {}, {"sparse_table_updates": True, "optimizer": "adam",
                                        "learning_rate": 0.01}, 3, False, "params", "b"),
    "cache_dense": (2, "a2a", {}, {"negative_cache": 2 * B}, 3, False, "params", "b"),
    "cache_sparse": (2, "a2a", {}, {"negative_cache": 2 * B, "sparse_table_updates": True},
                     3, False, "params", "b"),
    "padded": (4, "a2a", {}, {}, 3, False, "params_pad", "p"),
    "skew": (4, "a2a", {}, {}, 1, False, "params", "skew"),
    # every id on shard 0 (no overflow at factor 4): the other shards own
    # none of the sparse step's rows
    "sparse_skew": (4, "a2a", {}, {"sparse_table_updates": True, "optimizer": "adam",
                                   "learning_rate": 0.01}, 1, False, "params", "skew"),
}
CAPACITY_FACTOR = {"skew": 1.0, "sparse_skew": 4.0}
# Trainer.train on the 2 x 2 mesh, a2a: name -> (train overrides, capacity factor)
TRAIN_BATCH = 128
TRAIN = dict(batch_size=TRAIN_BATCH, epochs=2, learning_rate=5e-3, early_stop_patience=5)
TRAIN_RUNS = {
    "train_a2a": ({}, 2.0),
    "train_a2a_sparse": ({"sparse_table_updates": True, "eval_every_epochs": 1}, 2.0),
    "train_overflow": ({"epochs": 1}, 0.02),
    "train_resume_1": ({"epochs": 1}, 2.0),
    "train_resume_2": ({"resume": True, "replication_check_every_epochs": 1}, 2.0),
}
# the train CLI's runs: 2 epochs streamed at B = 128, dropout 0
CLI_ARGV = ["--embedding_dim", "16", "--batch_size", "128", "--device", "cpu",
            "--set", "model.dropout_rate=0.0", "--set", "train.device_resident_data=false",
            "--set", "train.early_stop_patience=5", "--epochs", "2"]
CLI_ROWS = ["--model_parallel", "2", "--embedding_sharding", "rows", "--lookup_strategy", "a2a"]


def configs(model_parallel, strategy, model_over, train_over, capacity=2.0, train=None):
    from recsys_tpu_torch.config import (EvalConfig, MeshConfig, ModelConfig, RecsysConfig,
                                         TrainConfig)

    return RecsysConfig(model=ModelConfig(**{**MODEL, **model_over}),
                        train=TrainConfig(**{**(train or dict(batch_size=B, epochs=1)),
                                             **train_over}),
                        mesh=MeshConfig(model_axis=model_parallel, embedding_sharding="rows",
                                        lookup_strategy=strategy,
                                        lookup_capacity_factor=capacity),
                        eval=EvalConfig(topk=(10,)))


def _unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def _whole(ctx, params):
    """The whole params as numpy on every rank: the table shards
    all-gathered over ``model`` (the test's own gather, so that every
    rank's result can be compared; the trainer gathers onto rank 0's host
    only)."""
    from recsys_tpu_torch.parallel.collectives import gather_rows
    from recsys_tpu_torch.train.checkpoint import ROW_SHARDED_KEYS, params_to_numpy

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return gather_rows(ctx, node.detach(), ctx.model_axis) if key in ROW_SHARDED_KEYS \
            else node

    return params_to_numpy(walk(params))


def run_steps(meshes, inputs, name, out_dir):
    """-> (whole params numpy tree, per-step losses and overflows, the
    cache or None, step counts, this rank's shard shapes) of case ``name``."""
    import torch

    from recsys_tpu_torch.parallel.sharding import local_slice
    from recsys_tpu_torch.train.checkpoint import params_from_numpy
    from recsys_tpu_torch.train.trainer import Trainer

    mp, strategy, model_over, train_over, n_steps, negs, pkey, bkey = CASES[name]
    ctx = meshes[mp]
    cfg = configs(mp, strategy, model_over, train_over, CAPACITY_FACTOR.get(name, 2.0))
    tr = Trainer(cfg, os.path.join(out_dir, name), device="cpu", mesh_ctx=ctx)
    state = tr.state_from_params(params_from_numpy(_unflatten(inputs, f"{pkey}/"), "cpu"), 3)
    shapes = {k: list(state.params["towers"][k].shape) for k in ("user_table", "item_table")}
    step = tr.make_train_step(CLASS_WEIGHTS, use_explicit_negs=negs)
    losses, overflow = [], []
    for i in range(n_steps):
        batch = _unflatten(inputs, f"{bkey}/" if bkey == "skew" else f"{bkey}{i}/")
        if negs:
            batch["neg_ids"] = inputs[f"neg{i}"]
        local = {k: torch.from_numpy(v) for k, v in local_slice(ctx, batch).items()}
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
        overflow.append(float(metrics.get("lookup_overflow", float("nan"))))
    cache = None if state.extras is None else {k: v.numpy() for k, v in state.extras.items()}
    whole = _whole(ctx, state.params)
    return whole, {"losses": losses, "overflow": overflow, "step_counts": tr.step_counts,
                   "shard_shapes": shapes}, cache


def run_train(ctx, bundle, out_dir):
    """The ``TRAIN_RUNS`` through ``Trainer.train`` on ``ctx`` -> records,
    with ``whole_tables``: what each ``Trainer._host_whole`` call gave this
    rank (each sharded leaf's type and shape, or None) and the all-gathers
    over ``model`` that the runs made."""
    import torch.distributed as dist

    from recsys_tpu_torch.train.checkpoint import ROW_SHARDED_KEYS
    from recsys_tpu_torch.train.trainer import Trainer

    records = {}
    warnings = []
    whole = {"host_whole": [], "model_all_gathers": 0}
    host_whole, all_gather = Trainer._host_whole, dist.all_gather
    model_group = ctx.group(ctx.model_axis)

    def sharded_leaves(tree, path=""):
        if not isinstance(tree, dict):
            return {}
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(sharded_leaves(v, f"{path}{k}/"))
            elif k in ROW_SHARDED_KEYS:
                out[path + k] = [type(v).__name__, list(v.shape)]
        return out

    def watched_host_whole(self, tree):
        got = host_whole(self, tree)
        whole["host_whole"].append(None if got is None else sharded_leaves(got))
        return got

    def watched_all_gather(tensors, tensor, group=None, **kw):
        whole["model_all_gathers"] += group is model_group
        return all_gather(tensors, tensor, group=group, **kw)

    Trainer._host_whole, dist.all_gather = watched_host_whole, watched_all_gather

    class Catch(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    logger = logging.getLogger("recsys_tpu_torch.train.trainer")
    handler = Catch()
    logger.addHandler(handler)
    try:
        for name, (train_over, capacity) in TRAIN_RUNS.items():
            run = os.path.join(out_dir, "train_resume" if name.startswith("train_resume")
                               else name)
            cfg = configs(2, "a2a", {}, train_over, capacity, train=TRAIN)
            del warnings[:]
            tr = Trainer(cfg, run, device="cpu", mesh_ctx=ctx)
            report = tr.train(bundle)
            records[name] = {"report": report, "warnings": list(warnings),
                             "step_counts": tr.step_counts, "dir": run,
                             "final_step": tr.final_state.step}
    finally:
        logger.removeHandler(handler)
        Trainer._host_whole, dist.all_gather = host_whole, all_gather
    records["whole_tables"] = whole
    return records


def run_cases(inputs, out_dir):
    import torch.distributed as dist

    from recsys_tpu_torch.parallel.mesh import make_mesh
    from recsys_tpu_torch.train.dryrun import dryrun_multichip
    from recsys_tpu_torch.train.trainer import Trainer

    meshes = {mp: make_mesh(model_parallel=mp, device="cpu") for mp in (2, 4)}
    arrays, records = {}, {"coords": {mp: list(c.coordinates) for mp, c in meshes.items()},
                           "rank": dist.get_rank()}
    for name in CASES:
        params, rec, cache = run_steps(meshes, inputs, name, out_dir)
        arrays.update(_flat(params, f"{name}/params/"))
        if cache is not None:
            arrays.update(_flat(cache, f"{name}/cache/"))
        records[name] = rec
    # the padded tables that init_state draws for 62 users on 4 model ranks
    tr = Trainer(configs(4, "a2a", {}, {}), os.path.join(out_dir, "init_pad"), device="cpu",
                 mesh_ctx=meshes[4])
    state = tr.init_state(PAD_USERS, N_ITEMS, seed=0)
    records["init_pad_shapes"] = {
        "/".join(k.split("/")): list(v.shape)
        for k, v in _flat(_whole(meshes[4], state.params)).items()}
    bundle = {k[len("bundle/"):]: v for k, v in inputs.items() if k.startswith("bundle/")}
    records["train"] = run_train(meshes[2], bundle, out_dir)
    records["dryrun"] = dryrun_multichip("cpu")
    return arrays, records


def run_cli(bundle_path, out_dir):
    """The train CLI's ``main`` on this rank's group: row-sharded on the
    1 x 2 mesh, then replicated on 2 x 1 (a directory each)."""
    from recsys_tpu_torch.train import __main__ as cli

    argv = ["--data", bundle_path] + CLI_ARGV
    cli.main(argv + CLI_ROWS + ["--output_dir", os.path.join(out_dir, "cli_rows")])
    cli.main(argv + ["--output_dir", os.path.join(out_dir, "cli_replicated")])
    return {}, {}


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs_path, out, mode = sys.argv[3:7]
    import numpy as np
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        if mode == "cli":
            arrays, records = run_cli(inputs_path, out)
        else:
            with np.load(inputs_path) as z:
                inputs = {k: z[k] for k in z.files}
            arrays, records = run_cases(inputs, out)
        dist.barrier()
    finally:
        from recsys_tpu_torch.parallel.mesh import shutdown

        shutdown()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(records, f, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
