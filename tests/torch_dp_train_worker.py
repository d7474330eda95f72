"""One gloo rank of the port's data-parallel training tests
(``test_torch_dp_train.py``).

Two worlds of these run beside each other. In mode ``steps`` the test
starts ``WORLD`` ranks, each with its rank, a ``FileStore`` path, the
inputs (an npz of the JAX-initialised params under ``params/``, three
global batches under ``b<i>/`` and explicit negatives under ``neg<i>``)
and an output directory; every rank joins the group, makes the
``(data, 1)`` mesh, trains every case of ``CASES`` from the same params on
its slice of each global batch (each case is a collective: the same order
on every rank) and runs the checks of the mesh's tools. In mode ``cli``
two ranks, given a preprocessed bundle in place of the inputs, run the
train CLI's ``main`` three times on it after joining their group (two
epochs; one epoch; ``--resume`` to two). Each rank writes
``<out>/rank<r>.npz`` (arrays) and ``<out>/rank<r>.json`` (the rest).

Usage:
  python tests/torch_dp_train_worker.py <rank> <world> <store> <inputs> <out> steps|cli
"""

import json
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLD = 4
N_USERS, N_ITEMS = 63, 127
B = 64  # the global batch: 16 rows a rank
CLASS_WEIGHTS = (1.25, 0.85)
MODEL = dict(embedding_dim=16, cross_layers=1, dropout_rate=0.0, mixed_precision=False)
TRAIN = dict(batch_size=B, epochs=1)
# name -> (model overrides, train overrides, steps, explicit negatives)
CASES = {
    "global": ({}, {}, 3, False),
    "global_noclip": ({}, {"clipnorm": 0.0}, 3, False),
    "flash": ({"use_flash_ce": True}, {}, 3, False),
    "per_replica": ({}, {"global_negatives": False}, 1, False),
    "negatives": ({}, {}, 2, True),
    "cache_dense": ({}, {"negative_cache": 2 * B}, 3, False),
    "cache_sparse": ({}, {"negative_cache": 2 * B, "sparse_table_updates": True}, 3, False),
    "sparse_adagrad": ({}, {"sparse_table_updates": True}, 3, False),
    "sparse_noclip": ({}, {"sparse_table_updates": True, "clipnorm": 0.0}, 3, False),
    "sparse_adam": ({}, {"sparse_table_updates": True, "optimizer": "adam"}, 3, False),
}
# the train CLI's runs: 2 epochs streamed at B = 128, dropout 0
CLI_ARGV = ["--embedding_dim", "16", "--batch_size", "128", "--device", "cpu",
            "--set", "model.dropout_rate=0.0", "--set", "train.device_resident_data=false",
            "--set", "train.early_stop_patience=5"]


def configs(model_over, train_over):
    from recsys_tpu_torch.config import EvalConfig, ModelConfig, RecsysConfig, TrainConfig

    return RecsysConfig(model=ModelConfig(**{**MODEL, **model_over}),
                        train=TrainConfig(**{**TRAIN, **train_over}),
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


def run_steps(ctx, inputs, name, out_dir):
    """-> (params numpy tree, per-step losses, the cache or None) of case
    ``name`` after its steps."""
    import torch

    from recsys_tpu_torch.parallel.sharding import local_slice
    from recsys_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy
    from recsys_tpu_torch.train.trainer import Trainer

    model_over, train_over, n_steps, negs = CASES[name]
    tr = Trainer(configs(model_over, train_over), os.path.join(out_dir, name), device="cpu",
                 mesh_ctx=ctx)
    state = tr.state_from_params(params_from_numpy(_unflatten(inputs, "params/"), "cpu"), 3)
    step = tr.make_train_step(CLASS_WEIGHTS, use_explicit_negs=negs)
    losses = []
    for i in range(n_steps):
        batch = _unflatten(inputs, f"b{i}/")
        if negs:
            batch["neg_ids"] = inputs[f"neg{i}"]
        local = {k: torch.from_numpy(v) for k, v in local_slice(ctx, batch).items()}
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
    cache = None if state.extras is None else {k: v.numpy() for k, v in state.extras.items()}
    return params_to_numpy(state.params), losses, cache, tr.step_counts


def run_cases(ctx, inputs, out_dir):
    import torch
    import torch.distributed as dist

    from recsys_tpu_torch.parallel import collectives as coll
    from recsys_tpu_torch.parallel.sharding import local_slice
    from recsys_tpu_torch.train.checkpoint import params_from_numpy
    from recsys_tpu_torch.train.trainer import Trainer
    from recsys_tpu_torch.utils.debug import assert_replicated

    arrays, records = {}, {}
    rank = dist.get_rank()
    for name in CASES:
        params, losses, cache, counts = run_steps(ctx, inputs, name, out_dir)
        arrays.update(_flat(params, f"{name}/params/"))
        if cache is not None:
            arrays.update(_flat(cache, f"{name}/cache/"))
        records[name] = {"losses": losses, "step_counts": counts}

    # ---- the cache's refusals
    errors = {}
    for label, over in (("per_replica", {"negative_cache": 2 * B, "global_negatives": False}),
                        ("not_multiple", {"negative_cache": 100})):
        tr = Trainer(configs({}, over), os.path.join(out_dir, "err"), device="cpu",
                     mesh_ctx=ctx)
        try:
            tr.make_train_step(CLASS_WEIGHTS)
            errors[label] = None
        except ValueError as e:
            errors[label] = str(e)
    records["cache_errors"] = errors

    # ---- dropout: independent masks per rank, params still bitwise replicated
    tr = Trainer(configs({"dropout_rate": 0.3}, {}), os.path.join(out_dir, "dropout"),
                 device="cpu", mesh_ctx=ctx)
    state = tr.state_from_params(params_from_numpy(_unflatten(inputs, "params/"), "cpu"), 3)
    arrays["dropout_draw"] = torch.rand(8, generator=tr._generator(state)).numpy()
    # the one-card trainer's stream of this step (its _generator's seed)
    one_card = torch.Generator().manual_seed(state.rng * 1_000_003 + state.step)
    arrays["dropout_draw_one_card"] = torch.rand(8, generator=one_card).numpy()
    step = tr.make_train_step(CLASS_WEIGHTS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(2):
            local = {k: torch.from_numpy(v) for k, v in
                     local_slice(ctx, _unflatten(inputs, f"b{i}/")).items()}
            state, _ = step(state, local)
    # the steps' collectives under their span: the gradients' all-reduce
    # and the metrics' mean, each step
    records["exchange_spans"] = sum(e.name == "train.exchange" for e in prof.events())
    records["dropout_checksum"] = float(assert_replicated(state.params, ctx)[0])
    if rank == 1:  # one ulp on one element of one rank
        with torch.no_grad():
            flat = state.params["rating_head"]["w"].view(-1)
            flat[0] = torch.nextafter(flat[0], torch.tensor(float("inf")))
    try:
        assert_replicated(state.params, ctx)
        records["nudged"] = None
    except RuntimeError as e:
        records["nudged"] = str(e)

    # ---- the autograd gather and the flat all-reduce
    n, r = ctx.n_data, ctx.data_index
    x = (torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r).requires_grad_(True)
    y = coll.all_gather_rows(ctx, x)
    weights = torch.arange(3 * n * 2, dtype=torch.float32).reshape(3 * n, 2) * (r + 1)
    (grad,) = torch.autograd.grad(torch.sum(y * weights), x)
    arrays["gather_fwd"], arrays["gather_bwd"] = y.detach().numpy(), grad.numpy()
    ga = torch.full((2, 3), float(r + 1))
    gb = torch.arange(4, dtype=torch.float32) * (r + 1)
    mean_a, mean_b = coll.allreduce_mean_flat(ctx, [ga, gb])
    arrays["flat_a"], arrays["flat_b"] = mean_a.numpy(), mean_b.numpy()
    arrays["flat_input_a"] = ga.numpy()
    return arrays, records


def run_cli(bundle_path, out_dir):
    """The train CLI's ``main`` on this rank's group: 2 epochs (a directory
    a rank, so that what rank 1 writes is seen), then 1 epoch and
    ``--resume`` to 2 in one shared directory."""
    import torch.distributed as dist

    from recsys_tpu_torch.train import __main__ as cli

    rank = dist.get_rank()
    argv = ["--data", bundle_path] + CLI_ARGV
    cli.main(argv + ["--output_dir", os.path.join(out_dir, f"cli_full_r{rank}"),
                     "--epochs", "2"])
    shared = os.path.join(out_dir, "cli_resume")
    cli.main(argv + ["--output_dir", shared, "--epochs", "1"])
    cli.main(argv + ["--output_dir", shared, "--epochs", "2", "--resume",
                     "--set", "train.replication_check_every_epochs=1"])
    # main leaves a group it did not start
    return {}, {"dist_still_up": dist.is_initialized()}


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs_path, out, mode = sys.argv[3:7]
    import numpy as np
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=90))
    try:
        from recsys_tpu_torch.parallel.mesh import make_mesh

        if mode == "cli":
            arrays, records = run_cli(inputs_path, out)
        else:
            ctx = make_mesh(device="cpu")
            with np.load(inputs_path) as z:
                inputs = {k: z[k] for k in z.files}
            arrays, records = run_cases(ctx, inputs, out)
        dist.barrier()
    finally:
        from recsys_tpu_torch.parallel.mesh import shutdown

        shutdown()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
