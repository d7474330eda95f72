"""One gloo rank of the port's debugging-mode tests under a mesh
(``test_torch_debug.py``).

The test starts ``WORLD`` ranks, each with its rank, a ``FileStore`` path,
the training bundle (an npz) and an output directory. Every rank joins the
group and runs, in order:

* ``profile``: ``Trainer.train`` one epoch with ``train.profile`` on the
  data-parallel ``(2, 1)`` mesh (rank 0 alone should trace);
* ``nan_update`` and ``nan_loss``: ``Trainer.train`` with
  ``train.debug_nans`` on the ``(1, 2)`` mesh with the tables row-sharded
  (psum lookup), a NaN planted in model rank 1's user shard only: in its
  last row (padding no batch looks up, so only the update of step 0 shows
  it, on rank 1), or in every row (the loss of step 0, on both ranks).

Each rank writes ``<out>/rank<r>.json``: its pid and, per NaN case, the
``FloatingPointError``'s message (or what else happened).

Usage:
  python tests/torch_debug_worker.py <rank> <world> <store> <bundle> <out>
"""

import json
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLD = 2
MODEL = dict(embedding_dim=16, user_tower_dims=(16,), item_tower_dims=(16,), cross_layers=1,
             dnn_dims=(16,), dropout_rate=0.0, mixed_precision=False)


def config(model_parallel: int, **train_over):
    from recsys_tpu_torch.config import (EvalConfig, MeshConfig, ModelConfig, RecsysConfig,
                                         TrainConfig)

    return RecsysConfig(
        model=ModelConfig(**MODEL),
        train=TrainConfig(**{"batch_size": 256, "epochs": 1, **train_over}),
        mesh=MeshConfig(model_axis=model_parallel,
                        embedding_sharding="rows" if model_parallel > 1 else "replicated",
                        lookup_strategy="psum"),
        eval=EvalConfig(topk=(10,), eval_sample=50))


def run_nan_case(ctx, bundle, out_dir, rows) -> str:
    """``Trainer.train`` under ``debug_nans`` with model rank 1's user
    shard NaN at ``rows`` -> what it raised."""
    import torch

    from recsys_tpu_torch.train.trainer import Trainer
    from recsys_tpu_torch.utils.debug import disable_nan_checks

    init_state = Trainer.init_state

    def planted(self, *args, **kwargs):
        state = init_state(self, *args, **kwargs)
        if ctx.model_index == 1:
            with torch.no_grad():
                state.params["towers"]["user_table"][rows] = float("nan")
        return state

    Trainer.init_state = planted
    try:
        Trainer(config(2, debug_nans=True), out_dir, device="cpu", mesh_ctx=ctx).train(bundle)
        return "no error"
    except FloatingPointError as e:
        return f"FloatingPointError: {e}"
    finally:
        Trainer.init_state = init_state
        disable_nan_checks()


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, bundle_path, out = sys.argv[3:6]
    import numpy as np
    import torch.distributed as dist

    from recsys_tpu_torch.parallel.mesh import make_mesh, shutdown
    from recsys_tpu_torch.train.trainer import Trainer

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    records = {"pid": os.getpid()}
    try:
        with np.load(bundle_path) as z:
            bundle = {k: z[k] for k in z.files}
        dp = make_mesh(model_parallel=1, device="cpu")
        Trainer(config(1, profile=True), os.path.join(out, "profile_run"), device="cpu",
                mesh_ctx=dp).train(bundle)
        rows = make_mesh(model_parallel=2, device="cpu")
        records["nan_update"] = run_nan_case(rows, bundle, os.path.join(out, "nan_update"),
                                             slice(-1, None))
        records["nan_loss"] = run_nan_case(rows, bundle, os.path.join(out, "nan_loss"),
                                           slice(None))
        dist.barrier()
    finally:
        shutdown()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(records, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
