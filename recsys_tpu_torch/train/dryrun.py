"""One training step of the flagship multi-card layout on tiny shapes (the
counterpart of ``__graft_entry__.py::dryrun_multichip``).

On the launcher's world (or the caller's process group, or one rank
without either): a ``(data, model)`` mesh with ``model`` 2 when the world
is even, row-sharded tables read through the a2a lookup when ``model`` is
above 1, global negatives, one step of ``Trainer``'s step on a seeded
batch of 8 rows a data rank. Raises on a non-finite loss.
"""

from __future__ import annotations

import tempfile
from typing import Dict

import numpy as np

from recsys_tpu_torch.utils.device import DeviceLike


def dryrun_multichip(device: DeviceLike = "cuda") -> Dict[str, float]:
    """-> {"loss", "lookup_overflow", "n_data", "n_model"} of one step on
    the world's mesh; every rank of the group must call it."""
    import torch

    from recsys_tpu_torch.config import EvalConfig, MeshConfig, ModelConfig, RecsysConfig, \
        TrainConfig
    from recsys_tpu_torch.parallel import mesh
    from recsys_tpu_torch.parallel.sharding import shard_batch
    from recsys_tpu_torch.train.trainer import Trainer

    n = mesh.world_size(device)
    model_parallel = 2 if n % 2 == 0 else 1
    ctx = mesh.make_mesh(model_parallel=model_parallel, device=device)
    cfg = RecsysConfig(
        model=ModelConfig(embedding_dim=64, dropout_rate=0.2),
        train=TrainConfig(batch_size=8 * ctx.n_data, epochs=1, global_negatives=True),
        mesh=MeshConfig(model_axis=model_parallel, embedding_sharding="rows",
                        lookup_strategy="a2a" if model_parallel > 1 else "xla"),
        eval=EvalConfig(topk=(10,)))
    n_users, n_items = 64, 128
    with tempfile.TemporaryDirectory() as out:
        trainer = Trainer(cfg, output_dir=out, device=device, mesh_ctx=ctx)
        state = trainer.init_state(n_users, n_items, seed=0)
        rng = np.random.default_rng(0)
        b = cfg.train.batch_size
        batch = {"user_id": rng.integers(0, n_users, b).astype(np.int32),
                 "movie_id": rng.integers(0, n_items, b).astype(np.int32),
                 "rating": rng.uniform(1, 5, b).astype(np.float32),
                 "y_implicit": (rng.random(b) > 0.4).astype(np.float32),
                 "log_q": np.full(b, -np.log(n_items), np.float32)}
        step = trainer.make_train_step(class_weights=(1.3, 0.8))
        state, metrics = step(state, shard_batch(ctx, batch))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss}")
    overflow = float(metrics.get("lookup_overflow", torch.zeros(())))
    return {"loss": loss, "lookup_overflow": overflow, "n_data": ctx.n_data,
            "n_model": ctx.n_model}

