"""One training step of the flagship multi-card layout on tiny shapes (the
counterpart of ``__graft_entry__.py::dryrun_multichip``).

On the launcher's world (or the caller's process group, or one rank
without either): a ``(data, model)`` mesh with ``model`` 2 when the world
is even, row-sharded tables read through the a2a lookup when ``model`` is
above 1, global negatives, one step of ``Trainer``'s step on a seeded
batch of 8 rows a data rank. Raises on a non-finite loss.

    python -m recsys_tpu_torch.train.dryrun [--config FILE] [--device cuda|cpu]

runs it and prints its numbers as JSON; a ``--config`` whose model is
DLRM-DCNv2 takes :func:`dryrun_dlrm` instead (that model trains on one
device), any other config the flagship step above.
"""

from __future__ import annotations

import tempfile
import argparse
import json
import sys
from typing import Dict, Optional, Sequence

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



# the rows each table keeps in :func:`dryrun_dlrm`
DRYRUN_TABLE_ROWS = 1000


def dryrun_dlrm(cfg, device: DeviceLike = "cuda", batch: int = 8) -> Dict[str, float]:
    """One ``Trainer`` step of ``cfg``'s DLRM-DCNv2 at its widths and bag
    sizes, each table cut to at most ``DRYRUN_TABLE_ROWS`` rows, on a
    seeded batch of ``batch`` rows -> {"loss", "lookups", "unique_rows"}."""
    import dataclasses

    import torch

    from recsys_tpu_torch.train.trainer import Trainer

    m = cfg.model
    rows = tuple(min(r, DRYRUN_TABLE_ROWS) for r in m.table_rows)
    cfg = cfg.replace(model=dataclasses.replace(m, table_rows=rows),
                      train=dataclasses.replace(cfg.train, batch_size=batch))
    rng = np.random.default_rng(0)
    sparse = np.concatenate([rng.integers(0, r, (batch, h)) for r, h in zip(rows, m.bag_sizes)],
                            axis=1).astype(np.int32)
    data = {"dense": rng.random((batch, m.dlrm_dense_in), dtype=np.float32),
            "sparse": sparse, "label": (rng.random(batch) < 0.5).astype(np.float32)}
    with tempfile.TemporaryDirectory() as out:
        trainer = Trainer(cfg, output_dir=out, device=device)
        state = trainer.init_state(0, 0, seed=0)
        step = trainer.make_train_step(None)
        _, metrics = step(state, {k: torch.as_tensor(v).to(trainer.device)
                                  for k, v in data.items()})
    out = {k: float(v) for k, v in metrics.items()}
    if not np.isfinite(out["loss"]):
        raise RuntimeError(f"dryrun_dlrm: non-finite loss {out['loss']}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="One training step on tiny shapes")
    ap.add_argument("--config", default="", help="a config JSON (a dlrm_dcnv2 model takes "
                                                 "dryrun_dlrm)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from recsys_tpu_torch.config import RecsysConfig

    cfg = RecsysConfig.load(args.config) if args.config else None
    if cfg is not None and cfg.model.arch == "dlrm_dcnv2":
        print(json.dumps(dryrun_dlrm(cfg, args.device)))
    else:
        print(json.dumps(dryrun_multichip(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
