"""One gloo rank of the port's row-sharded lookup tests
(``test_torch_embed.py``).

The test starts ``WORLD`` of these, each with its rank, a ``FileStore``
path, the inputs (an npz: the table ``table`` [V, D] and the id arrays
``ids_*`` [B]) and an output directory. Every rank joins the group, makes
the two meshes (``model_parallel=4``: 1 x 4, and 2: 2 x 2), and on each
holds its row shard of the table and its ``data`` slice of the ids and
runs every case in the same order (each is a collective): the psum and
a2a lookups forward, their backward (the gradient of ``sum(rows**2)``
with respect to the shard, summed over ``data``: the gradient of the
whole batch's loss), the a2a overflow, the out-of-range ids and the
trainer's "xla" lookup. It writes ``<out>/rank<r>.npz`` and
``<out>/rank<r>.json``.

Usage:
  python tests/torch_embed_worker.py <rank> <world> <store> <inputs.npz> <out>
"""

import json
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLD = 4
MESHES = {"m4": 4, "m2": 2}  # name -> model_parallel over the WORLD ranks
CAPACITY, SKEW_CAPACITY, OOR_CAPACITY = 8, 4, 16


def run_cases(inputs, out_dir: str) -> tuple:
    import numpy as np
    import torch

    from recsys_tpu_torch.config import MeshConfig, RecsysConfig
    from recsys_tpu_torch.embed.table import (lookup_a2a_inside, lookup_psum_inside,
                                              make_sharded_lookup_a2a, make_sharded_lookup_psum)
    from recsys_tpu_torch.parallel import collectives as coll
    from recsys_tpu_torch.parallel.mesh import make_mesh
    from recsys_tpu_torch.parallel.sharding import gather_table, local_slice, shard_rows
    from recsys_tpu_torch.train.trainer import Trainer

    arrays, records = {}, {}
    table = torch.from_numpy(inputs["table"])
    for name, mp in MESHES.items():
        ctx = make_mesh(model_parallel=mp, device="cpu")
        records[f"{name}/coords"] = [ctx.data_index, ctx.model_index]

        def ids(key):
            return torch.from_numpy(local_slice(ctx, inputs[key]))

        def shard():
            return shard_rows(ctx, table).clone().requires_grad_(True)

        def grad_of(rows, leaf):
            (g,) = torch.autograd.grad(torch.sum(rows ** 2), leaf)
            return coll.allreduce_sum(ctx, g, ctx.data_axis)  # the whole batch's loss

        psum = make_sharded_lookup_psum(ctx)
        w = shard()
        rows = psum(w, ids("ids_main"))
        arrays[f"{name}/psum_fwd"] = rows.detach().numpy()
        arrays[f"{name}/psum_grad"] = grad_of(rows, w).numpy()

        a2a = make_sharded_lookup_a2a(ctx, CAPACITY)
        w = shard()
        rows, overflow = a2a(w, ids("ids_main"))
        arrays[f"{name}/a2a_fwd"] = rows.detach().numpy()
        records[f"{name}/a2a_overflow"] = int(overflow)
        arrays[f"{name}/a2a_grad"] = grad_of(rows, w).numpy()
        rows, overflow = a2a(shard(), ids("ids_dup"))
        arrays[f"{name}/a2a_dup"] = rows.detach().numpy()
        records[f"{name}/a2a_dup_overflow"] = int(overflow)
        rows, overflow = make_sharded_lookup_a2a(ctx, SKEW_CAPACITY)(shard(), ids("ids_skew"))
        arrays[f"{name}/a2a_skew"] = rows.detach().numpy()
        records[f"{name}/a2a_skew_overflow"] = int(overflow)

        # each body's own treatment of out-of-range ids (the bodies, no wrapper)
        with torch.no_grad():
            arrays[f"{name}/oor_psum"] = lookup_psum_inside(
                ctx, shard_rows(ctx, table), ids("ids_oor"), ctx.model_axis).numpy()
            arrays[f"{name}/oor_a2a"] = lookup_a2a_inside(
                ctx, shard_rows(ctx, table), ids("ids_oor"), ctx.model_axis, ctx.n_model,
                OOR_CAPACITY)[0].numpy()

        # the whole table onto the host of each model group's first rank, in
        # chunks of 3 rows (the last one short)
        whole = gather_table(ctx, shard_rows(ctx, table),
                             chunk_bytes=3 * table.shape[1] * table.element_size())
        records[f"{name}/gather_table_none"] = whole is None
        if whole is not None:
            arrays[f"{name}/gather_table"] = whole

        # the trainer reads lookup_strategy="xla" through the psum body
        cfg = RecsysConfig().replace(**{"mesh.model_axis": mp, "mesh.embedding_sharding": "rows",
                                        "mesh.lookup_strategy": "xla"})
        tr = Trainer(cfg, os.path.join(out_dir, f"xla_{name}"), device="cpu", mesh_ctx=ctx)
        w = shard()
        rows = tr._lookup()(w, ids("ids_main"))
        records[f"{name}/xla_equals_psum"] = bool(
            np.array_equal(rows.detach().numpy(), arrays[f"{name}/psum_fwd"]))
        arrays[f"{name}/xla_grad"] = grad_of(rows, w).numpy()
    return arrays, records


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs_path, out = sys.argv[3:6]
    import numpy as np
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=90))
    try:
        with np.load(inputs_path) as z:
            inputs = {k: z[k] for k in z.files}
        arrays, records = run_cases(inputs, out)
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
