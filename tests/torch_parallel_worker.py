"""One gloo rank of the port's parallel tests (``test_torch_parallel.py``).

The test starts ``WORLD`` of these, each with its rank, a ``FileStore``
path, the inputs (an npz of seeded numpy arrays), the bundle directory of
the sharded service and an output directory. Every rank joins the group,
makes the two meshes of the tests (``model_parallel=4``: 1 x 4, and
``model_parallel=2``: 2 x 2) and runs every case, in the same order on
every rank (each case is a collective), then writes what it computed to
``<out>/rank<r>.npz`` (arrays) and ``<out>/rank<r>.json`` (the rest).

Usage:
  python tests/torch_parallel_worker.py <rank> <world> <store> <inputs.npz> <bundle> <out>
"""

import json
import os
import sys
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLD = 4
MESHES = {"m4": 4, "m2": 2}  # name -> model_parallel over the WORLD ranks


def run_cases(inputs, bundle: str) -> tuple:
    """-> (arrays {name: ndarray}, records {name: json value}) of this rank."""
    import numpy as np
    import torch

    from recsys_tpu_torch.ops.topk import make_ring_topk
    from recsys_tpu_torch.parallel import collectives as coll
    from recsys_tpu_torch.parallel.mesh import make_mesh
    from recsys_tpu_torch.parallel.sharding import shard_batch, shard_batch_chunk
    from recsys_tpu_torch.retrieval.scorer import RetrievalIndex, make_sharded_topk
    from recsys_tpu_torch.serve.service import RecommendationService

    arrays, records = {}, {}
    meshes = {name: make_mesh(model_parallel=mp, device="cpu") for name, mp in MESHES.items()}

    def t(name):
        return torch.from_numpy(inputs[name])

    # ---- the mesh: shapes, coordinates, errors
    errors = {}
    for label, kw in (("mp3", dict(model_parallel=3)),
                      ("dp3_mp2", dict(model_parallel=2, data_parallel=3)),
                      ("mp0", dict(model_parallel=0))):
        try:
            make_mesh(device="cpu", **kw)
            errors[label] = None
        except ValueError as e:
            errors[label] = str(e)
    records["mesh_errors"] = errors
    for name, ctx in meshes.items():
        try:
            ctx.local_batch(9)
            bad_batch = None
        except ValueError as e:
            bad_batch = str(e)
        records[f"mesh_{name}"] = {
            "n_data": ctx.n_data, "n_model": ctx.n_model, "n_devices": ctx.n_devices,
            "coordinates": list(ctx.coordinates), "local_batch_64": ctx.local_batch(64),
            "local_batch_9": bad_batch, "device": str(ctx.device),
            "axis_index": [coll.axis_index(ctx, "data"), coll.axis_index(ctx, "model")],
            "axis_size": [coll.axis_size(ctx, "data"), coll.axis_size(ctx, "model")],
            "data_ranks": torch.distributed.get_process_group_ranks(ctx.group("data")),
            "model_ranks": torch.distributed.get_process_group_ranks(ctx.group("model")),
        }

    # ---- collectives
    m2, m4 = meshes["m2"], meshes["m4"]
    x = t("allreduce_x")  # [n_data, 2]: row i is data index i's
    arrays["allreduce_mean"] = coll.allreduce_mean(
        m2, {"g": x[m2.data_index:m2.data_index + 1]})["g"].numpy()
    tree = {"a": t("allreduce_tree_a")[m2.model_index], "b": [t("allreduce_tree_b")[m2.model_index]]}
    summed = coll.allreduce_sum(m2, tree, axis="model")
    arrays["allreduce_sum_a"], arrays["allreduce_sum_b"] = summed["a"].numpy(), summed["b"][0].numpy()
    arrays["allreduce_sum_input_a"] = tree["a"].numpy()  # left as it was
    arrays["gather_rows"] = coll.gather_rows(m4, t("gather_x")[m4.model_index]).numpy()
    arrays["exchange"] = coll.exchange(m4, t("exchange_x")[m4.model_index]).numpy()
    for shift in (1, 3):
        arrays[f"ring_shift_{shift}"] = coll.ring_shift(
            m4, t("ring_x")[m4.model_index], shift=shift).numpy()
    arrays["ring_shift_m2"] = coll.ring_shift(m2, t("ring_x")[m2.model_index]).numpy()
    ms, mi = coll.merge_topk(m4, t("merge_s")[m4.model_index], t("merge_i")[m4.model_index], 5)
    arrays["merge_topk_scores"], arrays["merge_topk_ids"] = ms.numpy(), mi.numpy()
    tie_s = t("tie_scores")[m4.model_index]  # every shard's candidates score equal
    ts, ti = coll.merge_topk(m4, tie_s, torch.arange(4) + 10 * m4.model_index, 6)
    arrays["merge_ties_scores"], arrays["merge_ties_ids"] = ts.numpy(), ti.numpy()

    # ---- batch placement
    batch = {"x": inputs["batch_x"], "y": inputs["batch_y"]}
    placed = shard_batch(m2, batch)
    arrays["shard_batch_x"], arrays["shard_batch_y"] = placed["x"].numpy(), placed["y"].numpy()
    arrays["shard_batch_chunk"] = shard_batch_chunk(m2, {"c": inputs["chunk"]})["c"].numpy()

    # ---- ring and sharded top-k
    u, v = t("topk_u"), t("topk_v")
    for name, ctx in meshes.items():
        q_loc, rows = u.shape[0] // ctx.n_data, v.shape[0] // ctx.n_model
        u_loc = u[ctx.data_index * q_loc:(ctx.data_index + 1) * q_loc]
        shard = v[ctx.model_index * rows:(ctx.model_index + 1) * rows]
        for normalize, k in ((True, 6), (False, 3)):
            s, i = make_ring_topk(ctx, k, normalize=normalize)(u_loc, shard)
            arrays[f"ring_{name}_{normalize}_s"], arrays[f"ring_{name}_{normalize}_i"] = (
                s.numpy(), i.numpy())
        s, i = make_sharded_topk(ctx, 6, normalize=True)(u, shard)
        arrays[f"sharded_{name}_s"], arrays[f"sharded_{name}_i"] = s.numpy(), i.numpy()

    # ---- ShardedIndex, fp32 (77 rows: padded) and int8
    for kind in ("fp32", "int8"):
        index = RetrievalIndex(inputs[f"index_{kind}_items"], np.arange(77), device="cpu")
        for name, ctx in meshes.items():
            sh = index.shard(ctx, int8=kind == "int8")
            records[f"index_{kind}_{name}_shard"] = [sh.rows, sh.n_valid]
            for k in ((10, 25) if kind == "fp32" else (10,)):
                s, i = sh.search(inputs[f"index_{kind}_q"], k)
                arrays[f"index_{kind}_{name}_k{k}_s"], arrays[f"index_{kind}_{name}_k{k}_i"] = s, i

    # a catalog smaller than the shards: some ranks hold no real row
    tiny = RetrievalIndex(inputs["index_tiny_items"], np.arange(3), device="cpu")
    for name, ctx in meshes.items():
        s, i = tiny.shard(ctx).search(inputs["index_tiny_q"], 4)
        arrays[f"index_tiny_{name}_s"], arrays[f"index_tiny_{name}_i"] = s, i

    # ---- the service, backend="sharded": the default mesh (every rank on
    # "model") and the 2 x 2 mesh, with and without the rerank
    uids = [int(x) for x in inputs["service_uids"]]
    for label, kw in (("default", {}), ("m2", {"mesh_ctx": m2}),
                      ("m2_rerank", {"mesh_ctx": m2, "rerank_candidates": 20}),
                      ("int8", {"int8_catalog": True})):
        svc = RecommendationService(bundle, backend="sharded", device="cpu", **kw).load()
        records[f"service_{label}"] = {
            "mesh": [svc.mesh_ctx.n_data, svc.mesh_ctx.n_model],
            "one": {str(u): svc.recommend(u, 7) for u in uids[:4]},
            "batch": svc.recommend_batch(uids, 5),
            "info": svc.get_model_info()["backend"],
        }
    return arrays, records


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs_path, bundle, out = sys.argv[3:7]
    import numpy as np
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=90))
    try:
        with np.load(inputs_path) as z:
            inputs = {k: z[k] for k in z.files}
        arrays, records = run_cases(inputs, bundle)
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
