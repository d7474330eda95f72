"""One gloo rank of ``test_torch_parallel.py::test_two_rank_http_serving``:
``/recommend`` served from a catalog row-sharded over two ranks.

Every rank joins the group and loads the same ``backend="sharded"``
service (each holds its own rows of the catalog). A search is a
collective, so every rank must take part in each request, in the same
order: rank 0 runs the real HTTP server and relays each request's user
id to the other ranks by ``broadcast`` before it scores; they loop,
scoring the same user. A sentinel id stops the loop. This is the relay of
the JAX package's ``tests/sharded_serve_worker.py``.

Usage:
  python tests/torch_sharded_serve_worker.py <rank> <world> <store> <model_dir> <out.json> <uids_json>
"""

import json
import os
import sys
import threading
from datetime import timedelta

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = 5
SENTINEL = -2


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, model_dir, out_path, uids_json = sys.argv[3:7]
    uids = json.loads(uids_json)
    import torch
    import torch.distributed as dist

    from recsys_tpu_torch.parallel.mesh import shutdown
    from recsys_tpu_torch.serve.service import RecommendationService

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=90))
    try:
        svc = RecommendationService(model_dir, backend="sharded", device="cpu").load()
        assert svc.mesh_ctx.n_model == world

        def relay(uid: int) -> int:
            got = torch.tensor([uid], dtype=torch.long)
            dist.broadcast(got, src=0)
            return int(got[0])

        if rank == 0:
            import urllib.request

            from recsys_tpu_torch.serve.app import make_http_server

            class Relay:
                """Service adapter: broadcast the uid before scoring, so every
                rank joins the collective search."""

                def __init__(self, inner):
                    self._inner = inner
                    self._lock = threading.Lock()

                def recommend(self, user_id, k=K):
                    with self._lock:
                        relay(int(user_id))
                        return self._inner.recommend(user_id, k)

                def __getattr__(self, name):
                    return getattr(self._inner, name)

            server = make_http_server(Relay(svc), host="127.0.0.1", port=0)
            port = server.server_address[1]
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            results = {}
            try:
                for uid in uids:
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/recommend",
                        data=json.dumps({"user_id": int(uid), "k": K}).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=60) as r:
                        assert r.status == 200
                        results[str(uid)] = json.loads(r.read())
            finally:
                relay(SENTINEL)
                server.shutdown()
                server.server_close()
                thread.join(timeout=30)
            with open(out_path, "w") as f:
                json.dump(results, f)
        else:
            while (uid := relay(0)) != SENTINEL:
                svc.recommend(uid, K)
        dist.barrier()
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
