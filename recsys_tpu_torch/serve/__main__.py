"""Serving CLI of the port (the counterpart of ``scripts/serve.py``).

Usage:
  python -m recsys_tpu_torch.serve --model_dir outputs/models/experiment_001/serving \\
      [--rerank_candidates 200] [--int8_catalog] [--device cuda|cpu] \\
      [--backend auto|device|native|sharded|exported] [--exported_path <model_dir>/retrieve.pt2] \\
      [--workers N] [--microbatch N] [--microbatch_wait_ms MS] \\
      [--server threaded|asyncio] [--allow_reload] [--host 0.0.0.0] [--port 8000]

It takes every flag of the JAX CLI with its choices and defaults.
``--backend sharded`` serves the catalog row-sharded over a mesh of every
rank: in one process a one-rank mesh (one card); under ``torchrun
--nproc_per_node N`` every rank joins the launcher's group, loads the
service with its own rows of the catalog and serves. Each search is a
collective over the ranks, so every request must reach every rank in the
same order; the CLI does not relay requests between ranks (the tests'
``tests/torch_sharded_serve_worker.py`` does: rank 0 serves HTTP and
broadcasts each user id). Nothing that loads numpy or torch is imported
before the arguments are parsed: with ``--workers`` above 1 the BLAS
thread counts must be set first.
Exits non-zero when the card is asked for (``--device cuda``, the
default, with any backend but ``native``) and absent.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from recsys_tpu_torch.serve import BACKENDS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Serve recommendations over HTTP "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--model_dir", default="outputs/models/experiment_001/serving")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the towers, top-k and rerank run (cuda exits "
                         "non-zero if no card is present; the native backend "
                         "runs on the host whatever this says)")
    ap.add_argument("--stub", action="store_true",
                    help="serve the model-free stub service (degraded mode)")
    ap.add_argument("--rerank_candidates", type=int, default=0,
                    help="two-stage serving: retrieve this many candidates "
                         "and rerank with the DCN heads (0 = retrieval "
                         "only; needs model.npz)")
    ap.add_argument("--rerank_ctr_weight", type=float, default=0.25,
                    help="weight of the CTR logit in the rerank score")
    ap.add_argument("--rerank_rating_weight", type=float, default=0.0,
                    help="weight of the rating prediction in the rerank score")
    ap.add_argument("--workers", type=int, default=1,
                    help="forked SO_REUSEPORT serving processes, each loading "
                         "its own copy of the bundle")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="dynamic micro-batching: coalesce concurrent "
                         "/recommend requests into one batched scoring call "
                         "of up to this many users (0 = off)")
    ap.add_argument("--microbatch_wait_ms", type=float, default=0.0,
                    help="hold the first request of a micro-batch this long "
                         "to let the batch grow (0 = drain what is there)")
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS),
                    help="scoring backend: the device scorer (auto, device), the "
                         "host (native: numpy towers, BLAS top-k, precomputed "
                         "rerank), the catalog row-sharded over every rank "
                         "(sharded) or the torch.export artifact (exported)")
    ap.add_argument("--exported_path", default=None,
                    help="artifact of the exported backend (default: "
                         "<model_dir>/retrieve.pt2)")
    ap.add_argument("--int8_catalog", action="store_true",
                    help="serve from an int8-quantized catalog (4x less "
                         "device memory) with an exact fp32 refine of the "
                         "top 4k candidates")
    ap.add_argument("--allow_reload", action="store_true",
                    help="enable POST /admin/reload: atomically hot-swap a "
                         "retrained bundle from --model_dir without restarting "
                         "(unauthenticated: trusted networks only)")
    ap.add_argument("--server", default="threaded", choices=["threaded", "asyncio"],
                    help="HTTP transport: the stdlib threaded server (a thread "
                         "per connection, the optional micro-batcher thread) or "
                         "the single-event-loop asyncio server (loop-native "
                         "/recommend coalescing, always on; --microbatch and "
                         "--microbatch_wait_ms set its batch bound and linger)")
    args = ap.parse_args(argv)

    if args.workers > 1:
        # one BLAS thread per worker, set before numpy loads: pool threads
        # spinning in several processes fight over few cores. One worker
        # keeps the default pool (the host rerank's products use it).
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ.setdefault(var, "1")
    else:
        # short GIL-bound requests and many keep-alive handler threads: a
        # shorter switch interval cuts the convoy's tail latency
        sys.setswitchinterval(0.0005)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")

    from recsys_tpu_torch.serve.app import serve_forever

    return serve_forever(args.model_dir, args.host, args.port, workers=args.workers,
                         stub=args.stub, rerank_candidates=args.rerank_candidates,
                         rerank_ctr_weight=args.rerank_ctr_weight,
                         rerank_rating_weight=args.rerank_rating_weight,
                         microbatch=args.microbatch,
                         microbatch_wait_ms=args.microbatch_wait_ms,
                         backend=args.backend, int8_catalog=args.int8_catalog,
                         allow_reload=args.allow_reload, server=args.server,
                         device=args.device, exported_path=args.exported_path)


if __name__ == "__main__":
    sys.exit(main())
