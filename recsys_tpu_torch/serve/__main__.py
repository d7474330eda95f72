"""Serving CLI of the port (the counterpart of ``scripts/serve.py``).

Usage:
  python -m recsys_tpu_torch.serve --model_dir outputs/models/experiment_001/serving \\
      [--rerank_candidates 200] [--int8_catalog] [--device cuda|cpu] \\
      [--backend auto|device|exported] [--exported_path <model_dir>/retrieve.pt2] \\
      [--host 0.0.0.0] [--port 8000]

``--backend`` takes the JAX CLI's choices; ``native`` and ``sharded`` are
not ported yet and exit naming their ROADMAP Queue 1 item.
"""

from __future__ import annotations

import argparse
import logging
import sys

from recsys_tpu_torch.serve.service import NOT_PORTED_BACKENDS, BACKENDS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Serve recommendations over HTTP "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--model_dir", default="outputs/models/experiment_001/serving")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the towers, top-k and rerank run (cuda "
                         "raises at load if no card is present)")
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
    ap.add_argument("--int8_catalog", action="store_true",
                    help="serve from an int8-quantized catalog (4x less "
                         "device memory) with an exact fp32 refine of the "
                         "top 4k candidates")
    ap.add_argument("--backend", default="auto", choices=list(BACKENDS),
                    help="scoring backend: the device scorer (auto, device) or the "
                         "torch.export artifact (exported); native and sharded are "
                         "not ported yet")
    ap.add_argument("--exported_path", default=None,
                    help="artifact of the exported backend (default: "
                         "<model_dir>/retrieve.pt2)")
    args = ap.parse_args(argv)
    if args.backend in NOT_PORTED_BACKENDS:
        ap.error(f"--backend {args.backend} is not ported to recsys_tpu_torch yet "
                 f"(ROADMAP Queue 1: {NOT_PORTED_BACKENDS[args.backend]})")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")

    from recsys_tpu_torch.serve.app import serve_forever

    serve_forever(args.model_dir, args.host, args.port, stub=args.stub,
                  rerank_candidates=args.rerank_candidates,
                  rerank_ctr_weight=args.rerank_ctr_weight,
                  rerank_rating_weight=args.rerank_rating_weight,
                  int8_catalog=args.int8_catalog, device=args.device,
                  backend=args.backend, exported_path=args.exported_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
