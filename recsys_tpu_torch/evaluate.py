"""Offline evaluation CLI of the port (the counterpart of
``scripts/evaluate.py``): the full metric report of a trained model on
one split of a preprocessed bundle, and optionally the two-stage
(retrieve, then DCN rerank) metrics.

Usage:
  python -m recsys_tpu_torch.evaluate --data data/processed/processed_data.npz \\
      --model_dir outputs/run/serving [--split test] [--filter_seen] \\
      [--score_norm dot] [--eval_sample 0] [--rerank_candidates 200] \\
      [--output metrics_test.json] [--device cuda|cpu]

The flags are those of ``scripts/evaluate.py`` plus ``--device``. A
model with engineered dense features takes them from the bundle's
``features.npz`` (its absence is an error), as ``scripts/evaluate.py``
does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger("evaluate")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Evaluate a trained model "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--data", required=True, help="preprocessed bundle (.npz)")
    ap.add_argument("--model_dir", required=True,
                    help="inference bundle dir (the trainer's <out>/serving)")
    ap.add_argument("--split", default="val", choices=["train", "val", "test"])
    ap.add_argument("--topk", type=int, nargs="+", default=[5, 10, 20, 50])
    ap.add_argument("--eval_sample", type=int, default=0,
                    help="sample N rows (0 = full split)")
    ap.add_argument("--eval_batch_size", type=int, default=4096)
    ap.add_argument("--filter_seen", action="store_true",
                    help="mask items the user interacted with in train")
    ap.add_argument("--score_norm", default=None, choices=["cosine", "dot"],
                    help="override the bundle config's scoring mode")
    ap.add_argument("--rerank_candidates", type=int, default=0,
                    help="additionally score the two-stage pipeline: "
                         "retrieve N candidates, rerank with the DCN CTR "
                         "head (0 = skip)")
    ap.add_argument("--rerank_ctr_weight", type=float, default=0.25)
    ap.add_argument("--output", default=None,
                    help="write the report JSON here (default: print only)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and the top-k run (cuda raises "
                         "if no card is present)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s: %(message)s")

    from recsys_tpu_torch.config import RecsysConfig
    from recsys_tpu_torch.retrieval.evaluator import evaluate, two_stage_evaluate
    from recsys_tpu_torch.data.preprocessing import load_bundle
    from recsys_tpu_torch.train.checkpoint import (
        load_feature_engineer, load_model_params, params_from_numpy,
    )

    cfg = RecsysConfig.load(os.path.join(args.model_dir, "config.json"))
    params = load_model_params(args.model_dir)
    if params is None:
        ap.error(f"{args.model_dir}/model.npz not found: retrain to produce a "
                 "full-params bundle")
    params = params_from_numpy(params, args.device)
    bundle = load_bundle(args.data)

    eval_cfg = dataclasses.replace(
        cfg.eval,
        topk=tuple(args.topk),
        eval_sample=args.eval_sample,
        eval_batch_size=args.eval_batch_size,
        filter_seen=args.filter_seen or cfg.eval.filter_seen,
        score_norm=args.score_norm or cfg.eval.score_norm,
    )
    engineer = load_feature_engineer(args.model_dir)
    dense = None
    if cfg.model.dense_features > 0:
        if engineer is None:
            ap.error("model consumes dense features but the bundle has no features.npz")
        dense = engineer.transform_scaled(
            bundle[f"{args.split}/user_id"], bundle[f"{args.split}/movie_id"],
            bundle[f"{args.split}/timestamp"].astype(np.float64))
    report = evaluate(params, cfg.model, bundle, args.split, eval_cfg, seed=args.seed,
                      dense=dense)
    if args.rerank_candidates > 0:
        report.update(two_stage_evaluate(
            params, cfg.model, bundle, args.split, n_cand=args.rerank_candidates,
            ctr_weight=args.rerank_ctr_weight, engineer=engineer, seed=args.seed))
    report["split"] = args.split
    report["model_dir"] = args.model_dir

    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in report.items()}, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
        logger.info("report -> %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
