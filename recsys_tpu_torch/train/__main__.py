"""Train the multi-task model with the port:

    python -m recsys_tpu_torch.train --data <bundle.npz> --output_dir <dir> \
        [--device cuda|cpu] [--set train.epochs=3 ...]

The flags are those of the JAX package's ``scripts/train.py`` that this
port honours, with the same defaults; any other flag is an error.
``--set KEY=VALUE`` overrides a dotted config field (the value is parsed
as JSON, ``true``/``false``/``none`` included, else kept as a string).
The run writes what the JAX trainer writes: ``config.json``,
``training_log.csv``, ``detailed_metrics.json``, ``metrics.json``,
``checkpoints/`` and the inference bundle in ``serving/``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

import numpy as np

from recsys_tpu_torch.config import DataConfig, ModelConfig, RecsysConfig, TrainConfig

_RETRIEVAL_LOSS = {"auto": "auto", "xla": False, "flash": True, "chunked": "chunked"}


def parse_overrides(pairs: Sequence[str]) -> dict:
    parsed = {}
    for kv in pairs:
        if "=" not in kv:
            raise ValueError(f"--set expects KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        low = v.strip().lower()
        if low in ("true", "false"):
            parsed[k] = low == "true"
        elif low in ("none", "null"):
            parsed[k] = None
        else:
            try:
                parsed[k] = json.loads(v)
            except json.JSONDecodeError:
                parsed[k] = v
    return parsed


def build_config(args) -> RecsysConfig:
    cfg = RecsysConfig(
        model=ModelConfig(embedding_dim=args.embedding_dim, cross_layers=args.cross_layers,
                          ctr_weight=args.ctr_weight, rating_weight=args.rating_weight,
                          use_flash_ce=_RETRIEVAL_LOSS[args.retrieval_loss]),
        data=DataConfig(processed_path=args.data),
        train=TrainConfig(batch_size=args.batch_size, learning_rate=args.learning_rate,
                          epochs=args.epochs, seed=args.seed),
    )
    return cfg.replace(**parse_overrides(args.overrides)) if args.overrides else cfg


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Train with recsys_tpu_torch")
    ap.add_argument("--data", default=DataConfig().processed_path,
                    help="preprocessed bundle (.npz)")
    ap.add_argument("--output_dir", default="outputs/models/experiment_001")
    ap.add_argument("--embedding_dim", type=int, default=64)
    ap.add_argument("--cross_layers", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--learning_rate", type=float, default=1e-3)
    ap.add_argument("--ctr_weight", type=float, default=0.2)
    ap.add_argument("--rating_weight", type=float, default=0.2)
    ap.add_argument("--retrieval_loss", default="auto", choices=sorted(_RETRIEVAL_LOSS))
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides", help="dotted config override, e.g. "
                    "--set model.dropout_rate=0.3")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from recsys_tpu_torch.train.trainer import Trainer
    from recsys_tpu_torch.utils.metrics_io import setup_logging

    setup_logging()
    logger = logging.getLogger("train")
    try:
        cfg = build_config(args)
    except (ValueError, KeyError) as e:
        ap.error(str(e))
    logger.info("config:\n%s", cfg.to_json())
    with np.load(args.data, allow_pickle=False) as z:
        bundle = {k: z[k] for k in z.files}
    report = Trainer(cfg, output_dir=args.output_dir, device=args.device).train(bundle)
    logger.info("final metrics: %s", report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
