"""Train the multi-task model with the port:

    python -m recsys_tpu_torch.train --data <bundle.npz> --output_dir <dir> \
        [--device cuda|cpu] [--set train.epochs=3 ...]

and over N cards (one rank a card, NCCL; gloo with ``--device cpu``),
data-parallel with every rank holding the whole tables, or on a ``(N / M,
M)`` mesh with the tables row-sharded over its M model ranks:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m recsys_tpu_torch.train --data <bundle.npz> --output_dir <dir> \
        [--model_parallel M --embedding_sharding rows --lookup_strategy a2a]

Under a launcher (or in a process whose caller already started a process
group) the CLI makes the ``(data, model)`` mesh of ``--model_parallel``
over every rank and trains on it; rank 0 writes the run's files. The flags
are those of the JAX package's ``scripts/train.py`` that this port
honours, with the same names, defaults and mappings, so that one argv
gives one ``config.json`` in both packages. ``--distributed_strategy``
is accepted for compat and sets nothing. ``--global_negatives`` (the
default) / ``--per_replica_negatives`` set ``train.global_negatives``: on
a mesh of several data ranks the in-batch candidates are the global
batch or each rank's own. ``--negative_sampling hard|mixed|mined`` trains
with explicit negatives (``--num_hard_negatives`` +
``--num_random_negatives`` a row); ``mined`` mines them from the trained
serving bundle of ``--mined_from DIR``. ``--model_parallel``,
``--embedding_sharding`` and ``--lookup_strategy`` (xla, psum, a2a; "xla"
reads the row-sharded tables through the psum lookup) set ``config.mesh``,
and ``--set mesh.lookup_capacity_factor=F`` the a2a buckets' headroom.
Without a process group ``--model_parallel`` above 1 is an error: start
the ranks under the launcher. ``--use_dense_features`` sets
``model.dense_features`` to the engineered feature width (29, or 33 with
``--use_side_features``, which alone exits as in the JAX CLI).
``--use_wandb`` logs each epoch and the final metrics to a W&B run
(project ``recsys-tpu``, the config as its config); without ``wandb`` it
warns and trains. Any other flag is an error.
``--config FILE`` takes the whole config from a JSON file (the layout of
a run's ``config.json``; a ``bench_port/configs/`` file loads too, its
other keys left out): the way to train DLRM-DCNv2 (``model.arch``
"dlrm_dcnv2"), whose ``--data`` bundle holds ``train/`` and ``val/``
columns ``dense``, ``sparse`` and ``label`` (``Trainer._train_dlrm``), and
HSTU (``model.arch`` "hstu"), whose bundle holds ``train/`` and ``val/``
jagged histories: ``items`` [events] int32, ``timestamps`` [events] int64
and ``lengths`` [histories] (``Trainer._train_hstu``), and MLA-MoE
(``model.arch`` "mla_moe"), whose bundle holds the same columns
(``timestamps`` may be left out: it reads none).
With it, only ``--data``, ``--output_dir``, ``--device``, ``--use_wandb``,
``--distributed_strategy`` and ``--set`` may be given besides.
``--set KEY=VALUE`` overrides a dotted config field (the value is parsed
as JSON, ``true``/``false``/``none`` included, else kept as a string):
``--set train.device_resident_data=false`` takes the streaming input
path.
The run writes what the JAX trainer writes: ``config.json``,
``training_log.csv``, ``detailed_metrics.json``, ``metrics.json``,
``checkpoints/``, ``tensorboard/`` (with tensorboardX) and the inference
bundle in ``serving/``; ``--set train.debug_nans=true`` raises at the first
NaN naming the op that made it, ``--set train.profile=true`` traces the
first epoch into ``profile/``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np

from recsys_tpu_torch.config import (DataConfig, EvalConfig, MeshConfig, ModelConfig,
                                     RecsysConfig, TrainConfig)

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


# the flags that set no config field: the only ones --config takes besides
_RUN_FLAGS = ("data", "output_dir", "config", "overrides", "device", "use_wandb",
              "distributed_strategy")


def build_config(args) -> RecsysConfig:
    if args.config:
        defaults = vars(build_parser().parse_args([]))
        given = sorted(k for k, v in vars(args).items()
                       if k not in _RUN_FLAGS and v != defaults[k])
        if given:
            raise ValueError(f"--config takes the config from its file: set "
                             f"{', '.join(given)} there or with --set")
        cfg = RecsysConfig.load(args.config)
        return cfg.replace(**parse_overrides(args.overrides)) if args.overrides else cfg
    dense = 0
    if args.use_dense_features:
        from recsys_tpu_torch.data.features import FeatureEngineer

        side = args.use_side_features
        dense = FeatureEngineer.n_features(n_user_side=3 if side else 0,
                                           n_item_side=1 if side else 0)
    elif args.use_side_features:
        raise SystemExit("--use_side_features requires --use_dense_features")
    cfg = RecsysConfig(
        model=ModelConfig(embedding_dim=args.embedding_dim, cross_layers=args.cross_layers,
                          ctr_weight=args.ctr_weight, rating_weight=args.rating_weight,
                          mixed_precision=args.bf16, dense_features=dense,
                          softmax_temperature=args.softmax_temperature,
                          use_flash_ce=_RETRIEVAL_LOSS[args.retrieval_loss]),
        data=DataConfig(processed_path=args.data, negative_sampling=args.negative_sampling,
                        num_hard_negatives=args.num_hard_negatives,
                        num_random_negatives=args.num_random_negatives,
                        mined_from=args.mined_from),
        train=TrainConfig(batch_size=args.batch_size, learning_rate=args.learning_rate,
                          epochs=args.epochs, resume=args.resume, seed=args.seed,
                          global_negatives=args.global_negatives),
        mesh=MeshConfig(model_axis=args.model_parallel,
                        embedding_sharding=args.embedding_sharding,
                        lookup_strategy=args.lookup_strategy),
        eval=EvalConfig(eval_sample=args.eval_sample),
    )
    return cfg.replace(**parse_overrides(args.overrides)) if args.overrides else cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train with recsys_tpu_torch")
    ap.add_argument("--data", default=DataConfig().processed_path,
                    help="preprocessed bundle (.npz)")
    ap.add_argument("--config", default="",
                    help="take the whole config from this JSON file (e.g. a dlrm_dcnv2 "
                         "model); --set overrides it")
    ap.add_argument("--output_dir", default="outputs/models/experiment_001")
    ap.add_argument("--embedding_dim", type=int, default=64)
    ap.add_argument("--cross_layers", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--learning_rate", type=float, default=1e-3)
    ap.add_argument("--negative_sampling", default="random",
                    choices=["random", "hard", "mixed", "mined"],
                    help="random: in-batch negatives only; hard, mixed, mined: "
                         "explicit negatives as well")
    ap.add_argument("--mined_from", default="",
                    help="trained serving-bundle dir to mine hard negatives from "
                         "(negative_sampling=mined)")
    ap.add_argument("--num_hard_negatives", type=int, default=20)
    ap.add_argument("--num_random_negatives", type=int, default=30)
    ap.add_argument("--ctr_weight", type=float, default=0.2)
    ap.add_argument("--rating_weight", type=float, default=0.2)
    ap.add_argument("--distributed_strategy", default="mesh",
                    choices=["none", "mirrored", "multi_worker", "mesh"],
                    help="accepted for compat; sets nothing")
    ap.add_argument("--use_wandb", action="store_true",
                    help="log to a W&B run (project recsys-tpu), if wandb is installed")
    ap.add_argument("--model_parallel", type=int, default=1,
                    help="size of the model mesh axis (row-sharded tables over it)")
    ap.add_argument("--embedding_sharding", default="replicated",
                    choices=["replicated", "rows"])
    ap.add_argument("--lookup_strategy", default="xla", choices=["xla", "psum", "a2a"])
    ap.add_argument("--global_negatives", action="store_true", default=True,
                    help="in-batch candidates span the global batch (default)")
    ap.add_argument("--per_replica_negatives", dest="global_negatives",
                    action="store_false")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --output_dir")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--eval_sample", type=int, default=0,
                    help="0 = full-split eval; N = reference-style sampled eval")
    ap.add_argument("--use_dense_features", action="store_true",
                    help="feed the engineered feature set into the DCN ranking input")
    ap.add_argument("--use_side_features", action="store_true",
                    help="add the MovieLens demographic side tables (gender, age, "
                         "occupation, movie year) to the engineered features; "
                         "requires --use_dense_features")
    ap.add_argument("--softmax_temperature", type=float, default=1.0,
                    help="retrieval in-batch softmax temperature")
    ap.add_argument("--retrieval_loss", default="auto", choices=sorted(_RETRIEVAL_LOSS))
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides", help="dotted config override, e.g. "
                    "--set model.dropout_rate=0.3")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from recsys_tpu_torch.parallel import mesh
    from recsys_tpu_torch.train.trainer import Trainer
    from recsys_tpu_torch.utils.metrics_io import setup_logging

    try:
        cfg = build_config(args)
    except (ValueError, KeyError) as e:
        ap.error(str(e))
    # under a launcher, or in a caller's process group: the (data, model)
    # mesh over every rank (a group this call joins, it also leaves)
    had_group = dist.is_initialized()
    mesh.maybe_initialize_distributed(args.device)
    mesh_ctx = None
    if dist.is_initialized():
        mesh_ctx = mesh.make_mesh(model_parallel=cfg.mesh.model_axis,
                                  data_parallel=cfg.mesh.data_axis, device=args.device)
    setup_logging()
    logger = logging.getLogger("train")
    wandb_run = None
    try:
        logger.info("config:\n%s", cfg.to_json())
        with np.load(args.data, allow_pickle=False) as z:
            bundle = {k: z[k] for k in z.files}
        if args.use_wandb:
            try:
                import wandb

                wandb_run = wandb.init(project="recsys-tpu", config=cfg.to_dict())
            except ImportError:
                logger.warning("wandb not installed; continuing without it")
        report = Trainer(cfg, output_dir=args.output_dir, device=args.device,
                         mesh_ctx=mesh_ctx).train(bundle)
        logger.info("final metrics: %s", report)
    finally:
        if wandb_run is not None:
            wandb_run.finish()
        if mesh_ctx is not None and not had_group:
            mesh.shutdown()  # a communicator left behind can hang the exit
    return 0


if __name__ == "__main__":
    # the process's allocator policy, set before CUDA starts (a caller's
    # own PYTORCH_CUDA_ALLOC_CONF kept): HSTU's jagged steps allocate other
    # sizes every step, and segments that grow in place spare the cache
    # new cudaMalloc calls, which stall the card mid-step
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.exit(main())
