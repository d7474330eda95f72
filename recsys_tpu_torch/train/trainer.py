"""Single-GPU trainer (the counterpart of ``recsys_tpu/train/trainer.py``
on its one-device, dense-update, device-resident path).

* params, optimizer slots and the whole train split live on the device;
  an epoch is a loop of steps over an on-device permutation, each step
  a gather of the batch, ``MultiTaskModel.loss``, ``torch.autograd.grad``
  and the optimizer's in-place update (the JAX package's
  ``make_train_epoch``: one compiled scan per epoch; here the Python loop
  dispatches and the metrics stay on the device until the epoch ends);
* balanced CTR class weights, the log-frequency logQ table and the
  ``item_bias`` init to it;
* a padded, masked validation pass per epoch; early stopping on
  ``val_loss`` (or a periodic sampled ``val_recall@10``) with the best
  weights restored; a checkpoint every epoch and one on SIGTERM/SIGUSR1;
* the final ``evaluate``, then ``RetrievalIndex.build`` and the
  inference bundle in ``<output_dir>/serving``.

Every mode of the JAX trainer that is not ported raises
``NotImplementedError`` naming its ROADMAP item; none silently runs
something else. Dropout masks come from a ``torch.Generator`` on the
device, reseeded from (seed + 1, step) every step, so a run and its
resume draw the same masks; they are not JAX's masks.
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from recsys_tpu_torch.config import RecsysConfig
from recsys_tpu_torch.models import losses
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.retrieval.evaluator import evaluate
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.train import checkpoint as ckpt_lib
from recsys_tpu_torch.train.optimizer import leaves_with_paths, make_optimizer
from recsys_tpu_torch.utils.device import DeviceLike, resolve_device
from recsys_tpu_torch.utils.metrics_io import MetricWriter

logger = logging.getLogger(__name__)

METRIC_KEYS = ("loss", "retrieval_loss", "rating_mse", "ctr_bce", "l2")
BATCH_COLUMNS = ("user_id", "movie_id", "rating", "y_implicit")


class TrainState(NamedTuple):
    params: Any      # nested dict of fp32 leaves with requires_grad
    opt_state: Any   # the optimizer's slots, same tree per slot name
    step: int        # a host count
    rng: int         # the dropout seed; masks of a step derive from (rng, step)


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to recsys_tpu_torch yet (ROADMAP {item})")


def _unflatten_like(tree, values: Dict[Tuple[str, ...], torch.Tensor]):
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        return values[prefix]

    return walk(tree, ())


class Trainer:
    # Table elements above which the JAX package's "auto" switches to
    # sparse table updates: a TPU v5e crossover, unmeasured on H100. The
    # sparse path is not ported, so "auto" raises above it.
    SPARSE_AUTO_THRESHOLD = 32_000_000

    def __init__(self, config: RecsysConfig, output_dir: str = "outputs/run",
                 device: DeviceLike = "cuda"):
        self.config = config
        self.output_dir = output_dir
        self.device = resolve_device(device)
        self._check_config()
        self.optimizer = make_optimizer(config.train)
        self.writer = MetricWriter(output_dir)
        self.ckpt = ckpt_lib.CheckpointManager(
            f"{output_dir}/checkpoints", keep=config.train.keep_checkpoints,
            async_save=config.train.async_checkpoint)
        self._dropout_gen = torch.Generator(device=self.device)

    # ---- what this port runs ----------------------------------------
    def _check_config(self) -> None:
        cfg = self.config
        t, m = cfg.train, cfg.mesh
        if cfg.data.negative_sampling != "random":
            _not_ported(f"negative_sampling={cfg.data.negative_sampling!r} "
                        "(explicit negatives)", "Queue 1 item 9")
        if cfg.model.dense_features > 0:
            _not_ported("dense_features > 0", "Queue 1 item 4")
        if t.sparse_table_updates is True:
            _not_ported("sparse_table_updates=True", "Queue 1 item 9")
        if t.negative_cache > 0:
            _not_ported("negative_cache > 0 (the CBNS cache)", "Queue 1 item 9")
        if (m.model_axis != 1 or m.data_axis not in (-1, 1)
                or m.embedding_sharding != "replicated" or m.lookup_strategy != "xla"):
            _not_ported("a mesh of more than one device", "Queue 1 item 11")
        if not t.device_resident_data:
            _not_ported("the streaming input path", "Queue 1 item 9")
        if t.profile:
            _not_ported("TrainConfig.profile", "Queue 1 item 12")
        if t.debug_nans:
            _not_ported("TrainConfig.debug_nans", "Queue 1 item 12")

    def _check_sparse_auto(self, n_users: int, n_items: int) -> None:
        if self.config.train.sparse_table_updates == "auto":
            elems = (n_users + n_items + 2) * self.config.model.embedding_dim
            if elems > self.SPARSE_AUTO_THRESHOLD:
                _not_ported(f"sparse_table_updates='auto' above "
                            f"{self.SPARSE_AUTO_THRESHOLD} table elements "
                            "(sparse updates)", "Queue 1 item 9")

    # ---- state -------------------------------------------------------
    def init_state(self, n_users: int, n_items: int, seed: int) -> TrainState:
        """Params from ``MultiTaskModel.init`` (drawn from a CPU generator
        seeded with ``seed``), on the trainer's device, with gradients on;
        fresh optimizer slots; step 0."""
        self._check_sparse_auto(n_users, n_items)
        params = MultiTaskModel.init(torch.Generator().manual_seed(seed),
                                     self.config.model, n_users, n_items, self.device)
        return self.state_from_params(params, seed)

    def state_from_params(self, params, seed: int) -> TrainState:
        """A step-0 state around given params (moved to the trainer's
        device, gradients on), e.g. those of ``params_from_numpy``."""
        def own(node):
            if isinstance(node, dict):
                return {k: own(v) for k, v in node.items()}
            return node.detach().to(self.device, torch.float32).clone().requires_grad_(True)

        params = own(params)
        return TrainState(params, self.optimizer.init(params), 0, seed + 1)

    def _generator(self, state: TrainState) -> torch.Generator:
        self._dropout_gen.manual_seed(state.rng * 1_000_003 + state.step)
        return self._dropout_gen

    # ---- the step ----------------------------------------------------
    def _step_core(self, class_weights) -> Callable:
        """-> ``step_fn(state, batch) -> (state, metrics)``: the dense
        train step (loss, autograd, in-place optimizer update). ``batch``
        holds tensors on the device; metrics stay there."""
        cfg = self.config
        opt = self.optimizer

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
            paths, leaves = zip(*leaves_with_paths(state.params))
            _, metrics = MultiTaskModel.loss(
                state.params, cfg.model, batch, generator=self._generator(state),
                train=True, class_weights=class_weights)
            # a leaf the loss does not reach (item_bias under
            # use_item_bias=False) gets a zero gradient, as in JAX
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
                leaves, torch.autograd.grad(metrics["loss"], leaves, allow_unused=True))]
            opt.update(_unflatten_like(state.params, dict(zip(paths, grads))),
                       state.opt_state, state.params, state.step)
            return (state._replace(step=state.step + 1),
                    {k: v.detach() for k, v in metrics.items()})

        return step_fn

    def make_train_step(self, class_weights) -> Callable:
        return self._step_core(class_weights)

    def make_train_epoch(self, class_weights, n_rows: int, n_steps: int) -> Callable:
        """-> ``epoch_fn(state, data, epoch) -> (state, mean metrics)`` over
        device-resident ``data``: a permutation of the rows on the device
        from a generator seeded by (seed ^ 0x5EED, epoch), then ``n_steps``
        steps of ``batch_size`` rows (the remainder is dropped)."""
        b = self.config.train.batch_size
        step_fn = self._step_core(class_weights)
        perm_gen = torch.Generator(device=self.device)
        base = self.config.train.seed ^ 0x5EED

        def epoch_fn(state: TrainState, data: Dict[str, torch.Tensor], epoch: int):
            perm_gen.manual_seed(base * 1_000_003 + epoch)
            perm = torch.randperm(n_rows, generator=perm_gen, device=self.device)
            sums = {k: torch.zeros((), device=self.device) for k in METRIC_KEYS}
            for i in range(n_steps):
                idx = perm[i * b:(i + 1) * b]
                state, metrics = step_fn(state, {k: v[idx] for k, v in data.items()})
                for k in METRIC_KEYS:
                    sums[k] += metrics[k]
            return state, {k: v / max(n_steps, 1) for k, v in sums.items()}

        return epoch_fn

    def make_val_epoch(self, class_weights, n_steps: int) -> Callable:
        """-> ``val_fn(params, data) -> metrics``: the mask-weighted mean of
        the loss metrics over ``n_steps`` padded batches."""
        cfg = self.config
        b = cfg.train.batch_size

        @torch.no_grad()
        def val_fn(params, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            sums = {k: torch.zeros((), device=self.device) for k in METRIC_KEYS}
            wsum = torch.zeros((), device=self.device)
            for i in range(n_steps):
                batch = {k: v[i * b:(i + 1) * b] for k, v in data.items()}
                _, metrics = MultiTaskModel.loss(params, cfg.model, batch, train=False,
                                                 class_weights=class_weights)
                w = torch.sum(batch["mask"])
                for k in METRIC_KEYS:
                    sums[k] += metrics[k] * w
                wsum += w
            return {k: v / torch.clamp(wsum, min=1.0) for k, v in sums.items()}

        return val_fn

    # ---- checkpoints -------------------------------------------------
    @staticmethod
    def _state_dict(state: TrainState) -> Dict[str, Any]:
        return {"params": state.params, "opt_state": state.opt_state,
                "step": np.int64(state.step), "rng": np.int64(state.rng)}

    @staticmethod
    def _copy_into(live, saved) -> None:
        """Copy a saved (numpy) tree into the live tensors of the same tree."""
        saved = dict(leaves_with_paths(saved))
        with torch.no_grad():
            for path, t in leaves_with_paths(live):
                t.copy_(torch.from_numpy(np.asarray(saved[path])))

    def _load_state(self, state: TrainState, tree: Dict) -> TrainState:
        self._copy_into(state.params, tree["params"])
        self._copy_into(state.opt_state, tree["opt_state"])
        return state._replace(step=int(tree["step"]), rng=int(tree["rng"]))

    # ---- the training loop -------------------------------------------
    def train(self, bundle: Dict[str, np.ndarray]) -> Dict[str, float]:
        cfg = self.config
        t_cfg = cfg.train
        dev = self.device
        n_users = int(bundle["meta/n_users"])
        n_items = int(bundle["meta/n_movies"])
        logger.info("training: %d users, %d items on %s", n_users, n_items, dev)
        self.writer.write_config(cfg)

        class_weights = (losses.balanced_class_weights(bundle["train/y_implicit"])
                         if t_cfg.use_class_weights else (1.0, 1.0))
        log_q_table = None
        if t_cfg.logq_correction:
            pop = np.bincount(bundle["train/movie_id"], minlength=n_items).astype(np.float32)
            log_q_table = np.log(np.maximum(pop, 0.5)
                                 / max(len(bundle["train/movie_id"]), 1)).astype(np.float32)

        train_cols = {c: bundle[f"train/{c}"] for c in BATCH_COLUMNS}
        if log_q_table is not None:
            train_cols["log_q"] = log_q_table[train_cols["movie_id"]]
        data_bytes = sum(v.nbytes for v in train_cols.values())
        if data_bytes > t_cfg.device_data_limit_mb * 1024 * 1024:
            _not_ported(f"a train split of {data_bytes} bytes, above "
                        "device_data_limit_mb (the streaming input path)",
                        "Queue 1 item 9")

        state = self.init_state(n_users, n_items, t_cfg.seed)
        if log_q_table is not None:
            # item_bias starts at the log train frequency, so the
            # logQ-corrected softmax starts balanced
            bias = state.params["towers"]["item_bias"]
            bias0 = np.full(bias.shape[0], float(log_q_table.min()), np.float32)
            bias0[:n_items] = log_q_table
            with torch.no_grad():
                bias.copy_(torch.from_numpy(bias0))
        n_rows = len(train_cols["user_id"])
        steps_per_epoch = n_rows // t_cfg.batch_size
        start_epoch = 0
        if t_cfg.resume:
            restored = self.ckpt.restore_latest()
            if restored is not None:
                state = self._load_state(state, restored[1])
                start_epoch = state.step // max(steps_per_epoch, 1)
                logger.info("resumed from checkpoint step %d (epoch %d)",
                            restored[0], start_epoch)

        def on_device(arr):
            return torch.as_tensor(np.ascontiguousarray(arr)).to(dev)

        train_data = {k: on_device(v) for k, v in train_cols.items()}
        n_val = len(bundle["val/user_id"])
        val_steps = max(-(-n_val // t_cfg.batch_size), 1)
        pad = val_steps * t_cfg.batch_size - n_val
        val_data = {c: on_device(np.pad(bundle[f"val/{c}"], (0, pad)))
                    for c in BATCH_COLUMNS}
        if log_q_table is not None:
            val_data["log_q"] = on_device(
                log_q_table[np.pad(bundle["val/movie_id"], (0, pad))])
        val_data["mask"] = on_device(np.pad(np.ones(n_val, np.float32), (0, pad)))
        train_epoch = self.make_train_epoch(class_weights, n_rows, steps_per_epoch)
        val_epoch = self.make_val_epoch(class_weights, val_steps)
        logger.info("device-resident data: %d train rows (%.1f MB), %d steps/epoch",
                    n_rows, data_bytes / 1e6, steps_per_epoch)

        best_val = float("inf")
        best_params_host = None
        patience = 0
        examples_total = 0
        t_train0 = time.time()
        final_epoch = start_epoch
        preempted = False
        self._preempt_requested = False
        prev_handlers = {}
        if (t_cfg.checkpoint_on_preemption
                and threading.current_thread() is threading.main_thread()):
            def on_signal(signum, frame):
                logger.warning("signal %d received: checkpointing at epoch end, then "
                               "stopping (resume with --set train.resume=true)", signum)
                self._preempt_requested = True

            for sig in (signal.SIGTERM, signal.SIGUSR1):
                prev_handlers[sig] = signal.signal(sig, on_signal)

        try:
            for epoch in range(start_epoch, t_cfg.epochs):
                final_epoch = epoch
                self.writer.start_epoch()
                t0 = time.time()
                state, tmetrics = train_epoch(state, train_data, epoch)
                logs = {f"train_{k}": float(v) for k, v in tmetrics.items()}  # syncs
                epoch_time = time.time() - t0
                examples_total += steps_per_epoch * t_cfg.batch_size
                logs["examples_per_s"] = (steps_per_epoch * t_cfg.batch_size
                                          / max(epoch_time, 1e-9))
                logs.update({f"val_{k}": float(v)
                             for k, v in val_epoch(state.params, val_data).items()})
                if t_cfg.eval_every_epochs and (epoch + 1) % t_cfg.eval_every_epochs == 0:
                    sample_cfg = dataclasses.replace(
                        cfg.eval, eval_sample=cfg.eval.eval_sample or 20_000, topk=(10,))
                    logs["val_recall@10"] = evaluate(state.params, cfg.model, bundle, "val",
                                                     sample_cfg, seed=t_cfg.seed)["recall@10"]
                self.writer.end_epoch(epoch, logs)
                if self._preempt_requested:
                    self.ckpt.save(state.step, self._state_dict(state),
                                   metrics={"val_loss": logs["val_loss"]})
                    preempted = True
                    logger.info("preemption checkpoint saved (epoch %d, step %d)",
                                epoch, state.step)
                    break
                monitor = t_cfg.early_stop_metric
                sign = -1.0 if "recall" in monitor or "auc" in monitor else 1.0
                value = logs.get(monitor)
                if value is None and monitor != "val_loss":
                    # not computed this epoch (eval_every_epochs cadence)
                    self.ckpt.save(state.step, self._state_dict(state),
                                   metrics={"val_loss": logs["val_loss"]})
                    continue
                if value is None:
                    value = logs["val_loss"]
                score = sign * value  # lower is better
                is_best = score < best_val
                if is_best:
                    best_val = score
                    best_params_host = ckpt_lib.params_to_numpy(state.params)
                    patience = 0
                else:
                    patience += 1
                self.ckpt.save(state.step, self._state_dict(state),
                               metrics={monitor: value}, is_best=is_best)
                if patience >= t_cfg.early_stop_patience:
                    logger.info("early stopping at epoch %d (best %s %.4f)", epoch,
                                monitor, sign * best_val)
                    break
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            self.ckpt.wait()

        if not preempted and best_params_host is not None:
            self._copy_into(state.params, best_params_host)
        wall = time.time() - t_train0
        self.final_state = state
        if preempted:
            report = {"preempted": True, "train_wall_time_s": wall,
                      "epochs_run": final_epoch + 1, "resume_step": state.step}
            self.writer.write_final_metrics(report)
            self.writer.close()
            return report
        report = evaluate(state.params, cfg.model, bundle, "val", cfg.eval,
                          seed=t_cfg.seed)
        report["train_wall_time_s"] = wall
        report["examples_per_s"] = examples_total / max(wall, 1e-9)
        report["epochs_run"] = final_epoch + 1
        self.writer.write_final_metrics(report)
        self.writer.close()

        index = RetrievalIndex.build(state.params["towers"], cfg.model, n_items,
                                     bundle["meta/movie_raw_ids"], device=dev)
        ckpt_lib.save_inference_bundle(
            f"{self.output_dir}/serving", state.params["towers"], cfg,
            bundle["meta/user_raw_ids"], bundle["meta/movie_raw_ids"],
            index=index, full_params=state.params)
        return report
