"""Single-GPU trainer (the counterpart of ``recsys_tpu/train/trainer.py``
on its one-device, device-resident path).

* params, optimizer slots and the whole train split live on the device;
  an epoch is a loop of steps over an on-device permutation, each step
  a gather of the batch, ``MultiTaskModel.loss``, ``torch.autograd.grad``
  and the optimizer's in-place update (the JAX package's
  ``make_train_epoch``: one compiled scan per epoch; here the Python loop
  dispatches and the metrics stay on the device until the epoch ends);
* sparse table updates (``TrainConfig.sparse_table_updates``; "auto"
  above ``SPARSE_AUTO_THRESHOLD`` table elements): the batch's table rows
  become fresh [B, D] leaves, so autograd returns per-occurrence row
  gradients, and only the touched rows of the tables and their slots
  change (adagrad as the dense step up to summation order, adam as
  LazyAdam);
* the CBNS cross-batch negative cache (``TrainConfig.negative_cache``):
  a FIFO of earlier batches' item embeddings in ``TrainState.extras``,
  appended to the in-batch softmax's candidates, carried through both
  steps, the epoch loop and the checkpoints;
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
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from recsys_tpu_torch.config import RecsysConfig
from recsys_tpu_torch.models import losses
from recsys_tpu_torch.models.multitask import MultiTaskModel
from recsys_tpu_torch.models.towers import TwoTower
from recsys_tpu_torch.retrieval.evaluator import evaluate
from recsys_tpu_torch.retrieval.scorer import RetrievalIndex
from recsys_tpu_torch.train import checkpoint as ckpt_lib
from recsys_tpu_torch.train import optimizer as opt_lib
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
    # the CBNS cache {"emb" [N, D], "ids" [N], "corr" [N]} (a FIFO, newest
    # batch last) when TrainConfig.negative_cache > 0, else None
    extras: Any = None


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to recsys_tpu_torch yet (ROADMAP {item})")


def _tree_from_paths(values: Dict[Tuple[str, ...], torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, v in values.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _grads(loss: torch.Tensor, leaves) -> list:
    """d loss / d leaves; a leaf the loss does not reach (item_bias under
    use_item_bias=False) gets a zero gradient, as in JAX."""
    return [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]


class Trainer:
    # Table elements above which "auto" takes the sparse table updates:
    # the JAX package's TPU v5e crossover, unmeasured on H100.
    SPARSE_AUTO_THRESHOLD = 32_000_000
    _TABLE_KEYS = ("user_table", "item_table", "item_bias")

    def __init__(self, config: RecsysConfig, output_dir: str = "outputs/run",
                 device: DeviceLike = "cuda"):
        self.config = config
        self.output_dir = output_dir
        self.device = resolve_device(device)
        self._check_config()
        self.optimizer = make_optimizer(config.train)
        self._schedule = opt_lib.make_schedule(config.train)
        self.writer = MetricWriter(output_dir)
        self.ckpt = ckpt_lib.CheckpointManager(
            f"{output_dir}/checkpoints", keep=config.train.keep_checkpoints,
            async_save=config.train.async_checkpoint)
        self._dropout_gen = torch.Generator(device=self.device)
        # steps taken on each path, so a caller can see which one ran
        self.step_counts = {"dense": 0, "sparse": 0}
        # elements of the two embedding tables of the last state made
        # (what "auto" sparse updates reads), None before any
        self._table_elements: Optional[int] = None

    # ---- what this port runs ----------------------------------------
    def _check_config(self) -> None:
        cfg = self.config
        t, m = cfg.train, cfg.mesh
        if cfg.data.negative_sampling != "random":
            _not_ported(f"negative_sampling={cfg.data.negative_sampling!r} "
                        "(explicit negatives)", "Queue 1 item 9")
        if cfg.model.dense_features > 0:
            _not_ported("dense_features > 0", "Queue 1 item 4")
        if (m.model_axis != 1 or m.data_axis not in (-1, 1)
                or m.embedding_sharding != "replicated" or m.lookup_strategy != "xla"):
            _not_ported("a mesh of more than one device", "Queue 1 item 11")
        if not t.device_resident_data:
            _not_ported("the streaming input path", "Queue 1 item 9")
        if t.profile:
            _not_ported("TrainConfig.profile", "Queue 1 item 12")
        if t.debug_nans:
            _not_ported("TrainConfig.debug_nans", "Queue 1 item 12")

    def _resolve_sparse_updates(self) -> bool:
        """``sparse_table_updates`` as set, or for "auto" whether the two
        embedding tables of the trainer's state hold more than
        ``SPARSE_AUTO_THRESHOLD`` elements."""
        stu = self.config.train.sparse_table_updates
        if stu != "auto":
            return bool(stu)
        if self._table_elements is None:
            raise ValueError('sparse_table_updates="auto" reads the table sizes: make '
                             "the state (init_state / state_from_params) before the step")
        return self._table_elements > self.SPARSE_AUTO_THRESHOLD

    def _check_cache_config(self, batch_rows: int) -> None:
        n = self.config.train.negative_cache
        if n > 0 and n % batch_rows != 0:
            raise ValueError(
                f"negative_cache ({n}) must be a multiple of the batch size "
                f"({batch_rows}): the FIFO advances one batch per step")

    # ---- state -------------------------------------------------------
    def init_state(self, n_users: int, n_items: int, seed: int) -> TrainState:
        """Params from ``MultiTaskModel.init`` (drawn from a CPU generator
        seeded with ``seed``), on the trainer's device, with gradients on;
        fresh optimizer slots; an empty cache; step 0."""
        params = MultiTaskModel.init(torch.Generator().manual_seed(seed),
                                     self.config.model, n_users, n_items, self.device)
        return self.state_from_params(params, seed)

    def state_from_params(self, params, seed: int) -> TrainState:
        """A step-0 state around given params (moved to the trainer's
        device, gradients on), e.g. those of ``params_from_numpy``, with
        fresh slots and, under ``negative_cache``, an empty cache."""
        def own(node):
            if isinstance(node, dict):
                return {k: own(v) for k, v in node.items()}
            return node.detach().to(self.device, torch.float32).clone().requires_grad_(True)

        params = own(params)
        tw = params["towers"]
        self._table_elements = tw["user_table"].numel() + tw["item_table"].numel()
        extras = None
        n = self.config.train.negative_cache
        if n > 0:
            # empty slots: an id no item has (-1) and corr -1e9, so each
            # adds exp(-1e9) = 0 to the softmax: an exact no-op
            extras = {
                "emb": torch.zeros((n, self.config.model.embedding_dim), device=self.device),
                "ids": torch.full((n,), -1, dtype=torch.int32, device=self.device),
                "corr": torch.full((n,), -1e9, device=self.device),
            }
        return TrainState(params, self.optimizer.init(params), 0, seed + 1, extras)

    def _generator(self, state: TrainState) -> torch.Generator:
        self._dropout_gen.manual_seed(state.rng * 1_000_003 + state.step)
        return self._dropout_gen

    # ---- the step ----------------------------------------------------
    def _step_core(self, class_weights) -> Callable:
        """-> ``step_fn(state, batch) -> (state, metrics)``: the train step
        (loss, autograd, in-place optimizer update, the cache's FIFO),
        sparse or dense as ``_resolve_sparse_updates`` says when it is
        built. ``batch`` holds tensors on the device; metrics stay there."""
        self._check_cache_config(self.config.train.batch_size)
        if self._resolve_sparse_updates():
            return self._step_core_sparse(class_weights)
        return self._step_core_dense(class_weights)

    def _step_core_dense(self, class_weights) -> Callable:
        """The dense step: gradients of every leaf, the full-table update."""
        cfg = self.config
        opt = self.optimizer

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
            paths, leaves = zip(*leaves_with_paths(state.params))
            _, metrics = MultiTaskModel.loss(
                state.params, cfg.model, batch, generator=self._generator(state),
                train=True, class_weights=class_weights,
                extra_candidates=self._cache_tuple(state))
            grads = _grads(metrics["loss"], leaves)
            new_cache = self._cache_update(state, state.params, batch)  # pre-update params
            opt.update(_tree_from_paths(dict(zip(paths, grads))),
                       state.opt_state, state.params, state.step)
            self.step_counts["dense"] += 1
            return (state._replace(step=state.step + 1, extras=new_cache),
                    {k: v.detach() for k, v in metrics.items()})

        return step_fn

    def _step_core_sparse(self, class_weights) -> Callable:
        """The sparse step (``_step_core_sparse`` of the JAX package): the
        batch's table rows are gathered up front into virtual tables of
        exactly B rows, fresh leaves with gradients on, and the batch's ids
        become ``arange(B)`` with the true ids in ``mask_ids`` (the
        accidental-hit mask), so autograd returns per-occurrence [B, D] and
        [B] row gradients; :meth:`_sparse_apply` updates the touched rows.
        No [V, D] gradient is ever formed."""
        cfg = self.config
        if cfg.train.optimizer == "adam":
            logger.info(
                "sparse_table_updates with optimizer=adam uses LAZY-Adam "
                "semantics (untouched rows keep un-decayed moments; "
                "TF-LazyAdam parity), a deliberate divergence from dense "
                "Adam; set sparse_table_updates=False for exact dense-Adam "
                "math at full-table update cost.")
        # the dense leaves' optimizer; _sparse_apply clips before it, over
        # the dense gradients and the combined rows together
        dense_opt = make_optimizer(dataclasses.replace(cfg.train, clipnorm=0.0))

        def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
            params = state.params
            tw = params["towers"]
            movie = batch["movie_id"].long()
            ids = {"user_table": batch["user_id"].long(), "item_table": movie,
                   "item_bias": movie}
            ids = {k: v.clamp(0, tw[k].shape[0] - 1) for k, v in ids.items()}
            virt = {k: tw[k].detach()[ids[k]].requires_grad_(True) for k in self._TABLE_KEYS}
            vparams = {**params, "towers": {**tw, **virt}}
            ar = torch.arange(movie.shape[0], dtype=torch.int32, device=movie.device)
            vbatch = {**batch, "user_id": ar, "movie_id": ar, "mask_ids": batch["movie_id"]}
            _, metrics = MultiTaskModel.loss(
                vparams, cfg.model, vbatch, generator=self._generator(state), train=True,
                class_weights=class_weights, extra_candidates=self._cache_tuple(state))
            paths, leaves = zip(*leaves_with_paths(vparams))
            grads = dict(zip(paths, _grads(metrics["loss"], leaves)))
            new_cache = self._cache_update(state, params, batch)  # pre-update params
            self._sparse_apply(state, grads, ids, dense_opt)
            self.step_counts["sparse"] += 1
            return (state._replace(step=state.step + 1, extras=new_cache),
                    {k: v.detach() for k, v in metrics.items()})

        return step_fn

    @torch.no_grad()
    def _sparse_apply(self, state: TrainState, grads: Dict[Tuple[str, ...], torch.Tensor],
                      ids: Dict[str, torch.Tensor], dense_opt) -> None:
        """The update of the sparse step, in place (``_sparse_apply`` of
        the JAX package). ``grads`` maps each leaf's path to its gradient:
        per-occurrence rows (aligned with ``ids``) for the three table
        leaves, dense for the rest. Duplicates are combined; global-norm
        clipping runs over the dense gradients plus the combined rows (the
        dense step's norm: untouched rows add zero); ``dense_opt``, the
        configured optimizer without its own clipping, updates the dense
        leaves with the ranking LR scale; the tables take sparse adagrad or
        lazy Adam on their touched rows at the base LR."""
        t = self.config.train
        table_paths = {("towers", k): k for k in self._TABLE_KEYS}
        comb = {k: opt_lib.combine_duplicate_rows(ids[k], grads[p])
                for p, k in table_paths.items()}
        dense = {p: g for p, g in grads.items() if p not in table_paths}
        scale = None
        if t.clipnorm > 0:
            sq = sum(torch.sum(torch.square(g)) for g in dense.values())
            sq = sq + sum(torch.sum(torch.square(c[1])) for c in comb.values())
            scale = torch.clamp(t.clipnorm / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
            dense = {p: g * scale for p, g in dense.items()}
        dense_opt.update(_tree_from_paths(dense), state.opt_state, state.params, state.step)
        lr = self._schedule(state.step)
        tw, slots = state.params["towers"], state.opt_state
        for k, (slot_ids, combined, valid) in comb.items():
            if t.optimizer == "adagrad":
                opt_lib.sparse_adagrad_combined(tw[k], slots["accum"]["towers"][k], slot_ids,
                                                combined, valid, lr, grad_scale=scale)
            else:  # adam -> lazy Adam on the touched rows
                opt_lib.sparse_lazy_adam_combined(
                    tw[k], slots["mu"]["towers"][k], slots["nu"]["towers"][k], slot_ids,
                    combined, valid, lr, state.step, grad_scale=scale)

    # ---- CBNS cross-batch negative cache (TrainConfig.negative_cache) --
    @staticmethod
    def _cache_tuple(state: TrainState):
        """extras -> the (emb, ids, corr) triple the loss takes."""
        if state.extras is None:
            return None
        c = state.extras
        return c["emb"], c["ids"], c["corr"]

    @torch.no_grad()
    def _cache_update(self, state: TrainState, params, batch):
        """The FIFO advanced by one batch: this batch's item embeddings
        (item tower in inference mode on the PRE-update params, the
        encodings this step scored) with their ``item_bias - log_q``
        correction appended, the oldest batch dropped. The ids are the true
        item ids."""
        if state.extras is None:
            return None
        cfg = self.config
        tw = params["towers"]
        ids = batch["movie_id"]
        emb = TwoTower.item_embed(tw, ids, cfg.model, train=False)
        corr = torch.zeros(ids.shape, dtype=torch.float32, device=emb.device)
        if cfg.model.use_item_bias:
            corr = corr + tw["item_bias"][ids.long().clamp(0, tw["item_bias"].shape[0] - 1)]
        if "log_q" in batch:
            corr = corr - batch["log_q"]
        b = ids.shape[0]
        c = state.extras
        return {"emb": torch.cat([c["emb"][b:], emb.float()]),
                "ids": torch.cat([c["ids"][b:], ids.to(c["ids"].dtype)]),
                "corr": torch.cat([c["corr"][b:], corr])}

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
        """The checkpointed tree; ``extras`` (the cache) is None and left
        out of the npz when the cache is off, as in the JAX package."""
        return {"params": state.params, "opt_state": state.opt_state,
                "step": np.int64(state.step), "rng": np.int64(state.rng),
                "extras": state.extras}

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
        if state.extras is not None and "extras" in tree:
            self._copy_into(state.extras, tree["extras"])  # a warm cache
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
